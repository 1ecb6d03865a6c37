"""Inspection views of a fitted Gaussian set: ellipses, centres, radii, tile
occupancy and the per-pixel contributor count.

Port of ``gaussianimage_plus_tpu/utils/visualize.py`` (``_ellipse_params``
:16, ``visual_points`` :29, ``tile_occupancy_heatmap`` :64,
``visual_points_xyz`` :92, ``radius_circles`` :127, ``pixel_count_map``
:163, ``pixel_count_heatmap`` :193, ``radius_histogram`` :210), after the
reference's ``visual_points`` / ``visual_points_xyz`` / ``visual_gs_points``
(models/utils.py:396-897). ``pixel_count_map`` is torch on the state's
device (the card's render gate); the six plots draw on the host with
matplotlib, imported inside each function as in the JAX package, and write
a PNG.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _ellipse_params(cov2d: np.ndarray):
    """(major sigma, minor sigma, angle in degrees) per packed covariance."""
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    tr = 0.5 * (a + c)
    det = a * c - b * b
    disc = np.sqrt(np.maximum(tr * tr - det, 0.0))
    v1 = np.maximum(tr + disc, 1e-8)
    v2 = np.maximum(tr - disc, 1e-8)
    angle = 0.5 * np.degrees(np.arctan2(2 * b, a - c))
    return np.sqrt(v1), np.sqrt(v2), angle


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, plt, out_path, **kw):
    os.makedirs(os.path.dirname(str(out_path)) or ".", exist_ok=True)
    fig.savefig(out_path, **kw)
    plt.close(fig)
    return out_path


def _grid(ax, cfg, grid_size):
    for y in np.linspace(0, cfg.H, grid_size + 1):
        ax.axhline(y, color="gray", lw=0.5)
    for x in np.linspace(0, cfg.W, grid_size + 1):
        ax.axvline(x, color="gray", lw=0.5)


def visual_points(state, cfg, out_path, image=None, sigma_scale=3.0, max_draw=3000):
    """Ellipse overlay of the active Gaussians (visual_points,
    models/utils.py:396+), saved as a PNG at ``out_path``."""
    plt = _pyplot()
    from matplotlib.patches import Ellipse

    from ..models.gaussian_image import effective_cov2d, means_of

    with torch.no_grad():
        xy = _np(means_of(state.params, cfg))
        cov = _np(effective_cov2d(state.params, state.bound, cfg))
    active = _np(state.active)
    xy, cov = xy[active][:max_draw], cov[active][:max_draw]
    s1, s2, ang = _ellipse_params(cov)
    fig, ax = plt.subplots(figsize=(cfg.W / 96, cfg.H / 96), dpi=96)
    if image is not None:
        ax.imshow(_np(image), extent=[0, cfg.W, cfg.H, 0])
    for i in range(xy.shape[0]):
        ax.add_patch(Ellipse(xy[i], sigma_scale * 2 * s1[i], sigma_scale * 2 * s2[i],
                             angle=ang[i], fill=False, lw=0.4, color="lime", alpha=0.6))
    ax.scatter(xy[:, 0], xy[:, 1], s=0.5, c="red")
    ax.set_xlim(0, cfg.W)
    ax.set_ylim(cfg.H, 0)
    ax.set_axis_off()
    return _save(fig, plt, out_path, bbox_inches="tight", pad_inches=0)


def tile_occupancy_heatmap(state, cfg, out_path):
    """Per-tile member counts, as the binner sees them."""
    plt = _pyplot()
    from ..core.binning import bin_gaussians
    from ..core.gaussian2d import tile_bounds_for
    from ..models.gaussian_image import project

    with torch.no_grad():
        proj = project(state.params, state.active, state.bound, cfg)
        bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap)
    tb_x, tb_y = tile_bounds_for(cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    counts = _np(bins.count).reshape(tb_y, tb_x)
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(counts, cmap="viridis")
    fig.colorbar(im, ax=ax, label="gaussians per tile")
    ax.set_title(f"tile occupancy (max {counts.max()}, cap {cfg.tile_cap})")
    return _save(fig, plt, out_path, bbox_inches="tight")


def visual_points_xyz(state, cfg, out_path, colors=None, grid_size=16):
    """Centres on black with a grid (visual_points_xyz, models/utils.py:489-568):
    one dot per active Gaussian, in its colour, or red when ``colors`` is
    None, as the reference draws them."""
    plt = _pyplot()
    from ..models.gaussian_image import colors_of, means_of

    active = _np(state.active)
    with torch.no_grad():
        xy = _np(means_of(state.params, cfg))[active]
        c = "red" if colors is None else np.clip(_np(colors_of(state.params, cfg))[active], 0, 1)
    fig, ax = plt.subplots(figsize=(cfg.W / 96, cfg.H / 96), dpi=96)
    ax.set_facecolor("black")
    ax.scatter(xy[:, 0], xy[:, 1], s=4, c=c)
    _grid(ax, cfg, grid_size)
    ax.set_xlim(0, cfg.W)
    ax.set_ylim(cfg.H, 0)
    ax.set_axis_off()
    return _save(fig, plt, out_path, bbox_inches="tight", pad_inches=0, facecolor="black")


def radius_circles(state, cfg, out_path, grid_size=16):
    """A filled circle of each Gaussian's projected bounding radius, in its
    colour (the radius views of visual_points, models/utils.py:595-597)."""
    plt = _pyplot()
    from matplotlib.patches import Circle

    from ..models.gaussian_image import colors_of, project

    with torch.no_grad():
        proj = project(state.params, state.active, state.bound, cfg)
        valid = _np(proj.valid)
        xy, radii = _np(proj.xys)[valid], _np(proj.radii)[valid]
        cols = np.clip(_np(colors_of(state.params, cfg))[valid], 0, 1)
    fig, ax = plt.subplots(figsize=(cfg.W / 96, cfg.H / 96), dpi=96)
    ax.set_facecolor("black")
    for i in range(xy.shape[0]):
        ax.add_patch(Circle(xy[i], radii[i], color=cols[i], alpha=0.8))
    _grid(ax, cfg, grid_size)
    ax.set_xlim(0, cfg.W)
    ax.set_ylim(cfg.H, 0)
    ax.set_axis_off()
    return _save(fig, plt, out_path, bbox_inches="tight", pad_inches=0, facecolor="black")


def pixel_count_map(state, cfg) -> torch.Tensor:
    """[H, W] int32 on the state's device: the Gaussians that pass the blend
    gate at each pixel (the reference rasterizer's ``per_pix_gs_nums``,
    forward.cu:650-672), with the binned render's tile lists and cap."""
    from ..core.binning import bin_gaussians
    from ..core.render_tiled import contrib_counts
    from ..kernels.raster_binned import _prepare
    from ..models.gaussian_image import colors_of, project

    with torch.no_grad():
        proj = project(state.params, state.active, state.bound, cfg)
        bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap, block_h=cfg.block_h,
                             block_w=cfg.block_w,
                             method="top_k" if cfg.bin_method == "pallas" else cfg.bin_method)
        opacity = torch.ones((cfg.max_num_points,), dtype=proj.xys.dtype, device=proj.xys.device)
        raw, counts = _prepare(proj.xys, proj.conics, colors_of(state.params, cfg), opacity,
                               bins.ids, bins.mask)
        return contrib_counts(raw, counts, cfg.H, cfg.W, cfg.block_h, cfg.block_w)


def pixel_count_heatmap(state, cfg, out_path):
    """Heatmap of ``pixel_count_map`` with a colour bar (visual_gs_points,
    models/utils.py:831-897)."""
    plt = _pyplot()
    counts = _np(pixel_count_map(state, cfg))
    fig, ax = plt.subplots(figsize=(10, 7))
    im = ax.imshow(counts)
    fig.colorbar(im, ax=ax)
    ax.set_title("the number of gs per pixel")
    return _save(fig, plt, out_path, bbox_inches="tight")


def radius_histogram(state, cfg, out_path):
    """Histogram of the projected bounding radii."""
    plt = _pyplot()
    from ..models.gaussian_image import project

    with torch.no_grad():
        proj = project(state.params, state.active, state.bound, cfg)
    radii = _np(proj.radii)[_np(proj.valid)]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(radii, bins=50)
    ax.set_xlabel("bounding radius (px)")
    ax.set_ylabel("count")
    return _save(fig, plt, out_path, bbox_inches="tight")
