"""GaussianImage model: configuration, state, forward render, growth and pruning.

Port of ``gaussianimage_plus_tpu/models/gaussian_image.py``:
``GaussianConfig``, ``GaussianParams``, ``GaussianState``, ``init_state``,
``effective_cov2d`` (all three parameterizations), ``colors_of``,
``means_of``, ``project``, ``resolve_backend``, ``render``,
``prepare_render``, ``render_prepared``, ``render_fast``, ``get_attributes``,
``psd_clamp``, ``psd_mask_effective``, ``prune`` and ``grow``. Every
per-Gaussian buffer has ``max_num_points`` rows and an ``active`` mask, as in
the JAX package; opacity is fixed at 1. Randomness comes from an explicit
``torch.Generator`` (``init_state``, ``grow``); the JAX package's draws can be
injected instead (``grow(draws=...)``), since the two generators differ.

Backends: ``'pallas'`` is the binned capped pair (kernel A forward, kernel
D backward) over bins from ``cfg.bin_method`` (``'pallas'``: kernel E);
``'list'``/``'list_t'`` the cap-free chunk-list pair at kc 64/128 (kernel B
forward, kernel C backward); ``'dense'`` and ``'sweep'`` the same cap-free
function over every chunk or each tile's member chunks (kernel B forward,
kernel C backward). Every other name, ``'xla'`` among them, takes the plain
PyTorch tiled path with the capped semantics and the JAX package's VJP, as
the JAX ``render`` does. ``'auto'`` follows the JAX rule on the card
(``list_t`` when the tile grid divides 16, else ``'pallas'``) and gives
``'xla'`` on the CPU, as the JAX package does off the TPU. The forward-only
``render_fast`` adds the chunk-range enumeration, ``sweep='range'``. The
kernels render 16x16 tiles; other tile sizes take the plain path only
(``core.gaussian2d.check_kernel_tiles``).

The render clamps with ``torch.minimum(torch.maximum(img, 0), 1)``, whose
gradient at exactly 0 or 1 is one half, as ``jnp.clip``'s is
(``torch.clamp`` would pass all of it). It matters at the first step of a fit:
colours start at zero, so every pixel is exactly 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..core.binning import bin_gaussians
from ..core.gaussian2d import (BLOCK_H, BLOCK_W, Projected, check_kernel_tiles,
                               cholesky_to_cov2d,
                               project_gaussians_2d_covariance, psd_valid_mask,
                               scale_rot_to_cov2d, slv_bound, tile_bounds_for)
from ..core.render_tiled import rasterize_tiled, render_table
from ..kernels.binning_tiles import bin_gaussians_tiles
from ..kernels.raster_binned import (_gather, prepare_raster, rasterize_binned,
                                      rasterize_prepared_flat)
from ..kernels.raster_dense import (rasterize_dense, rasterize_dense_pallas,
                                    rasterize_range_pallas, rasterize_sweep,
                                    rasterize_sweep_pallas)
from ..kernels.raster_list import TB_T, rasterize_list, rasterize_list_t
from ..utils.profiling import span

_CAP_FREE = {"dense": rasterize_dense, "sweep": rasterize_sweep}


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    """Static model/rendering configuration (fields as in the JAX config)."""

    H: int = 512
    W: int = 768
    max_num_points: int = 5000
    param: str = "covariance"
    slv: bool = True
    color_norm: bool = False
    clip_coe: float = 3.0
    radius_clip: float = 1.0
    tile_cap: int = 256
    block_h: int = BLOCK_H
    block_w: int = BLOCK_W
    bin_method: str = "auto"
    raster_backend: str = "auto"
    # 'prune': drop non-PSD points (the reference); 'clamp': project the
    # effective covariance back onto the PSD cone after each update
    psd_mode: str = "prune"


class GaussianParams(NamedTuple):
    """Per-Gaussian attributes [max_num_points, ...] (raw parameters)."""

    xyz: torch.Tensor       # [M, 2]
    cov2d: torch.Tensor     # [M, 3]
    features: torch.Tensor  # [M, 3]


class GaussianState(NamedTuple):
    params: GaussianParams
    active: torch.Tensor      # [M] bool
    bound: torch.Tensor       # [M, 3] per-row covariance floor
    num_active: torch.Tensor  # [] int32


def _slv_rows(cfg: GaussianConfig, num_points, M: int, device) -> torch.Tensor:
    """[M, 3] covariance floors: SLV rows ``[lp, 0, lp]`` at ``num_points``,
    or the constant ``[0.5, 0, 0.5]`` without SLV."""
    if cfg.slv:
        lp = slv_bound(cfg.H, cfg.W, num_points).to(device)
        row = torch.stack([lp, torch.zeros_like(lp), lp])
    else:
        row = torch.tensor([0.5, 0.0, 0.5], device=device)
    return row[None, :].expand(M, 3).contiguous()


def init_state(cfg: GaussianConfig, num_points: int,
               generator: torch.Generator) -> GaussianState:
    """Random init (gaussianimage_covariance.py:52-69), on the generator's
    device: xy ~ U(0, W) x U(0, H), raw cov ~ U(0, 1)^3, colours zero, the
    first ``num_points`` slots active, SLV rows at ``num_points``."""
    M = cfg.max_num_points
    dev = generator.device
    xy = torch.rand((M, 2), generator=generator, device=dev)
    xyz = xy * torch.tensor([float(cfg.W), float(cfg.H)], device=dev)
    cov2d = torch.rand((M, 3), generator=generator, device=dev)
    return GaussianState(
        params=GaussianParams(xyz=xyz, cov2d=cov2d,
                              features=torch.zeros((M, 3), device=dev)),
        active=torch.arange(M, device=dev) < num_points,
        bound=_slv_rows(cfg, num_points, M, dev),
        num_active=torch.tensor(num_points, dtype=torch.int32, device=dev))


def effective_cov2d(params: GaussianParams, bound: torch.Tensor,
                    cfg: GaussianConfig) -> torch.Tensor:
    """Covariance actually rendered, per parameterization."""
    if cfg.param == "covariance":
        return params.cov2d + bound
    if cfg.param == "cholesky":
        return cholesky_to_cov2d(params.cov2d + bound)
    if cfg.param == "scale_rot":
        return scale_rot_to_cov2d(torch.abs(params.cov2d[:, :2]) + 0.3,
                                  torch.sigmoid(params.cov2d[:, 2]) * 2.0 * math.pi)
    raise ValueError(f"unknown parameterization {cfg.param!r}")


def colors_of(params: GaussianParams, cfg: GaussianConfig) -> torch.Tensor:
    """Colour activation: sigmoid iff ``color_norm``."""
    return torch.sigmoid(params.features) if cfg.color_norm else params.features


def means_of(params: GaussianParams, cfg: GaussianConfig) -> torch.Tensor:
    """Pixel-space means (the legacy Cholesky model keeps atanh space)."""
    if cfg.param == "cholesky":
        xy = torch.tanh(params.xyz)
        return torch.stack([0.5 * cfg.W * xy[:, 0] + 0.5 * cfg.W,
                            0.5 * cfg.H * xy[:, 1] + 0.5 * cfg.H], dim=-1)
    return params.xyz


def project(params: GaussianParams, state_active: torch.Tensor, bound: torch.Tensor,
            cfg: GaussianConfig, cov_override: Optional[torch.Tensor] = None,
            means_override: Optional[torch.Tensor] = None) -> Projected:
    """Project, then cull inactive slots exactly like pruned rows."""
    cov = cov_override if cov_override is not None else effective_cov2d(params, bound, cfg)
    means = means_override if means_override is not None else means_of(params, cfg)
    proj = project_gaussians_2d_covariance(means, cov, cfg.H, cfg.W,
                                           clip_coe=cfg.clip_coe,
                                           radius_clip=cfg.radius_clip)
    valid = proj.valid & state_active
    zero = torch.zeros_like(proj.radii)
    return proj._replace(valid=valid,
                         radii=torch.where(valid, proj.radii, zero),
                         num_tiles_hit=torch.where(valid, proj.num_tiles_hit, zero))


def resolve_backend(cfg: GaussianConfig, device) -> str:
    """Resolve ``raster_backend='auto'`` for tensors on ``device``: on CUDA
    ``'list_t'`` when the tile grid divides ``TB_T`` = 16, else the binned
    kernel ``'pallas'``; on the CPU the plain tiled path ``'xla'``. On CUDA
    with tiles other than 16x16 it raises (``check_kernel_tiles``) rather than
    resolve to the plain path on the card."""
    if cfg.raster_backend != "auto":
        return cfg.raster_backend
    if torch.device(device).type != "cuda":
        return "xla"
    check_kernel_tiles(cfg.block_h, cfg.block_w, "raster_backend='auto' on a CUDA device")
    tb_x, tb_y = tile_bounds_for(cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    return "list_t" if (tb_x * tb_y) % TB_T == 0 else "pallas"


# backends that launch a kernel, so render 16x16 tiles only (check_kernel_tiles);
# the trainer's chunks on these run as CUDA graph replays (train.trainer.captures)
KERNEL_BACKENDS = frozenset({"pallas", "list", "list_t", "dense", "sweep"})


def render_binner(cfg: GaussianConfig, device) -> Optional[str]:
    """The binning method ``render`` runs at ``cfg`` on ``device``: None for
    the cap-free backends, which bin nothing, else ``cfg.bin_method``."""
    backend = resolve_backend(cfg, device)
    return None if backend in ("list", "list_t") or backend in _CAP_FREE else cfg.bin_method


def _inputs(state, cfg, cov_override, means_override, colors_override):
    proj = project(state.params, state.active, state.bound, cfg,
                   cov_override=cov_override, means_override=means_override)
    colors = colors_override if colors_override is not None else colors_of(state.params, cfg)
    opacity = torch.ones((cfg.max_num_points,), dtype=proj.xys.dtype, device=proj.xys.device)
    return proj, colors, opacity


def _clip01(img: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(img, 0, 1)``, its gradient included (one half at a tie)."""
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    return torch.minimum(torch.maximum(img, zero), zero + 1.0)


def render(state: GaussianState, cfg: GaussianConfig,
           cov_override: Optional[torch.Tensor] = None,
           means_override: Optional[torch.Tensor] = None,
           colors_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward pass -> [H, W, 3] clamped to [0, 1]: project -> (bin) ->
    rasterize -> clamp, on the device of the state's tensors."""
    backend = resolve_backend(cfg, state.active.device)
    if backend in KERNEL_BACKENDS:
        check_kernel_tiles(cfg.block_h, cfg.block_w, f"raster_backend={backend!r}")
    elif cfg.bin_method == "pallas":
        check_kernel_tiles(cfg.block_h, cfg.block_w, "bin_method='pallas'")
    proj, colors, opacity = _inputs(state, cfg, cov_override, means_override,
                                    colors_override)
    if backend in ("list", "list_t"):
        raster = rasterize_list_t if backend == "list_t" else rasterize_list
        return _clip01(raster(proj, colors, opacity, cfg.H, cfg.W))
    if backend in _CAP_FREE:
        return _clip01(_CAP_FREE[backend](proj.xys, proj.conics, colors, opacity,
                                          proj.radii, proj.valid, cfg.H, cfg.W))
    # a span of a forward-only render (a decode, an evaluation); none inside a training step
    with contextlib.nullcontext() if proj.xys.requires_grad else span("render.bin"):
        if cfg.bin_method == "pallas":
            bins = bin_gaussians_tiles(proj, cfg.H, cfg.W, cap=cfg.tile_cap,
                                       block_h=cfg.block_h, block_w=cfg.block_w)
        else:
            bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap,
                                 block_h=cfg.block_h, block_w=cfg.block_w,
                                 method=cfg.bin_method)
    if backend == "pallas":
        img = rasterize_binned(proj.xys, proj.conics, colors, opacity,
                               bins.ids, bins.mask, proj.radii, cfg.H, cfg.W)
    else:
        img = rasterize_tiled(proj.xys, proj.conics, colors, opacity,
                              bins.ids, bins.mask, cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    return _clip01(img)


def prepare_render(state: GaussianState, cfg: GaussianConfig,
                   cov_override: Optional[torch.Tensor] = None,
                   means_override: Optional[torch.Tensor] = None,
                   colors_override: Optional[torch.Tensor] = None,
                   cap: Optional[int] = None):
    """Bin-once stage of the decode fast path: project + bin into a
    ``kernels.raster_binned.Prepared`` attribute table and slot ids. ``bin_method='pallas'``
    bins with ``'top_k'`` here (the same bins), as in the JAX package."""
    proj, colors, opacity = _inputs(state, cfg, cov_override, means_override,
                                    colors_override)
    method = "top_k" if cfg.bin_method == "pallas" else cfg.bin_method
    bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cap or cfg.tile_cap,
                         block_h=cfg.block_h, block_w=cfg.block_w, method=method)
    return prepare_raster(proj.xys, proj.conics, colors, opacity,
                          bins.ids, bins.mask, cfg.H, cfg.W, cfg.block_h, cfg.block_w)


def render_prepared(prep, cfg: GaussianConfig) -> torch.Tensor:
    """Per-frame render from a prepared table -> [H, W, 3] in [0, 1]:
    kernel A on 16x16 tiles (whatever the backend, as the JAX package runs
    its flat kernel), else the plain blend of the ``'xla'`` path."""
    if (cfg.block_h, cfg.block_w) == (BLOCK_H, BLOCK_W):
        return _clip01(rasterize_prepared_flat(prep, cfg.H, cfg.W))
    backend = resolve_backend(cfg, prep.table.device)
    if backend in KERNEL_BACKENDS:
        check_kernel_tiles(cfg.block_h, cfg.block_w, f"raster_backend={backend!r}")
    return _clip01(render_table(_gather(prep.table, prep.ids), prep.counts, cfg.H, cfg.W,
                                cfg.block_h, cfg.block_w))


def render_fast(state: GaussianState, cfg: GaussianConfig,
                cov_override: Optional[torch.Tensor] = None,
                means_override: Optional[torch.Tensor] = None,
                colors_override: Optional[torch.Tensor] = None,
                sweep=False) -> torch.Tensor:
    """Forward-only cap-free render (the decode/eval fast path) -> [H, W, 3]
    in [0, 1]. ``sweep`` picks the chunk enumeration of kernel B, as in the
    JAX package: ``False`` the dense kernel (every chunk), ``True`` the
    chunk-skip sweep, ``'range'``, ``'list'`` or ``'list_t'``. Each is
    kernel B, so the tiles must be 16x16."""
    check_kernel_tiles(cfg.block_h, cfg.block_w, f"render_fast(sweep={sweep!r})")
    proj, colors, opacity = _inputs(state, cfg, cov_override, means_override,
                                    colors_override)
    if sweep == "range":
        img = rasterize_range_pallas(proj, colors, opacity, cfg.H, cfg.W)
    elif sweep == "list":
        img = rasterize_list(proj, colors, opacity, cfg.H, cfg.W)
    elif sweep == "list_t":
        img = rasterize_list_t(proj, colors, opacity, cfg.H, cfg.W)
    elif sweep is True:
        img = rasterize_sweep_pallas(proj, colors, opacity, cfg.H, cfg.W)
    elif sweep is False:
        img = rasterize_dense_pallas(proj, colors, opacity, cfg.H, cfg.W)
    else:
        raise ValueError(f"unknown render_fast kernel {sweep!r}")
    return _clip01(img)


def get_attributes(state: GaussianState, cfg: GaussianConfig) -> dict:
    """Host-side export of the fitted attributes of the active rows, as
    numpy (gaussianimage_covariance.py:181-185)."""
    active = state.active.cpu().numpy()
    with torch.no_grad():
        return {
            "coords": means_of(state.params, cfg).cpu().numpy()[active],
            "covs": effective_cov2d(state.params, state.bound, cfg).cpu().numpy()[active],
            "colors": colors_of(state.params, cfg).cpu().numpy()[active],
        }


def psd_clamp(params: GaussianParams, bound: torch.Tensor, cfg: GaussianConfig,
              margin: float = 0.995, min_var: float = 1e-3) -> GaussianParams:
    """Project the raw covariance so that the effective one is PSD:
    variances at least ``min_var``, the off-diagonal within ``margin *
    sqrt(var_x * var_y)``. The other parameterizations are PSD by
    construction and pass through."""
    if cfg.param != "covariance":
        return params
    eff = params.cov2d + bound
    a = torch.clamp(eff[:, 0], min=min_var)
    c = torch.clamp(eff[:, 2], min=min_var)
    lim = margin * torch.sqrt(a * c)
    b = torch.minimum(torch.maximum(eff[:, 1], -lim), lim)
    return params._replace(cov2d=torch.stack([a, b, c], dim=-1) - bound)


def psd_mask_effective(state: GaussianState, cfg: GaussianConfig) -> torch.Tensor:
    """PSD check on the effective covariance (check_non_semi_definite,
    gaussianimage_covariance.py:373-378)."""
    return psd_valid_mask(effective_cov2d(state.params, state.bound, cfg))


def prune(state: GaussianState, cfg: GaussianConfig):
    """Deactivate non-PSD Gaussians (non_semi_definite_prune, :354-371),
    unless that would leave none (the reference's guard, :357). Returns
    (state, number pruned) with no host synchronisation."""
    new_active = state.active & psd_mask_effective(state, cfg)
    n_new = new_active.sum(dtype=torch.int32)
    do = n_new > 0
    active = torch.where(do, new_active, state.active)
    num_active = torch.where(do, n_new, state.num_active)
    return state._replace(active=active, num_active=num_active), state.num_active - num_active


def grow(state: GaussianState, cfg: GaussianConfig, render_img: torch.Tensor,
         gt_image: torch.Tensor, generator: Optional[torch.Generator], final_fill,
         base_num_samples: int = 1000, draws: Optional[torch.Tensor] = None):
    """Error-guided densification under static shapes (reference
    train.py:85-118 and densification_postfix :307-334).

    The ``max_num_points`` pixels of largest error ``|render - gt|`` (summed
    over channels) become candidates at their integer pixel coordinates,
    with colour 0 and raw covariance ``U(0, 1)^3 + [0.5, 0, 0.5]``; those
    whose raw covariance is not PSD are rejected; the first ``n_add``
    candidates, ``min(base_num_samples, free)`` or all free slots when
    ``final_fill``, fill the lowest free slots in order. SLV rows of the
    newcomers use the post-growth count. ``draws`` [M, 3] replaces the
    generator's ``U(0, 1)`` draws (the tests inject the JAX package's).
    Returns (state, n_added, new_slot_mask); the caller zeroes the optimizer
    moments at ``new_slot_mask``."""
    M = cfg.max_num_points
    dev = state.active.device
    free = M - state.num_active
    final_fill = torch.as_tensor(final_fill, device=dev)
    n_add = torch.where(final_fill, free, torch.clamp(free, max=base_num_samples))

    errors = (render_img - gt_image).abs().sum(dim=-1)                   # [H, W]
    top_idx = torch.topk(errors.reshape(-1), M).indices
    cand_xy = torch.stack([(top_idx % cfg.W).to(torch.float32),
                           torch.div(top_idx, cfg.W, rounding_mode="floor").to(torch.float32)],
                          dim=-1)
    if draws is None:
        draws = torch.rand((M, 3), generator=generator, device=dev)
    cand_cov = draws.to(dev) + torch.tensor([0.5, 0.0, 0.5], device=dev)
    rank = torch.arange(M, device=dev)
    cand_ok = psd_valid_mask(cand_cov) & (rank < n_add)
    n_added = cand_ok.sum(dtype=torch.int32)

    order = torch.argsort((~cand_ok).to(torch.int8), stable=True)       # accepted first
    dest = torch.argsort(state.active.to(torch.int8), stable=True)       # free slots first
    take = rank < n_added

    def scatter_rows(buf, rows):
        out = buf.clone()
        out[dest] = torch.where(take[:, None], rows, buf[dest])
        return out

    params = state.params
    new_params = GaussianParams(xyz=scatter_rows(params.xyz, cand_xy[order]),
                                cov2d=scatter_rows(params.cov2d, cand_cov[order]),
                                features=scatter_rows(params.features,
                                                      torch.zeros_like(params.features)))
    active = state.active.clone()
    active[dest] = take | state.active[dest]
    num_active = state.num_active + n_added
    bound = state.bound
    if cfg.slv:
        bound = scatter_rows(bound, _slv_rows(cfg, num_active, M, dev))
    new_slot_mask = torch.zeros((M,), dtype=torch.bool, device=dev)
    new_slot_mask[dest] = take
    return (GaussianState(params=new_params, active=active, bound=bound, num_active=num_active),
            n_added, new_slot_mask)
