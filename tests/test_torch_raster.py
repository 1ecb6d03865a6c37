"""Port rasterizers (plain PyTorch versions of kernels A and B, on the CPU)
against the JAX package's Pallas kernels in interpret mode.

Kernel A (``tile_table_forward``) is held against JAX ``rasterize_pallas``'s
forward (``_run_fwd``), ``rasterize_prepared`` and ``rasterize_prepared_flat``;
kernel B (``chunk_list_forward``) against ``rasterize_list_pallas`` and
``rasterize_list_t_pallas``. Scenes follow ``test_raster_pallas.make_scene``:
id order and Morton order, invalid rows, an odd tile grid. Tolerance atol
2e-5, rtol 1e-5: the JAX package's own cross-backend bound
(``tests/test_raster_list.py``); sums run in another order.

``assert_render_close`` also serves the full-width tests. There the
expanded quadratic ``sigma = w . phi`` cancels badly for thin Gaussians far
from the tile origin: one rounding of its largest term moves sigma by many
ulps, so any two float32 evaluations in different orders disagree there
(measured on kodim01: the JAX package's XLA and Pallas-interpret renders of
one stream differ by up to 1.6e-3 at ~1300 pixels). Such pixels may miss
atol, but only a few of them (``max_frac``), and each only by what the
rounding-error bound of the expanded form allows (``sigma_error_bound``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gaussianimage_plus_tpu.core import project_gaussians_2d_covariance as jax_project
from gaussianimage_plus_tpu.core.binning import bin_gaussians as jax_bin
from gaussianimage_plus_tpu.core.binning import morton_perm as jax_morton
from gaussianimage_plus_tpu.kernels.raster_flat_pallas import rasterize_prepared_flat as jax_flat
from gaussianimage_plus_tpu.kernels.raster_list_pallas import (
    rasterize_list_pallas as jax_list, rasterize_list_t_pallas as jax_list_t)
from gaussianimage_plus_tpu.kernels.raster_pallas import (
    prepare_raster as jax_prepare, rasterize_pallas as jax_rasterize_pallas,
    rasterize_prepared as jax_rasterize_prepared)

from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians, morton_perm
from gaussianimage_plus_tpu_torch.core.gaussian2d import project_gaussians_2d_covariance
from gaussianimage_plus_tpu_torch.kernels import raster_binned, raster_list

ATOL, RTOL = 2e-5, 1e-5
_U = 2.0 ** -24


def scene(n=60, H=48, W=80, seed=0, saturate=False, n_invalid=0):
    """``test_raster_pallas.make_scene`` as numpy; ``n_invalid`` rows get a
    non-invertible covariance (culled by projection)."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    a = rng.uniform(2.0, 60.0, n)
    c = rng.uniform(2.0, 60.0, n)
    b = rng.uniform(-0.8, 0.8, n) * np.sqrt(a * c)
    cov = np.stack([a, b, c], -1).astype(np.float32)
    cov[:n_invalid] = np.array([1.0, 2.0, 1.0], np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = (np.full((n,), 2.0) if saturate else np.ones((n,))).astype(np.float32)
    return xy, cov, colors, opacity, H, W


def both_projections(xy, cov, H, W, perm=None):
    """(JAX Projected, port Projected) of the same inputs, optionally
    reordered by ``perm``."""
    if perm is not None:
        xy, cov = xy[perm], cov[perm]
    pj = jax_project(jnp.asarray(xy), jnp.asarray(cov), H, W)
    pt = project_gaussians_2d_covariance(torch.as_tensor(xy), torch.as_tensor(cov), H, W)
    return pj, pt


def sigma_error_bound(xys, conics, colors, ids, mask, H, W, C=8.0, block_h=16, block_w=16):
    """[H, W, 1] bound on how far two float32 evaluations of the expanded
    blend can disagree at each pixel: per member, C ulps of the magnitude of
    the expanded quadratic's terms times d(alpha*rgb)/d(sigma), plus the
    whole contribution of a pair whose gates (sigma >= 0, alpha >= 1/255)
    lie inside that band (``gate_band``), on tiles of ``block_h`` x
    ``block_w`` pixels."""
    colors = np.asarray(colors, np.float64)
    ids, mask = np.asarray(ids), np.asarray(mask)
    tb_x, tb_y = -(-W // block_w), -(-H // block_h)
    E = np.zeros((ids.shape[0], block_h * block_w))
    for t in range(ids.shape[0]):
        k = ids[t][mask[t]]
        if k.size == 0:
            continue
        alpha, ds, a_hi, live, edge = gate_band(xys, conics, k, t, tb_x, C, block_h, block_w)
        e = np.where(live, alpha * ds, 0.0) + np.where(edge, a_hi, 0.0)
        E[t] = (np.abs(colors[k]).max(1)[:, None] * e).sum(0)
    img = E.reshape(tb_y, tb_x, block_h, block_w).transpose(0, 2, 1, 3)
    return img.reshape(tb_y * block_h, tb_x * block_w)[:H, :W, None]


def gate_band(xys, conics, k, t, tb_x, C=8.0, block_h=16, block_w=16):
    """Members ``k`` of tile ``t``, per (member, pixel), in float64: alpha,
    the rounding band ``ds`` of sigma (C ulps of the magnitude of the
    expanded quadratic's terms), alpha at the band's low edge, whether the
    pair contributes, and whether its gate lies inside the band (``edge``:
    two float32 evaluations may decide it differently)."""
    xys, conics = np.asarray(xys, np.float64), np.asarray(conics, np.float64)
    py, px = (a.astype(np.float64) for a in np.divmod(np.arange(block_h * block_w), block_w))
    ty, tx = divmod(t, tb_x)
    c1, c2, c3 = (conics[k, i][:, None] for i in range(3))
    lmx = xys[k, 0][:, None] - tx * block_w
    lmy = xys[k, 1][:, None] - ty * block_h
    dx, dy = lmx - px, lmy - py
    sig = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy
    mag = (0.5 * abs(c1) * px * px + 0.5 * abs(c3) * py * py + abs(c2) * px * py
           + (abs(c1 * lmx) + abs(c2 * lmy)) * px + (abs(c2 * lmx) + abs(c3 * lmy)) * py
           + 0.5 * abs(c1) * lmx * lmx + 0.5 * abs(c3) * lmy * lmy + abs(c2 * lmx * lmy))
    ds = C * _U * mag
    alpha = np.minimum(1.0, np.exp(-sig))
    a_hi = np.minimum(1.0, np.exp(-(sig - ds)))
    live = (sig >= 0) & (alpha >= 1 / 255)
    edge = (np.abs(sig) <= ds) | (np.abs(a_hi - 1 / 255) <= (a_hi - alpha) + 8 * _U)
    return alpha, ds, a_hi, live, edge


def assert_render_close(out, ref, bound=None, max_frac=0.0, what=""):
    """Every pixel within atol 2e-5 / rtol 1e-5, except at most ``max_frac``
    of the pixels, each of which must lie within the rounding bound."""
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    d = np.abs(out - ref)
    tol = ATOL + RTOL * np.abs(ref)
    bad = (d > tol).any(-1)
    frac = bad.mean()
    assert frac <= max_frac, (f"{what}: {bad.sum()} pixels ({frac:.3%}) outside "
                              f"atol {ATOL}, max diff {d.max():.3g}")
    if bad.any():
        assert bound is not None, what
        assert (d <= tol + 2 * bound)[bad].all(), f"{what}: beyond the rounding bound"


def _binned_case(seed, saturate=False, H=48, W=80, n=60, n_invalid=0, cap=64, morton=False):
    xy, cov, colors, opacity, H, W = scene(n=n, H=H, W=W, seed=seed, saturate=saturate,
                                           n_invalid=n_invalid)
    perm = None
    if morton:
        pj, _ = both_projections(xy, cov, H, W)
        perm = np.asarray(jax_morton(pj.xys, pj.valid, H, W))
        colors, opacity = colors[perm], opacity[perm]
    pj, pt = both_projections(xy, cov, H, W, perm)
    bj, bt = jax_bin(pj, H, W, cap=cap), bin_gaussians(pt, H, W, cap=cap)
    return pj, pt, bj, bt, colors, opacity, H, W


BINNED_CASES = {
    "id-order": dict(seed=0),
    "saturated": dict(seed=1, saturate=True),
    "invalid-rows": dict(seed=2, n_invalid=7),
    "morton": dict(seed=3, morton=True),
    "odd-grid": dict(seed=4, H=45, W=77, n=70),
    "overflow-cap8": dict(seed=5, n=120, cap=8),
}


@pytest.mark.parametrize("case", list(BINNED_CASES))
def test_binned_plain_matches_jax_kernels(case):
    pj, pt, bj, bt, colors, opacity, H, W = _binned_case(**BINNED_CASES[case])
    col_t, op_t = torch.as_tensor(colors), torch.as_tensor(opacity)
    out = raster_binned.rasterize_binned(pt.xys, pt.conics, col_t, op_t, bt.ids, bt.mask, pt.radii,
                                         H, W)
    ref = jax_rasterize_pallas(pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity),
                               bj.ids, bj.mask, pj.radii, H, W)
    assert_render_close(out, ref, what=f"rasterize_pallas {case}")
    # the bin-once pair: prepared tables, chunked and flat JAX kernels
    prep_j = jax_prepare(pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity),
                         bj.ids, bj.mask, H, W)
    prep_t = raster_binned.prepare_raster(pt.xys, pt.conics, col_t, op_t, bt.ids, bt.mask, H, W)
    np.testing.assert_array_equal(prep_t.counts.numpy(), np.asarray(prep_j.counts))
    # the rows the port's Prepared names through its slot ids are the JAX gathered table
    np.testing.assert_array_equal(raster_binned._gather(prep_t.table, prep_t.ids).numpy(),
                                  np.asarray(prep_j.raw))
    out_p = raster_binned.rasterize_prepared_flat(prep_t, H, W)
    assert_render_close(out_p, jax_rasterize_prepared(prep_j, H, W), what=f"prepared {case}")
    assert_render_close(out_p, jax_flat(prep_j, H, W), what=f"flat {case}")
    assert torch.equal(out_p, raster_binned.rasterize_prepared(prep_t, H, W))


def test_prepared_plain_on_a_ragged_grid_with_an_empty_and_a_full_tile():
    """Kernel A's plain version on its inputs (the [N+1, 16] table, the int32
    slot ids, the counts) against JAX ``rasterize_prepared`` on a 45x77 grid
    (ragged edge tiles) where the two right tile columns hold no member and
    tile 0 holds more Gaussians than its cap of 16."""
    rng = np.random.default_rng(7)
    n, H, W, cap = 90, 45, 77, 16
    xy = np.stack([rng.uniform(0, 40, n), rng.uniform(0, 28, n)], -1).astype(np.float32)
    xy[:30] = np.float32(8.5) + rng.uniform(-2, 2, (30, 2)).astype(np.float32)
    a, c = rng.uniform(1.0, 4.0, n), rng.uniform(1.0, 4.0, n)
    cov = np.stack([a, rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c), c], -1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 1.0, n).astype(np.float32)
    pj, pt = both_projections(xy, cov, H, W)
    bj, bt = jax_bin(pj, H, W, cap=cap), bin_gaussians(pt, H, W, cap=cap)
    counts = bt.count.reshape(3, 5)
    assert int(counts[:, 3:].max()) == 0 and int(counts[0, 0]) == cap
    assert int(bin_gaussians(pt, H, W, cap=128).count[0]) > cap        # tile 0 is clipped
    prep_j = jax_prepare(pj.xys, pj.conics, jnp.asarray(colors), jnp.asarray(opacity),
                         bj.ids, bj.mask, H, W)
    prep_t = raster_binned.prepare_raster(pt.xys, pt.conics, torch.as_tensor(colors),
                                          torch.as_tensor(opacity), bt.ids, bt.mask, H, W)
    assert prep_t.table.shape == (n + 1, 16) and prep_t.ids.dtype == torch.int32
    np.testing.assert_array_equal(raster_binned._gather(prep_t.table, prep_t.ids).numpy(),
                                  np.asarray(prep_j.raw))
    out = raster_binned.tile_table_forward(prep_t.table, prep_t.ids, prep_t.counts, H, W)
    assert torch.equal(out, raster_binned.tile_table_forward_plain(*prep_t, H, W))
    assert_render_close(out, jax_rasterize_prepared(prep_j, H, W), what="prepared ragged grid")
    # a slot id outside [0, N] reads the sentinel row: nothing
    bad = prep_t.ids.clone()
    bad[1, 0], bad[2, 0] = -5, n + 9
    assert not raster_binned._gather(prep_t.table, bad)[[1, 2], 0].any()


LIST_CASES = {
    "id-order-kc64": dict(seed=31, kc=64, t_layout=False),
    "id-order-kc128": dict(seed=39, kc=128, t_layout=True),
    "morton-kc64": dict(seed=32, kc=64, t_layout=False, morton=True),
    "morton-lmax1-kc128": dict(seed=33, kc=128, t_layout=True, morton=True, lmax=1),
    "residual-lmax1-kc16": dict(seed=34, kc=16, t_layout=False, lmax=1),
    "invalid-rows": dict(seed=35, kc=64, t_layout=False, n_invalid=9),
    "odd-grid": dict(seed=36, kc=128, t_layout=True, H=45, W=77),
}


@pytest.mark.parametrize("case", list(LIST_CASES))
def test_list_plain_matches_jax_kernels(case):
    kw = dict(LIST_CASES[case])
    kc, t_layout, lmax = kw.pop("kc"), kw.pop("t_layout"), kw.pop("lmax", None)
    morton = kw.pop("morton", False)
    xy, cov, colors, opacity, H, W = scene(n=150, **{"H": 48, "W": 80, **kw})
    perm = None
    if morton:
        pj, _ = both_projections(xy, cov, H, W)
        perm = np.asarray(jax_morton(pj.xys, pj.valid, H, W))
        colors, opacity = colors[perm], opacity[perm]
    pj, pt = both_projections(xy, cov, H, W, perm)
    jfn = jax_list_t if t_layout else jax_list
    ref = jfn(pj, jnp.asarray(colors), jnp.asarray(opacity), H, W, kc=kc, lmax=lmax)
    tfn = raster_list.rasterize_list_t if t_layout else raster_list.rasterize_list
    out = tfn(pt, torch.as_tensor(colors), torch.as_tensor(opacity), H, W, kc=kc, lmax=lmax)
    assert_render_close(out, ref, what=f"list {case}")


def test_capped_and_cap_free_agree_without_overflow():
    """Below the cap the binned and chunk-list forwards are one function."""
    xy, cov, colors, opacity, H, W = scene(n=150, seed=37)
    _, pt = both_projections(xy, cov, H, W)
    col_t, op_t = torch.as_tensor(colors), torch.as_tensor(opacity)
    bt = bin_gaussians(pt, H, W, cap=256)
    assert int(bt.count.max()) < 256
    a = raster_binned.rasterize_binned(pt.xys, pt.conics, col_t, op_t, bt.ids, bt.mask, pt.radii,
                                       H, W)
    b = raster_list.rasterize_list_t(pt, col_t, op_t, H, W)
    assert_render_close(a, b.numpy(), what="binned vs list")


DENSE_CASES = {
    "binned-cap256": dict(seed=40, tile_mask=True, tile_cap=256),
    "overflow-cap8": dict(seed=41, tile_mask=True, tile_cap=8, n=120),
    "no-mask": dict(seed=42, tile_mask=False, tile_cap=None),
    "odd-grid-banded": dict(seed=43, tile_mask=True, tile_cap=256, H=45, W=77, band_rows=16),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_render_dense_matches_jax(case):
    """The port's dense oracle against the JAX one (both in the direct form
    of the reference, so the same tolerance holds at every pixel)."""
    from gaussianimage_plus_tpu.core.render_dense import render_dense as jax_dense
    from gaussianimage_plus_tpu_torch.core.render_dense import render_dense

    kw = dict(DENSE_CASES[case])
    mask, cap, band = kw.pop("tile_mask"), kw.pop("tile_cap"), kw.pop("band_rows", None)
    xy, cov, colors, opacity, H, W = scene(**{"n": 60, **kw})
    pj, pt = both_projections(xy, cov, H, W)
    ref = jax_dense(pj, jnp.asarray(colors), jnp.asarray(opacity), H, W,
                    tile_mask=mask, tile_cap=cap)
    out = render_dense(pt, torch.as_tensor(colors), torch.as_tensor(opacity), H, W,
                       tile_mask=mask, tile_cap=cap, band_rows=band)
    assert_render_close(out, ref, what=f"dense {case}")


@pytest.mark.parametrize("H,W", [(48, 80), (45, 77)])
def test_tile_layout_helpers_match_jax(H, W):
    from gaussianimage_plus_tpu.core import render_tiled as jrt
    from gaussianimage_plus_tpu_torch.core import render_tiled as trt

    tb_x, tb_y = -(-W // 16), -(-H // 16)
    img = np.random.default_rng(H).uniform(size=(H, W, 3)).astype(np.float32)
    tiles = trt._image_to_tiles(torch.as_tensor(img), tb_x, tb_y, 16, 16)
    np.testing.assert_array_equal(tiles.numpy(),
                                  np.asarray(jrt._image_to_tiles(jnp.asarray(img), tb_x, tb_y, 16, 16)))
    back = trt._tiles_to_image(tiles, H, W, tb_x, tb_y, 16, 16)
    np.testing.assert_array_equal(back.numpy(), img)


def test_wrappers_validate_inputs():
    table = torch.zeros((11, 16))
    with pytest.raises(ValueError):   # 14 tiles for a 15-tile grid
        raster_binned.tile_table_forward(table, torch.zeros((14, 8), dtype=torch.int32),
                                         torch.zeros(14, dtype=torch.int32), 48, 80)
    with pytest.raises(ValueError):   # not an [N+1, 16] table
        raster_binned.tile_table_forward(torch.zeros((15, 8, 16)),
                                         torch.zeros((15, 8), dtype=torch.int32),
                                         torch.zeros(15, dtype=torch.int32), 48, 80)
    with pytest.raises(TypeError):
        raster_binned.tile_table_forward(table, torch.zeros((15, 8), dtype=torch.int32),
                                         torch.zeros(15), 48, 77)
    with pytest.raises(TypeError):    # int64 slot ids
        raster_binned.tile_table_forward(table, torch.zeros((15, 8), dtype=torch.int64),
                                         torch.zeros(15, dtype=torch.int32), 48, 77)
    with pytest.raises(ValueError):   # a bbox table of another N
        raster_binned.tile_table_backward(table, torch.zeros(15, dtype=torch.int32),
                                          torch.zeros((15, 8), dtype=torch.int32),
                                          torch.zeros((12, 4), dtype=torch.int32),
                                          torch.zeros((48, 80, 3)))
    t = torch.zeros((128, 16))
    i = torch.zeros(15, dtype=torch.int32)
    with pytest.raises(ValueError):
        raster_list.chunk_list_forward(t, torch.zeros((128, 4)), i[:, None], i, i, i, 100, 48, 80)
