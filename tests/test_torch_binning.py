"""Port selection plumbing against the JAX package: ``bin_gaussians``
(``top_k``, ``scatter`` and ``rank``, with an overflowing tile at a small cap),
``morton_perm``, the chunk-list lists (``_table_bbox``/``_chunk_lists``,
also at ``lmax=1`` where the residual interval is live), and the row-range
binners of the tile-sharded render (``bin_gaussian_rows`` flat and hier,
``super_overflow`` included, at several ``tile_start`` on a 32x64 and an odd
30x52 grid, also equal to the full bins' rows) and ``gather_tile_attrs``.
Integer outputs must be exactly equal, on random scenes and on every
committed fitted state.
"""

import functools
import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.core import binning as jb
from gaussianimage_plus_tpu.kernels import raster_list_pallas as jrl
from gaussianimage_plus_tpu.models import gaussian_image as jgi

from gaussianimage_plus_tpu_torch.core import binning as tb
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
from gaussianimage_plus_tpu_torch.kernels import raster_list as trl
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi

from test_torch_raster import both_projections, scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 48 fitted 768x512 states (repr_states_2k holds the 2040x1344 one)
STATES = sorted(p for d in ("repr_states_cn", "repr_states_plain")
                for p in glob.glob(os.path.join(ROOT, "results", d, "*.npz")))


def _eq(a_torch, a_jax, what):
    np.testing.assert_array_equal(a_torch.numpy(), np.asarray(a_jax), err_msg=what)


def assert_bins_equal(bt, bj, what=""):
    for k in ("ids", "mask", "count"):
        _eq(getattr(bt, k), getattr(bj, k), f"{what} {k}")


@functools.partial(jax.jit, static_argnames=("H", "W", "cap", "method"))
def _jax_bins(proj, H, W, cap, method):
    return jb.bin_gaussians(proj, H, W, cap=cap, method=method)


@functools.partial(jax.jit, static_argnames=("H", "W", "kc", "lmax"))
def _jax_lists(proj, colors, opacity, H, W, kc, lmax):
    table, bbox, member, _, _, _, N, Np = jrl._table_bbox(proj, colors, opacity, H, W, 16, 16, kc)
    return (table, bbox) + tuple(jrl._chunk_lists(member, N, Np, kc, lmax))


_jax_morton = jax.jit(jb.morton_perm, static_argnames=("H", "W"))


def assert_lists_equal(pj, pt, colors, H, W, kc, lmax, what=""):
    ones_j = jnp.ones((colors.shape[0],), jnp.float32)
    out_j = _jax_lists(pj, jnp.asarray(colors), ones_j, H, W, kc, lmax)
    table, bbox, lst, cnt, lo2, hi2 = trl.list_inputs(
        pt, torch.as_tensor(colors), torch.ones(colors.shape[0]), H, W, kc, lmax)
    np.testing.assert_allclose(table.numpy(), np.asarray(out_j[0]), rtol=1e-6, err_msg=what)
    for name, a, b in zip(("bbox", "lst", "cnt", "lo2", "hi2"),
                          (bbox, lst, cnt, lo2, hi2), out_j[1:]):
        _eq(a, b, f"{what} {name}")
    return cnt, hi2


@pytest.mark.parametrize("method", ["top_k", "scatter", "rank"])
@pytest.mark.parametrize("cap", [64, 8, 1])
def test_bin_gaussians_scene(method, cap):
    xy, cov, colors, opacity, H, W = scene(n=120, seed=11, n_invalid=5)
    xy[:30] = 12.0            # one crowded tile: overflows small caps
    pj, pt = both_projections(xy, cov, H, W)
    bj = jb.bin_gaussians(pj, H, W, cap=cap, method=method)
    bt = tb.bin_gaussians(pt, H, W, cap=cap, method=method)
    assert_bins_equal(bt, bj, f"{method} cap {cap}")
    if cap <= 8:
        assert int(torch.clamp(pt.num_tiles_hit, max=1).sum()) > cap  # overflow exercised
        assert int(bt.count.max()) == cap


def test_every_bin_method_gives_the_top_k_bins():
    """``'hier'``, ``'pallas'`` and ``'rank'`` were refused before they were
    ported; now they bin, and give the ``'top_k'`` bins (``'hier'`` where no
    super-tile overflows)."""
    xy, cov, *_ , H, W = scene(n=10, seed=1)
    _, pt = both_projections(xy, cov, H, W)
    ref = tb.bin_gaussians(pt, H, W)
    for method in ("hier", "pallas", "rank"):
        assert_bins_equal(tb.bin_gaussians(pt, H, W, method=method), ref, method)
    assert int(tb.bin_gaussians(pt, H, W, method="hier").super_overflow) == 0
    with pytest.raises(ValueError, match="unknown binning method"):
        tb.bin_gaussians(pt, H, W, method="sort")


@pytest.mark.parametrize("seed", [0, 1])
def test_morton_perm_scene(seed):
    xy, cov, colors, opacity, H, W = scene(n=200, seed=seed, n_invalid=11, H=45, W=77)
    xy[5] = [-30.0, 900.0]       # clamps to the grid edge
    pj, pt = both_projections(xy, cov, H, W)
    _eq(tb.morton_perm(pt.xys, pt.valid, H, W), jb.morton_perm(pj.xys, pj.valid, H, W), "perm")


@pytest.mark.parametrize("kc,lmax", [(64, 16), (128, 16), (16, 1), (64, 1)])
def test_chunk_lists_scene(kc, lmax):
    xy, cov, colors, opacity, H, W = scene(n=150, seed=33, n_invalid=4)
    pj, pt = both_projections(xy, cov, H, W)
    cnt, hi2 = assert_lists_equal(pj, pt, colors, H, W, kc, lmax, f"kc {kc} lmax {lmax}")
    if lmax == 1 and kc == 16:
        assert int(hi2.max()) > 0        # the residual interval is live


@pytest.mark.parametrize("path", STATES, ids=[os.path.basename(os.path.dirname(p))[12:] + "-"
                                               + os.path.basename(p)[:-4] for p in STATES])
def test_selection_committed_state(path):
    """Binning, Morton order and list_t chunk lists of a fitted state at
    full width (768x512, 5000 slots) equal the JAX ones."""
    d = dict(np.load(path))
    cfg_t = config_from_numpy(d)
    H, W = cfg_t.H, cfg_t.W
    st = state_from_numpy(d, device="cpu")
    params_j = jgi.GaussianParams(xyz=jnp.asarray(d["xyz"]), cov2d=jnp.asarray(d["cov2d"]),
                                  features=jnp.asarray(d["features"]))
    cfg_j = jgi.GaussianConfig(H=H, W=W, max_num_points=cfg_t.max_num_points,
                               color_norm=cfg_t.color_norm)
    # eager, as decode runs it: under jit XLA fuses multiply-adds, which moves
    # the conics of near-singular covariances by a few ulps
    pj = jgi.project(params_j, jnp.asarray(d["active"]), jnp.asarray(d["bound"]), cfg_j)
    perm_j = _jax_morton(pj.xys, pj.valid, H=H, W=W)
    pt = tgi.project(st.params, st.active, st.bound, cfg_t)
    assert_bins_equal(tb.bin_gaussians(pt, H, W, cap=256), _jax_bins(pj, H, W, 256, "scatter"),
                      "top_k vs JAX scatter, cap 256")
    _eq(tb.morton_perm(pt.xys, pt.valid, H, W), perm_j, "perm")
    colors = tgi.colors_of(st.params, cfg_t).numpy()
    assert_lists_equal(pj, pt, colors, H, W, trl.KC_T, trl.LMAX, "list_t lists")


RANK_STATES = STATES[::12]


@pytest.mark.parametrize("path", RANK_STATES, ids=[os.path.basename(os.path.dirname(p))[12:] + "-"
                                                    + os.path.basename(p)[:-4] for p in RANK_STATES])
def test_rank_bins_committed_state(path):
    """``'rank'`` bins of a fitted 768x512 state at cap 256 equal the JAX
    ``'rank'`` bins and the port's ``'top_k'`` bins."""
    d = dict(np.load(path))
    cfg_t = config_from_numpy(d)
    H, W = cfg_t.H, cfg_t.W
    st = state_from_numpy(d, device="cpu")
    params_j = jgi.GaussianParams(xyz=jnp.asarray(d["xyz"]), cov2d=jnp.asarray(d["cov2d"]),
                                  features=jnp.asarray(d["features"]))
    cfg_j = jgi.GaussianConfig(H=H, W=W, max_num_points=cfg_t.max_num_points,
                               color_norm=cfg_t.color_norm)
    pj = jgi.project(params_j, jnp.asarray(d["active"]), jnp.asarray(d["bound"]), cfg_j)
    pt = tgi.project(st.params, st.active, st.bound, cfg_t)
    rank = tb.bin_gaussians(pt, H, W, cap=256, method="rank")
    assert_bins_equal(rank, _jax_bins(pj, H, W, 256, "rank"), "rank vs JAX rank, cap 256")
    top_k = tb.bin_gaussians(pt, H, W, cap=256, method="top_k")
    for k in ("ids", "mask", "count"):
        assert torch.equal(getattr(rank, k), getattr(top_k, k)), f"rank vs top_k {k}"
    assert int(rank.count.sum()) > 0


_jax_rows = jax.jit(jb.bin_gaussian_rows, static_argnames=("H", "W", "n_tiles", "cap", "method"))
_jax_rows_hier = jax.jit(jb.bin_gaussian_rows_hier,
                         static_argnames=("H", "W", "n_tiles", "cap", "super_cap"))


@pytest.mark.parametrize("H,W", [(32, 64), (30, 52)])
@pytest.mark.parametrize("method", ["top_k", "scatter", "rank"])
def test_bin_gaussian_rows_scene(H, W, method):
    """Each flat row range, the grid's end and past it included, equals the
    JAX rows and the port's full bins sliced."""
    xy, cov, *_ = scene(n=64, seed=21, n_invalid=3, H=H, W=W)
    xy[:20] = 9.0                 # a crowded tile: over the cap of 8
    pj, pt = both_projections(xy, cov, H, W)
    full = tb.bin_gaussians(pt, H, W, cap=8, method=method)
    T = full.ids.shape[0]
    for start, n in ((0, 3), (2, 4), (5, 3), (T - 2, 4), (T, 2)):
        bj = _jax_rows(pj, H=H, W=W, tile_start=start, n_tiles=n, cap=8, method=method)
        bt = tb.bin_gaussian_rows(pt, H, W, start, n, cap=8, method=method)
        assert_bins_equal(bt, bj, f"rows {start}+{n}")
        m = max(0, min(n, T - start))
        for k in ("ids", "mask", "count"):
            assert torch.equal(getattr(bt, k)[:m], getattr(full, k)[start:start + m]), k
        assert not bool(bt.mask[m:].any())


@pytest.mark.parametrize("H,W", [(32, 64), (30, 52)])
@pytest.mark.parametrize("super_cap", [0, 12])
def test_bin_gaussian_rows_hier_scene(H, W, super_cap):
    """The two-level row binner against JAX (ids, mask, count and
    ``super_overflow``), with its default band budget and one small enough
    to overflow; without overflow it equals the flat rows."""
    xy, cov, *_ = scene(n=96, seed=22, n_invalid=4, H=H, W=W)
    pj, pt = both_projections(xy, cov, H, W)
    T = -(-W // 16) * -(-H // 16)
    overflowed = 0
    for start, n in ((0, 4), (3, 5), (T - 3, 4)):
        bj = _jax_rows_hier(pj, H=H, W=W, tile_start=start, n_tiles=n, cap=16,
                            super_cap=super_cap)
        bt = tb.bin_gaussian_rows_hier(pt, H, W, start, n, cap=16, super_cap=super_cap)
        assert_bins_equal(bt, bj, f"hier rows {start}+{n}")
        _eq(bt.super_overflow, bj.super_overflow, "super_overflow")
        overflowed += int(bt.super_overflow)
        if int(bt.super_overflow) == 0:
            assert_bins_equal(bt, _jax_rows(pj, H=H, W=W, tile_start=start, n_tiles=n, cap=16,
                                            method="top_k"), "vs flat")
    assert (overflowed > 0) == (super_cap > 0)


def test_gather_tile_attrs():
    xy, cov, colors, *_, H, W = scene(n=40, seed=23)
    pj, pt = both_projections(xy, cov, H, W)
    bj = _jax_bins(pj, H, W, 16, "top_k")
    bt = tb.bin_gaussians(pt, H, W, cap=16)
    out_j = jb.gather_tile_attrs(bj, pj.xys, jnp.asarray(colors))
    out_t = tb.gather_tile_attrs(bt, pt.xys, torch.as_tensor(colors))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# occupancy maxima at every edge of the JAX function's top_k tiers (64, 128,
# min(cap, N)) and past the cap (256), over N = 400 rows and N = 100 < cap
TIER_EDGES = [(m, 400) for m in (0, 1, 64, 65, 128, 129, 256, 300)] + [
    (m, 100) for m in (0, 1, 64, 65, 100)]


@pytest.mark.parametrize("fullest,N", TIER_EDGES, ids=[f"max{m}-N{n}" for m, n in TIER_EDGES])
def test_select_members_at_every_tier_edge(fullest, N):
    """The sync-free selections (``'top_k'``, ``'rank'``, ``'scatter'``) equal
    the JAX ``_select_members(..., 'top_k')`` (ids, mask, count) when the
    fullest row holds ``fullest`` members, whichever tier JAX picks."""
    rng = np.random.default_rng(fullest * 1000 + N)
    T, cap = 9, 256
    member = np.zeros((T, N), bool)
    for t in range(T):
        k = fullest if t < 2 else int(rng.integers(0, fullest + 1))
        member[t, rng.choice(N, size=k, replace=False)] = True
    bj = jb._select_members(jnp.asarray(member), cap, "top_k")
    assert int(np.asarray(bj.count).max()) == min(fullest, cap)
    for method in ("top_k", "rank", "scatter"):
        assert_bins_equal(tb.select_members(torch.as_tensor(member), cap, method), bj,
                          f"{method}, fullest row {fullest}, N {N}")


@pytest.mark.parametrize("super_cap", [0, 12], ids=["no-overflow", "overflow"])
@pytest.mark.parametrize("H,W", [(96, 160), (90, 150)])
def test_bin_hier_scene(H, W, super_cap):
    """The two-level ``'hier'`` binner (super-tiles of 2x2 tiles) against the
    JAX ``_bin_hier``: ids, mask, count and ``super_overflow``, with its
    default budget (equal to the flat ``'top_k'`` bins then) and with one
    that drops candidates."""
    xy, cov, *_ = scene(n=160, seed=31, n_invalid=6, H=H, W=W)
    xy[:40] = 20.0            # a crowded super-tile
    pj, pt = both_projections(xy, cov, H, W)
    bj = jb.bin_gaussians(pj, H, W, cap=32, method="hier", super_size=2, super_cap=super_cap)
    bt = tb.bin_gaussians(pt, H, W, cap=32, method="hier", super_size=2, super_cap=super_cap)
    assert_bins_equal(bt, bj, f"hier super_cap {super_cap}")
    _eq(bt.super_overflow, bj.super_overflow, "super_overflow")
    assert (int(bt.super_overflow) > 0) == (super_cap > 0)
    if super_cap == 0:
        assert_bins_equal(tb.bin_gaussians(pt, H, W, cap=32), bj, "hier against flat")
