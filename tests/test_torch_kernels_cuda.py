"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Kernel A (``tile_table_forward``), kernel B (``chunk_list_forward``),
kernel C (``chunk_backward``), kernel D (``tile_table_backward``) and kernel
E (``tile_bin``) on synthetic scenes made with numpy from a seed: a small odd
tile grid, a crowded tile that overflows a small cap, and a Kodak-size
768x512 scene. Kernel F (``chunk_lists``, the chunk-list enumeration) on the
committed Kodak and 2K states, ``fit_image``'s initial rows, crowded tiles
past the list width and float bboxes no projection makes: its lists
``torch.equal`` to the plain enumeration's; captured in a CUDA graph and
replayed on other rows; and a 300-step 2K fit bit-equal with the plain
enumeration patched in.
Every test is marked ``cuda`` and skips without a card. This file imports no
JAX, so it also runs on a machine with PyTorch alone::

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Kernel A must equal its plain version, run on the card, bit for bit: both
evaluate sigma in the same fused-multiply-add order and sum each pixel's rows
in slot order. Kernel B: atol 2e-5, rtol 1e-5 at every pixel but at most
0.01% of them (the plain version is run on the CPU, whose ``exp`` may round
across the sigma >= 0 or alpha >= 1/255 gate). Kernel C: per payload column, max
|kernel - plain| <= 1e-4 max |plain| (the gate is bit-equal; the sums over
pixels and tiles run in another order), and two launches give the same bits.
Kernel D: the same, per column of its [N, 9] output. Kernel E: ids and counts
equal the plain version's exactly. Kernels B and C also run on a 2040x1344
grid, the card's default 2K training path.

The trainer's CUDA graphs: a graphed ``fit_image`` (each chunk a replay of
one captured chunk) and a graphed ``train_macro_chunk`` equal the eager
``train_chunk`` loop bit for bit at 768x512, with equal launch counts;
``quant_train_macro_chunk`` equals successive ``quant_train_chunk`` calls;
every route that renders through a kernel (``train.trainer.captures``:
``'pallas'`` with each binner, the odd tile grid's ``'auto'`` among them, the
chunk lists, ``'dense'`` and ``'sweep'``) runs a chunk, and a QAT chunk, under
``torch.cuda.set_sync_debug_mode("error")``; on the odd grid a graphed fit
and QAT chunk, and a graphed ``fit_batch`` of two images, equal their eager
runs; a step that reads a value on the host makes the capture raise.

The binned decode's graphs (``compress.pipeline.decompress_wo_ec``): on the
50 committed streams the first call and a replay each equal the eager
binned decode (``'top_k'`` selection) bit for bit, a second pass captures
nothing and replays 50 times, a replay adds one launch each to kernels A and
E; two images of one graph held at once keep their own pixels; a replay
never synchronises with the host; an input that requires grad decodes
eagerly; and the benchmark's decode faults (``portbench/control.py``) fail
``rms_gap`` through the replays.

Kernel A reads its tile's rows of the attribute table through the slot
ids, 128 at a time, and gives a thread 2 pixels of one column; besides the
shared scenes it runs on the binned fit state's shape (a tile of ~150 live
slots among tiles of ~13), a tile at cap 256 and a 2040x1344 grid.
Kernel B stages each tile's members into a shared list of 512 and blends it
whenever the next batch of 256 visited rows might not fit. Kernel C gives a
block 8 table rows and each of its warps an equal share of their (row, bbox
tile) pairs, and adds the warps' sums per row in shared memory in warp order.
Kernel D numbers the live (tile, slot) pairs with a scan (stage 0), gives
every live slot 8 threads on a persistent grid of 32 slots a block (stage 1,
so one tile's slots may spread over several blocks), and sums each
Gaussian's payload with one warp whose lanes search its bbox tiles (stage 2).
Kernel E gives a block a window of one tile row, filters the bbox table
batch by batch down to the ids over that window, and lets each tile's warp
pick its members from that list. The cases below drive those paths: a tile
with 600 members (several blends of B's list), members reached only through
the residual interval, every chunk enumeration, a Gaussian whose bbox covers
the whole grid (C splits it over a block's warps, beside thousands of small
rows; D's stage 2 lanes loop), tiles over their cap (a bbox tile lacks the
slot; E stops early), a tile of 300 live slots (spread over ten blocks),
invalid rows, ragged edge tiles, tables not a multiple of E's batch or of 32
rows and larger than one batch, a big grid where E's warps own 4 tiles, and
two launches against each other.
"""

import dataclasses
import functools
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.core.gaussian2d import project_gaussians_2d_covariance
from gaussianimage_plus_tpu_torch.kernels import (binning_tiles, raster_binned, raster_dense,
                                                  raster_list)

ATOL, RTOL, MAX_FRAC = 2e-5, 1e-5, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(n, H, W, seed, crowd=0, spread=0.0, n_invalid=0, n_huge=0, cov_max=60.0):
    """``crowd`` centres at (12, 12) (spread uniformly over +- ``spread``),
    the last ``n_invalid`` rows with a non-invertible covariance (culled by
    the projection), the next ``n_huge`` with a bbox over the whole grid;
    variances drawn from [2, ``cov_max``]."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    xy[:crowd] = 12.0
    if spread:
        xy[:crowd] += rng.uniform(-spread, spread, (crowd, 2)).astype(np.float32)
    a, c = rng.uniform(2.0, cov_max, n), rng.uniform(2.0, cov_max, n)
    b = rng.uniform(-0.8, 0.8, n) * np.sqrt(a * c)
    cov = np.stack([a, b, c], -1).astype(np.float32)
    if n_invalid:
        cov[n - n_invalid:] = np.array([1.0, 2.0, 1.0], np.float32)
    if n_huge:
        big = max(4e4, 4.0 * max(H, W) ** 2)
        cov[n - n_invalid - n_huge:n - n_invalid] = np.array([big, 0.0, big], np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    proj = project_gaussians_2d_covariance(torch.as_tensor(xy), torch.as_tensor(cov), H, W)
    return proj, torch.as_tensor(colors), torch.ones(n)


def _close(out, ref, what):
    torch.cuda.synchronize()
    out = out.cpu()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all()), what
    bad = ((out - ref).abs() > ATOL + RTOL * ref.abs()).any(-1)
    assert float(bad.float().mean()) <= MAX_FRAC, f"{what}: {int(bad.sum())} pixels off"


SCENES = {
    "odd-grid": dict(n=150, H=45, W=77, seed=0, cap=64),
    "overflow-cap8": dict(n=200, H=48, W=80, seed=1, cap=8, crowd=40),
    "kodak-size": dict(n=5000, H=512, W=768, seed=2, cap=256),
}

# kernels B and C besides: a 2040x1344 grid (128 x 84 tiles), where 'auto'
# resolves to list_t, so a 2K fit trains through B and C by default
BC_SCENES = {**SCENES, "2K-size": dict(n=20000, H=1344, W=2040, seed=23, cap=256, cov_max=12.0)}


# kernel A besides: the binned fit state's shape (small Gaussians, ~13 live
# slots a tile, one tile of ~150), one tile at cap 256, and a 2040x1344 grid
A_SCENES = {
    **SCENES,
    "fit-state shape": dict(n=4800, H=512, W=768, seed=20, cap=256, crowd=150, spread=7.5,
                            cov_max=12.0),
    "a tile at cap 256": dict(n=600, H=48, W=80, seed=21, cap=256, crowd=400, spread=3.5),
    "2K-size grid": dict(n=20000, H=1344, W=2040, seed=22, cap=256, cov_max=12.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(A_SCENES))
def test_tile_table_forward_matches_plain(card, case):
    """Bit-equal to the plain version on the card: the same sigma chain and
    each pixel's sums in slot order."""
    kw = dict(A_SCENES[case])
    cap = kw.pop("cap")
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    bins = bin_gaussians(proj, H, W, cap=cap)
    table, ids, counts = (a.to(card) for a in raster_binned._slot_table(
        proj.xys, proj.conics, colors, opacity, bins.ids, bins.mask))
    if case == "a tile at cap 256":
        assert int(counts.max()) == 256 == ids.shape[1]
        assert int(bin_gaussians(proj, H, W, cap=1024).count.max()) > 256
    ref = raster_binned.tile_table_forward_plain(table, ids, counts, H, W)
    before = raster_binned.tile_table_forward.launches
    out = raster_binned.tile_table_forward(table, ids, counts, H, W)
    assert raster_binned.tile_table_forward.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, ref), (f"kernel A {case}: max |kernel - plain| "
                                   f"{float((out - ref).abs().max()):.3g}")


@pytest.mark.cuda
@pytest.mark.parametrize("kc,lmax", [(128, 16), (64, 16), (64, 1)])
@pytest.mark.parametrize("case", ["odd-grid", "kodak-size", "2K-size"])
def test_chunk_list_forward_matches_plain(card, case, kc, lmax):
    kw = dict(BC_SCENES[case])
    kw.pop("cap")
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    inputs = raster_list.list_inputs(proj, colors, opacity, H, W, kc, lmax)
    ref = raster_list.chunk_list_forward_plain(*inputs, kc, H, W)
    before = raster_list.chunk_list_forward.launches
    out = raster_list.chunk_list_forward(*(a.to(card) for a in inputs), kc, H, W)
    assert raster_list.chunk_list_forward.launches == before + 1
    _close(out, ref, f"kernel B {case} kc {kc} lmax {lmax}")


@pytest.mark.cuda
def test_wrappers_refuse_bad_card_inputs(card):
    table = torch.zeros((11, 16), device=card)
    ids = torch.zeros((15, 8), dtype=torch.int32, device=card)
    counts = torch.zeros(15, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):        # on two devices
        raster_binned.tile_table_forward(table, ids, counts.cpu(), 48, 80)
    with pytest.raises(ValueError):        # not contiguous
        raster_binned.tile_table_forward(table, ids.t().contiguous().t(), counts, 48, 80)
    with pytest.raises(TypeError):
        raster_binned.tile_table_forward(table.double(), ids, counts, 48, 80)


def _payload_close(out, ref, what):
    torch.cuda.synchronize()
    out = out.cpu()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all()), what
    assert not out[:, 9:].any(), f"{what}: padding columns not zero"
    assert ref[:, :9].abs().amax(0).min() > 0, f"{what}: a payload column is all zero"
    for j in range(9):
        err = float((out[:, j] - ref[:, j]).abs().max())
        assert err <= 1e-4 * float(ref[:, j].abs().max()), f"{what}: column {j} off by {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [128, 64])
@pytest.mark.parametrize("case", ["odd-grid", "kodak-size", "2K-size"])
def test_chunk_backward_matches_plain(card, case, kc):
    kw = dict(BC_SCENES[case])
    kw.pop("cap")
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    table, bbox, _, _ = raster_list._table_bbox(proj, colors, opacity, H, W, kc)
    v_img = torch.as_tensor(np.random.default_rng(kc).normal(size=(H, W, 3)).astype(np.float32))
    ref = raster_list.chunk_backward_plain(table, bbox, v_img)
    before = raster_list.chunk_backward.launches
    out = raster_list.chunk_backward(table.to(card), bbox.to(card), v_img.to(card))
    assert raster_list.chunk_backward.launches == before + 1
    _payload_close(out, ref, f"kernel C {case} kc {kc}")


@pytest.mark.cuda
def test_chunk_backward_is_deterministic(card):
    kw = dict(SCENES["kodak-size"])
    kw.pop("cap")
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    table, bbox, _, _ = raster_list._table_bbox(proj, colors, opacity, H, W, 128)
    v_img = torch.as_tensor(np.random.default_rng(9).normal(size=(H, W, 3)).astype(np.float32))
    args = (table.to(card), bbox.to(card), v_img.to(card))
    first = raster_list.chunk_backward(*args)
    second = raster_list.chunk_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _binned_inputs(case, dev):
    kw = dict(SCENES[case])
    cap = kw.pop("cap")
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    bins = bin_gaussians(proj, H, W, cap=cap)
    N = proj.xys.shape[0]
    table, ids, counts = raster_binned._slot_table(proj.xys, proj.conics, colors, opacity,
                                                   bins.ids, bins.mask)
    tb = (-(-W // 16), -(-H // 16))
    bbox = raster_binned.tile_bbox_table(proj.xys, proj.radii, tb)
    v_img = torch.as_tensor(np.random.default_rng(N).normal(size=(H, W, 3)).astype(np.float32))
    return [a.contiguous().to(dev) for a in (table, counts, ids, bbox, v_img)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SCENES))
def test_tile_table_backward_matches_plain(card, case):
    args = _binned_inputs(case, card)
    ref = raster_binned.tile_table_backward_plain(*(a.cpu() for a in args))
    before = raster_binned.tile_table_backward.launches
    out = raster_binned.tile_table_backward(*args)
    again = raster_binned.tile_table_backward(*args)
    assert raster_binned.tile_table_backward.launches == before + 2
    _payload_close(out, ref, f"kernel D {case}")
    assert torch.equal(out, again), f"kernel D {case}: two launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SCENES))
def test_tile_bin_matches_plain(card, case):
    kw = dict(SCENES[case])
    cap = kw.pop("cap")
    proj, _, _ = _scene(**kw)
    H, W = kw["H"], kw["W"]
    tb_x, tb_y = -(-W // 16), -(-H // 16)
    bbox = binning_tiles.tile_bbox_table(proj.xys, proj.radii, (tb_x, tb_y), proj.valid)
    ref_ids, ref_count = binning_tiles.tile_bin_plain(bbox, tb_x, tb_y, cap)
    before = binning_tiles.tile_bin.launches
    ids, count = binning_tiles.tile_bin(bbox.to(card), tb_x, tb_y, cap)
    assert binning_tiles.tile_bin.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(ids.cpu(), ref_ids) and torch.equal(count.cpu(), ref_count), case


ENUMERATIONS = {
    "list kc 64": (raster_list.KC, raster_list.member_lists),
    "list_t kc 128": (raster_list.KC_T, raster_list.member_lists),
    "dense": (raster_dense.DENSE_KC, raster_dense.dense_lists),
    "sweep": (raster_dense.SWEEP_KC, raster_dense.sweep_lists),
    "range": (raster_dense.SWEEP_KC, raster_dense.range_lists),
}
# 600 Gaussians over the tile at (0, 0) of a 64x96 grid, among 200 others:
# more members than kernel B's shared list holds
CROWDED = dict(n=800, H=64, W=96, seed=11, crowd=600, spread=3.5)


def _forward_both(card, kw, kc, lists):
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    table, bbox, N, Np = raster_list._table_bbox(proj, colors, opacity, H, W, kc)
    inputs = (table, bbox) + tuple(lists(table, bbox, N, Np, kc, H, W))
    ref = raster_list.chunk_list_forward_plain(*inputs, kc, H, W)
    on_card = [a.to(card) for a in inputs]
    before = raster_list.chunk_list_forward.launches
    out = raster_list.chunk_list_forward(*on_card, kc, H, W)
    again = raster_list.chunk_list_forward(*on_card, kc, H, W)
    assert raster_list.chunk_list_forward.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(out, again), "kernel B: two launches differ"
    return inputs, out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("enum", list(ENUMERATIONS))
def test_chunk_list_forward_crowded_tile(card, enum):
    kc, lists = ENUMERATIONS[enum]
    inputs, out, ref = _forward_both(card, CROWDED, kc, lists)
    table, bbox = inputs[:2]
    members = raster_list._bbox_members(table, bbox, 6, 24).sum(dim=1)
    assert int(members.max()) >= 600, int(members.max())
    _close(out, ref, f"kernel B crowded tile, {enum}")


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [64, 128])
def test_chunk_list_forward_residual_interval_only(card, kc):
    """lmax 1: every member chunk but a tile's first is reached only through
    the residual interval [lo2, hi2)."""
    lists = functools.partial(raster_list.member_lists, lmax=1)
    inputs, out, ref = _forward_both(card, CROWDED, kc, lists)
    _, _, lst, cnt, lo2, hi2 = inputs
    assert int((hi2 - lo2).max()) >= 3 and int(cnt.max()) == 1
    _close(out, ref, f"kernel B residual interval kc {kc}")


@pytest.mark.cuda
@pytest.mark.parametrize("enum", list(ENUMERATIONS))
def test_chunk_list_forward_every_enumeration(card, enum):
    kc, lists = ENUMERATIONS[enum]
    kw = dict(SCENES["kodak-size"])
    kw.pop("cap")
    _, out, ref = _forward_both(card, kw, kc, lists)
    _close(out, ref, f"kernel B kodak-size, {enum}")


def _state_rows(state, H, W, kc, morton=True):
    """The table and bbox that a training step's enumeration reads for a
    ``GaussianState`` (rows in Morton order, as the trainer keeps them)."""
    from gaussianimage_plus_tpu_torch.core.binning import morton_perm
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi

    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=state.active.shape[0])
    if morton:
        perm = morton_perm(state.params.xyz, state.active, H, W)
        state = gi.GaussianState(gi.GaussianParams(*(p[perm] for p in state.params)),
                                 state.active[perm], state.bound[perm], state.num_active)
    proj = gi.project(state.params, state.active, state.bound, cfg)
    ones = torch.ones_like(state.params.xyz[:, :1])
    return raster_list._table_bbox(proj, state.params.features, ones, H, W, kc)


def _npz_rows(card, name, kc):
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi

    d = np.load(ROOT / "results" / name)
    t = {k: torch.as_tensor(d[k]).to(card) for k in ("xyz", "cov2d", "features", "active",
                                                      "bound", "num_active")}
    state = gi.GaussianState(gi.GaussianParams(t["xyz"], t["cov2d"], t["features"]),
                             t["active"], t["bound"], t["num_active"])
    H, W = int(d["H"]), int(d["W"])
    table, bbox, _, Np = _state_rows(state, H, W, kc)
    return table, bbox, Np, kc, raster_list._default_lmax(H, W), H, W


def _initial_rows(card, H, W, n, M, seed):
    """``fit_image``'s random initial rows, in the order they are drawn."""
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=M)
    ts = tr.init_train_state(cfg, tr.TrainConfig(), n, seed=seed, device=card)
    table, bbox, _, Np = _state_rows(ts.gaussians, H, W, 128, morton=False)
    return table, bbox, Np, 128, raster_list._default_lmax(H, W), H, W


def _scene_rows(card, kw, kc, lmax):
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    table, bbox, _, Np = raster_list._table_bbox(proj, colors, opacity, H, W, kc)
    return table.to(card), bbox.to(card), Np, kc, lmax, H, W


def _odd_bboxes(card, H, W, n, seed, kc=64, lmax=4):
    """Float bboxes that no projection makes: non-integer, negative and
    off-grid bounds, zero-area and inverted boxes, infinite and NaN bounds,
    one box over the whole grid, and invalid rows among them."""
    tb_x, tb_y = -(-W // 16), -(-H // 16)
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-3, [tb_x + 2, tb_y + 2], (n, 2))
    ext = rng.choice([0.0, 0.4, 1.0, 2.5, 7.0, -1.0], (n, 2))
    bbox = np.stack([lo[:, 0], lo[:, 0] + ext[:, 0], lo[:, 1], lo[:, 1] + ext[:, 1]], -1)
    k = rng.permutation(n)
    bbox[k[0]] = [-0.5, tb_x + 0.5, -0.5, tb_y + 0.5]          # the whole grid
    bbox[k[1]] = [-np.inf, np.inf, -np.inf, np.inf]
    bbox[k[2]] = [np.nan, 3.0, 0.0, 2.0]
    bbox[k[3]] = [2.0, 2.0, 1.0, 5.0]                          # zero area
    bbox[k[4]] = [1e9, 2e9, -2e9, -1e9]
    bbox[k[5:40]] = np.round(bbox[k[5:40]])                    # integer bounds
    Np = -(-(n + 1) // kc) * kc
    table = torch.zeros((Np, 16))
    table[:n, 15] = torch.as_tensor(rng.uniform(size=n) > 0.15, dtype=torch.float32)
    table[k[:2], 15] = 1.0
    full = torch.zeros((Np, 4))
    full[:n] = torch.as_tensor(bbox, dtype=torch.float32)
    return table.to(card), full.to(card), Np, kc, lmax, H, W


# kernel F against the plain enumeration: a converged Kodak state at kc 128
# and 64 (width 16), the converged 2K state (width 8), fit_image's random
# initial rows at both grids, a crowded tile at widths 1 and 8 (residual
# intervals), float bboxes no projection makes at two grids, and fewer
# chunks than the list width
F_CASES = {
    "Kodak state kc 128": lambda c: _npz_rows(c, "repr_states_plain/kodim01.npz", 128),
    "Kodak state kc 64": lambda c: _npz_rows(c, "repr_states_plain/kodim01.npz", 64),
    "2K state": lambda c: _npz_rows(c, "repr_states_2k/mosaic2k.npz", 128),
    "initial rows 768x512": lambda c: _initial_rows(c, 512, 768, 2500, 5000, 41),
    "initial rows 2040x1344": lambda c: _initial_rows(c, 1344, 2040, 10000, 20000, 42),
    "crowded lmax 1": lambda c: _scene_rows(c, CROWDED, 64, 1),
    "crowded lmax 8 kc 32": lambda c: _scene_rows(c, CROWDED, 32, 8),
    "odd bboxes 45x77": lambda c: _odd_bboxes(c, 45, 77, 900, 50),
    "odd bboxes 2040x1344": lambda c: _odd_bboxes(c, 1344, 2040, 6000, 51, kc=128, lmax=8),
    "fewer chunks than lmax": lambda c: _scene_rows(
        c, dict(n=150, H=45, W=77, seed=0), 64, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(F_CASES))
def test_chunk_lists_match_plain(card, case):
    """Kernel F's lists, counts and member counts are ``torch.equal`` to
    ``_lists_and_members(_bbox_members(...))``, run on the card."""
    table, bbox, Np, kc, lmax, H, W = F_CASES[case](card)
    before = raster_list.chunk_lists.launches
    got = raster_list.chunk_lists(table, bbox, Np, kc, lmax, H, W)
    assert raster_list.chunk_lists.launches == before + 1
    tb_x, tb_y = -(-W // 16), -(-H // 16)
    want = raster_list._lists_and_members(
        raster_list._bbox_members(table, bbox, tb_x, tb_x * tb_y), Np, kc, lmax)
    torch.cuda.synchronize()
    (lst, cnt, lo2, hi2), members = got
    assert lst.shape == (tb_x * tb_y, lmax) and all(
        a.dtype == torch.int32 for a in (lst, cnt, lo2, hi2, members))
    for name, a, b in zip(("lst", "cnt", "lo2", "hi2", "members"),
                          (*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b), f"{case}: {name} differs at {int((a != b).sum())} entries"
    assert int(members.sum()) > 0, case
    if case.startswith("crowded"):
        assert int((hi2 > lo2).sum()) > 0, f"{case}: no residual interval"
    if case == "fewer chunks than lmax":
        assert Np // kc < lmax


@pytest.mark.cuda
def test_chunk_lists_replay_in_a_cuda_graph(card):
    """``member_lists`` captured in a CUDA graph, replayed on other rows
    copied into its static inputs, gives the eager lists, and syncs with
    nothing."""
    kw = dict(SCENES["kodak-size"])
    kw.pop("cap")
    first = _scene_rows(card, kw, 128, 16)
    second = _scene_rows(card, {**kw, "seed": 7}, 128, 16)
    table, bbox, Np, kc, lmax, H, W = first
    static_table, static_bbox = table.clone(), bbox.clone()
    args = (Np - 1, Np, kc, H, W, lmax)
    raster_list.member_lists(static_table, static_bbox, *args)      # builds the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    replays, eager = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = raster_list.member_lists(static_table, static_bbox, *args)
        for rows in (second, first):
            static_table.copy_(rows[0])
            static_bbox.copy_(rows[1])
            graph.replay()
            replays.append([a.clone() for a in out])
            eager.append(raster_list.member_lists(rows[0], rows[1], *args))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert not torch.equal(eager[0][0], eager[1][0])
    for got, want in zip(replays, eager):
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))


@pytest.mark.cuda
def test_2k_fit_is_bit_equal_with_the_plain_enumeration(card, monkeypatch):
    """A 300-step 2040x1344 fit through ``'auto'`` (list_t, graphed chunks,
    growth at 100 and 200) gives the same losses, history and best state
    with kernel F as with the plain enumeration's ATen operations on the
    card, patched in for the second fit."""
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    gt, cfg, tcfg, ts0 = _kodak_fit_case(card, H=1344, W=2040)
    tcfg = dataclasses.replace(tcfg, iterations=300)
    assert tr.captures(cfg, card)
    before = [k.launches for k in (raster_list.chunk_lists, raster_list.chunk_list_forward,
                                   raster_list.chunk_backward)]
    res = tr.fit_image(gt, cfg, tcfg, 2500, gaussians=ts0.gaussians)
    f, b, c = (k.launches - n for k, n in zip(
        (raster_list.chunk_lists, raster_list.chunk_list_forward, raster_list.chunk_backward),
        before))
    assert c == 300 and f == b >= 300

    def plain(*args):
        return raster_list.chunk_lists_plain(*args)

    plain.launches = 0
    monkeypatch.setattr(raster_list, "chunk_lists", plain)
    ref = tr.fit_image(gt, cfg, tcfg, 2500, gaussians=ts0.gaussians)
    assert plain.launches == 0
    assert torch.equal(res.history["loss"], ref.history["loss"])
    for key in res.history:
        assert torch.equal(res.history[key], ref.history[key]), key
    _assert_trees_equal(res.state, ref.state, "best state")


# kernel D: invalid rows and a Gaussian over the whole grid on the ragged
# 45x77 grid; two Gaussians over the whole 768x512 grid (stage 2's lanes take
# 48 of the 1536 tiles each); a crowded tile over cap 8 (bbox tiles lack
# their slot); 300 live slots in one tile at cap 512 (stage 1 spreads the
# tile over ten blocks of 32 slots)
D_CASES = {
    "ragged, invalid rows, whole-grid bbox": dict(n=150, H=45, W=77, seed=12, cap=64,
                                                  n_invalid=9, n_huge=2),
    "kodak-size, whole-grid bbox": dict(n=5000, H=512, W=768, seed=15, cap=256, n_huge=2),
    "crowded over cap 8": dict(n=200, H=48, W=80, seed=13, cap=8, crowd=60, spread=3.5,
                               n_huge=1),
    "300 slots in a tile, cap 512": dict(n=400, H=48, W=80, seed=14, cap=512, crowd=300,
                                         spread=3.5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(D_CASES))
def test_tile_table_backward_hard_cases(card, case):
    kw = dict(D_CASES[case])
    cap = kw.pop("cap")
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    tb = (-(-W // 16), -(-H // 16))
    bins = bin_gaussians(proj, H, W, cap=cap)
    table, ids, counts = raster_binned._slot_table(proj.xys, proj.conics, colors, opacity,
                                                   bins.ids, bins.mask)
    bbox = raster_binned.tile_bbox_table(proj.xys, proj.radii, tb)
    area = ((bbox[:, 1].clamp(max=tb[0]) - bbox[:, 0].clamp(min=0)).clamp(min=0)
            * (bbox[:, 3].clamp(max=tb[1]) - bbox[:, 2].clamp(min=0)).clamp(min=0))
    if kw.get("n_huge"):
        assert int(area.max()) == tb[0] * tb[1], "no bbox covers the whole grid"
    if kw.get("n_invalid"):
        assert int((~proj.valid).sum()) >= kw["n_invalid"]
        # a live slot whose row is invalid contributes nothing
        table[int(ids[0, 0]), 15] = 0.0
    if cap == 8:
        full = bin_gaussians(proj, H, W, cap=1024)
        assert int(full.count.sum()) > int(bins.count.sum()), "no member was capped out"
    if cap == 512:
        assert int(counts.max()) >= 300 and ids.shape[1] == 512
    v_img = torch.as_tensor(np.random.default_rng(kw["seed"]).normal(size=(H, W, 3))
                            .astype(np.float32))
    args = [a.contiguous() for a in (table, counts, ids, bbox, v_img)]
    ref = raster_binned.tile_table_backward_plain(*args)
    on_card = [a.to(card) for a in args]
    out = raster_binned.tile_table_backward(*on_card)
    again = raster_binned.tile_table_backward(*on_card)
    torch.cuda.synchronize()
    assert torch.equal(out, again), f"kernel D {case}: two launches differ"
    _payload_close(out, ref, f"kernel D {case}")


@pytest.mark.cuda
def test_tile_table_backward_clamps_counts(card):
    """counts past K read K slots, negative counts none, as the plain version."""
    args = _binned_inputs("odd-grid", "cpu")
    K = args[2].shape[1]
    args[1] = args[1].clone()
    args[1][0], args[1][1] = K + 7, -3
    ref = raster_binned.tile_table_backward_plain(*args)
    out = raster_binned.tile_table_backward(*(a.to(card) for a in args))
    _payload_close(out, ref, "kernel D clamped counts")


def _bbox_table(n, tb_x, tb_y, seed, extent=4, crowd=0, n_whole=0, n_invalid=0):
    """[n, 4] int32 tile bboxes ``(xmin, xmax, ymin, ymax)`` made with numpy:
    random boxes of at most ``extent`` tiles a side, ``crowd`` of them over
    tile (1, 1), ``n_whole`` over the whole grid and ``n_invalid`` with the
    empty bbox ``(1, 0, 1, 0)``, the special rows at random positions."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, tb_x, n), rng.integers(0, tb_y, n)
    w, h = rng.integers(1, extent + 1, n), rng.integers(1, extent + 1, n)
    bbox = np.stack([x0, np.minimum(x0 + w, tb_x), y0, np.minimum(y0 + h, tb_y)], -1)
    rows = rng.permutation(n)
    i = 0
    for count, box in ((crowd, (1, 3, 1, 2)), (n_whole, (0, tb_x, 0, tb_y)),
                       (n_invalid, (1, 0, 1, 0))):
        bbox[rows[i:i + count]] = box
        i += count
    return torch.as_tensor(bbox.astype(np.int32))


# kernel E reads the table in batches of 1024 ids (32 slices of 32); a block
# owns 8 tiles of one tile row (32 from 4096 tiles on, 4 a warp) and stops
# when all of them hold `cap` members
E_CASES = {
    "N 1037, not a multiple of 32 or of a batch": dict(n=1037, grid=(48, 32), cap=256),
    "N 20000, 20 batches, 2K grid": dict(n=20000, grid=(128, 84), cap=256, extent=3),
    "tile over cap 1": dict(n=3000, grid=(48, 32), cap=1, crowd=300),
    "tile over cap 8": dict(n=3000, grid=(48, 32), cap=8, crowd=300),
    "tile over cap 256": dict(n=3000, grid=(48, 32), cap=256, crowd=600),
    "every row invalid": dict(n=2000, grid=(48, 32), cap=256, n_invalid=2000),
    "whole-grid bboxes": dict(n=3000, grid=(48, 32), cap=256, n_whole=5, n_invalid=40),
    "odd grid 47x31": dict(n=5000, grid=(47, 31), cap=256, n_invalid=70),
    "big grid 127x41, 4 tiles a warp, over cap 8": dict(n=9000, grid=(127, 41), cap=8,
                                                         crowd=300, n_whole=2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(E_CASES))
def test_tile_bin_hard_cases(card, case):
    kw = dict(E_CASES[case])
    (tb_x, tb_y), cap = kw.pop("grid"), kw.pop("cap")
    bbox = _bbox_table(tb_x=tb_x, tb_y=tb_y, seed=len(case), **kw).to(card)
    ref_ids, ref_count = binning_tiles.tile_bin_plain(bbox, tb_x, tb_y, cap)
    before = binning_tiles.tile_bin.launches
    ids, count = binning_tiles.tile_bin(bbox, tb_x, tb_y, cap)
    assert binning_tiles.tile_bin.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(ids, ref_ids) and torch.equal(count, ref_count), case
    if kw.get("crowd"):
        assert int(count.max()) == cap
    if kw.get("n_invalid") == kw["n"]:
        assert not bool(count.any()) and not bool(ids.any())
    if kw.get("n_whole"):
        assert bool((count > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [128, 64])
def test_chunk_backward_imbalanced_rows(card, kc):
    """A Gaussian over the whole ragged 500x760 grid beside ~4000 Gaussians
    of at most 2x2 tiles and invalid rows: a block's warps split the big
    row's pairs between them. Against the plain version, and two launches."""
    H, W, n = 500, 760, 4000
    rng = np.random.default_rng(kc)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    a, c = rng.uniform(1.0, 4.0, n), rng.uniform(1.0, 4.0, n)
    cov = np.stack([a, rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c), c], -1).astype(np.float32)
    cov[1234] = np.array([4e6, 0.0, 4e6], np.float32)        # the whole grid
    cov[-37:] = np.array([1.0, 2.0, 1.0], np.float32)        # invalid
    proj = project_gaussians_2d_covariance(torch.as_tensor(xy), torch.as_tensor(cov), H, W)
    colors = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    table, bbox, _, _ = raster_list._table_bbox(proj, colors, torch.ones(n), H, W, kc)
    tb_x, tb_y = -(-W // 16), -(-H // 16)
    live = table[:, 15] > 0
    area = ((bbox[:, 1].clamp(max=tb_x) - bbox[:, 0].clamp(min=0)).clamp(min=0)
            * (bbox[:, 3].clamp(max=tb_y) - bbox[:, 2].clamp(min=0)).clamp(min=0))[live]
    assert int(area.max()) == tb_x * tb_y and int((area <= 4).sum()) >= 3900
    assert int((~live[:n]).sum()) >= 37
    v_img = torch.as_tensor(rng.normal(size=(H, W, 3)).astype(np.float32))
    ref = raster_list.chunk_backward_plain(table, bbox, v_img)
    args = (table.to(card), bbox.to(card), v_img.to(card))
    out = raster_list.chunk_backward(*args)
    again = raster_list.chunk_backward(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again), "kernel C: two launches differ"
    _payload_close(out, ref, f"kernel C imbalanced rows kc {kc}")
    assert not out[:n][~live[:n]].any(), "an invalid row has a gradient"


@pytest.mark.cuda
@pytest.mark.parametrize("color_quant", ["lsq", "vq"])
def test_render_quantized_gradients_auto_vs_xla(card, color_quant):
    """One QAT step's gradients at the fit state's shape (768x512, 5000
    Gaussians, no tile over the cap 256) through ``'auto'`` (list_t: kernels
    B and C) against ``'xla'`` (the plain capped path) on the card: per
    column of each model parameter, max |auto - xla| <= 1e-4 max |xla|. Each
    grid parameter gets one copy per row, so its gradient is a sum of per-row
    terms that may cancel: per column, |sum auto - sum xla| <= 1e-4 sum
    |xla's terms|. The two variances that set the log grid's min and max also
    take its ``beta`` and ``scale`` gradients, which the straight-through
    round makes cancel to rounding (``quant * scale + beta`` is ``log x``):
    they are held to 1e-4 of their column's max plus 2^-20 of the sum over
    the variances of |cotangent x dequantized value|."""
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi

    n, H, W = 5000, 512, 768
    rng = np.random.default_rng(30)
    a, c = rng.uniform(2.0, 60.0, n), rng.uniform(2.0, 60.0, n)
    b = rng.uniform(-0.8, 0.8, n) * np.sqrt(a * c)
    bound = np.tile(np.float32([[0.5, 0.0, 0.5]]), (n, 1))
    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=n)
    state = gi.GaussianState(
        params=gi.GaussianParams(
            xyz=torch.as_tensor(np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
                                .astype(np.float32), device=card),
            cov2d=torch.as_tensor((np.stack([a, b, c], -1) - bound).astype(np.float32), device=card),
            features=torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=card)),
        active=torch.as_tensor(np.arange(n) < n - 40, device=card),
        bound=torch.as_tensor(bound, device=card), num_active=torch.tensor(n - 40, device=card))
    gt = torch.as_tensor(rng.uniform(0, 1, (H, W, 3)).astype(np.float32), device=card)
    assert gi.resolve_backend(cfg, card) == "list_t"
    proj = gi.project(state.params, state.active, state.bound, cfg)
    assert int(bin_gaussians(proj, H, W, cap=257).count.max()) <= 256
    qcfg = pl.QuantConfig(color_quant=color_quant)
    bundle = pl.init_quantizers(state, cfg, qcfg)

    def grads(backend):
        """Gradients to the parameters and per-row grids, and the variances'
        |cotangent x dequantized value|."""
        params = gi.GaussianParams(*(p.detach().clone().requires_grad_(True) for p in state.params))
        rows = lambda u: pl.UniformQuantParams(*(t.detach().expand(n, -1).clone().requires_grad_(True)
                                                 for t in u))
        b_ = bundle._replace(xy=rows(bundle.xy), cov=pl.HybridQuantParams(cov=rows(bundle.cov.cov)),
                             color=rows(bundle.color))
        st_ = state._replace(params=params)
        means, cov_el, colors, _, _ = pl.quantize_attributes(b_, st_, cfg, qcfg)
        img = gi.render(st_, dataclasses.replace(cfg, raster_backend=backend),
                        cov_override=cov_el, means_override=means, colors_override=colors)
        leaves = tuple(params) + (b_.xy.scale, b_.xy.beta, b_.cov.cov.scale, b_.cov.cov.beta,
                                  b_.color.scale, b_.color.beta)
        out = torch.autograd.grad(torch.mean((img - gt) ** 2), leaves + (cov_el,), allow_unused=True)
        g = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, out)]
        return g, float((out[-1] * cov_el.detach())[:, ::2].abs().sum())

    c0 = raster_list.chunk_backward.launches
    g_auto, _ = grads("auto")
    assert raster_list.chunk_backward.launches == c0 + 1
    g_xla, noise = grads("xla")
    torch.cuda.synchronize()
    with torch.no_grad():     # the variances at the log grid's min and max (active rows)
        log_x = torch.log((gi.effective_cov2d(state.params, state.bound, cfg)[:, ::2].abs()
                           + 1e-6).double())
        big = torch.full_like(log_x, float("inf"))
        m = state.active[:, None]
        ends = [divmod(int(torch.argmin(torch.where(m, log_x, big))), 2),
                divmod(int(torch.argmax(torch.where(m, log_x, -big))), 2)]
    names = ("xyz", "cov2d", "features", "xy.scale", "xy.beta", "cov.scale", "cov.beta",
             "color.scale", "color.beta")
    for name, ga, gx in zip(names, g_auto, g_xla):
        assert bool(torch.isfinite(ga).all()), name
        if name in ("xyz", "cov2d", "features"):
            err, scale = (ga - gx).abs(), gx.abs().amax(0)
            if name == "cov2d":
                for r, j in ends:
                    assert float(err[r, 2 * j]) <= 1e-4 * float(scale[2 * j]) + 2.0 ** -20 * noise
                    err[r, 2 * j] = 0
            err = err.amax(0)
        else:
            err, scale = (ga.sum(0) - gx.sum(0)).abs(), gx.abs().sum(0)
        assert bool((err <= 1e-4 * scale).all()), f"{name}: {err.tolist()} vs {scale.tolist()}"
    assert float(g_xla[0].abs().max()) > 0 and float(g_xla[3].abs().sum()) > 0


@pytest.mark.cuda
def test_fit_resume_is_bit_equal(card, tmp_path):
    """A 200-step ``'auto'`` fit (kernels B and C, growth at 100, a prune
    every 50) stopped at 50 and resumed from its checkpoint equals the
    uninterrupted fit bit for bit: the generator rides in the checkpoint and
    every operation of the step is deterministic on the card."""
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    H = W = 256
    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=400)
    assert gi.resolve_backend(cfg, card) == "list_t"
    tcfg = tr.TrainConfig(iterations=200, grow_iter=100, prune_iter=50, lr=0.02)
    gt = torch.as_tensor(np.random.default_rng(31).uniform(0, 1, (H, W, 3)).astype(np.float32),
                         device=card)
    fit = lambda **kw: tr.fit_image(gt, cfg, tcfg, 200, seed=5, device=card, **kw)
    c0 = raster_list.chunk_backward.launches
    full = fit()
    assert raster_list.chunk_backward.launches == c0 + 200
    ck = str(tmp_path / "ck")
    fit(checkpoint_dir=ck, checkpoint_every=50, stop_after_iter=50)
    resumed = fit(checkpoint_dir=ck, resume=True)
    assert int(full.history["n_added"].sum()) > 0
    assert torch.equal(resumed.history["psnr"], full.history["psnr"][50:])
    for name, a, b in zip(("xyz", "cov2d", "features"), resumed.state.params, full.state.params):
        assert torch.equal(a, b), name
    assert torch.equal(resumed.state.active, full.state.active)
    assert torch.equal(resumed.state.num_active, full.state.num_active)
    assert resumed.best_psnr == full.best_psnr


@pytest.mark.cuda
def test_adan_cholesky_step_auto_vs_xla(card):
    """One Adan step of the legacy Cholesky model at 768x512 with 3000
    Gaussians (no tile over the cap 256): the gradients through ``'auto'``
    (list_t: kernels B and C) against ``'xla'`` (the plain capped path), per
    parameter column, max |auto - xla| <= 1e-4 max |xla| (kernel C's
    tolerance); then the step itself runs through ``'auto'``, B and C once."""
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import losses
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    n, H, W = 3000, 512, 768
    rng = np.random.default_rng(32)
    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=n, param="cholesky")
    bound = np.tile(np.float32([[0.5, 0.0, 0.5]]), (n, 1))
    chol = np.stack([rng.uniform(1.0, 5.0, n), rng.uniform(-1.0, 1.0, n),
                     rng.uniform(1.0, 5.0, n)], -1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=card)
    state = gi.GaussianState(
        params=gi.GaussianParams(xyz=t(rng.uniform(-1.5, 1.5, (n, 2))), cov2d=t(chol - bound),
                                 features=t(rng.uniform(0, 1, (n, 3)))),
        active=torch.as_tensor(np.arange(n) < n - 30, device=card), bound=t(bound),
        num_active=torch.tensor(n - 30, dtype=torch.int32, device=card))
    gt = t(rng.uniform(0, 1, (H, W, 3)))
    assert gi.resolve_backend(cfg, card) == "list_t"
    proj = gi.project(state.params, state.active, state.bound, cfg)
    assert int(bin_gaussians(proj, H, W, cap=257).count.max()) <= 256

    def grads(backend):
        params = gi.GaussianParams(*(p.detach().clone().requires_grad_(True) for p in state.params))
        img = gi.render(state._replace(params=params), dataclasses.replace(cfg, raster_backend=backend))
        return torch.autograd.grad(losses.loss_fn(img, gt, "L2", 0.7), params)

    g_auto, g_xla = grads("auto"), grads("xla")
    for name, ga, gx in zip(("xyz", "cov2d", "features"), g_auto, g_xla):
        assert bool(torch.isfinite(ga).all()), name
        err, scale = (ga - gx).abs().amax(0), gx.abs().amax(0)
        assert bool((scale > 0).all()), name
        assert bool((err <= 1e-4 * scale).all()), f"{name}: {err.tolist()} vs {scale.tolist()}"
    tcfg = tr.TrainConfig(lr=1e-3, opt_type="adan", adaptive_add=False, prune=False)
    tx = tr.make_optimizer(tcfg)
    ts = tr.init_train_state(cfg, tcfg, n, gaussians=state)
    b0, c0 = raster_list.chunk_list_forward.launches, raster_list.chunk_backward.launches
    ts, (loss, psnr, _) = tr.train_step(ts, gt, cfg, tcfg, tx)
    assert raster_list.chunk_backward.launches == c0 + 1
    assert raster_list.chunk_list_forward.launches == b0 + 1
    assert int(ts.opt_state.count) == 1 and bool(torch.isfinite(psnr))


@pytest.mark.cuda
def test_train_chunk_render_fn_default_is_bit_equal(card):
    """``train_chunk`` with ``render_fn=render`` equals the default step bit
    for bit on the card: 30 steps through ``'auto'`` (kernels B and C), a
    prune and a growth."""
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    H = W = 256
    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=400)
    tcfg = tr.TrainConfig(iterations=30, grow_iter=30, prune_iter=30, lr=0.02)
    gt = torch.as_tensor(np.random.default_rng(33).uniform(0, 1, (H, W, 3)).astype(np.float32),
                         device=card)
    ts0 = tr.init_train_state(cfg, tcfg, 200, seed=6, device=card)
    draws = torch.rand((400, 3), generator=torch.Generator().manual_seed(7)).to(card)
    c0 = raster_list.chunk_backward.launches
    a, ma = tr.train_chunk(ts0, gt, cfg, tcfg, 30, True, True, grow_draws=draws)
    b, mb = tr.train_chunk(ts0, gt, cfg, tcfg, 30, True, True, grow_draws=draws,
                           render_fn=gi.render)
    assert raster_list.chunk_backward.launches == c0 + 60
    assert torch.equal(ma["psnr"], mb["psnr"]) and int(ma["n_added"]) > 0
    for x, y in zip((*a.gaussians.params, a.gaussians.active, a.best_psnr, *a.opt_state.mu),
                    (*b.gaussians.params, b.gaussians.active, b.best_psnr, *b.opt_state.mu)):
        assert torch.equal(x, y)


# the 752x496 crop's grid, 47x31 tiles: 'auto' resolves to 'pallas' + 'top_k' there
ODD_HW = dict(H=496, W=752)


def _kodak_fit_case(card, H=512, W=768, **cfg_kw):
    """A 768x512 target (the render of a seeded random scene; ``H``, ``W``
    another size), its config at 5000 rows and a 2500-point train state."""
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=5000, **cfg_kw)
    proj, colors, opacity = _scene(3000, H, W, seed=40)
    inputs = raster_list.list_inputs(proj, colors, opacity, H, W, 128)
    gt = torch.clamp(raster_list.chunk_list_forward(*(a.to(card) for a in inputs), 128, H, W),
                     0, 1).contiguous()
    tcfg = tr.TrainConfig(iterations=200, grow_iter=100, prune_iter=50, lr=0.018)
    return gt, cfg, tcfg, tr.init_train_state(cfg, tcfg, 2500, seed=41, device=card)


def _assert_trees_equal(a, b, what):
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    ta, tb = tr._tensors(a), tr._tensors(b)
    assert len(ta) == len(tb), what
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert torch.equal(x, y), f"{what}: tensor {i} {tuple(x.shape)} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "pallas", "odd-grid auto"])
def test_graphed_fit_is_bit_equal(card, backend):
    """``fit_image`` at 768x512 (2500 -> 5000 Gaussians, a prune every 50,
    the growth at 100 with the final fill, 200 steps, a log point at 150)
    through ``'auto'`` (list_t: B + C) and ``'pallas'`` + kernel E (A + D +
    E), and at 752x496 through ``'auto'`` (``'pallas'`` + ``'top_k'``: A +
    D): its chunks replay one captured chunk, and its best state, history
    and launch counts equal the eager ``train_chunk`` loop's."""
    from gaussianimage_plus_tpu_torch.kernels import wrappers
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    kw = dict(raster_backend="pallas", bin_method="pallas") if backend == "pallas" else {}
    gt, cfg, tcfg, ts0 = _kodak_fit_case(card, **(ODD_HW if backend.startswith("odd") else {}),
                                         **kw)
    assert tr.captures(cfg, card)
    if backend.startswith("odd"):
        assert (gi.resolve_backend(cfg, card), gi.render_binner(cfg, card)) == ("pallas", "auto")
    draws = torch.rand((5000, 3), generator=torch.Generator().manual_seed(42)).to(card)
    for k in wrappers():
        k.launches = 0
    res = tr.fit_image(gt, cfg, tcfg, 2500, gaussians=ts0.gaussians, grow_draws=[draws],
                       log_every=150, logger=io.StringIO())
    graphed = [k.launches for k in wrappers()]
    for k in wrappers():
        k.launches = 0
    ts, hist = ts0, {"psnr": [], "n_pruned": [], "n_added": [], "num_active": []}
    for end in range(50, 201, 50):
        grow_now = end == 100
        ts, m = tr.train_chunk(ts, gt, cfg, tcfg, 50, True, grow_now, True,
                               draws if grow_now else None)
        hist["psnr"].append(m["psnr"])
        hist["n_pruned"].append(m["n_pruned"][None])
        hist["n_added"].append(m["n_added"][None])
        hist["num_active"].append(ts.gaussians.num_active[None])
    assert [k.launches for k in wrappers()] == graphed and graphed[2 if backend == "auto" else 3] == 200
    for key, parts in hist.items():
        assert torch.equal(res.history[key], torch.cat(parts)), key
    _assert_trees_equal(res.state, tr.restore_best(ts), "best state")
    assert res.best_iter == int(ts.best_iter) and int(res.history["n_added"].sum()) > 0


@pytest.mark.cuda
def test_graphed_macro_chunk_is_bit_equal(card):
    """A bare ``train_macro_chunk`` (3 chunks of 50, prune, the growth at the
    end) equals three ``train_chunk`` calls with the growth on the last:
    the whole train state, the metrics, and each kernel's launches beyond
    its warm-up chunk on a clone."""
    from gaussianimage_plus_tpu_torch.kernels import wrappers
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    gt, cfg, tcfg, ts0 = _kodak_fit_case(card)
    draws = torch.rand((5000, 3), generator=torch.Generator().manual_seed(43)).to(card)
    for k in wrappers():
        k.launches = 0
    a, ma = tr.train_macro_chunk(ts0, gt, cfg, tcfg, 3, 50, True, True, False, draws)
    graphed = [k.launches for k in wrappers()]
    for k in wrappers():
        k.launches = 0
    b, losses, psnrs = ts0, [], []
    for i in range(3):
        b, mb = tr.train_chunk(b, gt, cfg, tcfg, 50, True, i == 2, False, draws)
        losses.append(mb["loss"])
        psnrs.append(mb["psnr"])
    assert graphed == [4 * n // 3 for n in (k.launches for k in wrappers())]
    _assert_trees_equal(a, b, "train state")
    assert torch.equal(ma["loss"], torch.cat(losses)) and torch.equal(ma["psnr"], torch.cat(psnrs))
    assert torch.equal(ma["n_added"], mb["n_added"]) and int(ma["n_added"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["768x512", "odd 752x496"])
@pytest.mark.parametrize("color_quant", ["lsq", "vq"])
def test_graphed_quant_macro_chunk_is_bit_equal(card, color_quant, grid):
    """``quant_train_macro_chunk`` (3 chunks of 20 QAT steps through
    ``'auto'``: list_t at 768x512, ``'pallas'`` + ``'top_k'`` on the odd
    grid) equals three ``quant_train_chunk`` calls carrying ``best``."""
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    gt, cfg, tcfg, ts0 = _kodak_fit_case(card, **(ODD_HW if grid.startswith("odd") else {}))
    assert tr.captures(cfg, card)
    ts0, _ = tr.train_chunk(ts0, gt, cfg, tcfg, 20, True, False)
    state = tr.restore_best(ts0)
    qcfg = pl.QuantConfig(color_quant=color_quant)
    bundle = pl.init_quantizers(state, cfg, qcfg)
    mos = tr.make_optimizer(tcfg).init(state.params)
    a = pl.quant_train_macro_chunk(state, mos, bundle, gt, cfg, qcfg, 0.01, 3, 20)
    b, best, psnrs = (state, mos, bundle), None, []
    for _ in range(3):
        *b, m = pl.quant_train_chunk(*b, gt, cfg, qcfg, 0.01, 20, best=best)
        best = m["best"]
        psnrs.append(m["psnr"])
    _assert_trees_equal(a[:3], tuple(b), "QAT state")
    _assert_trees_equal(a[3]["best"], best, "best carry")
    assert torch.equal(a[3]["psnr"], torch.cat(psnrs))


# every route that renders through a kernel, so that its chunks replay as CUDA
# graphs (train.trainer.captures): (raster_backend, bin_method, grid); the
# default config on the odd grid resolves to 'pallas' + 'top_k'
GRAPH_ROUTES = ([("pallas", b, {}) for b in ("top_k", "hier", "scatter", "rank", "auto", "pallas")]
                + [(b, "auto", {}) for b in ("list", "list_t", "dense", "sweep", "auto")]
                + [("auto", "auto", ODD_HW)])


@pytest.mark.cuda
@pytest.mark.parametrize("route", GRAPH_ROUTES, ids=[f"{b}-{m}" + ("-odd-grid" if g else "")
                                                     for b, m, g in GRAPH_ROUTES])
def test_capture_set_routes_never_sync(card, route):
    """Each route that ``captures`` runs a train chunk (re-sort, steps,
    prune) and a QAT chunk with the host never synchronised: under
    ``torch.cuda.set_sync_debug_mode("error")`` a sync raises."""
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    backend, binner, grid = route
    gt, cfg, tcfg, ts = _kodak_fit_case(card, **grid, raster_backend=backend, bin_method=binner)
    assert tr.captures(cfg, card)
    qcfg = pl.QuantConfig(color_quant="vq")
    ts, _ = tr.train_chunk(ts, gt, cfg, tcfg, 2, True, False)       # builds the kernels
    bundle = pl.init_quantizers(tr.restore_best(ts), cfg, qcfg)
    mos = tr.make_optimizer(tcfg).init(ts.gaussians.params)
    pl.quant_train_chunk(ts.gaussians, mos, bundle, gt, cfg, qcfg, 0.01, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.train_chunk(ts, gt, cfg, tcfg, 3, True, False)
        for q in (bundle, bundle._replace(color_vq=None)):
            pl.quant_train_chunk(ts.gaussians, mos, q, gt, cfg,
                                 dataclasses.replace(qcfg, color_quant="vq" if q.color_vq else "lsq"),
                                 0.01, 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)



@pytest.mark.cuda
def test_eager_routes_do_not_capture(card):
    """The plain ``'xla'`` path and a ``render_fn`` run their chunks eagerly."""
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    cfg = gi.GaussianConfig(H=512, W=768, max_num_points=5000)
    assert tr.captures(cfg, card)
    assert not tr.captures(dataclasses.replace(cfg, raster_backend="xla"), card)
    assert not tr.captures(cfg, card, gi.render)


@pytest.mark.cuda
def test_graphed_fit_batch_is_bit_equal(card):
    """``fit_batch`` of two 752x496 images (the odd grid's ``'auto'``:
    ``'pallas'`` + ``'top_k'``; 2500 -> 5000 Gaussians each, a prune every
    50, the growth with the final fill at 100, 200 steps): each chunk of the
    block is a replay of one captured chunk, and each image's final state,
    the per-chunk metrics and the launch counts equal each image's
    ``train_chunk`` loop run eagerly."""
    from gaussianimage_plus_tpu_torch.kernels import wrappers
    from gaussianimage_plus_tpu_torch.parallel import sharded as psh
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    gt, cfg, tcfg, _ = _kodak_fit_case(card, **ODD_HW)
    images = torch.stack([gt, torch.flip(gt, dims=(1,))])
    assert tr.captures(cfg, card)
    seen = []
    for k in wrappers():
        k.launches = 0
    tss = psh.fit_batch(images, cfg, tcfg, 2500, seed=50,
                        progress=lambda it, m: seen.append({k: v.clone() for k, v in m.items()}))
    graphed = [k.launches for k in wrappers()]
    for k in wrappers():
        k.launches = 0
    for i in range(2):
        ts = tr.init_train_state(cfg, tcfg, 2500, seed=50 + i, device=card)
        for c, end in enumerate(range(50, 201, 50)):
            ts, m = tr.train_chunk(ts, images[i], cfg, tcfg, 50, True, end == 100, end == 100)
            for key in ("loss", "psnr", "n_pruned", "n_added"):
                assert torch.equal(seen[c][key][i], m[key]), (i, end, key)
        _assert_trees_equal(tss[i], ts, f"image {i}")
    assert [k.launches for k in wrappers()] == graphed and graphed[3] == 400
    assert int(sum(m["n_added"].sum() for m in seen)) > 0


@pytest.mark.cuda
def test_capture_of_a_host_sync_raises(card):
    """A ``render_fn`` that reads a value on the host (``.item()``) makes
    the capture of its chunk raise; the launch counts are put back and the
    card runs on."""
    from gaussianimage_plus_tpu_torch.kernels import wrappers
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    gt, cfg, tcfg, ts = _kodak_fit_case(card)
    ts, _ = tr.train_chunk(ts, gt, cfg, tcfg, 2, True, False)

    def syncing(state, cfg_):
        img = gi.render(state, cfg_)
        img.sum().item()
        return img

    assert not tr.captures(cfg, card, syncing)
    fn = lambda ts_: (tr.train_chunk(ts_, gt, cfg, tcfg, 2, True, False, render_fn=syncing)[0], ())
    before = [k.launches for k in wrappers()]
    with pytest.raises(RuntimeError):
        tr.ChunkGraph(fn, ts)
    assert [k.launches for k in wrappers()] == before
    after, m = tr.train_chunk(ts, gt, cfg, tcfg, 2, True, False)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(m["psnr"]).all())


ROOT = Path(__file__).resolve().parents[1]
# the benchmark's 50 streams (portbench/configs/kodak-768x512-n5000.json)
DECODE_STREAMS = sorted(p for d in ("bitstreams_r3", "bitstreams_r4", "bitstreams_vq_r5")
                        for p in (ROOT / "results" / d).glob("*.gipb"))


def _parsed(card, paths=DECODE_STREAMS):
    """(the parsed streams on the card, their decode configs, their eager
    binned decodes: ``_binned_config``'s render, selection ``'top_k'``)."""
    from gaussianimage_plus_tpu_torch.compress import bitstream as bs
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi

    decs = [bs.deserialize_bitstream(p.read_bytes(), device=card) for p in paths]
    cfgs = [gi.GaussianConfig(H=d.H, W=d.W, max_num_points=d.enc.active.shape[0],
                              tile_cap=d.qcfg.decode_cap or 256) for d in decs]
    eager = []
    for d, c in zip(decs, cfgs):
        bcfg = pl._binned_config(c, d.qcfg, card)
        assert bcfg.bin_method == "auto" and bcfg.raster_backend == "pallas"
        state, over = pl._decoded_state(d.bundle, d.enc, d.bound, d.qcfg)
        eager.append(gi.render(state, bcfg, **over))
    return decs, cfgs, eager


def _decode(dec, cfg):
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl

    return pl.decompress_wo_ec(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg)


@pytest.mark.cuda
def test_graphed_decode_is_bit_equal(card):
    """Every committed stream's first call and a replay equal its eager
    binned decode; the streams take at most 8 graphs; a second pass adds 0
    captures and 50 replays; a replay adds exactly one launch to kernel A
    and one to kernel E."""
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.kernels import wrappers
    from gaussianimage_plus_tpu_torch.utils import profiling

    pl._DECODE_GRAPHS.clear()
    decs, cfgs, eager = _parsed(card)
    assert len(decs) == 50
    profiling.reset()
    try:
        with profiling.recording():
            for i, (d, c, e) in enumerate(zip(decs, cfgs, eager)):
                assert pl._graphs(pl._decode_inputs(d.bundle, d.enc, d.bound), c)
                assert torch.equal(_decode(d, c), e), f"first call, stream {i}"
                assert torch.equal(_decode(d, c), e), f"replay, stream {i}"
            first = profiling.counters()
            for i, (d, c, e) in enumerate(zip(decs, cfgs, eager)):
                assert torch.equal(_decode(d, c), e), f"second pass, stream {i}"
            second = profiling.counters()
    finally:
        profiling.reset()
    caps = first["decode.graph_captures"]
    assert caps == len(pl._DECODE_GRAPHS) <= 8
    assert first["decode.graph_replays"] == 100 - caps
    assert second["decode.graph_captures"] == caps
    assert second["decode.graph_replays"] == first["decode.graph_replays"] + 50
    before = [k.launches for k in wrappers()]
    _decode(decs[0], cfgs[0])
    assert [k.launches - b for k, b in zip(wrappers(), before)] == [1, 0, 0, 0, 1, 0]


@pytest.mark.cuda
def test_graphed_decode_images_are_fresh_tensors(card):
    """Two images replayed from one graph and held at once each equal
    their own eager decode."""
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl

    paths = [ROOT / "results/bitstreams_r4/kodim01.gipb", ROOT / "results/bitstreams_r4/kodim02.gipb"]
    decs, cfgs, eager = _parsed(card, paths)
    keys = {pl.decode_graph_key(d.bundle, d.enc, d.bound, c, d.qcfg) for d, c in zip(decs, cfgs)}
    assert len(keys) == 1
    _decode(decs[0], cfgs[0])
    a = _decode(decs[0], cfgs[0])
    b = _decode(decs[1], cfgs[1])
    assert not torch.equal(eager[0], eager[1])
    assert torch.equal(a, eager[0]) and torch.equal(b, eager[1])


@pytest.mark.cuda
def test_graphed_decode_never_syncs(card):
    """A replay (the copy of the input into the graph's buffers, the replay,
    the copy of the image) runs under ``set_sync_debug_mode("error")``."""
    decs, cfgs, eager = _parsed(card, [ROOT / "results/bitstreams_vq_r5/kodim01.gipb"])
    _decode(decs[0], cfgs[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = _decode(decs[0], cfgs[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(img, eager[0])


@pytest.mark.cuda
def test_grad_inputs_decode_eagerly_on_the_card(card):
    """An input that requires grad takes the eager binned decode: no capture,
    no replay, the same pixels."""
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.utils import profiling

    decs, cfgs, eager = _parsed(card, [ROOT / "results/bitstreams_r3/kodim05.gipb"])
    d = decs[0]
    col = d.bundle.color
    graded = d.bundle._replace(color=col._replace(scale=col.scale.clone().requires_grad_(True)))
    assert not pl._graphs(pl._decode_inputs(graded, d.enc, d.bound), cfgs[0])
    profiling.reset()
    try:
        with profiling.recording():
            img = pl.decompress_wo_ec(graded, d.enc, d.bound, cfgs[0], d.qcfg)
        counters = profiling.counters()
    finally:
        profiling.reset()
    assert "decode.graph_captures" not in counters and "decode.graph_replays" not in counters
    assert img.requires_grad and torch.equal(img.detach(), eager[0])


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["altered_image", "altered_token"])
def test_decode_faults_fail_through_the_graph(card, fault):
    """The benchmark's decode faults, planted in the program, fail
    ``rms_gap`` against the plain reference through graph replays, where
    the sound replay passes: a graph holds the stream's shape, never its
    codes."""
    from gaussianimage_plus_tpu_torch.compress import bitstream as bs
    from gaussianimage_plus_tpu_torch.utils import profiling
    from portbench import cell as CL
    from portbench import control

    cell = CL.load_cell("kodak-decode")
    mod = CL.kind(cell)
    limit = cell.config["limits"]["rms_gap"]
    buf = (ROOT / "results/bitstreams_r4/kodim01.gipb").read_bytes()   # row 0 is visible
    ref = mod.reference_image(buf, card)
    bs.decode_bitstream(buf, device=card)
    profiling.reset()
    try:
        with profiling.recording():
            sound, _ = bs.decode_bitstream(buf, device=card)
            with control.planted(fault):
                bad, _ = bs.decode_bitstream(buf, device=card)
        replays = profiling.counters().get("decode.graph_replays")
    finally:
        profiling.reset()
    assert replays == 2
    assert mod.rms(sound, ref) <= limit < mod.rms(bad, ref)
