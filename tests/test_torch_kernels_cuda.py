"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Kernel A (``tile_table_forward``), kernel B (``chunk_list_forward``),
kernel C (``chunk_backward``), kernel D (``tile_table_backward``) and kernel
E (``tile_bin``) on synthetic scenes made with numpy from a seed: a small odd
tile grid, a crowded tile that overflows a small cap, and a Kodak-size
768x512 scene.
Every test is marked ``cuda`` and skips without a card. This file imports no
JAX, so it also runs on a machine with PyTorch alone::

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerance atol 2e-5, rtol 1e-5 at every pixel but at most 0.01% of them: the
kernels and their plain versions evaluate sigma in the same fused-multiply-add
order, and differ only where an ``exp`` or the colour sums round across the
sigma >= 0 or alpha >= 1/255 gate. Kernel C: per payload column, max
|kernel - plain| <= 1e-4 max |plain| (the gate is bit-equal; the sums over
pixels and tiles run in another order), and two launches give the same bits.
Kernel D: the same, per column of its [N, 9] output. Kernel E: ids and counts
equal the plain version's exactly.
"""

import numpy as np
import pytest
import torch

from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.core.gaussian2d import project_gaussians_2d_covariance
from gaussianimage_plus_tpu_torch.kernels import binning_tiles, raster_binned, raster_list

ATOL, RTOL, MAX_FRAC = 2e-5, 1e-5, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene(n, H, W, seed, crowd=0):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    xy[:crowd] = 12.0
    a, c = rng.uniform(2.0, 60.0, n), rng.uniform(2.0, 60.0, n)
    b = rng.uniform(-0.8, 0.8, n) * np.sqrt(a * c)
    cov = np.stack([a, b, c], -1).astype(np.float32)
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SCENES))
def test_tile_table_forward_matches_plain(card, case):
    kw = dict(SCENES[case])
    cap = kw.pop("cap")
    proj, colors, opacity = _scene(**kw)
    H, W = kw["H"], kw["W"]
    bins = bin_gaussians(proj, H, W, cap=cap)
    raw, counts = raster_binned._prepare(proj.xys, proj.conics, colors, opacity,
                                         bins.ids, bins.mask)
    ref = raster_binned.tile_table_forward_plain(raw, counts, H, W)
    before = raster_binned.tile_table_forward.launches
    out = raster_binned.tile_table_forward(raw.to(card), counts.to(card), H, W)
    assert raster_binned.tile_table_forward.launches == before + 1
    _close(out, ref, f"kernel A {case}")


@pytest.mark.cuda
@pytest.mark.parametrize("kc,lmax", [(128, 16), (64, 16), (64, 1)])
@pytest.mark.parametrize("case", ["odd-grid", "kodak-size"])
def test_chunk_list_forward_matches_plain(card, case, kc, lmax):
    kw = dict(SCENES[case])
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
    raw = torch.zeros((15, 8, 16), device=card)
    counts = torch.zeros(15, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):        # on two devices
        raster_binned.tile_table_forward(raw, counts.cpu(), 48, 80)
    with pytest.raises(ValueError):        # not contiguous
        raster_binned.tile_table_forward(raw.transpose(1, 2).contiguous().transpose(1, 2),
                                         counts, 48, 80)
    with pytest.raises(TypeError):
        raster_binned.tile_table_forward(raw.double(), counts, 48, 80)


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
@pytest.mark.parametrize("case", ["odd-grid", "kodak-size"])
def test_chunk_backward_matches_plain(card, case, kc):
    kw = dict(SCENES[case])
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
    raw, counts = raster_binned._prepare(proj.xys, proj.conics, colors, opacity,
                                         bins.ids, bins.mask)
    ids = raster_binned._slot_ids(bins.ids, bins.mask, N).to(torch.int32)
    tb = (-(-W // 16), -(-H // 16))
    bbox = raster_binned.tile_bbox_table(proj.xys, proj.radii, tb)
    v_img = torch.as_tensor(np.random.default_rng(N).normal(size=(H, W, 3)).astype(np.float32))
    return [a.contiguous().to(dev) for a in (raw, counts, ids, bbox, v_img)]


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
