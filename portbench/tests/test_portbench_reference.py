"""The plain reference against the port on the CPU, and the counts by hand.

Run: ``python -m pytest portbench/tests -m 'not cuda'`` from the repository root.
"""

from __future__ import annotations

import itertools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import counts as C
from portbench.reference import gipb
from portbench.reference import render as R
from portbench.reference import train as RT

ROOT = Path(__file__).resolve().parents[2]
STREAMS = sorted(ROOT.glob("results/bitstreams_r3/*.gipb")) + \
    sorted(ROOT.glob("results/bitstreams_r4/*.gipb")) + \
    sorted(ROOT.glob("results/bitstreams_vq_r5/*.gipb"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(H=64, W=96, M=160, seed=0, active=150):
    rng = np.random.default_rng(seed)
    xyz = torch.tensor(rng.random((M, 2)) * [W, H], dtype=torch.float32)
    cov = torch.tensor(rng.random((M, 3)) * [30, 4, 30] - [0, 2, 0], dtype=torch.float32)
    cov = cov + torch.tensor([2.0, 0.0, 2.0])
    feat = torch.tensor(rng.random((M, 3)) * 0.6, dtype=torch.float32)
    return xyz, cov, feat, torch.arange(M) < active


def test_streams_decode_to_the_ports_attributes():
    from gaussianimage_plus_tpu_torch.compress import bitstream, pipeline

    assert len(STREAMS) == 50
    for f in STREAMS:
        buf = f.read_bytes()
        ref = gipb.decode(buf)
        dec = bitstream.deserialize_bitstream(buf, device="cpu")
        xy, cov, col = pipeline._decode_attributes(dec.bundle, dec.enc, dec.qcfg)
        n = ref.xy.shape[0]
        assert int(dec.enc.num_active) == n and (dec.H, dec.W) == (ref.H, ref.W)
        np.testing.assert_array_equal(xy[:n].numpy(), ref.xy)
        np.testing.assert_array_equal(cov[:n].numpy(), ref.cov)
        np.testing.assert_array_equal(col[:n].numpy(), ref.colors)


@pytest.mark.parametrize("name", ["bitstreams_r3/kodim05.gipb", "bitstreams_vq_r5/kodim02.gipb"])
def test_stream_renders_as_the_ports_cpu_decode(name):
    from gaussianimage_plus_tpu_torch.compress import bitstream

    buf = (ROOT / "results" / name).read_bytes()
    g = gipb.decode(buf)
    ref = R.render_state(torch.tensor(g.xy), torch.tensor(g.cov), torch.tensor(g.colors),
                         torch.ones(len(g.xy), dtype=torch.bool), g.H, g.W, g.cap)
    img, _ = bitstream.decode_bitstream(buf, device="cpu")
    assert float(torch.sqrt(torch.mean((img - ref) ** 2))) < 1e-5


@pytest.mark.parametrize("cap", [256, 6])
def test_small_state_renders_as_the_ports_xla_path(cap):
    from gaussianimage_plus_tpu_torch.models.gaussian_image import (GaussianConfig,
                                                                    GaussianParams,
                                                                    GaussianState, render)

    H, W = 64, 96
    xyz, cov, feat, active = _state(H, W)
    cfg = GaussianConfig(H=H, W=W, max_num_points=len(xyz), tile_cap=cap,
                         raster_backend="xla", bin_method="top_k")
    st = GaussianState(GaussianParams(xyz, cov, feat), active, torch.zeros_like(cov),
                       torch.tensor(int(active.sum()), dtype=torch.int32))
    prog = render(st, cfg)
    ref = R.render_state(xyz, cov, feat, active, H, W, cap=cap)
    assert float(torch.sqrt(torch.mean((prog - ref) ** 2))) < 1e-6
    if cap == 6:   # the cap binds somewhere, so the rule is exercised
        assert not torch.equal(ref, R.render_state(xyz, cov, feat, active, H, W))


def _fit_setup(n=120, M=200, H=64, W=96):
    from gaussianimage_plus_tpu_torch.models.gaussian_image import (GaussianParams,
                                                                    GaussianState)

    xyz, cov, feat, active = _state(H, W, M, seed=1, active=M)
    gt = R.to_8bit(R.render_state(xyz, cov, feat, active, H, W))
    g = torch.Generator().manual_seed(7)
    xy0 = torch.rand((M, 2), generator=g) * torch.tensor([float(W), float(H)])
    cov0 = torch.rand((M, 3), generator=g)
    lp = min(H * W / (9 * math.pi * n), 300.0)
    bound = torch.tensor([lp, 0.0, lp]).expand(M, 3).contiguous()
    act0 = torch.arange(M) < n
    rows = RT.Rows(xy0, cov0, torch.zeros((M, 3)), act0, bound)
    st = GaussianState(GaussianParams(xy0.clone(), cov0.clone(), torch.zeros((M, 3))),
                       act0.clone(), bound.clone(), torch.tensor(n, dtype=torch.int32))
    return gt, rows, st


def test_first_steps_follow_the_ports_fit():
    from gaussianimage_plus_tpu_torch.models.gaussian_image import GaussianConfig
    from gaussianimage_plus_tpu_torch.train.trainer import TrainConfig, fit_image

    gt, rows, st = _fit_setup()
    H, W, M = gt.shape[0], gt.shape[1], rows.xyz.shape[0]
    res = fit_image(gt, GaussianConfig(H=H, W=W, max_num_points=M),
                    TrainConfig(iterations=100, prune_iter=100, grow_iter=100), 120,
                    gaussians=st, device="cpu")
    ref = RT.follow(rows, gt, 0.018, 2)
    got = res.history["loss"][:3].tolist()
    assert max(abs(a - b) / b for a, b in zip(got, ref)) < 1e-5
    assert got[0] > got[1] > got[2]


def test_reference_follows_a_fit_from_its_handed_on_carry():
    """From the carry the first chunk hands on (rows after its prune, Adam's
    count and moments), the reference's losses are the fit's at steps
    c + 1 to c + 4, and from a carry with zero moments they are not."""
    from gaussianimage_plus_tpu_torch.models.gaussian_image import GaussianConfig
    from gaussianimage_plus_tpu_torch.train.trainer import TrainConfig, fit_image

    from portbench.cell import load_module

    fit = load_module(ROOT / "portbench/kinds/fit.py", "kind_fit_test")
    gt, rows, st = _fit_setup()
    H, W, M = gt.shape[0], gt.shape[1], rows.xyz.shape[0]
    tcfg = TrainConfig(iterations=200, prune_iter=100, grow_iter=1000)
    with fit.carries() as got:
        res = fit_image(gt, GaussianConfig(H=H, W=W, max_num_points=M), tcfg, 120,
                        gaussians=st, device="cpu")
    assert len(got) == 1 and int(got[0].adam[0]) == 100
    losses = res.history["loss"][100:104].tolist()
    assert max(fit.replay_gaps(got[0], gt, tcfg, losses)) < 1e-5
    zero = got[0]._replace(adam=(got[0].adam[0], *[tuple(torch.zeros_like(m) for m in ms)
                                                   for ms in got[0].adam[1:]]))
    assert max(fit.replay_gaps(zero, gt, tcfg, losses)) > 1e-3
    assert max(fit.replay_gaps(None, gt, tcfg, losses)) == math.inf


def _brute_pairs(xy, cov, colors, H, W, cap=None):
    """Pairs within the radius and passing the gate, one by one."""
    p = R.project(xy, cov, torch.ones(len(xy), dtype=torch.bool), H, W)
    members = {}
    pairs = passing = 0
    for n in range(len(xy)):
        if not p.valid[n]:
            continue
        x0, x1, y0, y1 = p.rect[n].tolist()
        for ty, tx in itertools.product(range(y0, y1), range(x0, x1)):
            members.setdefault((ty, tx), []).append(n)
    for (ty, tx), rows in members.items():
        for n in (rows if cap is None else rows[:cap]):
            mx, my = p.xy[n].tolist()
            r = float(p.radius[n])
            c1, c2, c3 = p.conic[n].tolist()
            for y in range(ty * 16, min(ty * 16 + 16, H)):
                for x in range(tx * 16, min(tx * 16 + 16, W)):
                    if abs(x - mx) > r or abs(y - my) > r:
                        continue
                    pairs += 1
                    dx, dy = mx - x, my - y
                    s = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy
                    if s >= 0 and min(1.0, math.exp(-s)) >= 1 / 255:
                        passing += 1
    return pairs, passing


@pytest.mark.parametrize("rows,cap", [
    ([(20.0, 10.0, 4.0, 0.0, 4.0)], None),
    ([(20.0, 10.0, 4.0, 1.0, 9.0), (40.5, 30.25, 16.0, -3.0, 2.0)], None),
    ([(8.0, 8.0, 9.0, 0.0, 9.0), (10.0, 9.0, 9.0, 0.0, 9.0), (9.0, 7.0, 4.0, 0.5, 4.0)], 1),
])
def test_counts_are_exact_on_hand_made_states(rows, cap):
    H, W = 48, 64
    t = torch.tensor(rows, dtype=torch.float32)
    xy, cov = t[:, :2], t[:, 2:]
    colors = torch.full((len(rows), 3), 0.5)
    p = R.project(xy, cov, torch.ones(len(rows), dtype=torch.bool), H, W)
    got = C.pairs(p, H, W, cap)
    pairs, passing = _brute_pairs(xy, cov, colors, H, W, cap)
    assert (got.pairs, got.passing, got.rows, got.pixels) == (pairs, passing, len(rows), H * W)
    ops, nbytes = C.forward(got)
    assert ops == pairs * C.SIGMA + passing * C.BLEND
    assert nbytes == len(rows) * 48 + H * W * 12
    if len(rows) == 1:   # variance 4, the discriminant floored at 0.1: radius 7
        assert pairs == 15 * 15


def test_rans_normalization_keeps_every_symbol():
    freq, cum = gipb.normalize(np.array([1, 1, 70000, 3, 0, 5]))
    assert int(freq.sum()) == gipb.PROB_SCALE and int(cum[-1]) == gipb.PROB_SCALE
    assert all(f >= 1 for f, c in zip(freq, [1, 1, 70000, 3, 0, 5]) if c)
    assert freq[4] == 0
