"""The chunk-list enumeration at a big grid's list width, and its counters, on
the CPU.

A grid of ``BIG_T`` tiles or more takes list width 8 (``_default_lmax``), and a
tile with more member chunks than that makes kernel B walk a residual
interval. ``BIG_T`` is patched down to 64 here, so that a 128x128 image (64
tiles) takes width 8, and 1300 active rows on a floor of 6 px² (radius ~8
px) give every tile more than 8 member chunks.

- ``fit_image`` on ``'list_t'`` there (kernel B's plain version, the
  residual intervals, kernel C's plain version) follows the benchmark's
  plain reference (``portbench/reference/train.py``) over its first three
  steps, with the tolerance of the reference's small-state test.
- The four device counters of ``member_lists`` (``utils/profiling.py``)
  equal a count of the same lists tile by tile, on random bboxes whose
  residual intervals hold chunks with no member row of their tile.
- Off, ``member_lists`` records nothing and runs the ATen operations of the
  enumeration alone, counted by a dispatch mode; on, it runs those first.
- The counts are tagged with the root of the span open around them.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gaussianimage_plus_tpu_torch.kernels import raster_list as rl
from gaussianimage_plus_tpu_torch.models.gaussian_image import (GaussianConfig, GaussianParams,
                                                                GaussianState)
from gaussianimage_plus_tpu_torch.train.trainer import TrainConfig, fit_image
from gaussianimage_plus_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
H = W = 128          # 8 x 8 tiles
N, M = 1300, 1400    # active rows, rows
FLOOR = 6.0          # the covariance floor (``bound``) of every row


@pytest.fixture(autouse=True)
def _big_grid(monkeypatch):
    monkeypatch.setattr(rl, "BIG_T", 64)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _fit_inputs():
    """A target rendered by the reference from a seeded state, and initial
    rows as the benchmark's fit draws them (means uniform, raw covariances
    uniform in [0, 1), colours zero), on a floor of ``FLOOR``."""
    from portbench.reference import render as R
    from portbench.reference import train as RT

    rng = np.random.default_rng(0)
    xyz = torch.tensor(rng.random((M, 2)) * [W, H], dtype=torch.float32)
    cov = torch.tensor(rng.random((M, 3)) * [30, 4, 30] + [2, -2, 2], dtype=torch.float32)
    feat = torch.tensor(rng.random((M, 3)) * 0.12, dtype=torch.float32)
    gt = R.to_8bit(R.render_state(xyz, cov, feat, torch.ones(M, dtype=torch.bool), H, W))
    g = torch.Generator().manual_seed(7)
    xy0 = torch.rand((M, 2), generator=g) * torch.tensor([float(W), float(H)])
    cov0 = torch.rand((M, 3), generator=g)
    bound = torch.tensor([FLOOR, 0.0, FLOOR]).expand(M, 3).contiguous()
    active = torch.arange(M) < N
    rows = RT.Rows(xy0, cov0, torch.zeros((M, 3)), active, bound)
    state = GaussianState(GaussianParams(xy0.clone(), cov0.clone(), torch.zeros((M, 3))),
                          active.clone(), bound.clone(), torch.tensor(N, dtype=torch.int32))
    return gt, rows, state


def _enumeration_inputs(state, cfg):
    from gaussianimage_plus_tpu_torch.models.gaussian_image import project

    proj = project(state.params, state.active, state.bound, cfg)
    return rl._table_bbox(proj, state.params.features, torch.ones((M, 1)), H, W, rl.KC_T)


def test_big_grid_first_steps_follow_the_reference():
    from portbench.reference import train as RT

    gt, rows, state = _fit_inputs()
    cfg = GaussianConfig(H=H, W=W, max_num_points=M, raster_backend="list_t")
    assert rl._default_lmax(H, W) == rl.LMAX_BIG
    table, bbox, n, Np = _enumeration_inputs(state, cfg)
    _, cnt, lo2, hi2 = rl.member_lists(table, bbox, n, Np, rl.KC_T, H, W)
    assert bool((hi2 > lo2).all()) and bool((cnt == rl.LMAX_BIG).all())
    res = fit_image(gt, cfg, TrainConfig(iterations=10, prune_iter=10, grow_iter=10), N,
                    gaussians=state, device="cpu")
    ref = RT.follow(rows, gt, 0.018, 2)
    got = res.history["loss"][:3].tolist()
    assert max(abs(a - b) / b for a, b in zip(got, ref)) < 1e-5
    assert got[0] > got[1] > got[2]


def _random_table(T_x=8, T_y=8, nch=12, kc=rl.KC_T, seed=0):
    """A table of ``nch`` chunks whose rows have random tile bboxes, a few of
    them wide, and a tenth of them invalid."""
    g = torch.Generator().manual_seed(seed)
    Np = nch * kc
    x0 = torch.randint(0, T_x, (Np,), generator=g).float()
    y0 = torch.randint(0, T_y, (Np,), generator=g).float()
    wide = torch.rand((Np,), generator=g) < 0.05
    w = torch.where(wide, torch.full((Np,), 6.0), torch.randint(1, 3, (Np,), generator=g).float())
    bbox = torch.stack([x0, (x0 + w).clamp(max=T_x), y0, (y0 + w).clamp(max=T_y)], -1)
    table = torch.zeros((Np, rl.COLS))
    table[:, rl.COLS - 1] = (torch.rand((Np,), generator=g) > 0.1).float()
    return table.contiguous(), bbox.contiguous(), Np


def _plain_counts(table, bbox, lists, kc, T_x, T_y):
    """The four counts tile by tile, from the rows' bboxes and the lists."""
    lst, cnt, lo2, hi2 = (a.tolist() for a in lists)
    valid = table[:, rl.COLS - 1] > 0
    lmax = len(lst[0])
    over = members = visited = 0
    for t in range(T_x * T_y):
        tx, ty = t % T_x, t // T_x
        inside = ((bbox[:, 0] <= tx) & (tx < bbox[:, 1]) & (bbox[:, 2] <= ty) &
                  (ty < bbox[:, 3]) & valid)
        mine = {int(r) // kc for r in inside.nonzero().flatten()}
        walked = set(lst[t][:cnt[t]]) | set(range(lo2[t], hi2[t]))
        assert mine <= walked
        over += len(mine) > lmax
        members += len(mine)
        visited += cnt[t] + hi2[t] - lo2[t]
    return {"lists.tiles": T_x * T_y, "lists.overflow_tiles": over,
            "lists.member_chunks": members, "lists.visited_chunks": visited}


@pytest.mark.parametrize("lmax", [8, 4])
def test_counters_equal_a_plain_count(lmax):
    table, bbox, Np = _random_table()
    with profiling.recording():
        lists = rl.member_lists(table, bbox, Np - 1, Np, rl.KC_T, H, W, lmax=lmax)
    got = profiling.device_counters()
    want = _plain_counts(table, bbox, lists, rl.KC_T, 8, 8)
    assert got == want
    # the lists overflow, and their residual intervals hold chunks of no member row
    assert want["lists.overflow_tiles"] > 0
    assert want["lists.visited_chunks"] > want["lists.member_chunks"]
    assert profiling.counters() == {}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_off_records_nothing_and_runs_the_enumeration_alone():
    table, bbox, Np = _random_table()
    args = (table, bbox, Np - 1, Np, rl.KC_T, H, W)
    with _Ops() as alone:
        member = rl._bbox_members(table, bbox, 8, 64)
        want = rl._chunk_lists(member, Np - 1, Np, rl.KC_T, rl.LMAX_BIG)
    with _Ops() as off:
        got = rl.member_lists(*args)
    assert off.ops == alone.ops
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert profiling.device_counters() == {} and profiling.spans() == []
    with profiling.recording(), _Ops() as on:
        rl.member_lists(*args)
    assert on.ops[:len(alone.ops)] == alone.ops and len(on.ops) > len(alone.ops)
    assert profiling.device_counters()["lists.tiles"] == 64


def test_counts_are_tagged_with_their_root():
    gt, _, state = _fit_inputs()
    cfg = GaussianConfig(H=H, W=W, max_num_points=M, raster_backend="list_t")
    with profiling.recording():
        with profiling.span("outside"):
            table, bbox, n, Np = _enumeration_inputs(state, cfg)
            rl.member_lists(table, bbox, n, Np, rl.KC_T, H, W)
        fit_image(gt, cfg, TrainConfig(iterations=3, prune_iter=3, grow_iter=3), N,
                  gaussians=state, device="cpu")
    roots = {s.name: s.id for s in profiling.spans() if s.parent == 0}
    assert set(roots) == {"outside", "fit"}
    outside = profiling.device_counters(roots["outside"])
    fit = profiling.device_counters(roots["fit"])
    assert outside["lists.tiles"] == 64 and fit["lists.tiles"] == 3 * 64
    assert outside["lists.overflow_tiles"] == 64
    total = profiling.device_counters()
    assert all(total[k] == outside[k] + fit[k] for k in total)
