"""The port's spans and counters (``utils/profiling.py``) on the CPU, and one
case on the card.

- Off: a CPU ``decode_bitstream`` of a committed ``.gipb`` records no span
  and moves no counter.
- Under ``torch.profiler`` started and stopped as the benchmark's profiled
  stretches do: the decode records ``decode`` around ``decode.parse``
  (around each ``decode.entropy``), ``decode.dequantize`` and
  ``decode.render`` (around ``render.bin``); every span shares the root's id
  and nests in time inside its parent; ``decode.uploads`` is 14 on an LSQ
  stream and 16 on a VQ one (two codebooks).
- Clock: each span's profiler range agrees with its stored interval
  (median under 50 us, every span under 1 ms).
- The ring drops its oldest span past ``RING`` and counts the drop;
  ``recording()`` records with no profiler and opens no profiler range; a
  span that opened while recording was off stays unrecorded.
- A tiny CPU ``fit_image`` with one growth records ``fit`` around
  ``fit.grow``.
- The card (``-m cuda``): a graphed ``fit_image`` under the profiler records
  ``fit.warm_chunk`` and ``fit.capture`` once, under its ``fit`` root, its
  capture succeeds and its history equals an unprofiled fit's; the clock
  check holds there. A chunk of the 2K fit (2040x1344, 20,000 rows, list
  width 8, some tiles past it) captured with recording off and on: the eager
  chunk under recording counts every enumeration (``lists.*``), the
  captures count nothing, the two graphs launch the same kernels and replay
  to the same outputs, and a replay under recording counts nothing.

This file imports no JAX, so the card case runs on the card with
``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda``.
"""

import contextlib
import math
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream
from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
from gaussianimage_plus_tpu_torch.train import trainer as tr
from gaussianimage_plus_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
LSQ = ROOT / "results/bitstreams_r4/kodim01.gipb"
VQ = ROOT / "results/bitstreams_vq_r5/kodim01.gipb"
DECODE_TREE = [("decode", None), ("decode.parse", "decode"), ("decode.entropy", "decode.parse"),
               ("decode.entropy", "decode.parse"), ("decode.dequantize", "decode"),
               ("decode.render", "decode"), ("render.bin", "decode.render")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _profiled(fn, cuda=False):
    """``fn()`` under a profiler started and stopped as
    ``portbench/trace.py:profiled`` does; (its result, the profile)."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
    return out, prof


def _tree(spans):
    """(name, parent's name) of each span, in order of start."""
    by_id = {s.id: s for s in spans}
    return [(s.name, by_id[s.parent].name if s.parent else None)
            for s in sorted(spans, key=lambda s: s.start_ns)]


def _assert_nested(spans):
    root = [s for s in spans if s.parent == 0]
    assert len(root) == 1
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.root == root[0].id and s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)


def _clock_gaps_us(spans, prof):
    """Per span, the larger of the gaps between its stored start and end and
    its profiler range's, in us; spans and ranges paired by name in order of
    start."""
    names = {s.name for s in spans}
    ranges = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() in names and e.device_type() == torch.autograd.DeviceType.CPU),
                    key=lambda e: e.start_ns())
    gaps = []
    for name in names:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = [e for e in ranges if e.name() == name]
        assert len(mine) == len(theirs), name
        for s, e in zip(mine, theirs):
            gaps.append(max(abs(s.start_ns - e.start_ns()),
                            abs(s.end_ns - (e.start_ns() + e.duration_ns()))) / 1e3)
    return gaps


def test_decode_off_records_nothing():
    img, _ = decode_bitstream(LSQ.read_bytes(), device="cpu")
    assert img.shape == (512, 768, 3)
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.dropped() == 0


@pytest.mark.parametrize("stream, uploads", [(LSQ, 14), (VQ, 16)], ids=["lsq", "vq"])
def test_decode_spans_under_the_profiler(stream, uploads):
    _, prof = _profiled(lambda: decode_bitstream(stream.read_bytes(), device="cpu"))
    spans = profiling.spans()
    assert _tree(spans) == DECODE_TREE
    _assert_nested(spans)
    assert profiling.counters() == {"decode.uploads": uploads}
    gaps = _clock_gaps_us(spans, prof)
    assert len(gaps) == len(spans)
    assert statistics.median(gaps) < 50 and max(gaps) < 1000, gaps


def test_ring_drops_its_oldest_spans():
    extra = 5
    with profiling.recording():
        for i in range(profiling.RING + extra):
            with profiling.span(f"s{i}"):
                pass
    spans = profiling.spans()
    assert len(spans) == profiling.RING and profiling.dropped() == extra
    assert spans[0].name == f"s{extra}" and spans[-1].name == f"s{profiling.RING + extra - 1}"
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_recording_needs_no_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(profiling, "_range", lambda name: opened.append(name))
    outer = profiling.span("before")
    with outer:
        with profiling.recording():
            with profiling.span("a"):
                with profiling.span("b"):
                    profiling.count("n", 3)
            profiling.count("n")
    with profiling.span("after"):
        profiling.count("n")
    assert not torch._C._autograd._profiler_enabled()
    assert opened == []
    assert _tree(profiling.spans()) == [("a", None), ("b", "a")]
    assert profiling.counters() == {"n": 4}


def test_fit_records_fit_around_its_growth():
    H, W = 32, 48
    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=100)
    tcfg = tr.TrainConfig(iterations=20, prune_iter=10, grow_iter=10)
    gt = torch.as_tensor(np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32))
    with profiling.recording():
        res = tr.fit_image(gt, cfg, tcfg, 50, device="cpu")
    assert int(res.history["n_added"].sum()) > 0
    spans = profiling.spans()
    assert _tree(spans) == [("fit", None), ("fit.grow", "fit")]
    _assert_nested(spans)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_fit_spans_on_the_card(card):
    """A 200-step ``'auto'`` fit (kernels B and C, graphed) under the
    profiler: one warm-up chunk and one capture under the ``fit`` root, the
    same history as the fit without the profiler, and the clock check."""
    H = W = 256
    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=400)
    assert tr.captures(cfg, card)
    tcfg = tr.TrainConfig(iterations=200, grow_iter=100, prune_iter=50, lr=0.02)
    gt = torch.as_tensor(np.random.default_rng(31).uniform(0, 1, (H, W, 3)).astype(np.float32),
                         device=card)
    fit = lambda: tr.fit_image(gt, cfg, tcfg, 200, seed=5, device=card)
    plain = fit()
    assert profiling.spans() == []
    res, prof = _profiled(fit, cuda=True)
    for k in ("loss", "psnr", "num_active"):
        assert torch.equal(res.history[k], plain.history[k]), k
    spans = profiling.spans()
    assert _tree(spans) == [("fit", None), ("fit.warm_chunk", "fit"), ("fit.capture", "fit"),
                            ("fit.grow", "fit")]
    _assert_nested(spans)
    gaps = _clock_gaps_us(spans, prof)
    assert statistics.median(gaps) < 50 and max(gaps) < 1000, gaps
    # the profiler's device timeline holds none of the program's ranges
    names = {s.name for s in spans}
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name() in names and e.device_type() == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_graphed_2k_chunk_is_the_same_with_counters_on(card):
    H, W, M, n, steps = 1344, 2040, 20000, 10000, 10
    cfg = gi.GaussianConfig(H=H, W=W, max_num_points=M)
    assert tr.captures(cfg, card) and gi.resolve_backend(cfg, card) == "list_t"
    tcfg = tr.TrainConfig(iterations=steps, prune_iter=steps, grow_iter=steps)
    g = torch.Generator(device=card)
    g.manual_seed(11)
    lp = min(H * W / (9.0 * math.pi * n), 300.0)
    # the benchmark's initial rows, but a twentieth of them 4000 px² wide, so
    # that tiles have more than 8 member chunks and kernel B walks residual
    # intervals (on the benchmark's rows no tile has more than 7)
    cov = torch.rand((M, 3), generator=g, device=card)
    big = torch.rand((M, 1), generator=g, device=card) < 0.05
    state = gi.GaussianState(
        params=gi.GaussianParams(
            xyz=torch.rand((M, 2), generator=g, device=card) * torch.tensor([W, H], device=card),
            cov2d=torch.where(big, torch.tensor([4000.0, 0.0, 4000.0], device=card), cov),
            features=torch.zeros((M, 3), device=card)),
        active=torch.arange(M, device=card) < n,
        bound=torch.tensor([lp, 0.0, lp], device=card).expand(M, 3).contiguous(),
        num_active=torch.tensor(n, dtype=torch.int32, device=card))
    gt = torch.rand((H, W, 3), generator=g, device=card)
    runner = tr._fit_runner(gt, cfg, tcfg, steps, True)
    carry = (tr.init_train_state(cfg, tcfg, n, seed=5, gaussians=state),
             torch.zeros((H, W, 3), device=card))
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with profiling.recording(), torch.cuda.stream(side):
        runner.fn(tr._clone(carry))
    torch.cuda.current_stream(card).wait_stream(side)
    eager = profiling.device_counters()
    tiles = -(-W // 16) * -(-H // 16)
    assert eager["lists.tiles"] == steps * tiles
    assert 0 < eager["lists.overflow_tiles"] < steps * tiles
    assert eager["lists.visited_chunks"] > eager["lists.member_chunks"] > 0
    profiling.reset()
    outs, launches = {}, {}
    for on in (False, True):
        rec = profiling.recording if on else contextlib.nullcontext
        with rec():
            graph = tr.ChunkGraph(runner.fn, carry)
        graph.load(carry)
        with rec():
            graph.replay()
        torch.cuda.synchronize()
        assert profiling.device_counters() == {} and profiling.spans() == []
        outs[on] = tr._tensors((graph.carry(carry), graph.outs))
        launches[on] = graph._launches
    assert launches[True] == launches[False] and sum(launches[False]) > 0
    assert all(torch.equal(a, b) for a, b in zip(outs[False], outs[True], strict=True))
