"""The readers of the program's spans and counters (``portbench/program.py``
and the eight metrics that use it), on synthetic spans and a ``Profile``-like
stretch, against hand computations; and None where the program records
nothing, as a program without spans does."""

from __future__ import annotations

import types
from pathlib import Path

import pytest

from portbench import program
from portbench.cell import load_module

ROOT = Path(__file__).resolve().parents[2]
DECODE = ("entropy_ms.decode", "uploads.decode", "select_ms.decode", "parse_idle_ms.decode",
          "dispatch_idle_ms.decode")
FIT = ("warm_chunk_ms.train", "graph_capture_ms.train", "grow_ms.train")
MS = 1e-3


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                       "test_metric_" + name.replace(".", "_"))


def S(name, id, parent, root, start_s, end_s):
    return types.SimpleNamespace(name=name, id=id, parent=parent, root=root,
                                 start_ns=round(start_s * 1e9), end_ns=round(end_s * 1e9))


def program_with(spans=(), counters=None, dropped=0):
    """A stand-in for the port's ``utils.profiling`` holding these records."""
    return types.SimpleNamespace(spans=lambda: list(spans), counters=lambda: dict(counters or {}),
                                 dropped=lambda: dropped)


@pytest.fixture
def use(monkeypatch):
    from gaussianimage_plus_tpu_torch import utils

    return lambda mod: monkeypatch.setattr(utils, "profiling", mod, raising=False)


# a stretch of two frames from 1000.000 to 1000.100 s; the device busy in three stretches
STRETCH = {"frames": 2, "profile": types.SimpleNamespace(
    lo=1000.0, hi=1000.1,
    busy=[(1000.002, 1000.003), (1000.010, 1000.020), (1000.060, 1000.065)])}
T0 = 1000.0
DECODE_SPANS = [
    S("decode.entropy", 20, 0, 20, 999.0, 999.001),                 # before the stretch
    S("decode.entropy", 3, 2, 1, T0 + 0.0015, T0 + 0.0025),
    S("decode.entropy", 4, 2, 1, T0 + 0.003, T0 + 0.0035),
    S("decode.parse", 2, 1, 1, T0 + 0.001, T0 + 0.005),             # 1 ms of it busy
    S("decode.dequantize", 5, 1, 1, T0 + 0.005, T0 + 0.008),
    S("render.bin", 7, 6, 1, T0 + 0.009, T0 + 0.011),
    S("decode.render", 6, 1, 1, T0 + 0.008, T0 + 0.030),            # 10 ms of it busy
    S("decode", 1, 0, 1, T0 + 0.001, T0 + 0.040),
    S("decode.entropy", 10, 9, 8, T0 + 0.051, T0 + 0.052),
    S("decode.parse", 9, 8, 8, T0 + 0.050, T0 + 0.055),
    S("decode.dequantize", 11, 8, 8, T0 + 0.055, T0 + 0.058),
    S("render.bin", 13, 12, 8, T0 + 0.059, T0 + 0.060),
    S("decode.render", 12, 8, 8, T0 + 0.058, T0 + 0.070),           # 5 ms of it busy
    S("decode", 8, 0, 8, T0 + 0.050, T0 + 0.090),
    S("render.bin", 14, 0, 14, T0 + 0.080, T0 + 0.081),             # no decode root
    S("decode.parse", 30, 0, 30, T0 + 0.095, T0 + 0.105),           # clipped at the end
]
FIT_SPANS = [
    S("fit.warm_chunk", 2, 1, 1, 10.0, 10.5),
    S("fit", 1, 0, 1, 10.0, 20.0),
    S("fit.warm_chunk", 11, 10, 10, 30.1, 30.3),
    S("fit.capture", 12, 10, 10, 30.3, 31.5),
    S("fit.grow", 13, 10, 10, 35.0, 35.04),
    S("fit.grow", 14, 10, 10, 40.0, 40.05),
    S("fit", 10, 0, 10, 30.0, 45.0),
    S("fit.warm_chunk", 20, 0, 20, 50.0, 50.2),                       # the steady segment's
    S("fit.capture", 21, 0, 21, 50.2, 51.0),
]


@pytest.mark.parametrize("name, want", [
    ("entropy_ms.decode", (1 + 0.5 + 1) / 2),
    ("uploads.decode", 30 / 2),
    ("select_ms.decode", (2 + 1) / 2),
    ("parse_idle_ms.decode", (3 + 5 + 5) / 2),
    ("dispatch_idle_ms.decode", ((3 + 12) + (3 + 7)) / 2),
])
def test_decode_readers_by_hand(use, name, want):
    use(program_with(DECODE_SPANS, {"decode.uploads": 30}))
    assert reader(name).read({"stretch": STRETCH}) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name, want", [
    ("warm_chunk_ms.train", 200.0), ("graph_capture_ms.train", 1200.0), ("grow_ms.train", 40.0)])
def test_fit_readers_take_the_last_fit_root(use, name, want):
    use(program_with(FIT_SPANS))
    assert reader(name).read({"jobs": 5}) == pytest.approx(want, rel=1e-6)


def test_idle_counts_busy_stretches_across_spans():
    prof = types.SimpleNamespace(lo=0.0, hi=10.0, busy=[(0.5, 1.5), (2.5, 6.0), (7.0, 8.0)])
    # the union [1, 3] + [4, 5] + [5.5, 9]: 6.5 s, of which busy 0.5 + 0.5 + 1 + 0.5 + 1
    assert program.idle_s(prof, [(4.0, 5.0), (1.0, 3.0), (5.5, 9.0), (2.0, 2.2)]) == \
        pytest.approx(6.5 - 3.5)


@pytest.mark.parametrize("name", DECODE + FIT)
def test_none_without_the_programs_spans(use, name):
    trace = {"stretch": STRETCH, "jobs": 5}
    parent = types.SimpleNamespace(trace=None)     # a profiling module with no spans
    use(parent)
    assert reader(name).read(trace) is None
    use(program_with())                            # spans, but none recorded
    assert reader(name).read(trace) is None
    use(program_with(DECODE_SPANS if name in FIT else FIT_SPANS))   # the other cell's spans
    assert reader(name).read(trace) is None
    if name in DECODE:
        use(program_with(DECODE_SPANS, {"decode.uploads": 30}))
        assert reader(name).read({"jobs": 5}) is None               # no profiled stretch


def test_a_ring_that_dropped_spans_of_the_stretch_raises(use):
    use(program_with(DECODE_SPANS[5:], dropped=7))
    with pytest.raises(RuntimeError, match="dropped 7"):
        reader("entropy_ms.decode").read({"stretch": STRETCH})
    use(program_with(DECODE_SPANS, dropped=7))    # the dropped ones are older than the stretch
    assert reader("entropy_ms.decode").read({"stretch": STRETCH}) == pytest.approx(1.25)
