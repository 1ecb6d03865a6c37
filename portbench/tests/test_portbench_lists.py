"""The readers of the program's chunk-list counters (``portbench/lists.py``,
``list_overflow.train`` and ``residual_waste.train``) on synthetic spans and
counters, against hand computations; and None where the program keeps no
device counters or counted nothing in the steady segment's eager chunk."""

from __future__ import annotations

import types
from pathlib import Path

import pytest

from portbench.cell import load_module

ROOT = Path(__file__).resolve().parents[2]
NAMES = ("list_overflow.train", "residual_waste.train")


def reader(name):
    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                       "test_metric_" + name.replace(".", "_"))


def S(name, id, parent, root, start_s, end_s):
    return types.SimpleNamespace(name=name, id=id, parent=parent, root=root,
                                 start_ns=round(start_s * 1e9), end_ns=round(end_s * 1e9))


SPANS = [
    S("fit.warm_chunk", 11, 10, 10, 30.1, 30.3),     # the profiled job's, under its fit root
    S("fit.capture", 12, 10, 10, 30.3, 31.5),
    S("fit", 10, 0, 10, 30.0, 35.0),
    S("fit.warm_chunk", 20, 0, 20, 40.0, 40.2),      # an older steady segment's
    S("fit.warm_chunk", 30, 0, 30, 50.0, 50.2),      # the steady segment's
    S("fit.capture", 31, 0, 31, 50.2, 51.0),
]
COUNTS = {
    10: {"lists.tiles": 1075200, "lists.overflow_tiles": 900000, "lists.member_chunks": 5e6,
         "lists.visited_chunks": 6e6},
    20: {"lists.tiles": 10, "lists.overflow_tiles": 10, "lists.member_chunks": 10,
         "lists.visited_chunks": 20},
    30: {"lists.tiles": 1075200, "lists.overflow_tiles": 268800, "lists.member_chunks": 3000000,
         "lists.visited_chunks": 3200000},
}


def program_with(spans=(), counts=None):
    """A stand-in for the port's ``utils.profiling`` holding these records."""
    counts = counts or {}

    def device_counters(root=None):
        return dict(counts.get(root, {}))

    return types.SimpleNamespace(spans=lambda: list(spans), counters=lambda: {},
                                 dropped=lambda: 0, device_counters=device_counters)


@pytest.fixture
def use(monkeypatch):
    from gaussianimage_plus_tpu_torch import utils

    return lambda mod: monkeypatch.setattr(utils, "profiling", mod, raising=False)


@pytest.mark.parametrize("name, want", [
    ("list_overflow.train", 100.0 * 268800 / 1075200),
    ("residual_waste.train", 100.0 * 200000 / 3200000)])
def test_readers_take_the_steady_segments_eager_chunk(use, name, want):
    use(program_with(SPANS, COUNTS))
    assert reader(name).read({"steady": {"steps": 300}}) == pytest.approx(want, rel=1e-9)


def test_no_waste_where_no_tile_overflows(use):
    use(program_with(SPANS, {30: {"lists.tiles": 153600, "lists.overflow_tiles": 0,
                                  "lists.member_chunks": 400000,
                                  "lists.visited_chunks": 400000}}))
    trace = {"steady": {"steps": 300}}
    assert reader("list_overflow.train").read(trace) == 0.0
    assert reader("residual_waste.train").read(trace) == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_none_where_the_program_counted_nothing(use, name):
    trace = {"steady": {"steps": 300}}
    parent = program_with(SPANS)
    del parent.device_counters                     # a profiling module without device counters
    use(parent)
    assert reader(name).read(trace) is None
    use(types.SimpleNamespace(trace=None))         # one without spans
    assert reader(name).read(trace) is None
    use(program_with(SPANS, {10: COUNTS[10]}))     # counts under the profiled job's root only
    assert reader(name).read(trace) is None
    use(program_with(SPANS[:3], COUNTS))           # no steady segment's eager chunk
    assert reader(name).read(trace) is None
    use(program_with(SPANS, COUNTS))
    assert reader(name).read({"jobs": 5}) is None  # no steady segment
