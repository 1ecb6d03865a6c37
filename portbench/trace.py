"""Spans, CUDA-event timers and the reduction of a profiler trace.

Spans are recorded by the benchmark around calls into the port's modules:
``Tracer.wrap`` replaces a function or method of a port module by a wrapper
for the traced run only, and ``Tracer.restore`` puts every original back.
A span's time is the host clock (with ``sync`` it ends after the device has
finished the call's work); inside a profiled stretch each span is also a
``torch.profiler.record_function`` annotation, so that idle gaps on the
device can be named by the span that was open on the host.

``Profile`` reads a ``torch.profiler`` trace: the device operations by name,
the union of their intervals (``busy_s``: a sum of events can exceed the
window, a union cannot), and the idle gaps between them.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self._saved: List[Tuple[object, str, object]] = []
        self.annotate = False

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        ctx = (torch.profiler.record_function("pb:" + name) if self.annotate
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            try:
                yield
            finally:
                if sync:
                    self._sync()
                self.spans[name].append(time.perf_counter() - t0)

    def wrap(self, owner, attr: str, name: str, sync: bool = False,
             around: Optional[Callable] = None) -> bool:
        """Record a span ``name`` around every call of ``owner.attr``;
        ``around(fn, *args, **kw)`` replaces the plain call. Returns False,
        and wraps nothing, where the program has no such function."""
        orig = getattr(owner, attr, None)
        if orig is None:
            return False
        tracer = self

        def wrapper(*args, **kw):
            with tracer.span(name, sync):
                return around(orig, *args, **kw) if around else orig(*args, **kw)

        self._saved.append((owner, attr, orig))
        setattr(owner, attr, wrapper)
        return True

    def restore(self) -> None:
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)


class EventTimer:
    """CUDA events around calls, read after the run: no sync between calls."""

    def __init__(self):
        self.pairs: List[Tuple[torch.cuda.Event, torch.cuda.Event, int]] = []

    @contextlib.contextmanager
    def time(self, weight: int = 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.pairs.append((start, end, weight))

    def read(self) -> Tuple[float, int]:
        """(total ms, total weight)."""
        ms = weight = 0
        for s, e, w in self.pairs:
            e.synchronize()
            ms += s.elapsed_time(e)
            weight += w
        return ms, weight


class Interval(NamedTuple):
    name: str
    start: float   # seconds, on the trace's clock
    end: float


def _events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, host annotations) of a finished profile."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        iv = Interval(e.name(), start, start + e.duration_ns() * 1e-9)
        if e.name().startswith("pb:"):
            # an annotation; the profiler mirrors it on the device's timeline too
            if e.device_type() != DeviceType.CUDA:
                host.append(iv)
        elif e.device_type() == DeviceType.CUDA:
            dev.append(iv)
    return dev, host


def union(ivs: List[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for iv in sorted(ivs, key=lambda i: i.start):
        s, e = max(iv.start, lo), min(iv.end, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Profile:
    """A profiled stretch: its window is the host annotation ``pb:window``."""

    def __init__(self, prof, after: Optional[str] = None):
        t0 = time.perf_counter()
        dev, host = _events(prof)
        windows = [h for h in host if h.name == "pb:window"]
        if not windows:
            raise RuntimeError("the profile holds no pb:window annotation")
        self.lo, self.hi = windows[0].start, windows[0].end
        if after is not None:
            marks = [h.end for h in host if h.name == after]
            if marks:
                self.lo = max(marks)
        self.dev = [d for d in dev if d.end > self.lo and d.start < self.hi]
        self.host = [h for h in host if h.name != "pb:window"]
        self.busy = union(self.dev, self.lo, self.hi)
        self._by_name: Optional[Dict[str, Tuple[float, int]]] = None
        print(f"portbench: a profile of {len(dev)} device operations read in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy)

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """Device seconds and calls of each operation name."""
        if self._by_name is None:
            out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
            for d in self.dev:
                out[d.name][0] += d.end - d.start
                out[d.name][1] += 1
            self._by_name = {k: (v[0], v[1]) for k, v in out.items()}
        return self._by_name

    def seconds_of(self, names) -> Tuple[float, int]:
        """Device seconds and calls of the operations whose name holds any
        of ``names``."""
        s = n = 0
        for k, (t, c) in self.by_name().items():
            if any(x in k for x in names):
                s += t
                n += c
        return s, n

    def gaps(self, named: int = 2000) -> List[Tuple[str, float]]:
        """Idle stretches of the device. The ``named`` longest are each named
        by the innermost harness span open on the host at its middle; the
        rest, shorter, are summed under ``between launches``."""
        edges = [self.lo] + [x for se in self.busy for x in se] + [self.hi]
        gaps = sorted(((e - s, s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s),
                      reverse=True)
        out = []
        for length, s, e in gaps[:named]:
            mid = 0.5 * (s + e)
            open_ = [h for h in self.host if h.start <= mid <= h.end]
            name = min(open_, key=lambda h: h.end - h.start).name[3:] if open_ else "host"
            out.append((name, length))
        rest = sum(g[0] for g in gaps[named:])
        if rest:
            out.append(("between launches", rest))
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((k, v[0]) for k, v in self.by_name().items()), key=lambda r: -r[1])
        gaps: Dict[str, float] = defaultdict(float)
        for name, s in self.gaps():
            gaps[name] += s
        idle = sorted(gaps.items(), key=lambda r: -r[1])
        return {"device_ops": [[k, v] for k, v in ops[:top]],
                "idle_gaps": [[k, v] for k, v in idle[:top]]}


@contextlib.contextmanager
def profiled(until=None):
    """Profile the block; yields a holder whose ``prof`` is set on exit.
    ``until=(owner, attr)`` stops the profile when the first call of
    ``owner.attr`` inside the block returns."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Held", (), {})()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = torch.profiler.record_function("pb:window")
    state = {"on": True}

    def stop():
        if state["on"]:
            state["on"] = False
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            window.__exit__(None, None, None)
            t0 = time.perf_counter()
            prof.stop()
            print(f"portbench: the profiler stopped in {time.perf_counter() - t0:.1f} s",
                  file=sys.stderr)

    saved = None
    if until is not None:
        owner, attr = until
        saved = getattr(owner, attr)

        def hook(*a, **kw):
            out = saved(*a, **kw)
            stop()
            return out

        setattr(owner, attr, hook)
    prof.start()
    window.__enter__()
    try:
        yield holder
    finally:
        stop()
        if saved is not None:
            setattr(until[0], until[1], saved)
    holder.prof = prof


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile (0..1) by linear interpolation between order
    statistics."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    i = int(pos)
    j = min(i + 1, len(xs) - 1)
    return xs[i] + (xs[j] - xs[i]) * (pos - i)


def mean(values: List[float]) -> float:
    return statistics.fmean(values)
