"""The port's tracing: spans and counters where the work happens, and a
profiler trace.

- ``span(name)`` brackets a stretch of host work. While recording is on it
  stores a ``Span``: its name, its id, the id of the span open around it
  (its parent, 0 for none) and of the outermost one (its root: every span of
  one decode request or one fit job shares the root's id), and its start and
  end in ``time.time_ns()``, the clock of the torch profiler's events. The
  spans sit in a ring of ``RING`` entries that drops its oldest past that
  and counts the drops.
- ``count(name, n)`` adds to a host integer counter while recording is on.
- ``count_device(name, value)`` adds a device scalar to a device counter,
  tagged with the root of the innermost open span (0 outside any), while
  ``counting()``: recording is on and no CUDA stream is being captured. A
  caller computes what it counts only when ``counting()`` holds, so that,
  off or under a capture, its device work is what it would be without the
  count, and a graph captures no node of it. The sums stay on the device;
  ``device_counters()`` reads them to host integers, a sync, for readers
  after the work.
- Recording is on while a torch profiler records, and inside
  ``recording()``, which needs no profiler. Whether a span records is
  decided when it opens. Off, a span costs a flag check and a shared null
  context, and records and allocates nothing.
- While a profiler records, a span also opens a profiler range of its name,
  so that it shows in the trace beside the device's operations. The range is
  function-scoped (``torch._C._profiler._RecordFunctionFast``): a
  ``torch.profiler.record_function`` range is user-scoped, and the profiler
  mirrors those on the device's timeline as device intervals, which a
  reader of device busy time would count as device work.
- A span never synchronises with the device and never launches device work,
  so spans may open while a CUDA graph is being captured.
- ``spans()``, ``counters()``, ``device_counters()`` and ``dropped()``
  return copies for readers;
  ``reset()`` empties the registry.
- ``trace(log_dir)`` writes a Chrome trace with ``torch.profiler`` (device
  activity included when there is a card): the program's spans are ranges
  in it, and its ``launches`` entry holds each kernel wrapper's launches in
  the block.

The spans and counters the port records (where, and what reads them:
``PERF.md`` section 3):

- ``decode``: ``compress.bitstream.decode_bitstream``, the root of a decode;
- ``decode.parse``: ``deserialize_bitstream``, whole;
- ``decode.entropy``: ``compress.entropy.decode_rans``, each rANS decode;
- counter ``decode.uploads``: tensors ``deserialize_bitstream`` makes from
  host arrays, one host-to-device copy each on the card;
- ``decode.dequantize`` and ``decode.render``: ``compress.pipeline
  .decompress_wo_ec``, its dequantization and its render; on the card the
  binned decode is one ``decode.render`` around the copy of its input into
  the graph's buffers and the replay, with no ``decode.dequantize``;
- counters ``decode.graph_captures`` and ``decode.graph_replays``:
  ``compress.pipeline.decompress_wo_ec``'s binned decodes that captured a
  CUDA graph (a key's first call, run eagerly) and that replayed one;
- ``render.bin``: the binning in ``models.gaussian_image.render`` when no
  gradient flows through the render (a decode, an evaluation; no training
  step), where it runs eagerly: a graph replay records none;
- ``fit``: ``train.trainer.fit_image``, whole, the root of a fit;
- ``fit.warm_chunk`` and ``fit.capture``: ``ChunkRunner.run``'s eager chunk
  before the capture and its ``ChunkGraph`` construction;
- ``fit.grow``: ``train.trainer._grow_ts``, a growth;
- device counters ``lists.tiles``, ``lists.overflow_tiles``,
  ``lists.member_chunks`` and ``lists.visited_chunks``: per enumeration of
  ``kernels.raster_list.member_lists``, the tiles, those whose member chunks
  exceed the list width, the member chunks, and the chunks kernel B visits
  (the listed ones and the residual interval);
- device counter ``lists.kernel_tiles``: ``kernels.raster_list.chunk_lists``'
  tiles, per enumeration that ran kernel F (none on the plain path).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

RING = 1 << 16

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    id: int
    parent: int
    root: int
    start_ns: int
    end_ns: int


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        # plain tuples of a str and ints, which the garbage collector stops
        # tracking, unlike a NamedTuple's instances; ``spans()`` makes ``Span``s
        self.ring: Deque[tuple] = deque(maxlen=RING)
        self.dropped = 0
        self.counters: Dict[str, int] = {}
        # (name, root) -> a device scalar or an int, summed where it was counted
        self.device: Dict[Tuple[str, int], Union[torch.Tensor, int]] = {}
        self.forced = 0
        self.ids = itertools.count(1)
        self.local = threading.local()

    def open(self) -> list:
        """This thread's stack of open recording spans."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, s: tuple) -> None:
        with self.lock:
            if len(self.ring) == RING:
                self.dropped += 1
            self.ring.append(s)


_REG = _Registry()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _REG.open()
        self.id = next(_REG.ids)
        self.parent, self.root = (stack[-1].id, stack[-1].root) if stack else (0, self.id)
        self.range = _range(self.name) if _profiling() else None
        if self.range is not None:
            self.range.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _REG.open().pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _REG.add((self.name, self.id, self.parent, self.root, self.start, end))
        return False


def span(name: str):
    """A context manager that records a span ``name`` while recording is on
    (module docstring)."""
    if not (_REG.forced or _profiling()):
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _REG.forced or _profiling():
        with _REG.lock:
            _REG.counters[name] = _REG.counters.get(name, 0) + n


def counting() -> bool:
    """Whether ``count_device`` records now: recording is on and no CUDA
    stream is being captured."""
    if not (_REG.forced or _profiling()):
        return False
    return not (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())


def count_device(name: str, value: Union[torch.Tensor, int]) -> None:
    """Add ``value``, a device scalar or an int, to the device counter
    ``name`` under the root of the innermost open span, while
    ``counting()``. The addition runs on the device: nothing is read."""
    if not counting():
        return
    stack = _REG.open()
    key = (name, stack[-1].root if stack else 0)
    with _REG.lock:
        prev = _REG.device.get(key)
        _REG.device[key] = value if prev is None else prev + value


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with no profiler and no
    profiler ranges."""
    with _REG.lock:
        _REG.forced += 1
    try:
        yield
    finally:
        with _REG.lock:
            _REG.forced -= 1


def spans() -> List[Span]:
    """The recorded spans, oldest first, in the order they closed."""
    with _REG.lock:
        ring = list(_REG.ring)
    return [Span(*s) for s in ring]


def counters() -> Dict[str, int]:
    with _REG.lock:
        return dict(_REG.counters)


def device_counters(root: Optional[int] = None) -> Dict[str, int]:
    """The device counters as host integers, summed over roots, or only
    those under the span ``root``. It waits for the device: a reader calls
    it after the work."""
    with _REG.lock:
        items = list(_REG.device.items())
    if any(isinstance(v, torch.Tensor) and v.is_cuda for _, v in items):
        torch.cuda.synchronize()
    out: Dict[str, int] = {}
    for (name, r), v in items:
        if root is None or r == root:
            out[name] = out.get(name, 0) + int(v)
    return out


def dropped() -> int:
    """Spans the ring has dropped, oldest first, to stay at ``RING``."""
    return _REG.dropped


def reset() -> None:
    """Forget every recorded span, counter and drop."""
    with _REG.lock:
        _REG.ring.clear()
        _REG.counters.clear()
        _REG.device.clear()
        _REG.dropped = 0


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; writes ``<log_dir>/trace.json``
    (Chrome trace, viewable in Perfetto; the program's spans are ranges in
    it, ``launches`` each kernel wrapper's launches in the block) and yields
    its path."""
    from torch.profiler import ProfilerActivity, profile

    from .. import kernels

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    before = [k.launches for k in kernels.wrappers()]
    with profile(activities=activities) as prof:
        yield path
        prof.add_metadata_json("launches", json.dumps(
            {k.__name__: k.launches - b for k, b in zip(kernels.wrappers(), before)}))
    prof.export_chrome_trace(path)
