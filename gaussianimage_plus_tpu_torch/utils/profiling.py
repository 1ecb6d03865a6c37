"""Timing brackets and a profiler trace.

Port of ``gaussianimage_plus_tpu/utils/profiling.py`` (``sync``, ``Timer``,
``time_fn``, ``trace``); the reference brackets its training and its
100-render FPS loops with ``torch.cuda.synchronize`` (train.py:126-155,
:183-187). On the card ``sync`` is ``torch.cuda.synchronize`` on the
tensor's device and ``time_fn`` times with CUDA events; on the CPU work
is done when the call returns, so ``sync`` does nothing and ``time_fn``
reads the host clock. ``trace`` writes a Chrome trace with
``torch.profiler`` (device activity included when there is a card).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for x in items:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def sync(tree) -> None:
    """Wait for the device of the first tensor in ``tree`` (a tensor, or
    tuples, lists, dicts and NamedTuples of them)."""
    t = _first_tensor(tree)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Timer:
    """Wall-clock bracket that waits for the device on exit.

    >>> with Timer() as t:
    ...     out = step(state)
    ...     t.sync_on(out)
    >>> t.elapsed
    """

    def __enter__(self):
        self._tree = None
        self.elapsed = None
        self.t0 = time.perf_counter()
        return self

    def sync_on(self, tree) -> None:
        self._tree = tree

    def __exit__(self, *exc):
        if self._tree is not None:
            sync(self._tree)
        self.elapsed = time.perf_counter() - self.t0
        return False


def time_fn(f: Callable, *args, iters: int = 100, warmup: int = 1,
            chain: bool = False) -> float:
    """Seconds per call of ``f(*args)`` over ``iters`` calls after
    ``warmup`` calls: CUDA events around the calls when ``f`` returns card
    tensors, else the host clock. ``chain=True`` passes each call's output
    as the next call's first argument."""
    out = None
    for _ in range(max(warmup, 1)):
        out = f(*args)
    sync(out)
    t = _first_tensor(out)
    on_card = t is not None and t.device.type == "cuda"
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
        if chain:
            args = (out,) + args[1:]
    if on_card:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block; writes ``<log_dir>/trace.json``
    (Chrome trace, viewable in Perfetto) and yields its path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
