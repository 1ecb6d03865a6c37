"""What the per-layer metric readers (``portbench/metrics/*.py``) share.

A reader gets the traced run's ``trace`` dict (the traffic kind's
``traced`` output, with ``peaks`` and ``kernels`` added) and returns a
number, or None where it finds nothing to read. A kernel that the wrappers
say ran but that the profiler did not trace is an error, never a 0.
"""

from __future__ import annotations

from typing import Optional, Tuple


def kernel_seconds(trace: dict, section: dict, kernel: str) -> Optional[Tuple[float, int]]:
    """(device seconds, calls) of kernel ``kernel`` (A-E) in a profiled
    ``section``; None where its wrapper launched nothing there."""
    k = trace["kernels"][kernel]
    launched = section["launches"].get(k["wrapper"], 0)
    if launched == 0:
        return None
    seconds, calls = section["profile"].seconds_of(k["names"])
    if calls == 0:
        raise RuntimeError(f"kernel {kernel} launched {launched} times but the profiler "
                           f"traced none of {k['names']}")
    return seconds, calls


def bound_s(trace: dict, ops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the float32
    peak or bytes over the memory's, whichever is longer."""
    p = trace["peaks"]
    return max(ops / p["f32_flops"], nbytes / p["hbm_bytes_per_s"])


def roofline(trace: dict, section: dict, kernel: str, bound_seconds: float) -> Optional[float]:
    got = kernel_seconds(trace, section, kernel)
    if got is None or trace["peaks"] is None:
        return None
    return 100.0 * bound_seconds / got[0]


def idle_percent(profile) -> Optional[float]:
    if profile is None or profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)
