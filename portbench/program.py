"""The program's own spans and counters, as the per-layer readers select them.

The port records spans and counters (``gaussianimage_plus_tpu_torch.utils
.profiling``) while a torch profiler records, so the traced run's profiled
stretches carry them with no edit to the harness. A span's times are
``time.time_ns()``, the clock of the profiler's events, so a span and a
``trace.Profile`` meet on one clock: a reader selects spans by time, inside
a profile's window, or by their root (every span of one decode request or
one fit job shares its root's id).

Where the program records nothing (a program whose ``profiling`` module has
no ``spans``, or no span of the name), the helpers return None and a reader
returns None: the metric is left out of the line.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench import trace as T

Seconds = List[Tuple[float, float]]


def _profiling():
    from gaussianimage_plus_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "spans") else None


def _ring():
    """(the program's recorded spans, the ring's drops), or None where it
    records none."""
    P = _profiling()
    return None if P is None else (P.spans(), P.dropped())


def _kept(got: list, dropped: int, since_ns: float) -> list:
    """``got``, where the ring dropped no span that may start after
    ``since_ns``; else raises, as a count from part of the spans is wrong."""
    if dropped and (not got or got[0].start_ns > since_ns):
        raise RuntimeError(f"the program's span ring dropped {dropped} spans, "
                           f"some of them in the stretch read")
    return got


def in_window(profile, *names: str, root: Optional[str] = None) -> Optional[Seconds]:
    """(start, end) in seconds of the spans named ``names`` that overlap the
    profile's window, clipped to it; with ``root``, only those under a span
    of that name. None where there is none."""
    lo, hi = profile.lo, profile.hi
    ring = _ring()
    if ring is None:
        return None
    got = _kept(*ring, lo * 1e9)
    roots = {s.id for s in got if s.name == root} if root else None
    out = []
    for s in got:
        if s.name in names and (roots is None or s.root in roots):
            a, b = max(s.start_ns * 1e-9, lo), min(s.end_ns * 1e-9, hi)
            if b > a:
                out.append((a, b))
    return out or None


def under_last_root(root: str, name: str) -> Optional[Seconds]:
    """(start, end) in seconds, in order of start, of the spans ``name``
    under the latest span ``root`` (by start). None where there is none."""
    ring = _ring()
    if ring is None:
        return None
    got, dropped = ring
    roots = [s for s in got if s.name == root]
    if not roots:
        return None
    last = max(roots, key=lambda s: s.start_ns)
    _kept(got, dropped, last.start_ns)
    out = sorted((s.start_ns * 1e-9, s.end_ns * 1e-9) for s in got
                 if s.name == name and s.root == last.id)
    return out or None


def counter(name: str) -> Optional[int]:
    """The program's counter ``name``; None where it has none."""
    P = _profiling()
    return None if P is None else P.counters().get(name)


def seconds(ivs: Seconds) -> float:
    return sum(b - a for a, b in ivs)


def idle_s(profile, ivs: Seconds) -> float:
    """Seconds of the union of ``ivs`` (inside the profile's window) during
    which the device is idle: the union less its overlap with
    ``profile.busy``."""
    merged = T.union([T.Interval("", a, b) for a, b in ivs], profile.lo, profile.hi)
    busy = profile.busy
    overlap, j = 0.0, 0
    for a, b in merged:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            overlap += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return seconds(merged) - overlap
