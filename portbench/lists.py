"""The program's device counters of the chunk-list enumeration, as the
``list_overflow.train`` and ``residual_waste.train`` readers take them.

``kernels/raster_list.member_lists`` counts, per enumeration and while
recording is on, the tiles (``lists.tiles``), the tiles whose member chunks
exceed the list width (``lists.overflow_tiles``), the member chunks
(``lists.member_chunks``) and the chunks kernel B visits, the listed ones
and the residual interval (``lists.visited_chunks``); each count is tagged
with the root of the span open around it. The readers take the steady
segment's eager chunk: the latest ``fit.warm_chunk`` span that is a root
(the profiled job's lies under its ``fit`` root), 100 steps from the last
job's returned state, before the segment's capture.

Where the program keeps no device counters, or counted nothing there,
``steady()`` returns None and the readers return None.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench import program


def steady(trace: dict) -> Optional[Dict[str, int]]:
    """The ``lists.*`` counters of the steady segment's eager chunk."""
    P = program._profiling()
    if not trace.get("steady") or P is None or not hasattr(P, "device_counters"):
        return None
    roots = [s for s in P.spans() if s.name == "fit.warm_chunk" and s.parent == 0]
    if not roots:
        return None
    got = P.device_counters(max(roots, key=lambda s: s.start_ns).id)
    return got if got.get("lists.tiles") else None
