"""Kernel B's share of its roofline in the steady segment: the least time of the
counted forward work of a step (``reference/counts.py``) times the steps, over
kernel B's device time, %."""

from portbench import readers


def read(trace):
    st = trace.get("steady")
    if not st or trace["peaks"] is None:
        return None
    return readers.roofline(trace, st, "B", st["steps"] * readers.bound_s(trace, *st["forward"]))
