"""Kernel C's share of its roofline in the steady segment: the least time of the
counted backward work of a step times the steps, over kernel C's device time, %."""

from portbench import readers


def read(trace):
    st = trace.get("steady")
    if not st or trace["peaks"] is None:
        return None
    return readers.roofline(trace, st, "C", st["steps"] * readers.bound_s(trace, *st["backward"]))
