"""Kernel A's share of its roofline in the profiled decode stretch: the summed
least time of each frame's counted forward work (``reference/counts.py``, at the
stream's cap) over kernel A's device time, %."""

from portbench import readers


def read(trace):
    st = trace.get("stretch")
    if st is None or trace["peaks"] is None:
        return None
    least = sum(readers.bound_s(trace, ops, nbytes) for ops, nbytes in st["forward"])
    return readers.roofline(trace, st, "A", least)
