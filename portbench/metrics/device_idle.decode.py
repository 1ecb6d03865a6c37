"""Idle share of the device over the profiled decode stretch: 1 - the union of
device intervals over the stretch's length, %."""

from portbench import readers


def read(trace):
    st = trace.get("stretch")
    return readers.idle_percent(st["profile"]) if st else None
