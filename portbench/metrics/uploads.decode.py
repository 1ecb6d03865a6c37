"""Tensors a frame's parse makes from host arrays, each one host-to-device copy
on the card (the program's ``decode.uploads`` counter, which counts while the
profiler records): the count over the profiled decode stretch divided by its
frames."""

from portbench import program


def read(trace):
    st = trace.get("stretch")
    n = program.counter("decode.uploads") if st else None
    return n / st["frames"] if n else None
