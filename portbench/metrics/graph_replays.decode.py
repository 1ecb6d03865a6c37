"""Binned decode renders that replayed a captured CUDA graph (the program's
``decode.graph_replays`` counter, which counts while the profiler records):
the count over the profiled decode stretch divided by its frames."""

from portbench import program


def read(trace):
    st = trace.get("stretch")
    n = program.counter("decode.graph_replays") if st else None
    return n / st["frames"] if n else None
