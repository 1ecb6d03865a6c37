"""The binning of a frame's render (projection's output to each tile's
members: the program's ``render.bin`` spans under a ``decode`` root) in the
profiled decode stretch, summed and divided by its frames, ms."""

from portbench import program


def read(trace):
    st = trace.get("stretch")
    ivs = program.in_window(st["profile"], "render.bin", root="decode") if st else None
    return program.seconds(ivs) * 1e3 / st["frames"] if ivs else None
