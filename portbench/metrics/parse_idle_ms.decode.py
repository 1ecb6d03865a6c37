"""Device idle time inside a frame's parse: the stretch's window less the
union of its device intervals (``Profile.busy``), inside the program's
``decode.parse`` spans, summed over the profiled decode stretch and divided
by its frames, ms."""

from portbench import program


def read(trace):
    st = trace.get("stretch")
    ivs = program.in_window(st["profile"], "decode.parse") if st else None
    return program.idle_s(st["profile"], ivs) * 1e3 / st["frames"] if ivs else None
