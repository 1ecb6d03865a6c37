"""Device idle time while the host dequantizes and enqueues a frame's render:
the stretch's window less the union of its device intervals
(``Profile.busy``), inside the union of the program's ``decode.dequantize``
and ``decode.render`` spans, summed over the profiled decode stretch and
divided by its frames, ms."""

from portbench import program


def read(trace):
    st = trace.get("stretch")
    ivs = (program.in_window(st["profile"], "decode.dequantize", "decode.render")
           if st else None)
    return program.idle_s(st["profile"], ivs) * 1e3 / st["frames"] if ivs else None
