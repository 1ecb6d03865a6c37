"""The rANS decode of a frame (the program's ``decode.entropy`` spans, each a
``compress.entropy.decode_rans`` call) in the profiled decode stretch, summed
over the stretch and divided by its frames, ms."""

from portbench import program


def read(trace):
    st = trace.get("stretch")
    ivs = program.in_window(st["profile"], "decode.entropy") if st else None
    return program.seconds(ivs) * 1e3 / st["frames"] if ivs else None
