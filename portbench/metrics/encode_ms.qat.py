"""The encoder of a coding job (the program's ``encode`` span in
``compress.trainer.encode_decode_eval``: the integer codes, the rANS rates,
the ``.gipb``'s serialization and its file write), the mean over the traced
window's jobs, ms."""

from portbench import program


def read(trace):
    window = trace.get("qat_window")
    ivs = program.in_window(window, "encode") if window else None
    return program.seconds(ivs) * 1e3 / len(ivs) if ivs else None
