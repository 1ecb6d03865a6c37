"""The eager warm-up chunk of the profiled fit job (the program's
``fit.warm_chunk`` span under the job's ``fit`` root: its host time, which
ends when the chunk is enqueued, not when the device has run it), ms."""

from portbench import program


def read(trace):
    ivs = program.under_last_root("fit", "fit.warm_chunk")
    return program.seconds(ivs) * 1e3 if ivs else None
