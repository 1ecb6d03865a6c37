"""The capture of the chunk graph in the profiled fit job (the program's
``fit.capture`` span under the job's ``fit`` root; the capture first waits
for the device to finish the warm-up chunk), ms."""

from portbench import program


def read(trace):
    ivs = program.under_last_root("fit", "fit.capture")
    return program.seconds(ivs) * 1e3 if ivs else None
