"""The first growth of the profiled fit job (the program's first ``fit.grow``
span under the job's ``fit`` root; the profile ends with it), ms."""

from portbench import program


def read(trace):
    ivs = program.under_last_root("fit", "fit.grow")
    return (ivs[0][1] - ivs[0][0]) * 1e3 if ivs else None
