"""The share of tiles whose member chunks exceed the chunk list's width (8 at
grids of 4096 tiles or more, else 16), over the steady segment's eager chunk:
the program's ``lists.overflow_tiles`` over ``lists.tiles`` (``lists.py``), %."""

from portbench import lists


def read(trace):
    c = lists.steady(trace)
    return 100.0 * c["lists.overflow_tiles"] / c["lists.tiles"] if c else None
