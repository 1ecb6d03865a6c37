"""The share of the steady segment's eager chunk's enumerated tiles that the
chunk-list kernel (kernel F, ``kernels/raster_list.chunk_lists``) listed:
the program's ``lists.kernel_tiles`` over ``lists.tiles`` (``lists.py``), %.
100 where every enumeration ran the kernel; None where the program keeps no
such counter (a program without the kernel, or the CPU's plain path)."""

from portbench import lists


def read(trace):
    c = lists.steady(trace)
    if not c or "lists.kernel_tiles" not in c:
        return None
    return 100.0 * c["lists.kernel_tiles"] / c["lists.tiles"]
