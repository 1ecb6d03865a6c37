"""The share of the chunks kernel B visits that hold no member row of their
tile, over the steady segment's eager chunk: the listed chunks are members,
so the waste lies in the residual intervals. (``lists.visited_chunks`` −
``lists.member_chunks``) / ``lists.visited_chunks`` (``lists.py``), %."""

from portbench import lists


def read(trace):
    c = lists.steady(trace)
    if not c or not c["lists.visited_chunks"]:
        return None
    return 100.0 * (c["lists.visited_chunks"] - c["lists.member_chunks"]) / \
        c["lists.visited_chunks"]
