"""The fused dispatch's set-up in a fit: the eager warm-up chunk (to a sync) and
the capture of the chunk graph, summed per job, ms."""


def read(trace):
    s = trace["spans"]
    if not s.get("capture"):
        return None
    return (sum(s.get("warm_chunk", [])) + sum(s["capture"])) * 1e3 / trace["jobs"]
