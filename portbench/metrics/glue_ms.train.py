"""Device time per step outside the five named kernels (A-E) in the steady
segment: the plain-PyTorch work between kernels, ms."""


def read(trace):
    st = trace.get("steady")
    if not st or not st["steps"]:
        return None
    prof = st["profile"]
    named = [n for k in trace["kernels"].values() for n in k["names"]]
    total = sum(s for s, _ in prof.by_name().values())
    kern, _ = prof.seconds_of(named)
    return (total - kern) * 1e3 / st["steps"]
