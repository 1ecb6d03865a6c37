"""Idle share of the device over the traced run's window, whose jobs run
without the profiler: 1 - (the graph replays' time, CUDA events around each
``ChunkGraph.replay``, back to back on one stream) / the window's length by
the host's clock, %. A replay counts as busy throughout, the bubbles between
its kernels included; everything outside the replays counts as idle, the
eager warm-up chunk's device work too (its 100 steps a job, under 1% of a
job by the replay's step time)."""


def read(trace):
    ms, steps = trace["replay"]
    if not steps or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ms * 1e-3 / trace["window_s"])
