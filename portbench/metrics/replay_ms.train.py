"""Device time of the graph replays in the window, per step replayed: CUDA
events around each ``ChunkGraph.replay``, ms."""


def read(trace):
    ms, steps = trace["replay"]
    return ms / steps if steps else None
