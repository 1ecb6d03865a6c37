"""A graphed QAT step: CUDA events around each ``ChunkGraph.replay`` of the
steady segment (``steady_chunks`` graphed ``quant_train_macro_chunk``
chunks from the last job's returned snapshot and grids), per step, ms."""


def read(trace):
    st = trace.get("qat_steady")
    return st["step_ms"] if st and st["steps"] else None
