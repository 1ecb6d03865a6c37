"""The whole step's share of the card's float32 peak: the counted operations of a
step (forward, backward, projection, Adam, loss) over the steady segment's replay
time per step (CUDA events) times the peak, %."""


def read(trace):
    st = trace.get("steady")
    if not st or trace["peaks"] is None or not st["steps"]:
        return None
    ops, _ = st["step"]
    return 100.0 * ops / (st["step_ms"] * 1e-3 * trace["peaks"]["f32_flops"])
