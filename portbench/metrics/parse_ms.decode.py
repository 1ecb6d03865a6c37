"""Host parse and rANS decode of a frame (``compress.bitstream.deserialize_bitstream``):
the mean span over the window's frames, ms."""

from portbench.trace import mean


def read(trace):
    spans = trace["spans"].get("parse")
    return mean(spans) * 1e3 if spans else None
