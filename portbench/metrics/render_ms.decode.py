"""Dequantize, project, select and kernel A (``compress.pipeline.decompress_wo_ec``
to a sync): the mean span over the window's frames, ms."""

from portbench.trace import mean


def read(trace):
    spans = trace["spans"].get("render")
    return mean(spans) * 1e3 if spans else None
