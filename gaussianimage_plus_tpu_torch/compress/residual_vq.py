"""Residual vector quantization codebooks and the decoder.

Port of the decode half of ``gaussianimage_plus_tpu/compress/residual_vq.py``
(``VQCodebook``, ``ResidualVQState``, ``residual_vq_decode``): decode sums
``embed[idx_l]`` over the layers (reference quantize.py:326-333). k-means
init and the EMA update belong to the QAT slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class VQCodebook(NamedTuple):
    embed: torch.Tensor         # [K, D]
    cluster_size: torch.Tensor  # [K] EMA counts
    embed_avg: torch.Tensor     # [K, D] EMA sums


class ResidualVQState(NamedTuple):
    layers: Tuple[VQCodebook, ...]


def residual_vq_decode(state: ResidualVQState, indices: torch.Tensor) -> torch.Tensor:
    """Sum of per-layer codebook rows; ``indices`` [N, L] integer."""
    idx = indices.to(torch.int64)
    out = None
    for i, cb in enumerate(state.layers):
        rows = cb.embed[idx[:, i]]
        out = rows if out is None else out + rows
    return out
