"""Dense cap-free backward: every valid Gaussian over every tile it covers.

Port of ``dense_backward`` (``gaussianimage_plus_tpu/kernels/raster_dense_pallas.py:292-327``,
with ``_dense_prepare`` ``:274-289``). On the TPU it is its own kernel (#9,
``_make_bwd_kernel``): a grid over every (chunk of 64 rows, block of 8
tiles) pair with an in-kernel bbox test, the exact fallback of the
chunk-list backward. It computes the same function as ``list_backward``, so
here it routes to the same Hopper kernel, ``chunk_backward`` (kernel C,
``kernels/raster_list.py``), over the table padded to 64 rows; on CPU
tensors that is the plain version.

The dense and sweep forwards (TPU #8, #11) and ``sweep_backward`` (#10) are
not ported yet; ``sweep_backward`` computes this function too and will
route to kernel C.
"""

from __future__ import annotations

from ..core.gaussian2d import BLOCK_H, BLOCK_W, Projected
from .raster_list import KC, _table_bbox, chunk_backward, split_payload


def dense_backward(proj: Projected, colors, opacity, v_img, H: int, W: int,
                   block_h: int = BLOCK_H, block_w: int = BLOCK_W):
    """Per-Gaussian gradients (v_xys, v_conics, v_colors, v_opacity) of the
    cap-free render over all valid Gaussians (16x16 tiles only)."""
    if (block_h, block_w) != (BLOCK_H, BLOCK_W):
        raise NotImplementedError("the port's kernels render 16x16 tiles only")
    table, bbox, N, _ = _table_bbox(proj, colors, opacity, H, W, KC)
    return split_payload(chunk_backward(table, bbox, v_img.contiguous()), N, opacity)
