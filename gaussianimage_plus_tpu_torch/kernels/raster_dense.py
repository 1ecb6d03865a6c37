"""Cap-free dense, sweep and range rasterizers, and the dense backward.

Port of ``gaussianimage_plus_tpu/kernels/raster_dense_pallas.py``: the
forwards ``rasterize_dense_pallas`` (``:368-408``, TPU #8),
``rasterize_sweep_pallas`` (``:481-526``, #11) and ``rasterize_range_pallas``
(``:593-653``, #12); the backwards ``dense_backward`` (``:292-327``, #9) and
``sweep_backward`` (``:330-365``, #10); the differentiable
``rasterize_dense`` (``:661-692``) and ``rasterize_sweep`` (``:695-727``).

Each forward blends, per tile, every valid row of the padded attribute table
whose float tile bbox holds the tile, in ascending row order, with no cap:
the function of the chunk-list forward. The three TPU kernels differ only in
which chunks a tile visits, and kernel B (``chunk_list_forward``,
``kernels/raster_list.py``) takes that enumeration as arguments: the listed
chunks ``lst[:cnt]`` and a residual interval ``[lo2, hi2)``. So here:

- dense: every chunk, ``cnt = 0`` and ``[lo2, hi2) = [0, Np/kc)``, table
  padded to the JAX ``KC`` = 128 rows;
- sweep: exactly the tile's member chunks (the chunks the TPU kernel does not
  skip), all listed, kc 64 by default;
- range: ``cnt = 0`` and the interval of the tile's smallest and largest
  member ids in chunks (``:615-628``), kc 64 by default.

Kernel B re-tests each visited row's membership, as the TPU kernels do. Both
backwards compute the gradient of that one function, the function of kernel
C (``chunk_backward``), and route there; ``rasterize_dense`` and
``rasterize_sweep`` run kernel C on the table and bbox their forward built.
On CPU tensors the kernels' plain versions run.
"""

from __future__ import annotations

import torch

from ..core.gaussian2d import BLOCK_H, BLOCK_W, Projected, check_kernel_tiles, tile_bounds_for
from .raster_list import (RasterizeChunks, _bbox_members, _chunk_lists, _table_bbox,
                          chunk_backward, chunk_list_forward, split_payload)

DENSE_KC = 128   # rows per chunk of the dense kernels (raster_dense_pallas.KC)
SWEEP_KC = 64    # default kc of the sweep and range forwards


def _no_list(T: int, dev):
    zero = torch.zeros((T,), dtype=torch.int32, device=dev)
    return torch.zeros((T, 1), dtype=torch.int32, device=dev), zero


def dense_lists(table, bbox, N: int, Np: int, kc: int, H: int, W: int):
    """Every chunk for every tile: (lst, cnt = 0, lo2 = 0, hi2 = Np / kc)."""
    tb_x, tb_y = tile_bounds_for(H, W)
    T = tb_x * tb_y
    lst, zero = _no_list(T, table.device)
    return lst, zero, zero, torch.full((T,), Np // kc, dtype=torch.int32, device=table.device)


def sweep_lists(table, bbox, N: int, Np: int, kc: int, H: int, W: int):
    """Each tile's member chunks, all listed: (lst [T, Np / kc], cnt, 0, 0)."""
    tb_x, tb_y = tile_bounds_for(H, W)
    member = _bbox_members(table, bbox, tb_x, tb_x * tb_y)
    return _chunk_lists(member, N, Np, kc, Np // kc)


def range_lists(table, bbox, N: int, Np: int, kc: int, H: int, W: int):
    """Each tile's member-id range in chunks: (lst, cnt = 0, lo, hi), empty
    for a tile without members."""
    tb_x, tb_y = tile_bounds_for(H, W)
    T = tb_x * tb_y
    member = _bbox_members(table, bbox, tb_x, T)                       # [T, Np]
    ids = torch.arange(Np, dtype=torch.int32, device=table.device)[None, :]
    idx_min = torch.where(member, ids, torch.full_like(ids, Np)).amin(dim=1)
    idx_max = torch.where(member, ids, torch.full_like(ids, -1)).amax(dim=1)
    some = idx_max >= 0
    zero_t = torch.zeros_like(idx_min)
    lo = torch.where(some, torch.div(idx_min, kc, rounding_mode="floor"), zero_t)
    hi = torch.where(some, torch.div(idx_max, kc, rounding_mode="floor") + 1, zero_t)
    lst, zero = _no_list(T, table.device)
    return lst, zero, lo.to(torch.int32), hi.to(torch.int32)


def _forward(proj: Projected, colors, opacity, H: int, W: int, kc: int, lists) -> torch.Tensor:
    table, bbox, N, Np = _table_bbox(proj, colors, opacity, H, W, kc)
    return chunk_list_forward(table, bbox, *lists(table, bbox, N, Np, kc, H, W), kc, H, W)


def rasterize_dense_pallas(proj: Projected, colors, opacity, H: int, W: int,
                           block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Forward-only dense render -> unclamped [H, W, 3] (kernel B over every
    chunk of 128 rows)."""
    check_kernel_tiles(block_h, block_w, "rasterize_dense_pallas")
    return _forward(proj, colors, opacity, H, W, DENSE_KC, dense_lists)


def rasterize_sweep_pallas(proj: Projected, colors, opacity, H: int, W: int,
                           block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                           kc: int = SWEEP_KC) -> torch.Tensor:
    """Forward-only chunk-skip sweep render -> unclamped [H, W, 3] (kernel B
    over each tile's member chunks)."""
    check_kernel_tiles(block_h, block_w, "rasterize_sweep_pallas")
    return _forward(proj, colors, opacity, H, W, kc, sweep_lists)


def rasterize_range_pallas(proj: Projected, colors, opacity, H: int, W: int,
                           block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                           kc: int = SWEEP_KC) -> torch.Tensor:
    """Forward-only chunk-range render -> unclamped [H, W, 3] (kernel B over
    each tile's member-id chunk interval)."""
    check_kernel_tiles(block_h, block_w, "rasterize_range_pallas")
    return _forward(proj, colors, opacity, H, W, kc, range_lists)


def dense_backward(proj: Projected, colors, opacity, v_img, H: int, W: int,
                   block_h: int = BLOCK_H, block_w: int = BLOCK_W):
    """Per-Gaussian gradients (v_xys, v_conics, v_colors, v_opacity) of the
    cap-free render over all valid Gaussians, through kernel C on the table
    padded to 128 rows (``_dense_prepare``)."""
    check_kernel_tiles(block_h, block_w, "dense_backward")
    table, bbox, N, _ = _table_bbox(proj, colors, opacity, H, W, DENSE_KC)
    return split_payload(chunk_backward(table, bbox, v_img.contiguous()), N, opacity)


def sweep_backward(proj: Projected, colors, opacity, v_img, H: int, W: int,
                   block_h: int = BLOCK_H, block_w: int = BLOCK_W):
    """The sweep's backward: the gradient of the same function as
    ``dense_backward`` (the JAX kernel only skips memberless chunks), so the
    same kernel C."""
    return dense_backward(proj, colors, opacity, v_img, H, W, block_h, block_w)


def _differentiable(xys, conics, colors, opacity, radii, valid, H, W, block_h, block_w,
                    kc, lists) -> torch.Tensor:
    check_kernel_tiles(block_h, block_w, "the cap-free differentiable render")
    return RasterizeChunks.apply(xys, conics, colors, opacity, radii, valid, H, W, kc, lists)


def rasterize_dense(xys, conics, colors, opacity, radii, valid, H: int, W: int,
                    block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Differentiable dense render (no binning, no cap) -> unclamped [H, W, 3]:
    kernel B over every chunk, kernel C backward."""
    return _differentiable(xys, conics, colors, opacity, radii, valid, H, W, block_h,
                           block_w, DENSE_KC, dense_lists)


def rasterize_sweep(xys, conics, colors, opacity, radii, valid, H: int, W: int,
                    block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Differentiable chunk-skip sweep render -> unclamped [H, W, 3]: kernel B
    over each tile's member chunks, kernel C backward."""
    return _differentiable(xys, conics, colors, opacity, radii, valid, H, W, block_h,
                           block_w, SWEEP_KC, sweep_lists)
