"""Capped per-tile binning by a hand-written kernel (``bin_method='pallas'``).

Port of ``gaussianimage_plus_tpu/kernels/binning_pallas.py``:
``bin_gaussians_pallas`` (``:92-139``, TPU kernel #13, body ``:43-89``) and
its ``_counts_from_bbox``. On the TPU it compacts each tile's members by
matrix products on the MXU; here it is kernel E, ``tile_bin``
(``csrc/tile_bin.cu``): a block keeps the ids whose bbox holds its tile row
and window, in id order, and a warp per tile compacts its members from that
short list with warp ballots. Its ``TileBins`` equal ``core/binning.py``'s ``'top_k'``
selection exactly: ids, mask and count.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.binning import TileBins, select_members, tile_bbox_table
from ..core.gaussian2d import BLOCK_H, BLOCK_W, Projected, check_kernel_tiles, tile_bounds_for
from . import _build


def tile_bin_plain(bbox: torch.Tensor, tb_x: int, tb_y: int, cap: int):
    """Plain PyTorch version of kernel E: the [T, N] membership of the bbox
    table, then ``select_members`` (``'top_k'``) -> (ids [T, cap], count [T])."""
    dev = bbox.device
    tx = torch.arange(tb_x, dtype=torch.int32, device=dev)
    ty = torch.arange(tb_y, dtype=torch.int32, device=dev)
    in_x = (tx[:, None] >= bbox[None, :, 0]) & (tx[:, None] < bbox[None, :, 1])   # [tbx, N]
    in_y = (ty[:, None] >= bbox[None, :, 2]) & (ty[:, None] < bbox[None, :, 3])   # [tby, N]
    member = (in_y[:, None, :] & in_x[None, :, :]).reshape(tb_y * tb_x, -1)
    bins = select_members(member, cap, "top_k")
    return bins.ids, bins.count


def _setup(lib):
    lib.tile_bin.restype = ctypes.c_int
    lib.tile_bin.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def tile_bin(bbox: torch.Tensor, tb_x: int, tb_y: int, cap: int):
    """Kernel E: int32 tile bboxes [N, 4] -> (ids [T, cap] int32, ascending
    members then zeros; count [T] int32 = min(#members, cap)). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (built at first
    use) or raises."""
    if bbox.dim() != 2 or bbox.shape[1] != 4:
        raise ValueError(f"bbox must be [N, 4], got {tuple(bbox.shape)}")
    if bbox.dtype != torch.int32:
        raise TypeError("bbox must be int32")
    if cap < 1:
        raise ValueError(f"cap must be at least 1, got {cap}")
    dev = bbox.device
    if dev.type == "cpu":
        return tile_bin_plain(bbox, tb_x, tb_y, cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not bbox.is_contiguous():
        raise ValueError("bbox must be contiguous")
    T = tb_x * tb_y
    lib = _build.load("tile_bin", _setup)
    ids = torch.empty((T, cap), dtype=torch.int32, device=dev)
    count = torch.empty((T,), dtype=torch.int32, device=dev)
    rc = _build.launch(dev, lib.tile_bin, bbox.data_ptr(), ids.data_ptr(), count.data_ptr(),
                       bbox.shape[0], T, tb_x, cap)
    _build.check(rc, "tile_bin")
    tile_bin.launches += 1
    return ids, count


tile_bin.launches = 0


def bin_gaussians_tiles(proj: Projected, H: int, W: int, cap: int = 256,
                        block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> TileBins:
    """``bin_gaussians_pallas``: the same ``TileBins`` as
    ``core.binning.bin_gaussians(method='top_k')``, through kernel E."""
    check_kernel_tiles(block_h, block_w, "bin_method='pallas'")
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    bbox = tile_bbox_table(proj.xys, proj.radii, (tb_x, tb_y), proj.valid)
    ids, count = tile_bin(bbox, tb_x, tb_y, cap)
    mask = torch.arange(cap, device=ids.device)[None, :] < count[:, None]
    return TileBins(ids=ids, mask=mask, count=count)
