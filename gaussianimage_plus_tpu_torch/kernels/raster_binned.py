"""Binned, capped forward rasterizer over a pre-gathered tile table.

Port of the forward half of ``gaussianimage_plus_tpu/kernels/raster_pallas.py``
(``_build_table``, ``_prepare``, ``Prepared``, ``prepare_raster``,
``rasterize_prepared``, the forward of ``rasterize_pallas``) and of
``kernels/raster_flat_pallas.py`` (``rasterize_prepared_flat``). On the TPU
those are two kernels (``_run_fwd`` and the flat bin-once kernel) that differ
only in predication; they compute one function, so both route to one Hopper
kernel here: ``tile_table_forward`` (``csrc/tile_table_forward.cu``,
kernel A).

Data layout, as in the JAX package: one attribute table ``[N+1, 16]`` with
rows ``[c1, c2, c3, mx, my, r, g, b, opac, 0.., valid=1]`` and an all-zero
sentinel row N; ``raw = table[ids]`` ``[T, K, 16]`` with empty slots pointing
at the sentinel. A tile's members are front-packed, so only its first
``counts[t]`` rows are read, and the same kernel serves the untrimmed binned
table and the trimmed bin-once table.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.gaussian2d import BLOCK_H, BLOCK_W, tile_bounds_for
from ..core.render_tiled import render_table
from . import _build

COLS = 16
# slot-list alignment of the JAX package (raster_pallas.KC); kept so that the
# padded table has the JAX shape
KC = 128


def _build_table(xys, conics, colors, opacity) -> torch.Tensor:
    """[N+1, COLS] attribute table with a zero sentinel row."""
    op = opacity.reshape(-1)
    z = torch.zeros_like(op)
    cols = [conics[:, 0], conics[:, 1], conics[:, 2], xys[:, 0], xys[:, 1],
            colors[:, 0], colors[:, 1], colors[:, 2], op]
    cols += [z] * (COLS - len(cols) - 1) + [torch.ones_like(op)]
    table = torch.stack(cols, dim=1)
    return torch.cat([table, table.new_zeros((1, COLS))], dim=0)


def _padded_k(K: int) -> int:
    """Slot-list alignment: to 8 below one chunk of 128, else to 128."""
    return -(-K // 8) * 8 if K < KC else -(-K // KC) * KC


def _prepare(xys, conics, colors, opacity, ids, mask):
    """Gather the table into per-tile blocks: (raw [T, Kp, 16], counts [T])."""
    N = xys.shape[0]
    table = _build_table(xys, conics, colors, opacity)
    ids_s = torch.where(mask, ids.to(torch.int64), torch.full_like(ids, N, dtype=torch.int64))
    K = ids.shape[1]
    Kp = _padded_k(K)
    if Kp != K:
        ids_s = torch.nn.functional.pad(ids_s, (0, Kp - K), value=N)
    raw = table[ids_s]
    counts = mask.sum(dim=1, dtype=torch.int32)
    return raw, counts


class Prepared(NamedTuple):
    """A binned and gathered render input: the decode fast path renders a
    static stream from it with no per-frame binning (see the JAX
    ``raster_pallas.Prepared``)."""

    raw: torch.Tensor     # [T, Kp, COLS]
    counts: torch.Tensor  # [T] int32


def prepare_raster(xys, conics, colors, opacity, ids, mask, H, W,
                   block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> Prepared:
    """Bin-once stage: gather attributes into per-tile blocks (the tile
    grid is the rows of ``ids``; ``H``, ``W`` and the block size keep the
    JAX signature)."""
    return Prepared(*_prepare(xys, conics, colors, opacity, ids, mask))


def tile_table_forward_plain(raw: torch.Tensor, counts: torch.Tensor,
                             H: int, W: int) -> torch.Tensor:
    """Plain PyTorch version of kernel A: the same function, same
    arithmetic for ``sigma`` (``core/render_tiled.py``)."""
    return render_table(raw, counts, H, W, BLOCK_H, BLOCK_W)


def _setup(lib):
    lib.tile_table_forward.restype = ctypes.c_int
    lib.tile_table_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def tile_table_forward(raw: torch.Tensor, counts: torch.Tensor,
                       H: int, W: int) -> torch.Tensor:
    """Kernel A: [T, K, 16] table + counts [T] -> unclamped [H, W, 3].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (built at first use) or raises."""
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    if raw.dim() != 3 or raw.shape[0] != tb_x * tb_y or raw.shape[2] != COLS:
        raise ValueError(f"raw must be [{tb_x * tb_y}, K, {COLS}], got {tuple(raw.shape)}")
    if counts.shape != (raw.shape[0],):
        raise ValueError(f"counts must be [{raw.shape[0]}], got {tuple(counts.shape)}")
    if raw.dtype != torch.float32 or counts.dtype != torch.int32:
        raise TypeError("raw must be float32 and counts int32")
    if raw.device != counts.device:
        raise ValueError("raw and counts must be on one device")
    if raw.device.type == "cpu":
        return tile_table_forward_plain(raw, counts, H, W)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    if not (raw.is_contiguous() and counts.is_contiguous()):
        raise ValueError("raw and counts must be contiguous")
    lib = _build.load("tile_table_forward", _setup)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = lib.tile_table_forward(raw.data_ptr(), counts.data_ptr(), out.data_ptr(),
                                    raw.shape[0], raw.shape[1], tb_x, H, W, stream)
    _build.check(rc, "tile_table_forward")
    tile_table_forward.launches += 1
    return out


tile_table_forward.launches = 0


def rasterize_prepared(prep: Prepared, H: int, W: int) -> torch.Tensor:
    """Forward-only render from a prepared table -> unclamped [H, W, 3]."""
    return tile_table_forward(prep.raw, prep.counts, H, W)


def rasterize_prepared_flat(prep: Prepared, H: int, W: int) -> torch.Tensor:
    """The bin-once decode render (``decode_frame``). The JAX package's flat
    kernel exists to avoid TPU predication; it computes the function of
    ``rasterize_prepared``, and so runs the same kernel here."""
    return tile_table_forward(prep.raw, prep.counts, H, W)


def rasterize_binned(xys, conics, colors, opacity, ids, mask, H: int, W: int,
                     block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Forward of the JAX ``rasterize_pallas``: gather + kernel A."""
    return tile_table_forward(*_prepare(xys, conics, colors, opacity, ids, mask), H, W)
