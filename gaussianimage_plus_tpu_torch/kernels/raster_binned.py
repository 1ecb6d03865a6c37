"""Binned, capped rasterizer over a pre-gathered tile table, and its backward.

Port of ``gaussianimage_plus_tpu/kernels/raster_pallas.py`` (``_build_table``,
``_prepare``, ``Prepared``, ``prepare_raster``, ``rasterize_prepared``, the
differentiable ``rasterize_pallas``) and of ``kernels/raster_flat_pallas.py``
(``rasterize_prepared_flat``). On the TPU the forward is two kernels
(``_run_fwd`` and the flat bin-once kernel) that differ only in predication;
they compute one function, so both route to one Hopper kernel here:
``tile_table_forward`` (``csrc/tile_table_forward.cu``, kernel A). The
backward (TPU ``_run_bwd``, #2, then a scatter-add or ``_gather_grads``) is
kernel D, ``tile_table_backward`` (``csrc/tile_table_backward.cu``): a scan
that numbers the live (tile, slot) pairs, a payload pass over them and a
per-Gaussian gather pass.

Deviation, on purpose: the JAX backward scatter-adds the payload by default
and gathers it per Gaussian only under a static tile budget
(``gather_tiles``), falling back to the scatter when a bbox exceeds it.
Kernel D always gathers, walking each Gaussian's whole tile bbox, which is
exact for every bbox size; so it needs no budget and no fallback, and the
port's ``GaussianConfig`` has no ``grad_gather_tiles`` field. The gather
relies, as ``_gather_grads`` does, on each tile's ids being ascending and
front-packed, which every binning method produces.

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

from ..core.binning import tile_bbox_table
from ..core.gaussian2d import BLOCK_H, BLOCK_W, tile_bounds_for
from ..core.render_tiled import render_table, tile_grads
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


def _slot_ids(ids, mask, N: int) -> torch.Tensor:
    """[T, Kp] int64 table rows of the slots: the member ids, the sentinel N
    past them, padded to the slot-list alignment."""
    ids_s = torch.where(mask, ids.to(torch.int64), torch.full_like(ids, N, dtype=torch.int64))
    K = ids.shape[1]
    Kp = _padded_k(K)
    if Kp != K:
        ids_s = torch.nn.functional.pad(ids_s, (0, Kp - K), value=N)
    return ids_s


def _gather(xys, conics, colors, opacity, ids, mask):
    """Gather the table into per-tile blocks: (raw [T, Kp, 16], counts [T],
    the slot ids [T, Kp] int64 it was gathered by)."""
    ids_s = _slot_ids(ids, mask, xys.shape[0])
    raw = _build_table(xys, conics, colors, opacity)[ids_s]
    return raw, mask.sum(dim=1, dtype=torch.int32), ids_s


def _prepare(xys, conics, colors, opacity, ids, mask):
    """Gather the table into per-tile blocks: (raw [T, Kp, 16], counts [T])."""
    return _gather(xys, conics, colors, opacity, ids, mask)[:2]


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
    rc = _build.launch(raw.device, lib.tile_table_forward, raw.data_ptr(), counts.data_ptr(),
                       out.data_ptr(), raw.shape[0], raw.shape[1], tb_x, H, W)
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


def tile_table_backward_plain(raw: torch.Tensor, counts: torch.Tensor, ids: torch.Tensor,
                              bbox: torch.Tensor, v_img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D: the per-(tile, slot) payload of
    ``core/render_tiled.tile_payload`` (the gate in the forward's float64
    emulation of the fused-multiply-add chain), summed per Gaussian by a
    deterministic scatter over the live slots (the JAX default). It takes
    the kernel's arguments, so that either serves the wrapper; of ``bbox``,
    which bounds the kernel's walk, it reads only the row count N. Returns
    [N, 9]."""
    N = bbox.shape[0]
    return tile_grads(raw, ids.to(torch.int64), counts, v_img, N + 1)[:N]


def _setup_bwd(lib):
    lib.tile_table_backward.restype = ctypes.c_int
    lib.tile_table_backward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])


def tile_table_backward(raw: torch.Tensor, counts: torch.Tensor, ids: torch.Tensor,
                        bbox: torch.Tensor, v_img: torch.Tensor) -> torch.Tensor:
    """Kernel D: the gathered table raw [T, K, 16] and counts [T] that kernel
    A read, the slot ids [T, K] int32 (ascending members, front-packed), the
    int32 tile bboxes [N, 4] ``(xmin, xmax, ymin, ymax)`` of the N Gaussians
    and the cotangent image v_img [H, W, 3] -> per-Gaussian gradient payload
    [N, 9] = ``[v_xy(2), v_conic(3, half off-diagonal), v_rgb(3), v_opac]``.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (built at first use) or raises."""
    if v_img.dim() != 3 or v_img.shape[2] != 3:
        raise ValueError(f"v_img must be [H, W, 3], got {tuple(v_img.shape)}")
    H, W, _ = v_img.shape
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    if raw.dim() != 3 or raw.shape[0] != tb_x * tb_y or raw.shape[2] != COLS:
        raise ValueError(f"raw must be [{tb_x * tb_y}, K, {COLS}], got {tuple(raw.shape)}")
    T, K, _ = raw.shape
    if counts.shape != (T,) or ids.shape != (T, K):
        raise ValueError(f"counts must be [{T}] and ids [{T}, {K}], got "
                         f"{tuple(counts.shape)} and {tuple(ids.shape)}")
    if bbox.dim() != 2 or bbox.shape[1] != 4:
        raise ValueError(f"bbox must be [N, 4], got {tuple(bbox.shape)}")
    if raw.dtype != torch.float32 or v_img.dtype != torch.float32:
        raise TypeError("raw and v_img must be float32")
    if any(a.dtype != torch.int32 for a in (counts, ids, bbox)):
        raise TypeError("counts, ids and bbox must be int32")
    dev = raw.device
    if any(a.device != dev for a in (counts, ids, bbox, v_img)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return tile_table_backward_plain(raw, counts, ids, bbox, v_img)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(a.is_contiguous() for a in (raw, counts, ids, bbox, v_img)):
        raise ValueError("inputs must be contiguous")
    N = bbox.shape[0]
    lib = _build.load("tile_table_backward", _setup_bwd)
    # one scratch allocation: the payload [T, K, 9], then the int32 count of
    # live slots before each tile [T + 1]
    scratch = torch.empty((T * K * 9 + T + 1,), dtype=torch.float32, device=dev)
    payload = scratch.data_ptr()
    start = payload + T * K * 9 * scratch.element_size()
    out = torch.empty((N, 9), dtype=torch.float32, device=dev)
    rc = _build.launch(dev, lib.tile_table_backward, raw.data_ptr(), counts.data_ptr(),
                       ids.data_ptr(), bbox.data_ptr(), v_img.data_ptr(), payload, start,
                       out.data_ptr(), T, K, N, tb_x, tb_y, H, W)
    _build.check(rc, "tile_table_backward")
    tile_table_backward.launches += 1
    return out


tile_table_backward.launches = 0


class _RasterizeBinned(torch.autograd.Function):
    """Kernel A forward, kernel D backward on the gathered table, counts and
    slot ids the forward built; gradients reach the centres, conics, colours
    and opacities."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacity, ids, mask, radii, H, W):
        raw, counts, ids_s = _gather(xys, conics, colors, opacity, ids, mask)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(raw, counts, ids_s.to(torch.int32).contiguous(),
                                  tile_bbox_table(xys, radii, tile_bounds_for(H, W)))
            ctx.opacity_shape = opacity.shape
        return tile_table_forward(raw, counts, H, W)

    @staticmethod
    def backward(ctx, v_img):
        raw, counts, ids_s, bbox = ctx.saved_tensors
        acc = tile_table_backward(raw, counts, ids_s, bbox, v_img.contiguous())
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 5:8], acc[:, 8].reshape(ctx.opacity_shape),
                None, None, None, None, None)


def rasterize_binned(xys, conics, colors, opacity, ids, mask, radii, H: int, W: int,
                     block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """The JAX ``rasterize_pallas``: gather + kernel A forward, kernel D
    backward -> unclamped [H, W, 3]. ``radii`` [N] are the projected radii
    that binned ``ids`` (kernel D walks their tile bboxes); differentiable
    in ``xys``, ``conics``, ``colors`` and ``opacity``."""
    return _RasterizeBinned.apply(xys, conics, colors, opacity, ids, mask, radii, H, W)
