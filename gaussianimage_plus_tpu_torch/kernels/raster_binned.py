"""Binned, capped rasterizer over the attribute table and the slot ids, and its backward.

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

Data layout: one attribute table ``[N+1, 16]`` with rows ``[c1, c2, c3, mx,
my, r, g, b, opac, 0.., valid=1]`` and an all-zero sentinel row N, and the
int32 slot ids ``[T, K]`` (a tile's members, then the sentinel N). A tile's
members are front-packed, so only its first ``counts[t]`` slots are read,
and the same kernel serves the untrimmed binned table and the trimmed
bin-once table.

Deviation, on purpose (see ``Prepared``): the JAX package gathers ``raw =
table[ids]`` ``[T, K, 16]`` before its kernels; kernels A and D read the
attribute table (a few hundred KB, resident in the card's L2) through the
slot ids instead, so that table, 25 MB at 768x512 and 176 MB at 2040x1344,
is never built on the card. ``_gather`` builds it for the plain versions.
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
    """[T, Kp] int32 table rows of the slots: the member ids, the sentinel N
    past them, padded to the slot-list alignment."""
    ids_s = torch.where(mask, ids.to(torch.int32), torch.full_like(ids, N, dtype=torch.int32))
    K = ids.shape[1]
    Kp = _padded_k(K)
    if Kp != K:
        ids_s = torch.nn.functional.pad(ids_s, (0, Kp - K), value=N)
    return ids_s


def _slot_table(xys, conics, colors, opacity, ids, mask):
    """The kernels' inputs: (table [N+1, 16], slot ids [T, Kp] int32,
    counts [T] int32)."""
    return (_build_table(xys, conics, colors, opacity), _slot_ids(ids, mask, xys.shape[0]),
            mask.sum(dim=1, dtype=torch.int32))


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The plain versions' per-tile blocks ``table[ids]`` [T, K, 16]; a slot
    id outside [0, N] reads the sentinel row N, as in the kernels."""
    N = table.shape[0] - 1
    ids = ids.to(torch.int64)
    return table[torch.where((ids < 0) | (ids > N), N, ids)]


def _prepare(xys, conics, colors, opacity, ids, mask):
    """Gather the table into per-tile blocks for the plain path: (raw
    [T, Kp, 16], counts [T])."""
    table, ids_s, counts = _slot_table(xys, conics, colors, opacity, ids, mask)
    return _gather(table, ids_s), counts


class Prepared(NamedTuple):
    """A binned render input: the decode fast path renders a static stream
    from it with no per-frame binning (see the JAX
    ``raster_pallas.Prepared``).

    Deviation, on purpose: the JAX ``Prepared`` holds the gathered blocks
    ``raw = table[ids]`` [T, Kp, 16] and ``counts``. This one holds the
    attribute table and the slot ids instead, which kernel A reads through;
    ``_gather(table, ids)`` is the JAX ``raw``. Trimming the capacity cuts
    ``ids``."""

    table: torch.Tensor   # [N+1, COLS]
    ids: torch.Tensor     # [T, Kp] int32
    counts: torch.Tensor  # [T] int32


def prepare_raster(xys, conics, colors, opacity, ids, mask, H, W,
                   block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> Prepared:
    """Bin-once stage: the attribute table and the slot ids (the tile grid
    is the rows of ``ids``; ``H``, ``W`` and the block size keep the JAX
    signature)."""
    return Prepared(*_slot_table(xys, conics, colors, opacity, ids, mask))


def _check_table(table: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor, T: int) -> None:
    if table.dim() != 2 or table.shape[0] < 1 or table.shape[1] != COLS:
        raise ValueError(f"table must be [N+1, {COLS}], got {tuple(table.shape)}")
    if ids.dim() != 2 or ids.shape[0] != T:
        raise ValueError(f"ids must be [{T}, K], got {tuple(ids.shape)}")
    if counts.shape != (T,):
        raise ValueError(f"counts must be [{T}], got {tuple(counts.shape)}")
    if table.dtype != torch.float32 or ids.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("table must be float32, ids and counts int32")


def tile_table_forward_plain(table: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor,
                             H: int, W: int) -> torch.Tensor:
    """Plain PyTorch version of kernel A: gather, then the same function in
    the same arithmetic for ``sigma`` (``core/render_tiled.py``)."""
    return render_table(_gather(table, ids), counts, H, W, BLOCK_H, BLOCK_W)


def _setup(lib):
    lib.tile_table_forward.restype = ctypes.c_int
    lib.tile_table_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def tile_table_forward(table: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor,
                       H: int, W: int) -> torch.Tensor:
    """Kernel A: the attribute table [N+1, 16], the slot ids [T, K] int32
    and counts [T] -> unclamped [H, W, 3].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (built at first use) or raises."""
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    _check_table(table, ids, counts, tb_x * tb_y)
    dev = table.device
    if ids.device != dev or counts.device != dev:
        raise ValueError("table, ids and counts must be on one device")
    if dev.type == "cpu":
        return tile_table_forward_plain(table, ids, counts, H, W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (table.is_contiguous() and ids.is_contiguous() and counts.is_contiguous()):
        raise ValueError("table, ids and counts must be contiguous")
    lib = _build.load("tile_table_forward", _setup)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    T, K = ids.shape
    rc = _build.launch(dev, lib.tile_table_forward, table.data_ptr(), ids.data_ptr(),
                       counts.data_ptr(), out.data_ptr(), T, table.shape[0] - 1, K, tb_x, H, W)
    _build.check(rc, "tile_table_forward")
    tile_table_forward.launches += 1
    return out


tile_table_forward.launches = 0


def rasterize_prepared(prep: Prepared, H: int, W: int) -> torch.Tensor:
    """Forward-only render from a prepared table -> unclamped [H, W, 3]."""
    return tile_table_forward(prep.table, prep.ids, prep.counts, H, W)


def rasterize_prepared_flat(prep: Prepared, H: int, W: int) -> torch.Tensor:
    """The bin-once decode render (``decode_frame``). The JAX package's flat
    kernel exists to avoid TPU predication; it computes the function of
    ``rasterize_prepared``, and so runs the same kernel here."""
    return tile_table_forward(prep.table, prep.ids, prep.counts, H, W)


def tile_table_backward_plain(table: torch.Tensor, counts: torch.Tensor, ids: torch.Tensor,
                              bbox: torch.Tensor, v_img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D: the per-(tile, slot) payload of
    ``core/render_tiled.tile_payload`` over the gathered table (the gate in
    the forward's float64 emulation of the fused-multiply-add chain), summed
    per Gaussian by a deterministic scatter over the live slots (the JAX
    default). It takes the kernel's arguments, so that either serves the
    wrapper; of ``bbox``, which bounds the kernel's walk, it reads only the
    row count N. Returns [N, 9]."""
    N = bbox.shape[0]
    return tile_grads(_gather(table, ids), ids.to(torch.int64), counts, v_img, N + 1)[:N]


def _setup_bwd(lib):
    lib.tile_table_backward.restype = ctypes.c_int
    lib.tile_table_backward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])


def tile_table_backward(table: torch.Tensor, counts: torch.Tensor, ids: torch.Tensor,
                        bbox: torch.Tensor, v_img: torch.Tensor) -> torch.Tensor:
    """Kernel D: the attribute table [N+1, 16], counts [T] and slot ids
    [T, K] int32 (ascending members, front-packed) that kernel A read, the
    int32 tile bboxes [N, 4] ``(xmin, xmax, ymin, ymax)`` of the N Gaussians
    and the cotangent image v_img [H, W, 3] -> per-Gaussian gradient payload
    [N, 9] = ``[v_xy(2), v_conic(3, half off-diagonal), v_rgb(3), v_opac]``.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (built at first use) or raises."""
    if v_img.dim() != 3 or v_img.shape[2] != 3:
        raise ValueError(f"v_img must be [H, W, 3], got {tuple(v_img.shape)}")
    H, W, _ = v_img.shape
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    T = tb_x * tb_y
    _check_table(table, ids, counts, T)
    K = ids.shape[1]
    if bbox.dim() != 2 or bbox.shape[1] != 4 or table.shape[0] != bbox.shape[0] + 1:
        raise ValueError(f"bbox must be [N, 4] for a table of N+1 rows, got "
                         f"{tuple(bbox.shape)} and {tuple(table.shape)}")
    if v_img.dtype != torch.float32 or bbox.dtype != torch.int32:
        raise TypeError("v_img must be float32 and bbox int32")
    dev = table.device
    if any(a.device != dev for a in (counts, ids, bbox, v_img)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return tile_table_backward_plain(table, counts, ids, bbox, v_img)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(a.is_contiguous() for a in (table, counts, ids, bbox, v_img)):
        raise ValueError("inputs must be contiguous")
    N = bbox.shape[0]
    lib = _build.load("tile_table_backward", _setup_bwd)
    # one scratch allocation: the payload [T, K, 9], then the int32 count of
    # live slots before each tile [T + 1]
    scratch = torch.empty((T * K * 9 + T + 1,), dtype=torch.float32, device=dev)
    payload = scratch.data_ptr()
    start = payload + T * K * 9 * scratch.element_size()
    out = torch.empty((N, 9), dtype=torch.float32, device=dev)
    rc = _build.launch(dev, lib.tile_table_backward, table.data_ptr(), counts.data_ptr(),
                       ids.data_ptr(), bbox.data_ptr(), v_img.data_ptr(), payload, start,
                       out.data_ptr(), T, K, N, tb_x, tb_y, H, W)
    _build.check(rc, "tile_table_backward")
    tile_table_backward.launches += 1
    return out


tile_table_backward.launches = 0


class _RasterizeBinned(torch.autograd.Function):
    """Kernel A forward, kernel D backward on the attribute table, slot ids
    and counts the forward built; gradients reach the centres, conics,
    colours and opacities."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacity, ids, mask, radii, H, W):
        table, ids_s, counts = _slot_table(xys, conics, colors, opacity, ids, mask)
        if any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(table, counts, ids_s,
                                  tile_bbox_table(xys, radii, tile_bounds_for(H, W)))
            ctx.opacity_shape = opacity.shape
        return tile_table_forward(table, ids_s, counts, H, W)

    @staticmethod
    def backward(ctx, v_img):
        table, counts, ids_s, bbox = ctx.saved_tensors
        acc = tile_table_backward(table, counts, ids_s, bbox, v_img.contiguous())
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 5:8], acc[:, 8].reshape(ctx.opacity_shape),
                None, None, None, None, None)


def rasterize_binned(xys, conics, colors, opacity, ids, mask, radii, H: int, W: int,
                     block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """The JAX ``rasterize_pallas``: kernel A forward, kernel D backward,
    both reading the attribute table through the slot ids -> unclamped
    [H, W, 3]. ``radii`` [N] are the projected radii that binned ``ids``
    (kernel D walks their tile bboxes); differentiable in ``xys``,
    ``conics``, ``colors`` and ``opacity``."""
    return _RasterizeBinned.apply(xys, conics, colors, opacity, ids, mask, radii, H, W)
