"""Cap-free chunk-list rasterizer pair: forward (kernel B) and backward (kernel C).

Port of ``gaussianimage_plus_tpu/kernels/raster_list_pallas.py``:
``_table_bbox`` (``:105-122``), ``_member_matrix`` (``:125-135``, as
``_bbox_members`` on the padded table), ``_chunk_lists`` (``:138-166``),
``_default_lmax``, the two forwards ``rasterize_list_pallas`` (row-major,
kc 64) and ``rasterize_list_t_pallas`` (lane-major, kc 128),
``list_backward`` (``:617-725``) and the differentiable
``rasterize_list`` / ``rasterize_list_t`` (``:733-796``). The two TPU forwards
compute one function and differ only in vector-register layout, so both route
to one Hopper kernel, ``chunk_list_forward`` (``csrc/chunk_list_forward.cu``,
kernel B), on the row-major table; ``kc`` stays a parameter because it changes
the lists.

Tile t visits exactly its member chunks ``lst[t, :cnt[t]]`` plus the residual
interval ``[lo2[t], hi2[t])`` of chunks past the list width ``lmax``, and
re-tests each row's bbox membership, so the render is exact for any stream
order and any occupancy, with no per-tile cap. The integer lists equal the
JAX ones exactly. On the card one hand-written kernel pair enumerates them,
``chunk_lists`` (``csrc/chunk_lists.cu``, kernel F: each row marks its bbox
tiles' chunk, each tile compacts its marks), where the JAX package and the
plain version (``chunk_lists_plain``, the CPU path) build the [T, Np]
membership and reduce it.

The backward is one function on the TPU in three kernels: ``list_backward``
with ``layout="rows"`` (#6, ``_make_list_bwd_kernel``) or ``"lanes"`` (#7,
``_make_list_t_bwd_kernel``), and its exact fallback ``dense_backward`` (#9,
``kernels/raster_dense.py``). Each sums, for every Gaussian, the payload
``[v_xy, v_conic (half off-diagonal), v_rgb, v_opac]`` over its (member tile,
pixel) pairs. All three route to one Hopper kernel, ``chunk_backward``
(``csrc/chunk_backward.cu``, kernel C), on the same row-major table and
bbox that kernel B reads.

Deviation, on purpose: the TPU backward walks per-chunk tile-block lists of
static width ``mtb`` (built from the [T, N] membership) and falls back to
``dense_backward`` through ``lax.cond`` when a chunk spans more than ``mtb``
blocks. Kernel C enumerates each Gaussian's own bbox tiles, so it needs no
list, never overflows and has no fallback. ``mtb`` and ``tb``, which size only
the TPU's lists, are not parameters of ``list_backward`` here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.binning import select_members
from ..core.gaussian2d import BLOCK_H, BLOCK_W, Projected, tile_bbox, tile_bounds_for
from ..core.render_tiled import render_table, tile_grads
from ..utils import profiling
from . import _build
from .raster_binned import COLS, _build_table

KC = 64       # rows per chunk, row-major 'list' backend
KC_T = 128    # rows per chunk, 'list_t' backend
TB_T = 16     # tiles per TPU grid step of list_t; 'auto' picks list_t when T % TB_T == 0
LMAX = 16     # per-tile chunk-list width (residual interval beyond)
LMAX_BIG = 8  # list width for big tile grids
BIG_T = 4096  # tile-count threshold between the two widths


def _default_lmax(H, W, block_h=BLOCK_H, block_w=BLOCK_W) -> int:
    """16 at Kodak-like grids, 8 for T >= 4096 (the JAX default)."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    return LMAX_BIG if tb_x * tb_y >= BIG_T else LMAX


def _table_bbox(proj: Projected, colors, opacity, H, W, kc,
                block_h=BLOCK_H, block_w=BLOCK_W):
    """Attribute table [Np, 16] (valid column = ``proj.valid``) and float
    tile bboxes [Np, 4], padded with invalid rows to a multiple of ``kc``
    rows (at least one past N), and (N, Np)."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    N = proj.xys.shape[0]
    table = _build_table(proj.xys, proj.conics, colors, opacity)
    table[:N, COLS - 1] = proj.valid.to(torch.float32)
    xmin, xmax, ymin, ymax = tile_bbox(
        proj.xys, proj.radii.to(torch.float32), (tb_x, tb_y), block_h, block_w)
    bbox = torch.stack([xmin, xmax, ymin, ymax], dim=-1).to(torch.float32)
    bbox = torch.cat([bbox, bbox.new_zeros((1, 4))], dim=0)
    Np = -(-(N + 1) // kc) * kc
    if Np != N + 1:
        table = torch.nn.functional.pad(table, (0, 0, 0, Np - N - 1))
        bbox = torch.nn.functional.pad(bbox, (0, 0, 0, Np - N - 1))
    return table.contiguous(), bbox.contiguous(), N, Np


def _bbox_members(table: torch.Tensor, bbox: torch.Tensor, tb_x: int, T: int) -> torch.Tensor:
    """[T, Np] membership of the table rows, tested as the kernels test it:
    the tile lies in the row's float bbox and the row is valid."""
    t = torch.arange(T, device=table.device)
    tx = (t % tb_x).to(torch.float32)[:, None]
    ty = torch.div(t, tb_x, rounding_mode="floor").to(torch.float32)[:, None]
    return ((tx >= bbox[None, :, 0]) & (tx < bbox[None, :, 1]) &
            (ty >= bbox[None, :, 2]) & (ty < bbox[None, :, 3]) &
            (table[None, :, COLS - 1] > 0.0))


def _chunk_lists(member: torch.Tensor, N: int, Np: int, kc: int, lmax: int):
    """Per-tile compacted member-chunk lists + residual interval:
    (lst [T, lmax] int32, cnt [T], lo2 [T], hi2 [T]). Tile t's member chunks
    are lst[t, :cnt[t]] and those in [lo2[t], hi2[t]) (nonempty only past
    lmax member chunks)."""
    return _lists_and_members(member, Np, kc, lmax)[0]


def _lists_and_members(member: torch.Tensor, Np: int, kc: int, lmax: int):
    """``_chunk_lists``' lists and each tile's count of member chunks [T]
    (int32), which the lists are built from."""
    T = member.shape[0]
    nch = Np // kc
    dev = member.device
    if member.shape[1] != Np:
        member = torch.nn.functional.pad(member, (0, Np - member.shape[1]))
    mc = member.reshape(T, nch, kc).any(dim=-1)                 # [T, nch]
    ids_c = torch.arange(nch, dtype=torch.int32, device=dev)
    cnt_full = mc.sum(dim=-1, dtype=torch.int32)
    k_sel = min(lmax + 1, nch)
    key = torch.where(mc, nch - ids_c[None, :], torch.zeros((), dtype=torch.int32, device=dev))
    topv = torch.topk(key, k_sel, dim=1).values
    lids = torch.where(topv > 0, nch - topv, torch.zeros_like(topv)).to(torch.int32)
    lst = lids[:, :lmax]
    if lst.shape[1] < lmax:
        lst = torch.nn.functional.pad(lst, (0, lmax - lst.shape[1]))
    cnt = torch.clamp(cnt_full, max=lmax)
    over = cnt_full > lmax
    zero = torch.zeros((T,), dtype=torch.int32, device=dev)
    lo2 = torch.where(over, lids[:, lmax], zero) if k_sel == lmax + 1 else zero
    last = torch.where(mc, ids_c[None, :], torch.full_like(mc, -1, dtype=torch.int32)).amax(dim=-1)
    hi2 = torch.where(over, last + 1, zero)
    return (lst.contiguous(), cnt.to(torch.int32), lo2.to(torch.int32),
            hi2.to(torch.int32)), cnt_full


def chunk_list_forward_plain(table, bbox, lst, cnt, lo2, hi2, kc: int,
                             H: int, W: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B: each tile's visited rows, tested
    for membership, gathered in ascending order, then blended with the
    arithmetic of kernel A (``core/render_tiled.py``)."""
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    T = tb_x * tb_y
    Np = table.shape[0]
    nch = Np // kc
    dev = table.device
    lmax = lst.shape[1]
    ch = torch.arange(nch, device=dev)
    listed = torch.zeros((T, nch + 1), dtype=torch.bool, device=dev)
    slots = torch.where(torch.arange(lmax, device=dev)[None, :] < cnt[:, None],
                        lst.to(torch.int64), torch.full_like(lst, nch, dtype=torch.int64))
    listed.scatter_(1, slots, True)
    visited = listed[:, :nch] | ((ch[None, :] >= lo2[:, None]) & (ch[None, :] < hi2[:, None]))
    member = _bbox_members(table, bbox, tb_x, T)                   # [T, Np]
    member &= visited.repeat_interleave(kc, dim=1)
    kmax = max(int(member.sum(dim=1).max()), 1) if T else 1
    bins = select_members(member, kmax)
    sentinel = torch.zeros((1, COLS), dtype=table.dtype, device=dev)
    ext = torch.cat([table, sentinel], dim=0)
    raw = ext[torch.where(bins.mask, bins.ids.to(torch.int64),
                          torch.full_like(bins.ids, Np, dtype=torch.int64))]
    return render_table(raw, bins.count, H, W, BLOCK_H, BLOCK_W)


def _setup(lib):
    lib.chunk_list_forward.restype = ctypes.c_int
    lib.chunk_list_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                       + [ctypes.c_void_p])


def chunk_list_forward(table, bbox, lst, cnt, lo2, hi2, kc: int,
                       H: int, W: int) -> torch.Tensor:
    """Kernel B: table [Np, 16], bbox [Np, 4], lst [T, lmax], cnt/lo2/hi2 [T]
    -> unclamped [H, W, 3]. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (built at first use) or raises."""
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    T = tb_x * tb_y
    Np = table.shape[0]
    if not 1 <= kc <= KC_T:
        raise ValueError(f"kc must be in [1, {KC_T}], got {kc}")
    if table.dim() != 2 or table.shape[1] != COLS or Np % kc:
        raise ValueError(f"table must be [Np, {COLS}] with Np % kc == 0, got {tuple(table.shape)}")
    if bbox.shape != (Np, 4):
        raise ValueError(f"bbox must be [{Np}, 4], got {tuple(bbox.shape)}")
    if lst.dim() != 2 or lst.shape[0] != T:
        raise ValueError(f"lst must be [{T}, lmax], got {tuple(lst.shape)}")
    for name, a in (("cnt", cnt), ("lo2", lo2), ("hi2", hi2)):
        if a.shape != (T,):
            raise ValueError(f"{name} must be [{T}], got {tuple(a.shape)}")
    if table.dtype != torch.float32 or bbox.dtype != torch.float32:
        raise TypeError("table and bbox must be float32")
    if any(a.dtype != torch.int32 for a in (lst, cnt, lo2, hi2)):
        raise TypeError("lst, cnt, lo2 and hi2 must be int32")
    dev = table.device
    if any(a.device != dev for a in (bbox, lst, cnt, lo2, hi2)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return chunk_list_forward_plain(table, bbox, lst, cnt, lo2, hi2, kc, H, W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(a.is_contiguous() for a in (table, bbox, lst, cnt, lo2, hi2)):
        raise ValueError("inputs must be contiguous")
    lib = _build.load("chunk_list_forward", _setup)
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    rc = _build.launch(
        dev, lib.chunk_list_forward, table.data_ptr(), bbox.data_ptr(), lst.data_ptr(),
        cnt.data_ptr(), lo2.data_ptr(), hi2.data_ptr(), out.data_ptr(),
        T, Np // kc, kc, lst.shape[1], tb_x, H, W)
    _build.check(rc, "chunk_list_forward")
    chunk_list_forward.launches += 1
    return out


chunk_list_forward.launches = 0


def chunk_lists_plain(table, bbox, Np: int, kc: int, lmax: int, H: int, W: int):
    """Plain PyTorch version of kernel F: the [T, Np] membership
    (``_bbox_members``) reduced to each tile's lists and member-chunk count
    (``_lists_and_members``)."""
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    return _lists_and_members(_bbox_members(table, bbox, tb_x, tb_x * tb_y), Np, kc, lmax)


def _setup_lists(lib):
    lib.chunk_lists.restype = ctypes.c_int
    lib.chunk_lists.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def chunk_lists(table, bbox, Np: int, kc: int, lmax: int, H: int, W: int):
    """Kernel F: table [rows, 16] and bbox [rows, 4] (rows <= Np, Np % kc ==
    0) -> ((lst [T, lmax], cnt, lo2, hi2), members [T]), int32, integer for
    integer what ``_lists_and_members`` returns. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (built at first use) or
    raises, builds no [T, Np] tensor and counts ``lists.kernel_tiles`` (T)
    while ``utils.profiling.counting()``."""
    rows = table.shape[0]
    if kc < 1 or Np % kc or not 0 <= rows <= Np:
        raise ValueError(f"need kc >= 1, Np % kc == 0 and rows <= Np; got kc {kc}, "
                         f"Np {Np}, {rows} rows")
    if lmax < 0:
        raise ValueError(f"lmax must be >= 0, got {lmax}")
    if table.dim() != 2 or table.shape[1] != COLS or bbox.shape != (rows, 4):
        raise ValueError(f"table must be [rows, {COLS}] and bbox [rows, 4], got "
                         f"{tuple(table.shape)} and {tuple(bbox.shape)}")
    if table.dtype != torch.float32 or bbox.dtype != torch.float32:
        raise TypeError("table and bbox must be float32")
    dev = table.device
    if bbox.device != dev:
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return chunk_lists_plain(table, bbox, Np, kc, lmax, H, W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (table.is_contiguous() and bbox.is_contiguous()) or bbox.data_ptr() % 16:
        raise ValueError("table and bbox must be contiguous, bbox 16-byte aligned")
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    T, nch = tb_x * tb_y, Np // kc
    lib = _build.load("chunk_lists", _setup_lists)
    mark = torch.empty((T, nch), dtype=torch.uint8, device=dev)
    lst = torch.empty((T, lmax), dtype=torch.int32, device=dev)
    cnt, lo2, hi2, members = torch.empty((4, T), dtype=torch.int32, device=dev).unbind(0)
    rc = _build.launch(dev, lib.chunk_lists, table.data_ptr(), bbox.data_ptr(), mark.data_ptr(),
                       lst.data_ptr(), cnt.data_ptr(), lo2.data_ptr(), hi2.data_ptr(),
                       members.data_ptr(), rows, nch, kc, lmax, tb_x, tb_y)
    _build.check(rc, "chunk_lists")
    chunk_lists.launches += 1
    profiling.count_device("lists.kernel_tiles", T)
    return (lst, cnt, lo2, hi2), members


chunk_lists.launches = 0


def member_lists(table, bbox, N: int, Np: int, kc: int, H: int, W: int,
                 lmax: int = None):
    """The chunk-list enumeration: each tile's member chunks, the first
    ``lmax`` listed and the rest as a residual interval -> (lst, cnt, lo2,
    hi2), through kernel F (``chunk_lists``) on the card and its plain
    version on the CPU. While ``utils.profiling.counting()`` it also counts
    the lists (``_count_lists``); otherwise, and under a capture, it runs
    only the enumeration."""
    lmax = _default_lmax(H, W) if lmax is None else lmax
    lists, members = chunk_lists(table, bbox, Np, kc, lmax, H, W)
    if profiling.counting():
        _count_lists(lists, members)
    return lists


def _count_lists(lists, members) -> None:
    """Device counters of one enumeration (``utils/profiling.py``): its
    tiles (``lists.tiles``), the tiles whose member chunks exceed the list
    width (``lists.overflow_tiles``), the member chunks
    (``lists.member_chunks``), and the chunks kernel B visits, the listed
    ones and the residual interval (``lists.visited_chunks``). ``members``
    is each tile's count of member chunks; nothing is read on the host."""
    _, cnt, lo2, hi2 = lists
    profiling.count_device("lists.tiles", cnt.shape[0])
    profiling.count_device("lists.overflow_tiles", (members > cnt).sum())
    profiling.count_device("lists.member_chunks", members.sum())
    profiling.count_device("lists.visited_chunks", cnt.sum() + (hi2 - lo2).sum())


def list_inputs(proj: Projected, colors, opacity, H: int, W: int, kc: int,
                lmax: int = None):
    """Everything kernel B reads: (table, bbox, lst, cnt, lo2, hi2)."""
    table, bbox, N, Np = _table_bbox(proj, colors, opacity, H, W, kc)
    return (table, bbox) + member_lists(table, bbox, N, Np, kc, H, W, lmax)


def chunk_backward_plain(table: torch.Tensor, bbox: torch.Tensor,
                         v_img: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel C: each tile's member rows, gathered
    in ascending order, the per-(tile, member) payload of
    ``core/render_tiled.tile_payload`` (the gate in the forward's float64
    emulation of the fused-multiply-add chain), summed per row by a
    deterministic ``index_add_``. Returns the payload [Np, 16] (columns 0-8
    live)."""
    H, W, _ = v_img.shape
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    T = tb_x * tb_y
    Np = table.shape[0]
    member = _bbox_members(table, bbox, tb_x, T)
    kmax = max(int(member.sum(dim=1).max()), 1) if T else 1
    bins = select_members(member, kmax)
    ids = torch.where(bins.mask, bins.ids.to(torch.int64),
                      torch.full_like(bins.ids, Np, dtype=torch.int64))
    ext = torch.cat([table, table.new_zeros((1, COLS))], dim=0)
    acc = tile_grads(ext[ids], ids, bins.count, v_img, Np + 1)
    payload = table.new_zeros((Np, COLS))
    payload[:, :9] = acc[:Np]
    return payload


def _setup_bwd(lib):
    lib.chunk_backward.restype = ctypes.c_int
    lib.chunk_backward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def chunk_backward(table: torch.Tensor, bbox: torch.Tensor, v_img: torch.Tensor) -> torch.Tensor:
    """Kernel C: table [Np, 16] and bbox [Np, 4] (as kernel B reads them)
    and the cotangent image v_img [H, W, 3] -> the per-row gradient payload
    [Np, 16] = ``[v_xy(2), v_conic(3, half off-diagonal), v_rgb(3),
    v_opac, 0 x 7]``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (built at first use) or raises."""
    Np = table.shape[0]
    if table.dim() != 2 or table.shape[1] != COLS:
        raise ValueError(f"table must be [Np, {COLS}], got {tuple(table.shape)}")
    if bbox.shape != (Np, 4):
        raise ValueError(f"bbox must be [{Np}, 4], got {tuple(bbox.shape)}")
    if v_img.dim() != 3 or v_img.shape[2] != 3:
        raise ValueError(f"v_img must be [H, W, 3], got {tuple(v_img.shape)}")
    if any(a.dtype != torch.float32 for a in (table, bbox, v_img)):
        raise TypeError("table, bbox and v_img must be float32")
    dev = table.device
    if bbox.device != dev or v_img.device != dev:
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return chunk_backward_plain(table, bbox, v_img)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(a.is_contiguous() for a in (table, bbox, v_img)):
        raise ValueError("inputs must be contiguous")
    H, W, _ = v_img.shape
    tb_x, tb_y = tile_bounds_for(H, W, BLOCK_H, BLOCK_W)
    lib = _build.load("chunk_backward", _setup_bwd)
    out = torch.empty((Np, COLS), dtype=torch.float32, device=dev)
    rc = _build.launch(dev, lib.chunk_backward, table.data_ptr(), bbox.data_ptr(),
                       v_img.data_ptr(), out.data_ptr(), Np, tb_x, tb_y, H, W)
    _build.check(rc, "chunk_backward")
    chunk_backward.launches += 1
    return out


chunk_backward.launches = 0


def split_payload(payload: torch.Tensor, N: int, opacity: torch.Tensor):
    """Payload rows [:N] -> (v_xys, v_conics, v_colors, v_opacity)."""
    return (payload[:N, 0:2], payload[:N, 2:5], payload[:N, 5:8],
            payload[:N, 8].reshape(opacity.shape))


def list_backward(proj: Projected, colors, opacity, v_img, H: int, W: int,
                  kc: int = None, layout: str = "rows"):
    """Per-Gaussian gradients (v_xys, v_conics, v_colors, v_opacity) of the
    chunk-list render, through kernel C. ``kc`` (default 64 for ``'rows'``,
    128 for ``'lanes'``) sets the table padding."""
    if layout not in ("rows", "lanes"):
        raise ValueError(f"unknown layout {layout!r}")
    kc = (KC_T if layout == "lanes" else KC) if kc is None else kc
    table, bbox, N, _ = _table_bbox(proj, colors, opacity, H, W, kc)
    return split_payload(chunk_backward(table, bbox, v_img.contiguous()), N, opacity)


class RasterizeChunks(torch.autograd.Function):
    """Kernel B forward over the chunks that ``lists(table, bbox, N, Np, kc,
    H, W) -> (lst, cnt, lo2, hi2)`` enumerates, kernel C backward on the
    table and bbox the forward built; gradients reach the centres, conics,
    colours and opacities. Every enumeration that covers each tile's member
    chunks renders the same cap-free function, so they share this backward."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacity, radii, valid, H, W, kc, lists):
        proj = Projected(xys, conics, radii, torch.zeros_like(radii), valid)
        table, bbox, N, Np = _table_bbox(proj, colors, opacity, H, W, kc)
        ctx.save_for_backward(table, bbox, opacity)
        ctx.n = N
        return chunk_list_forward(table, bbox, *lists(table, bbox, N, Np, kc, H, W), kc, H, W)

    @staticmethod
    def backward(ctx, v_img):
        table, bbox, opacity = ctx.saved_tensors
        payload = chunk_backward(table, bbox, v_img.contiguous())
        return (*split_payload(payload, ctx.n, opacity),
                None, None, None, None, None, None)


def rasterize_list(proj: Projected, colors, opacity, H: int, W: int,
                   kc: int = None, lmax: int = None) -> torch.Tensor:
    """Differentiable ``rasterize_list`` (kc 64, row-major TPU bodies #4 and
    #6) -> unclamped [H, W, 3]."""
    kc = KC if kc is None else kc
    return RasterizeChunks.apply(proj.xys, proj.conics, colors, opacity, proj.radii,
                                 proj.valid, H, W, kc, functools.partial(member_lists, lmax=lmax))


def rasterize_list_t(proj: Projected, colors, opacity, H: int, W: int,
                     kc: int = None, lmax: int = None) -> torch.Tensor:
    """Differentiable ``rasterize_list_t`` (kc 128, lane-major TPU bodies #5
    and #7) -> unclamped [H, W, 3]."""
    kc = KC_T if kc is None else kc
    return RasterizeChunks.apply(proj.xys, proj.conics, colors, opacity, proj.radii,
                                 proj.valid, H, W, kc, functools.partial(member_lists, lmax=lmax))
