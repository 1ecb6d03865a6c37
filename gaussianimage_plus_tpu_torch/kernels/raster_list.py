"""Cap-free chunk-list forward rasterizer and its selection plumbing.

Port of the forward half of ``gaussianimage_plus_tpu/kernels/raster_list_pallas.py``:
``_table_bbox`` (``:105-122``), ``_member_matrix`` (``:125-135``),
``_chunk_lists`` (``:138-166``), ``_default_lmax``, and the two forwards
``rasterize_list_pallas`` (row-major, kc 64) and ``rasterize_list_t_pallas``
(lane-major, kc 128). The two TPU forwards compute one function and differ
only in vector-register layout, so both route to one Hopper kernel,
``chunk_list_forward`` (``csrc/chunk_list_forward.cu``, kernel B), on the
row-major table; ``kc`` stays a parameter because it changes the lists.

Tile t visits exactly its member chunks ``lst[t, :cnt[t]]`` plus the residual
interval ``[lo2[t], hi2[t])`` of chunks past the list width ``lmax``, and
re-tests each row's bbox membership, so the render is exact for any stream
order and any occupancy, with no per-tile cap. The integer lists equal the
JAX ones exactly.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.binning import select_members
from ..core.gaussian2d import BLOCK_H, BLOCK_W, Projected, tile_bbox, tile_bounds_for
from ..core.render_tiled import render_table
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


def _member_matrix(xmin, xmax, ymin, ymax, valid, tb_x, tb_y) -> torch.Tensor:
    """[T, N] tile-membership bools, row t = ty * tb_x + tx (float compares,
    as in the JAX function)."""
    dev = valid.device
    tx = torch.arange(tb_x, dtype=torch.float32, device=dev)
    ty = torch.arange(tb_y, dtype=torch.float32, device=dev)
    in_x = (tx[:, None] >= xmin[None, :]) & (tx[:, None] < xmax[None, :])
    in_y = (ty[:, None] >= ymin[None, :]) & (ty[:, None] < ymax[None, :])
    return (in_y[:, None, :] & in_x[None, :, :] & valid[None, None, :]).reshape(tb_x * tb_y, -1)


def _table_bbox(proj: Projected, colors, opacity, H, W, kc,
                block_h=BLOCK_H, block_w=BLOCK_W):
    """Attribute table [Np, 16] (valid column = ``proj.valid``) and float
    tile bboxes [Np, 4], padded to a multiple of ``kc`` rows, plus the
    [T, N] membership matrix."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    T = tb_x * tb_y
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
    member = _member_matrix(xmin.to(torch.float32), xmax.to(torch.float32),
                            ymin.to(torch.float32), ymax.to(torch.float32),
                            proj.valid, tb_x, tb_y)
    return table.contiguous(), bbox.contiguous(), member, tb_x, tb_y, T, N, Np


def _chunk_lists(member: torch.Tensor, N: int, Np: int, kc: int, lmax: int):
    """Per-tile compacted member-chunk lists + residual interval:
    (lst [T, lmax] int32, cnt [T], lo2 [T], hi2 [T]). Tile t's member chunks
    are lst[t, :cnt[t]] and those in [lo2[t], hi2[t]) (nonempty only past
    lmax member chunks)."""
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
            hi2.to(torch.int32))


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
    t = torch.arange(T, device=dev)
    tx = (t % tb_x).to(torch.float32)[:, None]
    ty = torch.div(t, tb_x, rounding_mode="floor").to(torch.float32)[:, None]
    member = ((tx >= bbox[None, :, 0]) & (tx < bbox[None, :, 1]) &
              (ty >= bbox[None, :, 2]) & (ty < bbox[None, :, 3]) &
              (table[None, :, COLS - 1] > 0.0))                  # [T, Np]
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.chunk_list_forward(
            table.data_ptr(), bbox.data_ptr(), lst.data_ptr(), cnt.data_ptr(),
            lo2.data_ptr(), hi2.data_ptr(), out.data_ptr(),
            T, Np // kc, kc, lst.shape[1], tb_x, H, W, stream)
    _build.check(rc, "chunk_list_forward")
    chunk_list_forward.launches += 1
    return out


chunk_list_forward.launches = 0


def list_inputs(proj: Projected, colors, opacity, H: int, W: int, kc: int,
                lmax: int = None):
    """Everything kernel B reads: (table, bbox, lst, cnt, lo2, hi2)."""
    lmax = _default_lmax(H, W) if lmax is None else lmax
    table, bbox, member, _, _, _, N, Np = _table_bbox(proj, colors, opacity, H, W, kc)
    lst, cnt, lo2, hi2 = _chunk_lists(member, N, Np, kc, lmax)
    return table, bbox, lst, cnt, lo2, hi2


def rasterize_list(proj: Projected, colors, opacity, H: int, W: int,
                   kc: int = None, lmax: int = None) -> torch.Tensor:
    """Forward of ``rasterize_list_pallas`` (kc 64) -> unclamped [H, W, 3]."""
    kc = KC if kc is None else kc
    return chunk_list_forward(*list_inputs(proj, colors, opacity, H, W, kc, lmax), kc, H, W)


def rasterize_list_t(proj: Projected, colors, opacity, H: int, W: int,
                     kc: int = None, lmax: int = None) -> torch.Tensor:
    """Forward of ``rasterize_list_t_pallas`` (kc 128) -> unclamped [H, W, 3]."""
    kc = KC_T if kc is None else kc
    return chunk_list_forward(*list_inputs(proj, colors, opacity, H, W, kc, lmax), kc, H, W)
