"""Tile binning: fixed-capacity per-tile Gaussian lists, and Morton order.

Port of ``gaussianimage_plus_tpu/core/binning.py`` — ``bin_gaussians`` with
the exact ``'top_k'``, ``'scatter'`` and ``'rank'`` selections (``:91-119``,
``:245-315``; none reads a value on the host: ``select_members``), the
two-level ``'hier'`` method (``_bin_hier``, ``:122-172``, plain tensor code
in both packages), ``morton_perm`` (``:318-343``), and the
row-range binners of the tile-sharded render: ``_membership_rows``
(``:70-89``), ``bin_gaussian_rows`` (``:175-184``), ``bin_gaussian_rows_hier``
(``:187-244``) and ``gather_tile_attrs`` (``:346-348``).
Each tile keeps its first ``cap`` members in Gaussian-index order (the
reference's silent per-tile cap, forward.cu:673), so ids/mask/count equal
the JAX ones exactly. Slots past the count hold id 0 and ``mask=False``.
``method='pallas'`` is the hand-written binner, kernel E
(``kernels/binning_tiles.py``), which gives the ``'top_k'`` result.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .gaussian2d import BLOCK_H, BLOCK_W, Projected, _to_int32, tile_bbox, tile_bounds_for


class TileBins(NamedTuple):
    """ids [T, cap] int32 (0 where ~mask), mask [T, cap] bool, count [T] int32;
    ``super_overflow`` ([] int32, ``'hier'`` only, else None): candidates
    dropped at the super-tile level. Nonzero means the result may differ from
    the flat binning even in tiles under ``cap``."""

    ids: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    super_overflow: Optional[torch.Tensor] = None


def _membership(proj: Projected, tile_bounds: Tuple[int, int],
                block_h: int, block_w: int) -> torch.Tensor:
    """[T, N] bool — tile t (y-major) lies inside Gaussian n's bbox, n valid."""
    tb_x, tb_y = tile_bounds
    xmin, xmax, ymin, ymax = tile_bbox(
        proj.xys, proj.radii.to(torch.float32), tile_bounds, block_h, block_w)
    dev = proj.xys.device
    tx = torch.arange(tb_x, dtype=torch.int32, device=dev)
    ty = torch.arange(tb_y, dtype=torch.int32, device=dev)
    in_x = (tx[:, None] >= xmin[None, :]) & (tx[:, None] < xmax[None, :])   # [tbx, N]
    in_y = (ty[:, None] >= ymin[None, :]) & (ty[:, None] < ymax[None, :])   # [tby, N]
    member = in_y[:, None, :] & in_x[None, :, :] & proj.valid[None, None, :]
    return member.reshape(tb_y * tb_x, -1)


def _first_by_rank(member: torch.Tensor, cap: int, count: torch.Tensor):
    """(ids, mask) [T, cap]: the (s+1)-th member of a row is the first index
    where the inclusive membership cumsum reaches s+1, one batched binary
    search (``torch.searchsorted``) over the nondecreasing rank rows."""
    T, N = member.shape
    rank = torch.cumsum(member, dim=1, dtype=torch.int32)
    k_eff = min(cap, N)
    targets = torch.arange(1, k_eff + 1, dtype=torch.int32, device=member.device)
    lo = torch.searchsorted(rank, targets.expand(T, k_eff).contiguous(), out_int32=True)
    mask = targets[None, :] <= count[:, None]
    ids = torch.where(mask, torch.clamp(lo, max=N - 1), torch.zeros_like(lo))
    if k_eff < cap:
        ids = torch.nn.functional.pad(ids, (0, cap - k_eff))
        mask = torch.nn.functional.pad(mask, (0, cap - k_eff))
    return ids, mask


def _first_by_scatter(member: torch.Tensor, cap: int, count: torch.Tensor):
    """(ids, mask) [T, cap]: each member written to its rank slot, the rest
    to a dropped column."""
    T, N = member.shape
    dev = member.device
    rank = torch.cumsum(member, dim=1, dtype=torch.int32) - 1
    slot = torch.where(member & (rank < cap), rank, torch.full_like(rank, cap))
    gidx = torch.arange(N, dtype=torch.int32, device=dev).expand(T, N)
    ids = torch.zeros((T, cap + 1), dtype=torch.int32, device=dev)
    ids.scatter_(1, slot.to(torch.int64), gidx)   # slot == cap: dropped column
    ids = ids[:, :cap].contiguous()
    mask = torch.arange(cap, device=dev)[None, :] < count[:, None]
    return torch.where(mask, ids, torch.zeros_like(ids)), mask


def select_members(member: torch.Tensor, cap: int, method: str = "top_k") -> TileBins:
    """First ``cap`` members of each row of a [T, N] bool matrix, in index
    order: ids, mask and count equal the JAX ``_select_members``'s bit for
    bit, whatever the method. ``'rank'`` binary-searches each slot's member
    in the membership cumsum; ``'scatter'`` writes each member to its rank
    slot; ``'top_k'`` is the JAX name of the default.

    No method reads a value on the host, so a CUDA graph can hold each. The
    JAX ``'top_k'`` runs ``lax.top_k`` at an occupancy tier that it picks on
    the device with ``lax.switch`` (64, 128 or ``min(cap, N)``); every tier
    selects the same members, so the tier is only a speed choice, and
    reading it on the host here would sync the step. ``'top_k'`` therefore
    runs the rank search, the fastest exact selection on the card, in ms a
    call in a CUDA graph (``scripts/torch_select_members.py``; NVIDIA H100
    80GB HBM3, 700.00 W):

    - odd-grid fit state ``[1457, 5000]``, cap 256: 0.2030; ``torch.topk``
      at ``min(cap, N)`` 0.2607, the scatter 0.3299 (``torch.topk`` at the
      tier 128 that the JAX function picks there 0.1884);
    - 2K ``'hier'`` level 1 ``[176, 20000]``, 1024: 0.1008; topk 0.1351;
    - 2K ``'hier'`` level 2 ``[10752, 1024]``, 256: 0.2287; topk 0.6646,
      the scatter 0.4071.
    """
    count = torch.clamp(member.sum(dim=1, dtype=torch.int32), max=cap)
    if method in ("top_k", "rank"):
        ids, mask = _first_by_rank(member, cap, count)
    elif method == "scatter":
        ids, mask = _first_by_scatter(member, cap, count)
    else:
        raise ValueError(f"unknown binning method {method!r}")
    return TileBins(ids=ids.to(torch.int32), mask=mask, count=count)


def tile_bbox_table(xys: torch.Tensor, radii: torch.Tensor, tile_bounds: Tuple[int, int],
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, 4] int32 ``(xmin, xmax, ymin, ymax)`` tile bboxes of the projected
    radii (the rectangle ``_membership`` tests); with ``valid``, invalid rows
    get the empty bbox ``(1, 0, 1, 0)``, as in the JAX Pallas binner."""
    bbox = torch.stack(tile_bbox(xys, radii.to(torch.float32), tile_bounds, BLOCK_H, BLOCK_W),
                       dim=-1).to(torch.int32)
    if valid is not None:
        # built on the device: a host tensor's copy would sync the step
        empty = torch.zeros((4,), dtype=torch.int32, device=bbox.device)
        empty[0::2] = 1
        bbox = torch.where(valid[:, None], bbox, empty)
    return bbox.contiguous()


def resolve_bin_method(method: str, n_tiles: int, n: int) -> str:
    """``'auto'`` -> ``'hier'`` past 32M membership entries (``n_tiles``
    tiles by ``n`` Gaussians), else ``'top_k'`` (the JAX rule); any other
    method as it is."""
    if method != "auto":
        return method
    return "hier" if n_tiles * n > 32_000_000 else "top_k"


def bin_gaussians(proj: Projected, H: int, W: int, cap: int = 256,
                  block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                  method: str = "top_k", super_size: int = 8,
                  super_cap: int = 0) -> TileBins:
    """Per-tile member lists. ``method``: ``'top_k'`` | ``'scatter'`` |
    ``'rank'`` (exact, over the full [T, N] membership), ``'hier'`` (two
    levels, for large tile grids: super-tiles of ``super_size`` x
    ``super_size`` tiles keep at most ``super_cap`` candidates, 0 =
    ``max(4 cap, 512)``; equal to the flat result whenever no super-tile
    overflows), ``'pallas'`` (kernel E, the ``'top_k'`` result) or
    ``'auto'``: ``'hier'`` past 32M membership entries, else ``'top_k'``
    (the JAX rule)."""
    tb = tile_bounds_for(H, W, block_h, block_w)
    method = resolve_bin_method(method, tb[0] * tb[1], proj.xys.shape[0])
    if method == "hier":
        return _bin_hier(proj, tb, cap, block_h, block_w, super_size,
                         super_cap or max(4 * cap, 512))
    if method == "pallas":
        # The one call from this layer into the kernels, on purpose: the JAX
        # function raises here and its render dispatches the Pallas binner
        # itself (as the port's does); here every method name bins. The
        # import is lazy because kernels/binning_tiles imports this module.
        from ..kernels.binning_tiles import bin_gaussians_tiles

        return bin_gaussians_tiles(proj, H, W, cap, block_h, block_w)
    return select_members(_membership(proj, tb, block_h, block_w), cap, method)


def _bin_hier(proj: Projected, tile_bounds: Tuple[int, int], cap: int,
              block_h: int, block_w: int, ss, super_cap: int) -> TileBins:
    """Two-level binning (JAX ``_bin_hier``): level 1 bins the Gaussians into
    super-tiles of ``ss`` tiles (an int, or ``(ss_y, ss_x)``) and keeps each
    one's first ``super_cap`` candidates; level 2 tests each tile only
    against its super-tile's candidates. Both levels keep id order."""
    tb_x, tb_y = tile_bounds
    N = proj.xys.shape[0]
    dev = proj.xys.device
    ss_y, ss_x = (ss, ss) if isinstance(ss, int) else ss
    sb_x, sb_y = -(-tb_x // ss_x), -(-tb_y // ss_y)
    S = sb_x * sb_y
    super_cap = min(super_cap, N)
    xmin, xmax, ymin, ymax = tile_bbox(
        proj.xys, proj.radii.to(torch.float32), tile_bounds, block_h, block_w)

    def floor_div(a, b):
        return torch.div(a, b, rounding_mode="floor")

    # level 1: super-tile membership and candidate compaction
    sxmin, sxmax = floor_div(xmin, ss_x), -floor_div(-xmax, ss_x)
    symin, symax = floor_div(ymin, ss_y), -floor_div(-ymax, ss_y)
    sx = torch.arange(sb_x, dtype=torch.int32, device=dev)
    sy = torch.arange(sb_y, dtype=torch.int32, device=dev)
    in_x = (sx[:, None] >= sxmin[None, :]) & (sx[:, None] < sxmax[None, :])
    in_y = (sy[:, None] >= symin[None, :]) & (sy[:, None] < symax[None, :])
    s_member = (in_y[:, None, :] & in_x[None, :, :] & proj.valid[None, None, :]).reshape(S, N)
    s_count = s_member.sum(dim=1, dtype=torch.int32)
    overflow = torch.clamp(s_count - super_cap, min=0).sum(dtype=torch.int32)
    cand = select_members(s_member, super_cap, "top_k")            # ascending ids
    cid = cand.ids.to(torch.int64)
    c_xmin, c_xmax, c_ymin, c_ymax = xmin[cid], xmax[cid], ymin[cid], ymax[cid]

    # level 2: each tile against its super-tile's candidates
    t = torch.arange(tb_y * tb_x, dtype=torch.int64, device=dev)
    tx, ty = t % tb_x, torch.div(t, tb_x, rounding_mode="floor")
    s_of_t = torch.div(ty, ss_y, rounding_mode="floor") * sb_x + torch.div(
        tx, ss_x, rounding_mode="floor")
    tx32, ty32 = tx.to(torch.int32)[:, None], ty.to(torch.int32)[:, None]
    member2 = ((tx32 >= c_xmin[s_of_t]) & (tx32 < c_xmax[s_of_t]) &
               (ty32 >= c_ymin[s_of_t]) & (ty32 < c_ymax[s_of_t]) & cand.mask[s_of_t])
    sel = select_members(member2, cap, "top_k")                   # columns into cand
    ids = cand.ids[s_of_t[:, None], sel.ids.to(torch.int64)]
    ids = torch.where(sel.mask, ids, torch.zeros_like(ids))
    return TileBins(ids=ids, mask=sel.mask, count=sel.count, super_overflow=overflow)


def morton_spread(v: torch.Tensor) -> torch.Tensor:
    """Interleave-ready bit spread, 16 -> 32 bits (int32 tensor)."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_perm(xys: torch.Tensor, valid: torch.Tensor, H: int, W: int,
                block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """[N] permutation sorting Gaussians by the Morton code of their
    center's tile, invalid rows last (stable)."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    tx = torch.clamp(_to_int32(torch.floor(xys[:, 0] / block_w)), 0, tb_x - 1)
    ty = torch.clamp(_to_int32(torch.floor(xys[:, 1] / block_h)), 0, tb_y - 1)
    code = morton_spread(tx) | (morton_spread(ty) << 1)
    code = torch.where(valid, code, torch.full_like(code, 2 ** 30))
    return torch.argsort(code, stable=True)


def _membership_rows(proj: Projected, tile_bounds: Tuple[int, int], block_h: int,
                     block_w: int, tile_start: int, n_tiles: int) -> torch.Tensor:
    """[n_tiles, N] membership of the flat y-major tile rows ``[tile_start,
    tile_start + n_tiles)``; rows past the grid are all False. Each rank of a
    tile-sharded render bins only its own rows."""
    tb_x, tb_y = tile_bounds
    xmin, xmax, ymin, ymax = tile_bbox(
        proj.xys, proj.radii.to(torch.float32), tile_bounds, block_h, block_w)
    t = tile_start + torch.arange(n_tiles, dtype=torch.int32, device=proj.xys.device)
    tx = (t % tb_x)[:, None]
    ty = torch.div(t, tb_x, rounding_mode="floor")[:, None]
    in_grid = (t < tb_x * tb_y)[:, None]
    return ((tx >= xmin[None, :]) & (tx < xmax[None, :]) & (ty >= ymin[None, :])
            & (ty < ymax[None, :]) & in_grid & proj.valid[None, :])


def bin_gaussian_rows(proj: Projected, H: int, W: int, tile_start: int, n_tiles: int,
                      cap: int = 256, block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                      method: str = "top_k") -> TileBins:
    """``bin_gaussians`` restricted to the flat tile rows ``[tile_start,
    tile_start + n_tiles)``: the full result's rows, sliced, at a shard's
    share of the work. ``method``: ``'top_k'``, ``'scatter'`` or ``'rank'``."""
    tb = tile_bounds_for(H, W, block_h, block_w)
    member = _membership_rows(proj, tb, block_h, block_w, tile_start, n_tiles)
    return select_members(member, cap, method)


def bin_gaussian_rows_hier(proj: Projected, H: int, W: int, tile_start: int, n_tiles: int,
                           cap: int = 256, block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                           band_rows: int = 4, super_cap: int = 0) -> TileBins:
    """Two-level ``bin_gaussian_rows``: level 1 keeps, for each full-width
    band of ``band_rows`` tile rows over the shard's range, its first
    ``super_cap`` candidates (0 = ``max(4 cap, 512)``); level 2 tests each of
    the shard's tiles only against its band's candidates. Equal to
    ``bin_gaussian_rows`` wherever no band overflows; ``super_overflow``
    counts the candidates dropped."""
    tb = tile_bounds_for(H, W, block_h, block_w)
    tb_x, tb_y = tb
    N = proj.xys.shape[0]
    dev = proj.xys.device
    super_cap = min(super_cap or max(4 * cap, 512), N)
    xmin, xmax, ymin, ymax = tile_bbox(
        proj.xys, proj.radii.to(torch.float32), tb, block_h, block_w)

    # a band count that covers every tile row the shard's flat range can touch
    rows_max = (n_tiles - 1) // tb_x + 2
    B = rows_max // band_rows + 2
    b_first = (tile_start // tb_x) // band_rows
    band_y0 = (b_first + torch.arange(B, dtype=torch.int32, device=dev)) * band_rows
    band_y1 = band_y0 + band_rows

    # level 1: band membership (y-interval overlap) and compaction
    member1 = ((ymin[None, :] < band_y1[:, None]) & (ymax[None, :] > band_y0[:, None])
               & (band_y0 < tb_y)[:, None] & proj.valid[None, :])
    s_count = member1.sum(dim=1, dtype=torch.int32)
    overflow = torch.clamp(s_count - super_cap, min=0).sum(dtype=torch.int32)
    cand = select_members(member1, super_cap, "top_k")
    cid = cand.ids.to(torch.int64)
    c_xmin, c_xmax, c_ymin, c_ymax = xmin[cid], xmax[cid], ymin[cid], ymax[cid]

    # level 2: each local tile against its band's candidates
    t = tile_start + torch.arange(n_tiles, dtype=torch.int64, device=dev)
    tx, ty = t % tb_x, torch.div(t, tb_x, rounding_mode="floor")
    b_of_t = torch.clamp(torch.div(ty, band_rows, rounding_mode="floor") - b_first, 0, B - 1)
    tx32, ty32 = tx.to(torch.int32)[:, None], ty.to(torch.int32)[:, None]
    member2 = ((tx32 >= c_xmin[b_of_t]) & (tx32 < c_xmax[b_of_t]) & (ty32 >= c_ymin[b_of_t])
               & (ty32 < c_ymax[b_of_t]) & cand.mask[b_of_t] & (t < tb_x * tb_y)[:, None])
    sel = select_members(member2, cap, "top_k")                   # columns into cand
    ids = cand.ids[b_of_t[:, None], sel.ids.to(torch.int64)]
    ids = torch.where(sel.mask, ids, torch.zeros_like(ids))
    return TileBins(ids=ids, mask=sel.mask, count=sel.count, super_overflow=overflow)


def gather_tile_attrs(bins: TileBins, *arrays: torch.Tensor):
    """Per-Gaussian arrays [N, ...] -> per-tile layout [T, cap, ...]."""
    ids = bins.ids.to(torch.int64)
    return tuple(a[ids] for a in arrays)
