"""Tile binning: fixed-capacity per-tile Gaussian lists, and Morton order.

Port of ``gaussianimage_plus_tpu/core/binning.py`` — ``bin_gaussians`` with
the exact ``'top_k'`` and ``'scatter'`` selections (``:91-119``,
``:245-315``) and ``morton_perm`` (``:318-343``). Each tile keeps its first
``cap`` members in Gaussian-index order (the reference's silent per-tile cap,
forward.cu:673), so ids/mask/count equal the JAX ones exactly. Slots past the
count hold id 0 and ``mask=False``.

The two-level ``'hier'`` method and the Pallas binner (``bin_method=
'pallas'``) are not ported yet (ROADMAP, queue 2); asking for them raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .gaussian2d import BLOCK_H, BLOCK_W, Projected, _to_int32, tile_bbox, tile_bounds_for


class TileBins(NamedTuple):
    """ids [T, cap] int32 (0 where ~mask), mask [T, cap] bool, count [T] int32."""

    ids: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor


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


def select_members(member: torch.Tensor, cap: int, method: str = "top_k") -> TileBins:
    """First ``cap`` members of each row of a [T, N] bool matrix, in index
    order. ``'top_k'`` selects by keys ``N - index``; ``'scatter'`` writes
    each member to its rank slot. Both give the same result."""
    T, N = member.shape
    dev = member.device
    count = torch.clamp(member.sum(dim=1, dtype=torch.int32), max=cap)
    if method == "top_k":
        ar = torch.arange(N, dtype=torch.int32, device=dev)
        key = torch.where(member, N - ar[None, :], torch.zeros((), dtype=torch.int32, device=dev))
        # occupancy tiers, as in the JAX function: when every row's count
        # fits a smaller k, top_k at that k selects the same members
        k_eff = min(cap, N)
        max_c = int(count.max()) if T else 0
        k = next(t for t in (64, 128, k_eff) if t >= min(max_c, k_eff))
        topv = torch.topk(key, min(k, k_eff), dim=1, largest=True, sorted=True).values
        if topv.shape[1] < cap:
            topv = torch.nn.functional.pad(topv, (0, cap - topv.shape[1]))
        mask = topv > 0
        ids = torch.where(mask, N - topv, torch.zeros_like(topv))
    elif method == "scatter":
        rank = torch.cumsum(member.to(torch.int32), dim=1, dtype=torch.int32) - 1
        slot = torch.where(member & (rank < cap), rank, torch.full_like(rank, cap))
        gidx = torch.arange(N, dtype=torch.int32, device=dev).expand(T, N)
        ids = torch.zeros((T, cap + 1), dtype=torch.int32, device=dev)
        ids.scatter_(1, slot.to(torch.int64), gidx)   # slot == cap: dropped column
        ids = ids[:, :cap].contiguous()
        mask = torch.arange(cap, device=dev)[None, :] < count[:, None]
        ids = torch.where(mask, ids, torch.zeros_like(ids))
    else:
        raise ValueError(f"unknown binning method {method!r}")
    return TileBins(ids=ids.to(torch.int32), mask=mask, count=count)


def bin_gaussians(proj: Projected, H: int, W: int, cap: int = 256,
                  block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                  method: str = "top_k") -> TileBins:
    """Per-tile member lists over the full [T, N] membership matrix.

    ``method``: ``'top_k'`` | ``'scatter'``; ``'auto'`` resolves to
    ``'top_k'`` (the JAX rule picks ``'hier'`` only past 32M membership
    entries, far beyond the Kodak point; ``'hier'`` raises here)."""
    tb = tile_bounds_for(H, W, block_h, block_w)
    if method == "auto":
        if tb[0] * tb[1] * proj.xys.shape[0] > 32_000_000:
            method = "hier"
        else:
            method = "top_k"
    if method in ("hier", "pallas"):
        raise NotImplementedError(
            f"bin method {method!r} is not ported yet (ROADMAP queue 2)")
    return select_members(_membership(proj, tb, block_h, block_w), cap, method)


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
