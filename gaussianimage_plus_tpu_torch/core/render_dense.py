"""Dense O(N * H * W) accumulated-sum renderer — the port's own oracle.

Port of the forward of ``gaussianimage_plus_tpu/core/render_dense.py``. It
evaluates every (pixel, Gaussian) pair in the reference's direct form
(forward.cu:570-691), independent of the tiled table layout and of the
expanded quadratic the kernels use:

    delta = xy_g - (px, py)
    sigma = 0.5*(c1*dx^2 + c3*dy^2) + c2*dx*dy
    alpha = min(1, opacity * exp(-sigma)), skipped when sigma < 0 or
            alpha < 1/255; pixel += color * alpha; clamp to [0, 1]

``tile_mask`` restricts each Gaussian to the tiles of its projected bbox
(the binning step); ``tile_cap`` keeps only the first ``tile_cap`` members
of each tile in index order (forward.cu:673). It holds a
``[band_rows, W, N]`` array at a time: the whole image by default, or bands
of ``band_rows`` rows, so that it also serves as the oracle at full width.
"""

from __future__ import annotations

from typing import Optional

import torch

from .binning import _membership
from .gaussian2d import (ALPHA_THRESHOLD, BLOCK_H, BLOCK_W, Projected,
                         tile_bbox, tile_bounds_for)


def tile_membership(proj: Projected, H: int, W: int,
                    block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """[T, N] bool — tile t (y-major) lies inside Gaussian n's tile bbox."""
    return _membership(proj, tile_bounds_for(H, W, block_h, block_w),
                       block_h, block_w)


def tile_cap_mask(member: torch.Tensor, cap: int) -> torch.Tensor:
    """Keep the first ``cap`` members of each row of a [T, N] matrix."""
    rank = torch.cumsum(member.to(torch.int32), dim=1) - 1
    return member & (rank < cap)


def render_dense(proj: Projected, colors: torch.Tensor, opacity: torch.Tensor,
                 H: int, W: int, tile_mask: bool = True,
                 tile_cap: Optional[int] = 256,
                 block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                 band_rows: Optional[int] = None) -> torch.Tensor:
    """Render [H, W, 3] in [0, 1] by dense accumulation over all Gaussians,
    ``band_rows`` image rows at a time (default: all)."""
    dev = proj.xys.device
    opacity = opacity.reshape(-1)
    member = None
    if tile_mask or tile_cap is not None:
        member = tile_membership(proj, H, W, block_h, block_w)
        if tile_cap is not None:
            member = tile_cap_mask(member, tile_cap)
    tb_x, _ = tile_bounds_for(H, W, block_h, block_w)
    px = torch.arange(W, dtype=torch.float32, device=dev)
    dx = proj.xys[:, 0][None, None, :] - px[None, :, None]     # [1, W, N]
    c1 = proj.conics[:, 0][None, None, :]
    c2 = proj.conics[:, 1][None, None, :]
    c3 = proj.conics[:, 2][None, None, :]
    img = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    band_rows = band_rows or H
    for y0 in range(0, H, band_rows):
        y1 = min(H, y0 + band_rows)
        py = torch.arange(y0, y1, dtype=torch.float32, device=dev)
        dy = proj.xys[:, 1][None, None, :] - py[:, None, None]  # [B, 1, N]
        sigma = 0.5 * (c1 * dx * dx + c3 * dy * dy) + c2 * dx * dy  # [B, W, N]
        alpha = torch.clamp(opacity[None, None, :] * torch.exp(-sigma), max=1.0)
        contrib = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & proj.valid[None, None, :]
        if member is not None:
            pix_ty = torch.arange(y0, y1, device=dev) // block_h
            pix_tx = torch.arange(W, device=dev) // block_w
            contrib = contrib & member[pix_ty[:, None] * tb_x + pix_tx[None, :]]
        weights = torch.where(contrib, alpha, torch.zeros_like(alpha))
        img[y0:y1] = torch.einsum("hwn,nc->hwc", weights, colors)
    return torch.clamp(img, 0.0, 1.0)
