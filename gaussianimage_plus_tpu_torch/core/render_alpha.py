"""Depth-sorted alpha-compositing rasterizer (the legacy 3DGS blend).

Port of ``gaussianimage_plus_tpu/core/render_alpha.py``
(``depth_order_projection`` :44, ``rasterize_alpha_tiled`` :57), after the
reference's ``rasterize_gaussians`` (forward.cu:322-450): front-to-back
compositing

    alpha = min(0.999, opac * exp(-sigma));  skip alpha < 1/255
    next_T = T * (1 - alpha);  stop when next_T <= 1e-4
    pix += colour * alpha * T;  pix += T_final * background

The Gaussians are argsorted by depth first, so the binner's index-order
lists are depth-ordered; per tile the exclusive ``cumprod`` of ``1 - alpha``
gives every T at once, and the early stop is the mask ``T_excl (1 - alpha) >
1e-4``. Plain torch ops with autograd, as the JAX package's are plain XLA.

Deviation, with the same result: only tiles with members are blended, each
over its first ``max(count)`` slots; every other pixel is the background
(alpha 0).
"""

from __future__ import annotations

from typing import Optional

import torch

from .binning import bin_gaussians
from .gaussian2d import ALPHA_THRESHOLD, BLOCK_H, BLOCK_W, Projected, tile_bounds_for
from .render_tiled import _phi, _quad_coeffs, _tiles_to_image


def depth_order_projection(proj: Projected, depths: torch.Tensor):
    """The projection permuted into ascending depth, invalid Gaussians last
    (a stable argsort), and the permutation: index-order binning is then
    depth-order binning (the reference sorts by ``tile << 32 | depth``)."""
    key = torch.where(proj.valid, depths, torch.full_like(depths, float("inf")))
    order = torch.argsort(key, stable=True)
    return Projected(*(a[order] for a in proj)), order


def rasterize_alpha_tiled(proj_sorted: Projected, colors_sorted: torch.Tensor,
                          opacity_sorted: torch.Tensor, H: int, W: int,
                          background: Optional[torch.Tensor] = None, tile_cap: int = 256,
                          block_h: int = BLOCK_H, block_w: int = BLOCK_W,
                          return_alpha: bool = False):
    """[H, W, 3] with true alpha compositing (and the [H, W] alpha with
    ``return_alpha``); the inputs must be depth-ordered
    (``depth_order_projection``). ``background`` defaults to white."""
    dev = proj_sorted.xys.device
    if background is None:
        background = torch.ones((3,), dtype=torch.float32, device=dev)
    bins = bin_gaussians(proj_sorted, H, W, cap=tile_cap, block_h=block_h, block_w=block_w)
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    T, P = tb_x * tb_y, block_h * block_w
    tiles_on = torch.nonzero(bins.count > 0).squeeze(1)
    k = max(int(bins.count.max()), 1)
    ids = bins.ids[tiles_on, :k].to(torch.int64)
    mask = bins.mask[tiles_on, :k]
    tx0 = ((tiles_on % tb_x) * block_w).to(torch.float32)[:, None]
    ty0 = (torch.div(tiles_on, tb_x, rounding_mode="floor") * block_h).to(torch.float32)[:, None]
    # gather the members' rows only, empty slots zero: the backward of a gather
    # through every slot runs the empty slots' id 0, thousands of times over,
    # through one accumulation on the card (175 ms of a 239 ms 3DGS step)
    attrs = torch.cat([proj_sorted.xys, proj_sorted.conics, colors_sorted,
                       opacity_sorted.reshape(-1, 1)], dim=1)               # [N, 9]
    live_slots = mask.reshape(-1).nonzero().squeeze(1)
    g = attrs.new_zeros((ids.numel(), 9)).index_copy(
        0, live_slots, attrs[ids.reshape(-1)[live_slots]]).reshape(*ids.shape, 9)
    g_xy, g_con, g_col, g_op = g[..., 0:2], g[..., 2:5], g[..., 5:8], g[..., 8]
    w = torch.stack(_quad_coeffs(g_con[..., 0], g_con[..., 1], g_con[..., 2],
                                 g_xy[..., 0] - tx0, g_xy[..., 1] - ty0), dim=-1)
    pp = torch.arange(P, device=dev)
    phi = _phi(pp % block_w, torch.div(pp, block_w, rounding_mode="floor"))
    sigma = torch.einsum("pf,tkf->tpk", phi, w)                       # [Tl, P, K]
    # the reference's 0.999 clamp (forward.cu:399) and 1/255 skip (:401)
    alpha = torch.minimum(g_op[:, None, :] * torch.exp(-sigma),
                          torch.full((), 0.999, device=dev))
    zero = torch.zeros((), dtype=alpha.dtype, device=dev)
    alpha = torch.where((alpha >= ALPHA_THRESHOLD) & mask[:, None, :], alpha, zero)
    one_minus = 1.0 - alpha
    t_incl = torch.cumprod(one_minus, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
    # the reference stops before compositing a Gaussian whose next_T <= 1e-4
    # (forward.cu:414-419)
    live = (t_excl * one_minus) > 1e-4
    weights = torch.where(live, alpha * t_excl, zero)
    t_final = torch.prod(torch.where(live, one_minus, zero + 1.0), dim=-1)    # [Tl, P]
    lit = torch.einsum("tpk,tkc->tpc", weights, g_col) + t_final[..., None] * background
    tiles = background.expand(T, P, 3).contiguous().index_copy(0, tiles_on, lit)
    img = _tiles_to_image(tiles, H, W, tb_x, tb_y, block_h, block_w)
    if return_alpha:
        alpha_tiles = torch.zeros((T, P, 1), dtype=lit.dtype, device=dev).index_copy(
            0, tiles_on, (1.0 - t_final)[..., None])
        return img, _tiles_to_image(alpha_tiles, H, W, tb_x, tb_y, block_h, block_w)[..., 0]
    return img
