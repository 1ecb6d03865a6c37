"""Tile-binned accumulated-sum rasterizer and its VJP — the plain PyTorch path.

Port of ``gaussianimage_plus_tpu/core/render_tiled.py`` (``rasterize_tiled``
with its hand-written VJP ``_rasterize_bwd`` and ``scatter_tile_grads``,
``_tiles_to_image``, ``_image_to_tiles``): the JAX ``'xla'`` backend. It is
also the plain version of the port's binned kernel (``kernels/raster_binned.py``,
kernel A): both evaluate the same per-tile blend in the same arithmetic,
this one over the gathered ``[T, K, 16]`` table, the kernel through the
slot ids; and its per-(tile,
slot) gradient payload (``tile_grads``) is the plain version of the
chunk-list backward kernel (``kernels/raster_list.py``, kernel C).

Per (Gaussian, pixel), reference forward.cu:650-668:

    sigma = phi(p) . w          tile-local pixel coords, w from conic+center
    alpha = min(1, opac * exp(-sigma))
    skip when sigma < 0, alpha < 1/255, or the row is not valid
    pixel += rgb * alpha         (unclamped; the model clamps)

Arithmetic shared with the CUDA kernels, so that the two agree to rounding
of the final colour sums: ``w`` is evaluated with the JAX expressions
(``raster_pallas.py:105-111``), one rounding per operation, and ``sigma`` is
a fixed chain of fused multiply-adds ``s = w5; s = fma(w4, py, s); ...``.
The expanded quadratic cancels badly for thin Gaussians far from the tile
origin, so a different order moves ``sigma`` by many ulps there; PyTorch has
no fused multiply-add on tensors, so ``_fma`` emulates one in float64 (the
product of a float32 and a small integer is exact in float64).

Backward, per (tile, slot), with the reference's conventions
(backward.cu:1297-1320; the JAX module docstring has the derivation):

    v_rgb   = sum_p weights * v_out          v_alpha = rgb . v_out
    v_sigma = -(opac * vis) * v_alpha        (through the saturated min)
    v_opac  = sum_p vis * v_alpha
    M       = sum_p v_sigma * phi(p)         six moments, tile-local
    v_conic = half off-diagonal, from M, lmx, lmy;  v_xy from M and the conic

where the gate (sigma >= 0, alpha >= 1/255, valid) is recomputed with the
forward's arithmetic, so a pair contributes to the gradient exactly when it
contributed to the image. The per-Gaussian sums are deterministic
(``index_sum_``), which replaces the reference's warp sums and ``atomicAdd``.

Tiles are processed in batches so that memory stays bounded at full width.
"""

from __future__ import annotations

import torch

from .gaussian2d import ALPHA_THRESHOLD, BLOCK_H, BLOCK_W, tile_bounds_for

# [Tb, K, P] elements per batch of the plain blend (float64 intermediates).
_BATCH_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}


def _tiles_to_image(tiles: torch.Tensor, H: int, W: int, tb_x: int, tb_y: int,
                    block_h: int, block_w: int) -> torch.Tensor:
    """[T, P, C] -> [H, W, C] (crop away tile padding)."""
    C = tiles.shape[-1]
    img = tiles.reshape(tb_y, tb_x, block_h, block_w, C)
    img = img.permute(0, 2, 1, 3, 4).reshape(tb_y * block_h, tb_x * block_w, C)
    return img[:H, :W]


def _image_to_tiles(img: torch.Tensor, tb_x: int, tb_y: int,
                    block_h: int, block_w: int) -> torch.Tensor:
    """[H, W, C] -> [T, P, C] (zero-pad to the tile grid)."""
    H, W, C = img.shape
    Hp, Wp = tb_y * block_h, tb_x * block_w
    img = torch.nn.functional.pad(img, (0, 0, 0, Wp - W, 0, Hp - H))
    tiles = img.reshape(tb_y, block_h, tb_x, block_w, C)
    return tiles.permute(0, 2, 1, 3, 4).reshape(tb_y * tb_x, block_h * block_w, C)


def _quad_coeffs(c1, c2, c3, lmx, lmy):
    """w such that sigma = phi(p) . w, phi = [px^2, py^2, px*py, px, py, 1]:
    the expansion of 0.5*c1*dx^2 + 0.5*c3*dy^2 + c2*dx*dy, dx = lmx - px."""
    w0 = 0.5 * c1
    w1 = 0.5 * c3
    w2 = c2
    w3 = -(c1 * lmx + c2 * lmy)
    w4 = -(c2 * lmx + c3 * lmy)
    w5 = 0.5 * c1 * lmx * lmx + 0.5 * c3 * lmy * lmy + c2 * lmx * lmy
    return w0, w1, w2, w3, w4, w5


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` with one rounding (fmaf), for float32 ``a``, ``c``
    and ``b`` a float64 tensor of small integers."""
    return (a.double() * b + c.double()).float()


def _sigma(w, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """[..., K, P] sigma from per-row w (each [..., K]) and pixel coords [P]
    (float64): the kernels' fmaf chain, in the same order."""
    w0, w1, w2, w3, w4, w5 = (x[..., None] for x in w)
    s = w5.expand(*w5.shape[:-1], px.shape[0])
    s = _fma(w4, py, s)
    s = _fma(w3, px, s)
    s = _fma(w2, px * py, s)
    s = _fma(w1, py * py, s)
    return _fma(w0, px * px, s)


def _tile_gate(raw: torch.Tensor, tile_idx: torch.Tensor, tb_x: int, block_h: int,
               block_w: int):
    """The blend gate of a gathered table ``raw`` [Tb, K, 16] (rows ``[c1,
    c2, c3, mx, my, r, g, b, opac, 0.., valid]``) over the tiles ``tile_idx``
    [Tb]: (px, py, lmx, lmy, vis, alpha, contrib), the last three [Tb, K, P]."""
    dev = raw.device
    P = block_h * block_w
    pp = torch.arange(P, device=dev)
    px = (pp % block_w).double()
    py = torch.div(pp, block_w, rounding_mode="floor").double()
    tx0 = ((tile_idx % tb_x) * block_w).to(torch.float32)[:, None]
    ty0 = (torch.div(tile_idx, tb_x, rounding_mode="floor") * block_h).to(torch.float32)[:, None]
    c1, c2, c3 = raw[..., 0], raw[..., 1], raw[..., 2]
    lmx = raw[..., 3] - tx0
    lmy = raw[..., 4] - ty0
    sigma = _sigma(_quad_coeffs(c1, c2, c3, lmx, lmy), px, py)     # [Tb, K, P]
    vis = torch.exp(-sigma)
    alpha = torch.clamp(raw[..., 8, None] * vis, max=1.0)
    contrib = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & (raw[..., 15, None] > 0.0)
    return px, py, lmx, lmy, vis, alpha, contrib


def blend_table_tiles(raw: torch.Tensor, tile_idx: torch.Tensor, tb_x: int,
                      block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Per-tile blend of a gathered table ``raw`` [Tb, K, 16] for the tiles
    ``tile_idx`` [Tb] -> [Tb, P, 3]."""
    *_, alpha, contrib = _tile_gate(raw, tile_idx, tb_x, block_h, block_w)
    weights = torch.where(contrib, alpha, torch.zeros_like(alpha))
    return torch.einsum("tkp,tkc->tpc", weights, raw[..., 5:8])


def _tile_batches(counts: torch.Tensor, K: int, P: int, budget: int):
    """(t0, t1, k) over batches of tiles whose [t1 - t0, k, P] slab stays
    within ``budget`` elements, ``k`` the batch's largest count (batches
    with no member are skipped)."""
    T = counts.shape[0]
    kmax = int(counts.max()) if T else 0
    step = max(1, budget // (max(min(kmax, K), 1) * P))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        k = min(K, int(counts[t0:t1].max()))
        if k > 0:
            yield t0, t1, k


def blend_tiles(raw: torch.Tensor, counts: torch.Tensor, tile_idx: torch.Tensor, tb_x: int,
                block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """[T, P, 3] unclamped tiles ``tile_idx`` [T] of the grid from their
    per-tile table [T, K, 16], whose first ``counts[t]`` rows are tile t's
    members and the rest invalid sentinels (so only those rows are read)."""
    T, K, _ = raw.shape
    P = block_h * block_w
    dev = raw.device
    out = torch.zeros((T, P, 3), dtype=torch.float32, device=dev)
    for t0, t1, k in _tile_batches(counts, K, P, _BATCH_ELEMS.get(dev.type, 1 << 22)):
        out[t0:t1] = blend_table_tiles(raw[t0:t1, :k], tile_idx[t0:t1], tb_x, block_h, block_w)
    return out


def render_table(raw: torch.Tensor, counts: torch.Tensor, H: int, W: int,
                 block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """[H, W, 3] unclamped image from the per-tile table [T, K, 16] of the
    whole grid (``blend_tiles``)."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    idx = torch.arange(raw.shape[0], device=raw.device)
    return _tiles_to_image(blend_tiles(raw, counts, idx, tb_x, block_h, block_w),
                           H, W, tb_x, tb_y, block_h, block_w)


def contrib_counts(raw: torch.Tensor, counts: torch.Tensor, H: int, W: int,
                   block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """[H, W] int32: the rows of a per-tile table (as ``render_table``
    takes it) that pass the blend gate at each pixel."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    T, K, _ = raw.shape
    P = block_h * block_w
    dev = raw.device
    out = torch.zeros((T, P, 1), dtype=torch.int32, device=dev)
    for t0, t1, k in _tile_batches(counts, K, P, _BATCH_ELEMS.get(dev.type, 1 << 22)):
        idx = torch.arange(t0, t1, device=dev)
        contrib = _tile_gate(raw[t0:t1, :k], idx, tb_x, block_h, block_w)[-1]
        out[t0:t1, :, 0] = contrib.sum(dim=1, dtype=torch.int32)
    return _tiles_to_image(out, H, W, tb_x, tb_y, block_h, block_w)[..., 0]


def _phi(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """[P, 6] float32 pixel features [px^2, py^2, px*py, px, py, 1]."""
    px, py = px.float(), py.float()
    return torch.stack([px * px, py * py, px * py, px, py, torch.ones_like(px)], dim=-1)


def tile_payload(raw: torch.Tensor, v_out: torch.Tensor, tile_idx: torch.Tensor,
                 tb_x: int, block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Gradient payload [Tb, K, 9] = ``[v_xy(2), v_conic(3, half
    off-diagonal), v_rgb(3), v_opac]`` of each slot of a gathered table
    ``raw`` [Tb, K, 16] against the cotangent tiles ``v_out`` [Tb, P, 3]
    (``_rasterize_bwd`` of the JAX package, per tile)."""
    dev = raw.device
    c1, c2, c3 = raw[..., 0], raw[..., 1], raw[..., 2]
    opac = raw[..., 8, None]
    px, py, lmx, lmy, vis, alpha, contrib = _tile_gate(raw, tile_idx, tb_x, block_h, block_w)
    zero = torch.zeros((), dtype=alpha.dtype, device=dev)
    weights = torch.where(contrib, alpha, zero)
    vo = v_out[:, None, :, :]                                       # [Tb, 1, P, 3]
    v_alpha = (raw[..., 5, None] * vo[..., 0] + raw[..., 6, None] * vo[..., 1]
               + raw[..., 7, None] * vo[..., 2])                    # [Tb, K, P]
    v_rgb = torch.einsum("tkp,tpc->tkc", weights, v_out)
    v_sigma = torch.where(contrib, -(opac * vis) * v_alpha, zero)
    v_opac = torch.where(contrib, vis * v_alpha, zero).sum(dim=-1)
    M = torch.einsum("tkp,pf->tkf", v_sigma, _phi(px, py))
    Sxx, Syy, Sxy, Sx, Sy, S1 = M.unbind(-1)
    v_con_x = 0.5 * (lmx * lmx * S1 - 2.0 * lmx * Sx + Sxx)
    v_con_y = 0.5 * (lmx * lmy * S1 - lmx * Sy - lmy * Sx + Sxy)
    v_con_z = 0.5 * (lmy * lmy * S1 - 2.0 * lmy * Sy + Syy)
    mom_x = lmx * S1 - Sx
    mom_y = lmy * S1 - Sy
    v_xy_x = c1 * mom_x + c2 * mom_y
    v_xy_y = c2 * mom_x + c3 * mom_y
    return torch.cat([torch.stack([v_xy_x, v_xy_y, v_con_x, v_con_y, v_con_z], dim=-1),
                      v_rgb, v_opac[..., None]], dim=-1)


def index_sum_(acc: torch.Tensor, ids: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``acc[ids] += src`` row by row, in a fixed order: ``index_add_`` runs
    serially on the CPU, where ``index_put_(accumulate=True)`` uses atomics;
    on the card it is the other way round (``index_put_`` sorts the indices,
    ``index_add_`` uses atomics)."""
    if acc.device.type == "cpu":
        return acc.index_add_(0, ids, src)
    return acc.index_put_((ids,), src, accumulate=True)


def payload_sums(raw: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor,
                 v_out: torch.Tensor, tile_idx: torch.Tensor, tb_x: int, num: int,
                 block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Per-row gradient payload sums [num, 9] of the tiles ``tile_idx`` [T]
    from their per-tile table ``raw`` [T, K, 16], whose first ``counts[t]``
    rows are the members ``ids[t]`` (row indices < ``num``), against the
    cotangent tiles ``v_out`` [T, P, 3] (``scatter_tile_grads``)."""
    T, K, _ = raw.shape
    P = block_h * block_w
    dev = raw.device
    acc = torch.zeros((num, 9), dtype=torch.float32, device=dev)
    for t0, t1, k in _tile_batches(counts, K, P, _BATCH_ELEMS.get(dev.type, 1 << 22) // 4):
        pay = tile_payload(raw[t0:t1, :k], v_out[t0:t1], tile_idx[t0:t1], tb_x, block_h, block_w)
        live = torch.arange(k, device=dev)[None, :] < counts[t0:t1, None]
        index_sum_(acc, ids[t0:t1, :k][live].to(torch.int64), pay[live])
    return acc


def tile_grads(raw: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor,
               v_img: torch.Tensor, num: int, block_h: int = BLOCK_H,
               block_w: int = BLOCK_W) -> torch.Tensor:
    """``payload_sums`` over the whole grid, against the image cotangent
    ``v_img`` [H, W, 3]."""
    H, W, _ = v_img.shape
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    v_out = _image_to_tiles(v_img, tb_x, tb_y, block_h, block_w)
    idx = torch.arange(raw.shape[0], device=raw.device)
    return payload_sums(raw, ids, counts, v_out, idx, tb_x, num, block_h, block_w)


class _RasterizeTiles(torch.autograd.Function):
    """``rasterize_tiles`` with the JAX package's hand-written VJP."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacity, ids, mask, tile_idx, tb_x, block_h, block_w):
        from ..kernels.raster_binned import _prepare

        raw, counts = _prepare(xys, conics, colors, opacity, ids, mask)
        ctx.save_for_backward(xys, conics, colors, opacity, ids, mask, tile_idx)
        ctx.grid = (tb_x, block_h, block_w)
        return blend_tiles(raw, counts, tile_idx, *ctx.grid)

    @staticmethod
    def backward(ctx, v_tiles):
        from ..kernels.raster_binned import _prepare

        xys, conics, colors, opacity, ids, mask, tile_idx = ctx.saved_tensors
        tb_x, block_h, block_w = ctx.grid
        N = xys.shape[0]
        raw, counts = _prepare(xys, conics, colors, opacity, ids, mask)
        ids_s = torch.where(mask, ids.to(torch.int64), torch.full_like(ids, N, dtype=torch.int64))
        acc = payload_sums(raw, ids_s, counts, v_tiles.contiguous(), tile_idx, tb_x, N + 1,
                           block_h, block_w)[:N]
        return (acc[:, 0:2], acc[:, 2:5], acc[:, 5:8], acc[:, 8].reshape(opacity.shape),
                None, None, None, None, None, None)


def rasterize_tiles(xys, conics, colors, opacity, ids, mask, tile_idx: torch.Tensor,
                    tb_x: int, block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """The tiles ``tile_idx`` [T] of a grid ``tb_x`` tiles wide, binned as
    ``ids`` / ``mask`` [T, K] -> [T, P, 3], raw (unclamped, no background);
    differentiable in ``xys``, ``conics``, ``colors`` and ``opacity``
    through the reference's VJP: ``min(1, .)`` passes its gradient through
    (backward.cu:1310), and the packed off-diagonal conic receives half its
    cotangent (backward.cu:1313-1315; the projection VJP doubles it back)."""
    return _RasterizeTiles.apply(xys, conics, colors, opacity, ids, mask, tile_idx, tb_x,
                                 block_h, block_w)


def rasterize_tiled(xys, conics, colors, opacity, ids, mask,
                    H: int, W: int, block_h: int = BLOCK_H,
                    block_w: int = BLOCK_W) -> torch.Tensor:
    """Accumulated-sum rasterization of binned 2D Gaussians -> [H, W, 3],
    raw (unclamped, no background), with the plain PyTorch blend on
    whichever device the tensors live: ``rasterize_tiles`` over the whole
    grid."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    tiles = rasterize_tiles(xys, conics, colors, opacity, ids, mask,
                            torch.arange(ids.shape[0], device=ids.device), tb_x, block_h, block_w)
    return _tiles_to_image(tiles, H, W, tb_x, tb_y, block_h, block_w)
