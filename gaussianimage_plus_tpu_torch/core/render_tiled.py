"""Tile-binned accumulated-sum rasterizer, forward — the plain PyTorch path.

Port of the forward of ``gaussianimage_plus_tpu/core/render_tiled.py``
(``rasterize_tiled``, ``_tiles_to_image``, ``_image_to_tiles``). It is also
the plain version of the port's binned kernel (``kernels/raster_binned.py``,
kernel A): both evaluate the same per-tile blend over a pre-gathered
``[T, K, 16]`` attribute table, in the same arithmetic.

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

Tiles are processed in batches so that memory stays bounded at full width.
The hand-written VJP belongs to the training slice.
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


def blend_table_tiles(raw: torch.Tensor, tile_idx: torch.Tensor, tb_x: int,
                      block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """Per-tile blend of a gathered table ``raw`` [Tb, K, 16] (rows
    ``[c1, c2, c3, mx, my, r, g, b, opac, 0.., valid]``) for the tiles
    ``tile_idx`` [Tb] -> [Tb, P, 3]."""
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
    alpha = torch.clamp(raw[..., 8, None] * torch.exp(-sigma), max=1.0)
    contrib = (sigma >= 0.0) & (alpha >= ALPHA_THRESHOLD) & (raw[..., 15, None] > 0.0)
    weights = torch.where(contrib, alpha, torch.zeros_like(alpha))
    return torch.einsum("tkp,tkc->tpc", weights, raw[..., 5:8])


def render_table(raw: torch.Tensor, counts: torch.Tensor, H: int, W: int,
                 block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """[H, W, 3] unclamped image from a per-tile table [T, K, 16] whose
    first ``counts[t]`` rows are tile t's members and the rest are
    invalid sentinels (so only the first ``counts`` rows are read)."""
    tb_x, tb_y = tile_bounds_for(H, W, block_h, block_w)
    T, K, _ = raw.shape
    P = block_h * block_w
    dev = raw.device
    out = torch.zeros((T, P, 3), dtype=torch.float32, device=dev)
    budget = _BATCH_ELEMS.get(dev.type, 1 << 22)
    kmax = int(counts.max()) if T else 0
    step = max(1, budget // (max(min(kmax, K), 1) * P))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        k = min(K, int(counts[t0:t1].max()))
        if k <= 0:
            continue
        idx = torch.arange(t0, t1, device=dev)
        out[t0:t1] = blend_table_tiles(raw[t0:t1, :k], idx, tb_x, block_h, block_w)
    return _tiles_to_image(out, H, W, tb_x, tb_y, block_h, block_w)


def rasterize_tiled(xys, conics, colors, opacity, ids, mask,
                    H: int, W: int, block_h: int = BLOCK_H,
                    block_w: int = BLOCK_W) -> torch.Tensor:
    """Accumulated-sum rasterization of binned 2D Gaussians -> [H, W, 3],
    raw (unclamped, no background), with the plain PyTorch blend on
    whichever device the tensors live."""
    from ..kernels.raster_binned import _prepare

    raw, counts = _prepare(xys, conics, colors, opacity, ids, mask)
    return render_table(raw, counts, H, W, block_h, block_w)
