"""Plain float32 projection and renderer of GaussianImage's accumulated sum.

The semantics of the reference (gsplat's 2D forward, ``helpers.cuh`` and
``forward.cu``), written straight from the equations, with none of the
program's code:

- projection: the conic is the adjugate inverse of the covariance; the radii
  are ``ceil(3 sqrt(eig))`` with the eigenvalue discriminant floored at 0.1;
  a row is culled on a zero determinant, a minor radius under 1, an empty
  tile rectangle, or when it is inactive;
- tile rectangle: ``[trunc(cx/16 - r/16), trunc(cx/16 + r/16 + 1))`` in tile
  units, clamped to the grid, and the same in y;
- a (pixel, Gaussian) pair counts when the pixel's 16x16 tile lies in the
  rectangle, the Gaussian is among its tile's first ``cap`` members in index
  order (``cap=None``: no cap), ``sigma >= 0`` and ``alpha >= 1/255``, with
  ``sigma = 0.5 (c1 dx^2 + c3 dy^2) + c2 dx dy``, ``d = mean - pixel`` at
  integer pixel coordinates, ``alpha = min(1, exp(-sigma))`` (opacity 1);
- the pixel is the sum of ``alpha * colour`` over its pairs, clamped to
  [0, 1] with ``minimum(maximum(x, 0), 1)`` (a half gradient at a tie).

The gate ``sigma >= 0`` is a cliff at a Gaussian's centre, where alpha is 1:
a centre on a pixel (quantized means put many there) has sigma 0 exactly,
and any float32 evaluation puts it a rounding off, on either side. So
``render(..., ties=True)`` also marks the pixels that hold a pair with
``|sigma| < SIGMA_TIE``: there the semantics leave the pixel undecided to
rounding, and a comparison leaves them out.

The blend is a matrix product of the gated weights and the colour table, in
blocks of 16 x 512 pixels, each against the rows whose rectangle meets it,
so a block's image is whole and a loss over blocks adds up. TF32 is off
unless the caller turns it on (the control, ``portbench/control.py``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

TILE = 16
BLOCK_W = 512          # pixels across a render block (32 tiles)
ALPHA_MIN = 1.0 / 255.0
SIGMA_TIE = 1e-3       # |sigma| under this decides the sigma >= 0 gate by rounding


class Projected(NamedTuple):
    xy: torch.Tensor      # [N, 2] pixel-space means
    conic: torch.Tensor   # [N, 3] (c1, c2, c3)
    radius: torch.Tensor  # [N] float, major radius in pixels
    rect: torch.Tensor    # [N, 4] int64 tiles (x0, x1, y0, y1), x1/y1 exclusive
    valid: torch.Tensor   # [N] bool


def project(xy: torch.Tensor, cov: torch.Tensor, active: torch.Tensor, H: int, W: int,
            clip: float = 3.0, radius_clip: float = 1.0) -> Projected:
    """Screen-space quantities of rows with pixel means ``xy`` and effective
    covariances ``cov`` = (xx, xy, yy)."""
    xx, xy_, yy = cov[:, 0], cov[:, 1], cov[:, 2]
    det = xx * yy - xy_ * xy_
    ok = det != 0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    conic = torch.stack([yy * inv, -xy_ * inv, xx * inv], dim=-1)
    with torch.no_grad():
        b = 0.5 * (xx + yy)
        disc = torch.sqrt(torch.clamp(b * b - det, min=0.1))
        r_major = torch.ceil(clip * torch.sqrt(torch.clamp(b + disc, min=0.0)))
        r_minor = torch.ceil(clip * torch.sqrt(torch.clamp(b - disc, min=0.0)))
        valid = ok & (r_minor >= radius_clip) & active
        r = torch.where(valid, r_major, torch.zeros_like(r_major))
        r = torch.nan_to_num(r, nan=0.0, posinf=2.0 ** 31, neginf=0.0)
        tbx, tby = -(-W // TILE), -(-H // TILE)
        c = torch.nan_to_num(xy.detach(), nan=0.0)

        def edge(x, hi):
            return torch.clamp(torch.trunc(torch.clamp(x, -2.0 ** 31, 2.0 ** 31)), 0, hi).long()

        x0 = edge(c[:, 0] / TILE - r / TILE, tbx)
        x1 = edge(c[:, 0] / TILE + r / TILE + 1.0, tbx)
        y0 = edge(c[:, 1] / TILE - r / TILE, tby)
        y1 = edge(c[:, 1] / TILE + r / TILE + 1.0, tby)
        valid = valid & ((x1 - x0) * (y1 - y0) > 0)
        rect = torch.stack([x0, x1, y0, y1], dim=-1)
    return Projected(xy=xy, conic=conic, radius=torch.where(valid, r, torch.zeros_like(r)),
                     rect=rect, valid=valid)


def clip01(img: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    return torch.minimum(torch.maximum(img, zero), zero + 1.0)


class Block(NamedTuple):
    y0: int
    y1: int
    x0: int
    x1: int
    rows: torch.Tensor    # [Nc] int64, the rows whose rectangle meets the block


def blocks(p: Projected, H: int, W: int):
    """The render blocks of the image, each with its candidate rows."""
    rect = p.rect
    for ty in range(-(-H // TILE)):
        in_y = p.valid & (rect[:, 2] <= ty) & (rect[:, 3] > ty)
        for bx in range(0, W, BLOCK_W):
            tx0, tx1 = bx // TILE, -(-min(bx + BLOCK_W, W) // TILE)
            m = in_y & (rect[:, 0] < tx1) & (rect[:, 1] > tx0)
            yield Block(ty * TILE, min(ty * TILE + TILE, H), bx, min(bx + BLOCK_W, W),
                        torch.nonzero(m).flatten())


def _kept(p: Projected, blk: Block, cap: Optional[int]) -> torch.Tensor:
    """[tiles across the block, Nc]: row is a member of the tile and among
    its first ``cap`` members in index order. Every member of a tile of the
    block is a candidate of the block, so the running count is the rank."""
    rect = p.rect[blk.rows]
    tx = torch.arange(blk.x0 // TILE, -(-blk.x1 // TILE), device=rect.device)
    member = (rect[None, :, 0] <= tx[:, None]) & (rect[None, :, 1] > tx[:, None])
    if cap is None:
        return member
    return member & (torch.cumsum(member.int(), dim=1) <= cap)


def block_weights(p: Projected, blk: Block, cap: Optional[int], dtype=torch.float32):
    """([P, Nc] gated alpha, [P, Nc] the gate, the pixel coordinates, [P]
    pixels with a pair whose ``|sigma| < SIGMA_TIE``), the block's pixels
    row-major."""
    dev = p.xy.device
    ys = torch.arange(blk.y0, blk.y1, device=dev)
    xs = torch.arange(blk.x0, blk.x1, device=dev)
    py = ys[:, None].expand(len(ys), len(xs)).reshape(-1)
    px = xs[None, :].expand(len(ys), len(xs)).reshape(-1)
    kept = _kept(p, blk, cap)[(px - blk.x0) // TILE]            # [P, Nc]
    xy = p.xy[blk.rows].to(dtype)
    c = p.conic[blk.rows].to(dtype)
    dx = xy[None, :, 0] - px[:, None].to(dtype)
    dy = xy[None, :, 1] - py[:, None].to(dtype)
    sigma = 0.5 * (c[None, :, 0] * dx * dx + c[None, :, 2] * dy * dy) + c[None, :, 1] * dx * dy
    alpha = torch.clamp(torch.exp(-sigma), max=1.0)
    gate = kept & (sigma >= 0) & (alpha >= ALPHA_MIN)
    tie = (kept & (sigma.abs() < SIGMA_TIE)).any(dim=1)
    return torch.where(gate, alpha, torch.zeros_like(alpha)), gate, px, py, tie


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 off for the reference; on for the control."""
    cuda = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def render(p: Projected, colors: torch.Tensor, H: int, W: int, cap: Optional[int] = None,
           dtype=torch.float32, tf32: bool = False, ties: bool = False):
    """[H, W, 3] clamped image, without gradients; with ``ties`` also the
    [H, W] mask of pixels the sigma >= 0 gate leaves to rounding."""
    out = torch.zeros((H, W, 3), dtype=dtype, device=colors.device)
    tie = torch.zeros((H, W), dtype=torch.bool, device=colors.device)
    with torch.no_grad(), matmul_precision(tf32):
        for blk in blocks(p, H, W):
            w, _, _, _, t = block_weights(p, blk, cap, dtype)
            img = clip01(w @ colors[blk.rows].to(dtype))
            out[blk.y0:blk.y1, blk.x0:blk.x1] = img.reshape(blk.y1 - blk.y0, blk.x1 - blk.x0, 3)
            tie[blk.y0:blk.y1, blk.x0:blk.x1] = t.reshape(blk.y1 - blk.y0, blk.x1 - blk.x0)
    return (out, tie) if ties else out


def render_state(xy, cov, colors, active, H, W, cap=None, dtype=torch.float32,
                 tf32=False, ties=False):
    """Project then render, in ``dtype``."""
    p = project(xy.to(dtype), cov.to(dtype), active, H, W)
    return render(p, colors, H, W, cap, dtype, tf32, ties)


def to_8bit(img: torch.Tensor) -> torch.Tensor:
    """An image as an 8-bit PNG stores it, back in [0, 1] float32."""
    return torch.round(torch.clamp(img, 0, 1) * 255.0) / 255.0
