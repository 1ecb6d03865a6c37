"""Operations and bytes of the work itself, whatever implements it.

A (pixel, Gaussian) pair is counted when the pixel lies within the
Gaussian's radius, ``|x - mx| <= r`` and ``|y - my| <= r`` on the image
(and, in a capped render, in a tile that keeps the Gaussian): there the
render has to evaluate sigma. A pair "passes" where the render's gate
passes. Float32 operations:

- forward: sigma at every pair (two differences, their three products, the
  three conic products, two adds, the half: ``SIGMA`` = 10 with the half
  taken per row); at a passing pair the exp, the min and three
  multiply-adds of the colour sum (``BLEND`` = 8);
- backward: the gate again at every pair (``SIGMA`` + the exp); at a passing
  pair ``v_alpha = rgb . v_out`` (5), three multiply-adds of ``v_rgb`` (6),
  ``v_sigma`` (2), the three conic moments (6) and the two mean terms (9):
  ``BACKWARD_PASS`` = 28;
- per active row: the projection and its VJP (``PROJECT`` = 60) and Adam on
  its eight parameters (``ADAM`` = 10 each);
- per pixel and channel: the loss and its gradient (``LOSS`` = 5).

Bytes: every input read once and every output written once: a projected
row is 12 float32 (mean 2, conic 3, colour 3, tile rectangle 4), an image
3 float32 a pixel, a row's gradient 8 float32, Adam's state per parameter
4 reads and 3 writes. No tile, chunk or launch term enters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import render as R

SIGMA, EXP, BLEND = 10, 1, 8
BACKWARD_PASS = 28
PROJECT, ADAM, PARAMS, LOSS = 60, 10, 8, 5
F32 = 4
ROW_BYTES = 12 * F32
GRAD_BYTES = 8 * F32


class Pairs(NamedTuple):
    pairs: int      # within the radius
    passing: int    # and through the gate
    rows: int       # valid rows
    pixels: int


def pairs(p: R.Projected, H: int, W: int, cap: Optional[int] = None) -> Pairs:
    n_pairs = n_pass = 0
    with torch.no_grad():
        for blk in R.blocks(p, H, W):
            if blk.rows.numel() == 0:
                continue
            _, gate, px, py, _ = R.block_weights(p, blk, cap)
            kept = R._kept(p, blk, cap)[(px - blk.x0) // R.TILE]
            xy = p.xy[blk.rows]
            r = p.radius[blk.rows]
            near = ((xy[None, :, 0] - px[:, None]).abs() <= r[None, :]) & \
                   ((xy[None, :, 1] - py[:, None]).abs() <= r[None, :]) & kept
            n_pairs += int(near.sum())
            n_pass += int((near & gate).sum())
    return Pairs(n_pairs, n_pass, int(p.valid.sum()), H * W)


def forward(c: Pairs) -> tuple[int, int]:
    """(operations, bytes) of one forward render."""
    ops = c.pairs * SIGMA + c.passing * BLEND
    return ops, c.rows * ROW_BYTES + c.pixels * 3 * F32


def backward(c: Pairs) -> tuple[int, int]:
    """(operations, bytes) of the render's backward."""
    ops = c.pairs * (SIGMA + EXP) + c.passing * BACKWARD_PASS
    return ops, c.rows * (ROW_BYTES + GRAD_BYTES) + c.pixels * 3 * F32


def step(c: Pairs, active_rows: int) -> tuple[int, int]:
    """(operations, bytes) of one training step: forward, loss, backward,
    projection and Adam."""
    fo, fb = forward(c)
    bo, bb = backward(c)
    ops = fo + bo + active_rows * (PROJECT + ADAM * PARAMS) + c.pixels * 3 * LOSS
    nbytes = (fb + bb + active_rows * (2 * ROW_BYTES + PARAMS * 7 * F32)
              + 3 * c.pixels * 3 * F32)
    return ops, nbytes
