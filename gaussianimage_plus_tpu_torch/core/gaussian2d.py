"""Per-Gaussian 2D projection: conic/radius bounds, tile bbox, culling.

Port of ``gaussianimage_plus_tpu/core/gaussian2d.py`` (``compute_cov2d_bounds``,
``tile_bbox``, ``_project_cov2d_fwd_impl``, ``_project_cov2d_bwd`` and the
parameterization helpers). Same reference semantics (gsplat
``helpers.cuh:179-206``, ``foward2d.cu:192-288``): adjugate inverse,
eigenvalue discriminant floor 0.1, ``ceil(clip_coe * sqrt(eig))`` radii, cull
on zero determinant, minor radius below ``radius_clip`` or an empty tile
bbox. Culled Gaussians carry ``valid=False``.

Integer outputs (radii, bbox, ``num_tiles_hit``) equal the JAX package's
exactly: float->int32 casts saturate as XLA's do (``_to_int32``), and the
bbox truncates toward zero before clamping, as the reference's C casts do.

The projection is differentiable in the means and the covariance through a
hand-written VJP, ``_ProjectCov2d`` (the JAX ``_project_cov2d_bwd``, reference
backward2d.cu:157-214); the Cholesky and scale-rotation helpers, and the
legacy entry points ``project_gaussians_2d_cholesky`` and
``project_gaussians_2d_scale_rot`` (JAX ``:256-286``), stay plain autograd on
top of it, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

# Reference tile size: gsplat/gsplat/cuda/csrc/config.h:1-3 (BLOCK_X=BLOCK_Y=16).
BLOCK_W = 16
BLOCK_H = 16

# Reference alpha cutoff 1/255: forward.cu:662 (`alpha < 1.f / 255.f`).
ALPHA_THRESHOLD = 1.0 / 255.0

# Reference eigenvalue discriminant floor: helpers.cuh:196.
EIGEN_DISCRIMINANT_FLOOR = 0.1

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (see the JAX ``Projected``)."""

    xys: torch.Tensor            # [N, 2] pixel-space centers
    conics: torch.Tensor         # [N, 3] inverse covariance (upper triangular)
    radii: torch.Tensor          # [N] int32 major-axis bounding radius
    num_tiles_hit: torch.Tensor  # [N] int32 tile bbox area
    valid: torch.Tensor          # [N] bool — survives all culling tests


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 with XLA's saturating semantics (NaN -> 0); a plain
    ``.to(torch.int32)`` is undefined out of range."""
    x = torch.nan_to_num(x, nan=0.0)
    big = x >= 2.0 ** 31
    small = x < -(2.0 ** 31)
    safe = torch.where(big | small, torch.zeros_like(x), x)
    out = safe.to(torch.int32)
    out = torch.where(big, torch.full_like(out, _I32_MAX), out)
    return torch.where(small, torch.full_like(out, _I32_MIN), out)


def tile_bounds_for(H: int, W: int, block_h: int = BLOCK_H,
                    block_w: int = BLOCK_W) -> Tuple[int, int]:
    """(tiles_x, tiles_y) grid covering a HxW image."""
    return (-(-W // block_w), -(-H // block_h))


# Deviation, on purpose: the JAX package renders any tile size on every
# backend. The port's kernels (A-E) are written for the reference's 16x16
# tiles (gsplat config.h, BLOCK_X = BLOCK_Y = 16), so every path that would
# launch one refuses other sizes here and names the plain path, which renders
# and differentiates any block_h x block_w on either device: ``render``,
# ``prepare_render``/``render_prepared`` and the trainer's step with
# ``raster_backend='xla'`` (or ``'auto'`` on the CPU).
def check_kernel_tiles(block_h: int, block_w: int, what: str) -> None:
    """Raise ``NotImplementedError`` for tiles other than 16x16: ``what``
    would run a kernel."""
    if (block_h, block_w) != (BLOCK_H, BLOCK_W):
        raise NotImplementedError(
            f"{what} runs the port's kernels, which render 16x16 tiles only; "
            f"{block_h}x{block_w} tiles render through raster_backend='xla' "
            f"with a bin_method other than 'pallas'")


def slv_bound(H: int, W: int, num_points) -> torch.Tensor:
    """Scalar SLV low-pass variance floor ``min(H*W / (9*pi*N), 300)``."""
    n = torch.as_tensor(num_points, dtype=torch.float32)
    return torch.clamp(H * W / (9.0 * math.pi * torch.clamp(n, min=1.0)),
                       max=300.0)


def psd_valid_mask(cov2d: torch.Tensor) -> torch.Tensor:
    """``Sigma11*Sigma22 - Sigma12^2 > 0 and Sigma11 > 0 and Sigma22 > 0``."""
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    return (det > 0) & (cov2d[:, 0] > 0) & (cov2d[:, 2] > 0)


def cholesky_to_cov2d(chol: torch.Tensor) -> torch.Tensor:
    """``(l11^2, l11*l21, l21^2 + l22^2)`` from ``[l11, l21, l22]``."""
    l11, l21, l22 = chol[:, 0], chol[:, 1], chol[:, 2]
    return torch.stack([l11 * l11, l11 * l21, l21 * l21 + l22 * l22], dim=-1)


def scale_rot_to_cov2d(scales: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """``Sigma = (R S)(R S)^T`` from scales [N, 2] and angle [N] (radians)."""
    c, s = torch.cos(rotation), torch.sin(rotation)
    sx2 = scales[:, 0] ** 2
    sy2 = scales[:, 1] ** 2
    cov_xx = c * c * sx2 + s * s * sy2
    cov_xy = c * s * (sx2 - sy2)
    cov_yy = s * s * sx2 + c * c * sy2
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def compute_cov2d_bounds(cov2d: torch.Tensor, clip_coe: float = 3.0):
    """``(conic [N,3], radius [N,2] float (major, minor), det_valid [N])``.

    Same expressions as the JAX function, including the clamp of negative
    eigenvalues to 0 before the sqrt (culled downstream by the minor-radius
    test)."""
    xx, xy, yy = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = xx * yy - xy * xy
    det_valid = det != 0.0
    inv_det = torch.where(det_valid, 1.0 / torch.where(det_valid, det, 1.0),
                          torch.zeros_like(det))
    conic = torch.stack([yy * inv_det, -xy * inv_det, xx * inv_det], dim=-1)

    b = 0.5 * (xx + yy)
    disc = torch.sqrt(torch.clamp(b * b - det, min=EIGEN_DISCRIMINANT_FLOOR))
    v1 = b + disc
    v2 = b - disc
    radius_major = torch.ceil(clip_coe * torch.sqrt(torch.clamp(v1, min=0.0)))
    radius_minor = torch.ceil(clip_coe * torch.sqrt(torch.clamp(v2, min=0.0)))
    return conic, torch.stack([radius_major, radius_minor], dim=-1), det_valid


def tile_bbox(xys: torch.Tensor, radii: torch.Tensor, tile_bounds: Tuple[int, int],
              block_h: int = BLOCK_H, block_w: int = BLOCK_W):
    """Inclusive-min / exclusive-max tile bbox (reference helpers.cuh:16-49):
    truncate toward zero, then clamp to ``[0, bounds]``."""
    tb_x, tb_y = tile_bounds
    tile_cx = xys[:, 0] / block_w
    tile_cy = xys[:, 1] / block_h
    tile_rx = radii / block_w
    tile_ry = radii / block_h
    xmin = torch.clamp(_to_int32(torch.trunc(tile_cx - tile_rx)), 0, tb_x)
    xmax = torch.clamp(_to_int32(torch.trunc(tile_cx + tile_rx + 1.0)), 0, tb_x)
    ymin = torch.clamp(_to_int32(torch.trunc(tile_cy - tile_ry)), 0, tb_y)
    ymax = torch.clamp(_to_int32(torch.trunc(tile_cy + tile_ry + 1.0)), 0, tb_y)
    return xmin, xmax, ymin, ymax


def _project_fwd(means2d: torch.Tensor, cov2d: torch.Tensor, H: int, W: int,
                 clip_coe: float, radius_clip: float) -> Projected:
    """``_project_cov2d_fwd_impl``."""
    tb = tile_bounds_for(H, W)
    conic, radius, det_valid = compute_cov2d_bounds(cov2d, clip_coe)
    valid = det_valid & (radius[:, 1] >= radius_clip)
    radii = _to_int32(torch.where(valid, radius[:, 0], torch.zeros_like(radius[:, 0])))
    xmin, xmax, ymin, ymax = tile_bbox(means2d, radii.to(torch.float32), tb)
    tile_area = (xmax - xmin) * (ymax - ymin)
    valid = valid & (tile_area > 0)
    zero = torch.zeros_like(radii)
    return Projected(xys=means2d, conics=conic,
                     radii=torch.where(valid, radii, zero),
                     num_tiles_hit=torch.where(valid, tile_area, zero),
                     valid=valid)


def project_cov2d_vjp(conics: torch.Tensor, valid: torch.Tensor,
                      v_xy: torch.Tensor, v_conic: torch.Tensor):
    """``_project_cov2d_bwd``: ``v_cov2d = -X G X`` with X the conic and G
    the symmetrized ``v_conic`` (cov2d_to_conic_vjp, helpers.cuh:384-395),
    both off-diagonal products summed into the packed slot; ``v_mean =
    v_xy`` as is. Both are zero where ``valid`` is false (the reference
    kernel returns early for culled Gaussians)."""
    cx, cxy, cy = conics[:, 0], conics[:, 1], conics[:, 2]
    gx, gxy, gy = v_conic[:, 0], v_conic[:, 1], v_conic[:, 2]
    m00 = cx * gx + cxy * gxy
    m01 = cx * gxy + cxy * gy
    m10 = cxy * gx + cy * gxy
    m11 = cxy * gxy + cy * gy
    s00 = m00 * cx + m01 * cxy
    s01 = m00 * cxy + m01 * cy
    s10 = m10 * cx + m11 * cxy
    s11 = m10 * cxy + m11 * cy
    v_cov2d = -torch.stack([s00, s01 + s10, s11], dim=-1)
    vmask = valid[:, None]
    return (torch.where(vmask, v_xy, torch.zeros_like(v_xy)),
            torch.where(vmask, v_cov2d, torch.zeros_like(v_cov2d)))


class _ProjectCov2d(torch.autograd.Function):
    """Projection with the reference's hand-written VJP: gradients reach the
    means and the covariance only (radii, ``num_tiles_hit`` and ``valid``
    carry none, as the reference returns None for them)."""

    @staticmethod
    def forward(ctx, means2d, cov2d, H, W, clip_coe, radius_clip):
        out = _project_fwd(means2d, cov2d, H, W, clip_coe, radius_clip)
        ctx.save_for_backward(out.conics, out.valid)
        ctx.mark_non_differentiable(out.radii, out.num_tiles_hit, out.valid)
        # a fresh tensor for xys: autograd must not see an input returned as is
        return means2d.clone(), out.conics, out.radii, out.num_tiles_hit, out.valid

    @staticmethod
    def backward(ctx, v_xy, v_conic, *_):
        conics, valid = ctx.saved_tensors
        v_mean, v_cov = project_cov2d_vjp(conics, valid, v_xy, v_conic)
        return v_mean, v_cov, None, None, None, None


def project_gaussians_2d_covariance(means2d: torch.Tensor, cov2d: torch.Tensor,
                                    H: int, W: int, clip_coe: float = 3.0,
                                    radius_clip: float = 1.0) -> Projected:
    """The ACTIVE projection path: means already in pixels, covariance
    passed through directly. Differentiable in ``means2d`` and ``cov2d``
    through ``_ProjectCov2d``."""
    return Projected(*_ProjectCov2d.apply(means2d, cov2d, H, W, clip_coe, radius_clip))


def project_gaussians_2d_cholesky(means_ndc: torch.Tensor, chol: torch.Tensor, H: int, W: int,
                                  clip_coe: float = 3.0, radius_clip: float = 1.0) -> Projected:
    """Legacy Cholesky parameterization: means in [-1, 1] mapped to pixels by
    ``0.5 size x + 0.5 size`` (foward2d.cu:37-41), covariance ``L L^T``.
    Autograd through these 2x2 formulas gives the reference's chain rule
    (backward2d.cu:8-51)."""
    center = torch.stack([0.5 * W * means_ndc[:, 0] + 0.5 * W,
                          0.5 * H * means_ndc[:, 1] + 0.5 * H], dim=-1)
    return Projected(*_ProjectCov2d.apply(center, cholesky_to_cov2d(chol), H, W, clip_coe,
                                          radius_clip))


def project_gaussians_2d_scale_rot(means2d: torch.Tensor, scales: torch.Tensor,
                                   rotation: torch.Tensor, H: int, W: int, clip_coe: float = 3.0,
                                   radius_clip: float = 1.0) -> Projected:
    """Legacy scale-rotation parameterization: ``Sigma = (R S)(R S)^T``
    (foward2d.cu:157-164); autograd through the 2x2 products gives
    backward2d.cu:53-154."""
    return Projected(*_ProjectCov2d.apply(means2d, scale_rot_to_cov2d(scales, rotation), H, W,
                                          clip_coe, radius_clip))
