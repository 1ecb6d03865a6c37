"""3D -> 2D EWA projection of Gaussians (the legacy 3DGS path).

Port of ``gaussianimage_plus_tpu/core/project3d.py`` (``Projected3D`` :26,
``quat_to_rotmat`` :32, ``scale_rot_to_cov3d`` :44, ``project_cov3d_ewa``
:55, ``project_gaussians_3d`` :84), after the reference's
``project_gaussians`` (gsplat project_gaussians.py, forward.cu:12-103):
quaternion -> rotation, cov3d = (R S)(R S)^T, EWA with the perspective
Jacobian and the frustum clamp, the 0.3 screen-space blur floor, pixel
centres ``f x / z + c``, culling behind ``clip_thresh``. Autograd through
these 3x3 products is the backward (backward.cu:1919-2105 by hand).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gaussian2d import Projected, _to_int32, compute_cov2d_bounds, tile_bbox, tile_bounds_for


class Projected3D(NamedTuple):
    proj: Projected
    depths: torch.Tensor   # [N] view-space z (inf where culled)
    cov3d: torch.Tensor    # [N, 6] packed upper triangle


def quat_to_rotmat(quats: torch.Tensor) -> torch.Tensor:
    """[N, 4] (w, x, y, z) -> [N, 3, 3], normalising first."""
    norm = torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    q = quats / torch.clamp(norm, min=1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def scale_rot_to_cov3d(scales: torch.Tensor, glob_scale: float,
                       quats: torch.Tensor) -> torch.Tensor:
    """[N, 6] packed cov3d = (R S)(R S)^T."""
    M = quat_to_rotmat(quats) * (glob_scale * scales)[:, None, :]
    C = torch.einsum("nij,nkj->nik", M, M)
    return torch.stack([C[:, 0, 0], C[:, 0, 1], C[:, 0, 2],
                        C[:, 1, 1], C[:, 1, 2], C[:, 2, 2]], dim=-1)


def project_cov3d_ewa(mean_view: torch.Tensor, cov3d: torch.Tensor, fx: float, fy: float,
                      tan_fovx: float, tan_fovy: float) -> torch.Tensor:
    """cov2d = J W Sigma W^T J^T + 0.3 I (forward.cu:60-77), packed [N, 3],
    with ``x/z`` and ``y/z`` clamped to 1.3 times the frustum's tangents."""
    x, y, z = mean_view.unbind(-1)
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = z * torch.clamp(x / z, -lim_x, lim_x)
    ty = z * torch.clamp(y / z, -lim_y, lim_y)
    zero = torch.zeros_like(z)
    J = torch.stack([torch.stack([fx / z, zero, -fx * tx / (z * z)], -1),
                     torch.stack([zero, fy / z, -fy * ty / (z * z)], -1)], dim=-2)
    V = torch.stack([torch.stack([cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]], -1),
                     torch.stack([cov3d[:, 1], cov3d[:, 3], cov3d[:, 4]], -1),
                     torch.stack([cov3d[:, 2], cov3d[:, 4], cov3d[:, 5]], -1)], dim=-2)
    cov2d = torch.einsum("nij,njk,nlk->nil", J, V, J)
    return torch.stack([cov2d[:, 0, 0] + 0.3, cov2d[:, 0, 1], cov2d[:, 1, 1] + 0.3], dim=-1)


def project_gaussians_3d(means3d: torch.Tensor, scales: torch.Tensor, glob_scale: float,
                         quats: torch.Tensor, viewmat: torch.Tensor, fx: float, fy: float,
                         cx: float, cy: float, H: int, W: int, clip_thresh: float = 0.01,
                         clip_coe: float = 3.0) -> Projected3D:
    """The full 3DGS projection: view transform, z-culling, cov3d, EWA,
    conic and radius, pixel centres, tile bbox culling."""
    p_view = means3d @ viewmat[:3, :3].T + viewmat[:3, 3]
    z = p_view[:, 2]
    in_front = z >= clip_thresh
    zsafe = torch.where(in_front, z, torch.ones_like(z))
    p_view = torch.cat([p_view[:, :2], zsafe[:, None]], dim=-1)
    cov3d = scale_rot_to_cov3d(scales, glob_scale, quats)
    cov2d = project_cov3d_ewa(p_view, cov3d, fx, fy, 0.5 * W / fx, 0.5 * H / fy)
    conic, radius, det_valid = compute_cov2d_bounds(cov2d, clip_coe)
    xys = torch.stack([fx * p_view[:, 0] / zsafe + cx, fy * p_view[:, 1] / zsafe + cy], dim=-1)
    valid = det_valid & in_front
    radii = _to_int32(torch.where(valid, radius[:, 0], torch.zeros_like(radius[:, 0])))
    xmin, xmax, ymin, ymax = tile_bbox(xys, radii.to(torch.float32), tile_bounds_for(H, W))
    area = (xmax - xmin) * (ymax - ymin)
    valid = valid & (area > 0)
    zero = torch.zeros_like(radii)
    proj = Projected(xys=xys, conics=conic, radii=torch.where(valid, radii, zero),
                     num_tiles_hit=torch.where(valid, area, zero), valid=valid)
    return Projected3D(proj=proj, depths=torch.where(valid, z, torch.full_like(z, float("inf"))),
                       cov3d=cov3d)
