"""Port of ``gaussianimage_plus_tpu.core`` (see each module); the same public
names as the JAX ``core/__init__.py``."""

from .gaussian2d import (
    ALPHA_THRESHOLD,
    BLOCK_H,
    BLOCK_W,
    Projected,
    cholesky_to_cov2d,
    compute_cov2d_bounds,
    project_gaussians_2d_covariance,
    project_gaussians_2d_cholesky,
    project_gaussians_2d_scale_rot,
    psd_valid_mask,
    scale_rot_to_cov2d,
    slv_bound,
    tile_bbox,
    tile_bounds_for,
)
from .render_dense import render_dense, tile_membership, tile_cap_mask
