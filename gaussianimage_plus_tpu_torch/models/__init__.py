"""Port of ``gaussianimage_plus_tpu.models`` (see each module); the same
public names as the JAX ``models/__init__.py``."""

from .gaussian_image import (
    get_attributes,
    GaussianConfig,
    GaussianParams,
    GaussianState,
    colors_of,
    effective_cov2d,
    grow,
    init_state,
    means_of,
    project,
    prune,
    resolve_backend,
    psd_mask_effective,
    render,
    render_fast,
)
