"""GaussianImage model: configuration, state and the forward render.

Port of the forward half of ``gaussianimage_plus_tpu/models/gaussian_image.py``:
``GaussianConfig``, ``GaussianParams``, ``GaussianState``, ``effective_cov2d``
(all three parameterizations), ``colors_of``, ``means_of``, ``project``,
``resolve_backend``, ``render``, ``prepare_render``, ``render_prepared`` and
``render_fast``. Every per-Gaussian buffer has ``max_num_points`` rows and an
``active`` mask, as in the JAX package; opacity is fixed at 1.

Backends: ``'pallas'`` is the binned capped kernel (kernel A), ``'xla'`` the
plain PyTorch tiled path with the same semantics, ``'list'``/``'list_t'`` the
cap-free chunk-list kernel (kernel B) at kc 64/128. ``'auto'`` follows the
JAX rule on the card (``list_t`` when the tile grid divides 16, else the
binned kernel) and gives ``'xla'`` on the CPU, as the JAX package does off the
TPU. ``'dense'``, ``'sweep'`` and ``'range'`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..core.binning import bin_gaussians
from ..core.gaussian2d import (BLOCK_H, BLOCK_W, Projected, cholesky_to_cov2d,
                               project_gaussians_2d_covariance,
                               scale_rot_to_cov2d, tile_bounds_for)
from ..core.render_tiled import rasterize_tiled
from ..kernels.raster_binned import prepare_raster, rasterize_binned, rasterize_prepared_flat
from ..kernels.raster_list import TB_T, rasterize_list, rasterize_list_t

_NOT_PORTED = ("dense", "sweep", "range")


@dataclasses.dataclass(frozen=True)
class GaussianConfig:
    """Static model/rendering configuration (fields as in the JAX config)."""

    H: int = 512
    W: int = 768
    max_num_points: int = 5000
    param: str = "covariance"
    color_norm: bool = False
    clip_coe: float = 3.0
    radius_clip: float = 1.0
    tile_cap: int = 256
    block_h: int = BLOCK_H
    block_w: int = BLOCK_W
    bin_method: str = "auto"
    raster_backend: str = "auto"


class GaussianParams(NamedTuple):
    """Per-Gaussian attributes [max_num_points, ...] (raw parameters)."""

    xyz: torch.Tensor       # [M, 2]
    cov2d: torch.Tensor     # [M, 3]
    features: torch.Tensor  # [M, 3]


class GaussianState(NamedTuple):
    params: GaussianParams
    active: torch.Tensor      # [M] bool
    bound: torch.Tensor       # [M, 3] per-row covariance floor
    num_active: torch.Tensor  # [] int32


def effective_cov2d(params: GaussianParams, bound: torch.Tensor,
                    cfg: GaussianConfig) -> torch.Tensor:
    """Covariance actually rendered, per parameterization."""
    if cfg.param == "covariance":
        return params.cov2d + bound
    if cfg.param == "cholesky":
        return cholesky_to_cov2d(params.cov2d + bound)
    if cfg.param == "scale_rot":
        return scale_rot_to_cov2d(torch.abs(params.cov2d[:, :2]) + 0.3,
                                  torch.sigmoid(params.cov2d[:, 2]) * 2.0 * math.pi)
    raise ValueError(f"unknown parameterization {cfg.param!r}")


def colors_of(params: GaussianParams, cfg: GaussianConfig) -> torch.Tensor:
    """Colour activation: sigmoid iff ``color_norm``."""
    return torch.sigmoid(params.features) if cfg.color_norm else params.features


def means_of(params: GaussianParams, cfg: GaussianConfig) -> torch.Tensor:
    """Pixel-space means (the legacy Cholesky model keeps atanh space)."""
    if cfg.param == "cholesky":
        xy = torch.tanh(params.xyz)
        return torch.stack([0.5 * cfg.W * xy[:, 0] + 0.5 * cfg.W,
                            0.5 * cfg.H * xy[:, 1] + 0.5 * cfg.H], dim=-1)
    return params.xyz


def project(params: GaussianParams, state_active: torch.Tensor, bound: torch.Tensor,
            cfg: GaussianConfig, cov_override: Optional[torch.Tensor] = None,
            means_override: Optional[torch.Tensor] = None) -> Projected:
    """Project, then cull inactive slots exactly like pruned rows."""
    cov = cov_override if cov_override is not None else effective_cov2d(params, bound, cfg)
    means = means_override if means_override is not None else means_of(params, cfg)
    proj = project_gaussians_2d_covariance(means, cov, cfg.H, cfg.W,
                                           clip_coe=cfg.clip_coe,
                                           radius_clip=cfg.radius_clip)
    valid = proj.valid & state_active
    zero = torch.zeros_like(proj.radii)
    return proj._replace(valid=valid,
                         radii=torch.where(valid, proj.radii, zero),
                         num_tiles_hit=torch.where(valid, proj.num_tiles_hit, zero))


def resolve_backend(cfg: GaussianConfig, device) -> str:
    """Resolve ``raster_backend='auto'`` for tensors on ``device``: on CUDA
    ``'list_t'`` when the tile grid divides ``TB_T`` = 16, else the binned
    kernel ``'pallas'``; on the CPU the plain tiled path ``'xla'``."""
    if cfg.raster_backend != "auto":
        return cfg.raster_backend
    if torch.device(device).type != "cuda":
        return "xla"
    tb_x, tb_y = tile_bounds_for(cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    return "list_t" if (tb_x * tb_y) % TB_T == 0 else "pallas"


def _check_supported(cfg: GaussianConfig, backend: str) -> None:
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"raster backend {backend!r} is not ported yet (ROADMAP queue 2)")
    if (cfg.block_h, cfg.block_w) != (BLOCK_H, BLOCK_W):
        raise NotImplementedError("the port's kernels render 16x16 tiles only")


def _inputs(state, cfg, cov_override, means_override, colors_override):
    proj = project(state.params, state.active, state.bound, cfg,
                   cov_override=cov_override, means_override=means_override)
    colors = colors_override if colors_override is not None else colors_of(state.params, cfg)
    opacity = torch.ones((cfg.max_num_points,), dtype=proj.xys.dtype, device=proj.xys.device)
    return proj, colors, opacity


def render(state: GaussianState, cfg: GaussianConfig,
           cov_override: Optional[torch.Tensor] = None,
           means_override: Optional[torch.Tensor] = None,
           colors_override: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward pass -> [H, W, 3] clamped to [0, 1]: project -> (bin) ->
    rasterize -> clamp, on the device of the state's tensors."""
    backend = resolve_backend(cfg, state.active.device)
    _check_supported(cfg, backend)
    proj, colors, opacity = _inputs(state, cfg, cov_override, means_override,
                                    colors_override)
    if backend in ("list", "list_t"):
        raster = rasterize_list_t if backend == "list_t" else rasterize_list
        img = raster(proj, colors, opacity, cfg.H, cfg.W)
        return torch.clamp(img, 0.0, 1.0)
    bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap,
                         block_h=cfg.block_h, block_w=cfg.block_w,
                         method=cfg.bin_method)
    if backend == "pallas":
        img = rasterize_binned(proj.xys, proj.conics, colors, opacity,
                               bins.ids, bins.mask, cfg.H, cfg.W)
    elif backend == "xla":
        img = rasterize_tiled(proj.xys, proj.conics, colors, opacity,
                              bins.ids, bins.mask, cfg.H, cfg.W)
    else:
        raise ValueError(f"unknown raster backend {backend!r}")
    return torch.clamp(img, 0.0, 1.0)


def prepare_render(state: GaussianState, cfg: GaussianConfig,
                   cov_override: Optional[torch.Tensor] = None,
                   means_override: Optional[torch.Tensor] = None,
                   colors_override: Optional[torch.Tensor] = None,
                   cap: Optional[int] = None):
    """Bin-once stage of the decode fast path: project + bin + gather into
    a ``kernels.raster_binned.Prepared`` table."""
    _check_supported(cfg, "pallas")
    proj, colors, opacity = _inputs(state, cfg, cov_override, means_override,
                                    colors_override)
    method = "top_k" if cfg.bin_method == "pallas" else cfg.bin_method
    bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cap or cfg.tile_cap,
                         block_h=cfg.block_h, block_w=cfg.block_w, method=method)
    return prepare_raster(proj.xys, proj.conics, colors, opacity,
                          bins.ids, bins.mask, cfg.H, cfg.W)


def render_prepared(prep, cfg: GaussianConfig) -> torch.Tensor:
    """Per-frame render from a prepared table -> [H, W, 3] in [0, 1]."""
    return torch.clamp(rasterize_prepared_flat(prep, cfg.H, cfg.W), 0.0, 1.0)


def render_fast(state: GaussianState, cfg: GaussianConfig,
                cov_override: Optional[torch.Tensor] = None,
                means_override: Optional[torch.Tensor] = None,
                colors_override: Optional[torch.Tensor] = None,
                sweep="list_t") -> torch.Tensor:
    """Forward-only cap-free render. ``sweep`` picks the kernel family; the
    port has the chunk-list pair (``'list'``, ``'list_t'``). The JAX default
    (dense kernel), ``True`` (sweep) and ``'range'`` raise."""
    if sweep not in ("list", "list_t"):
        name = {False: "dense", True: "sweep"}.get(sweep, sweep)
        raise NotImplementedError(
            f"render_fast kernel {name!r} is not ported yet (ROADMAP queue 2)")
    return render(state, dataclasses.replace(cfg, raster_backend=sweep),
                  cov_override, means_override, colors_override)
