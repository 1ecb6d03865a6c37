"""The legacy 3D Gaussian splatting image model (Gaussian3D).

Port of ``gaussianimage_plus_tpu/models/gaussian_3d.py``:
``Gaussian3DConfig`` :32, ``Gaussian3DParams`` :42, ``random_quats`` :51,
``init_params_3d`` :63, ``camera`` :84, ``render_3d`` :96 and
``fit_image_3d`` :117, after the reference's models/gaussiansplatting_3d.py:
points in [-1, 1]^3, log scales and quaternions, logit opacity (0.1 at
start), SH colours (random DC, zero rest), a fixed camera at distance 8 with
``fov_x = pi / 2``, alpha compositing over a white background. Training is
Adam or Adan with the StepLR schedule ``lr * 0.5 ** (count // 20000)``, no
growth and no pruning.

Randomness comes from a ``torch.Generator`` (``random_quats``,
``init_params_3d``); the tests inject the JAX package's parameters instead
(``fit_image_3d(params=...)``, ``interop.gaussian3d_params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.precision import resolve_device
from ..core.project3d import project_gaussians_3d
from ..core.render_alpha import depth_order_projection, rasterize_alpha_tiled
from ..core.sh import num_sh_bases, spherical_harmonics
from ..train.losses import loss_fn
from ..train.metrics import psnr as psnr_fn
from ..train.optim import Adam, adan, step_lr


@dataclasses.dataclass(frozen=True)
class Gaussian3DConfig:
    H: int = 512
    W: int = 768
    num_points: int = 5000
    sh_degree: int = 3
    tile_cap: int = 256
    camera_z: float = 8.0


class Gaussian3DParams(NamedTuple):
    xyz: torch.Tensor            # [N, 3] in [-1, 1]
    scaling: torch.Tensor        # [N, 3] log scales
    rotation: torch.Tensor       # [N, 4] quaternions (w, x, y, z)
    opacity: torch.Tensor        # [N, 1] logits
    features_dc: torch.Tensor    # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K - 1, 3]


def random_quats(generator: torch.Generator, n: int) -> torch.Tensor:
    """Uniform random rotations (random_quat_tensor,
    gaussiansplatting_3d.py:11-26), on the generator's device."""
    u, v, w = torch.rand((n, 3), generator=generator, device=generator.device).split(1, dim=1)
    return torch.cat([torch.sqrt(1 - u) * torch.sin(2 * math.pi * v),
                      torch.sqrt(1 - u) * torch.cos(2 * math.pi * v),
                      torch.sqrt(u) * torch.sin(2 * math.pi * w),
                      torch.sqrt(u) * torch.cos(2 * math.pi * w)], dim=1)


def init_params_3d(cfg: Gaussian3DConfig, generator: torch.Generator) -> Gaussian3DParams:
    """gaussiansplatting_3d.py:56-69, on the generator's device: xyz uniform
    in [-1, 1]^3; log scales of the mean distance to the 3 nearest
    neighbours; opacity logit(0.1); DC colour uniform, the rest zero."""
    n, dev = cfg.num_points, generator.device
    xyz = 2.0 * (torch.rand((n, 3), generator=generator, device=dev) - 0.5)
    d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1) + torch.eye(n, device=dev) * 1e9
    knn = torch.topk(d2, 3, dim=1, largest=False).values
    avg = torch.sqrt(torch.clamp(knn, min=1e-12)).mean(dim=1, keepdim=True)
    k = num_sh_bases(cfg.sh_degree)
    features_dc = torch.rand((n, 1, 3), generator=generator, device=dev)
    return Gaussian3DParams(
        xyz=xyz, scaling=torch.log(avg.expand(n, 3).contiguous()),
        rotation=random_quats(generator, n),
        opacity=torch.full((n, 1), math.log(0.1 / 0.9), device=dev),
        features_dc=features_dc, features_rest=torch.zeros((n, k - 1, 3), device=dev))


def camera(cfg: Gaussian3DConfig, device=None):
    """Fixed camera: identity rotation, translation z = +``camera_z``,
    ``fov_x = pi / 2`` (gaussiansplatting_3d.py:73-84): (viewmat, focal)."""
    focal = 0.5 * cfg.W / math.tan(0.5 * math.pi / 2.0)
    viewmat = torch.tensor([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, cfg.camera_z],
                            [0, 0, 0, 1.0]], device=device)
    return viewmat, focal


def render_3d(params: Gaussian3DParams, cfg: Gaussian3DConfig,
              background: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian3D.forward (gaussiansplatting_3d.py:117-140): project, SH
    colours from the camera-relative view directions, sigmoid, alpha
    compositing -> [H, W, 3] in [0, 1], on the parameters' device."""
    dev = params.xyz.device
    viewmat, focal = camera(cfg, dev)
    p3 = project_gaussians_3d(params.xyz, torch.exp(params.scaling), 1.0, params.rotation,
                              viewmat, focal, focal, cfg.W / 2.0, cfg.H / 2.0, cfg.H, cfg.W)
    cam_pos = torch.tensor([0.0, 0.0, -cfg.camera_z], device=dev)
    coeffs = torch.cat([params.features_dc, params.features_rest], dim=1)
    colors = torch.sigmoid(spherical_harmonics(cfg.sh_degree, params.xyz - cam_pos, coeffs))
    opac = torch.sigmoid(params.opacity).reshape(-1)
    proj_sorted, order = depth_order_projection(p3.proj, p3.depths)
    img = rasterize_alpha_tiled(proj_sorted, colors[order], opac[order], cfg.H, cfg.W,
                                background=background, tile_cap=cfg.tile_cap)
    zero = torch.zeros((), dtype=img.dtype, device=dev)
    return torch.minimum(torch.maximum(img, zero), zero + 1.0)    # jnp.clip, its gradient too


def fit_image_3d(gt, cfg: Gaussian3DConfig, iterations: int = 2000, lr: float = 0.01,
                 loss_type: str = "Fusion2", seed: int = 3047, opt: str = "adam",
                 device=None, params: Optional[Gaussian3DParams] = None):
    """A plain 3D training loop (the reference's SimpleTrainer with
    ``model_name=3DGS`` remaps to lr 1e-3 and Adan, train.py:256-262; both
    optimizers are here) on ``device`` (the card unless ``device='cpu'``).
    ``params`` replaces the initial draw from a generator seeded ``seed``.
    Returns (params, {"loss", "psnr"} of the last step, and "history": the
    per-step ``loss`` and ``psnr`` tensors)."""
    dev = params.xyz.device if params is not None else resolve_device(device)
    gt = torch.as_tensor(np.asarray(gt) if not isinstance(gt, torch.Tensor) else gt,
                         dtype=torch.float32).to(dev)
    if params is None:
        params = init_params_3d(cfg, torch.Generator(device=dev).manual_seed(seed))
    schedule = step_lr(lr, 20000, 0.5)
    tx = adan(schedule) if opt == "adan" else Adam(schedule, eps=1e-8)   # optax.adam's eps
    state = tx.init(params)
    losses, psnrs = [], []
    for _ in range(iterations):
        p = Gaussian3DParams(*(x.detach().requires_grad_(True) for x in params))
        img = render_3d(p, cfg)
        loss = loss_fn(img, gt, loss_type)
        grads = torch.autograd.grad(loss, p)
        with torch.no_grad():
            updates, state = tx.update(grads, state, params)
            params = Gaussian3DParams(*(x + u for x, u in zip(params, updates)))
            losses.append(loss.detach())
            psnrs.append(psnr_fn(img.detach(), gt))
    hist = {"loss": torch.stack(losses), "psnr": torch.stack(psnrs)} if losses else {}
    return params, {"loss": float(losses[-1]) if losses else float("nan"),
                    "psnr": float(psnrs[-1]) if psnrs else float("nan"), "history": hist}
