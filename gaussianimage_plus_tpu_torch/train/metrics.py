"""Quality metrics: PSNR variants, and SSIM / MS-SSIM re-exported.

Port of ``gaussianimage_plus_tpu/train/metrics.py``: the float-MSE PSNR of
the train loop (reference train.py:188-189, ``10*log10(1/mse)``) and the
clamped-uint8 variants of models/metrics.py:19-46; ``ssim`` and ``ms_ssim``
live in ``losses``.
"""

from __future__ import annotations

import torch

from .losses import ms_ssim, ssim  # noqa: F401 (re-export)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``10*log10(1 / mse)`` on float images in [0, 1]."""
    return 10.0 * torch.log10(1.0 / torch.clamp(mse(pred, target), min=1e-12))


def clamped_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE after a uint8 round trip (models/metrics.py:19-31 semantics)."""
    p = torch.round(torch.clamp(pred, 0, 1) * 255.0)
    t = torch.round(torch.clamp(target, 0, 1) * 255.0)
    return torch.mean((p - t) ** 2)


def clamped_psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(255.0 ** 2 / torch.clamp(clamped_mse(pred, target), min=1e-12))
