"""Training losses.

Port of ``loss_fn`` (``gaussianimage_plus_tpu/train/losses.py:128-150``,
reference models/utils.py:60-80) for ``'L2'`` (the default), ``'L1'`` and
``'Fusion3'``. The SSIM-based losses (``'SSIM'``, ``'Fusion1'``,
``'Fusion2'``, ``'Fusion4'``, ``'Fusion_hinerv'``) need SSIM and MS-SSIM,
which are not ported yet, and raise.
"""

from __future__ import annotations

import torch

_SSIM_LOSSES = ("SSIM", "Fusion1", "Fusion2", "Fusion4", "Fusion_hinerv")


def loss_fn(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "L2",
            lambda_value: float = 0.7) -> torch.Tensor:
    """Reference loss dispatch; the target carries no gradient."""
    target = target.detach()
    if loss_type == "L2":
        return torch.mean((pred - target) ** 2)
    if loss_type == "L1":
        return torch.mean(torch.abs(pred - target))
    if loss_type == "Fusion3":
        return (lambda_value * torch.mean((pred - target) ** 2)
                + (1 - lambda_value) * torch.mean(torch.abs(pred - target)))
    if loss_type in _SSIM_LOSSES:
        raise NotImplementedError(f"loss {loss_type!r} needs SSIM, which is not ported yet")
    raise ValueError(f"unknown loss_type {loss_type!r}")
