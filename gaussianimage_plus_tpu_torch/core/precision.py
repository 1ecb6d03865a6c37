"""Precision and device policy — ONE home for the whole port.

Counterpart of ``gaussianimage_plus_tpu/core/precision.py``. The JAX package
runs every raster matmul at ``Precision.HIGHEST`` because reduced-precision
operands flip the ``sigma >= 0`` blend gate near Gaussian centres (0.07 rms
image error measured with bf16 operands, EXPERIMENTS.md "MXU precision root
cause"). The port's counterpart of that rule: every tensor is float32, and
TF32 is off for both matmuls and cuDNN, since TF32 keeps only ~3 decimal
digits.

Device rule: entry points take an explicit ``device``. ``None`` means the
card; with no card they raise instead of quietly running on the CPU. The CPU
runs only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raise if there is none); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
