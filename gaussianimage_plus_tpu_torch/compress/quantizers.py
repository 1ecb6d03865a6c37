"""Attribute quantizer grids and their decoders.

Port of the decode half of ``gaussianimage_plus_tpu/compress/quantizers.py``:
the parameter tuples ``UniformQuantParams``, ``LogQuantState``,
``HybridQuantParams`` and ``uniform_qrange``, ``uniform_decompress``,
``log_decompress``, ``hybrid_decompress`` (reference quantize.py). The
training-time fake quantizers belong to the QAT slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class UniformQuantParams(NamedTuple):
    """Per-channel affine grid: value = code * scale + beta."""

    scale: torch.Tensor  # [C]
    beta: torch.Tensor   # [C]


class LogQuantState(NamedTuple):
    """Log-domain grid frozen at compress time: value = exp(code * scale + beta)."""

    beta: torch.Tensor   # scalar
    scale: torch.Tensor  # scalar


class HybridQuantParams(NamedTuple):
    """Covariance quantizer: log grid on the variances (no learned params),
    learned affine grid on the off-diagonal channel."""

    cov: UniformQuantParams


def uniform_qrange(bits: int, signed: bool = False) -> Tuple[int, int]:
    if signed:
        return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    return 0, 2 ** bits - 1


def uniform_decompress(params: UniformQuantParams, code: torch.Tensor) -> torch.Tensor:
    return code * params.scale + params.beta


def log_decompress(state: LogQuantState, code: torch.Tensor) -> torch.Tensor:
    """``exp(code * scale + beta)``: the argument in the code's float type, as
    the JAX package computes it, the ``exp`` in float64 and rounded once.
    PyTorch's CPU ``exp`` of float32 (MKL's vector math, split across
    threads) has, in a fresh process, returned a whole thread's chunk at up
    to 1.5e-4 relative error; float64 keeps the result within an ulp of the
    true exponential on every device."""
    arg = code * state.scale + state.beta
    return torch.exp(arg.double()).to(arg.dtype)


def hybrid_decompress(params: HybridQuantParams, log_state: LogQuantState,
                      code: torch.Tensor) -> torch.Tensor:
    var = log_decompress(log_state, code[:, ::2])
    cov = uniform_decompress(params.cov, code[:, 1:2])
    return torch.cat([var[:, 0:1], cov, var[:, 1:2]], dim=1)
