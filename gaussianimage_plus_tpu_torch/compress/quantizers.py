"""Attribute quantizers: LSQ uniform, log-domain, hybrid and fp16.

Port of ``gaussianimage_plus_tpu/compress/quantizers.py`` (reference
quantize.py): the parameter tuples, the training-time fake quantizers with
straight-through gradients (``ste_round``, ``fake_quantize_half``,
``uniform_forward``, ``log_forward``, ``hybrid_forward``), the data inits
(``uniform_init``, ``hybrid_init``), the encoders (``uniform_compress``,
``log_compress``, ``hybrid_compress``), the decoders and ``hybrid_size``.

Gradient semantics follow the JAX functions under autograd:

- The reference computes LSQ's gradient scaling and then overwrites it
  (quantize.py:135), so the gradients to ``scale`` and ``beta`` are plain
  autograd through ``round(clip((x - beta) / scale)) * scale + beta``.
- The clip is ``torch.minimum(torch.maximum(v, lo), hi)``, whose gradient at
  a tie is one half, as ``jnp.clip``'s is. ``torch.clamp`` passes all of it,
  and ties are the normal case here: at init the smallest row's code is
  exactly ``qmin``.
- The log quantizer's ``log`` and ``exp`` are taken in float64 and rounded
  once to the argument's type (``_log``, ``_exp``), as ``log_decompress``
  takes its ``exp``: PyTorch's float32 CPU ``exp`` of a large tensor has, in a
  fresh process, returned a whole thread's chunk at up to 1.5e-4 relative
  error (``utils/exp_drift.py``). Autograd goes through the casts.
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


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, its gradient included (one half at a tie)."""
    # filled on the device: a host scalar's copy would sync the QAT step
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def _log(x: torch.Tensor) -> torch.Tensor:
    """``log`` in float64, rounded once to ``x``'s type."""
    return torch.log(x.double()).to(x.dtype)


def _exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` in float64, rounded once to ``x``'s type."""
    return torch.exp(x.double()).to(x.dtype)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round (half to even, as ``jnp.round``) with identity gradient (quantize.py:23-24)."""
    return x + (torch.round(x) - x).detach()


def fake_quantize_half(x: torch.Tensor) -> torch.Tensor:
    """fp16 round trip with identity gradient (quantize.py:27-37)."""
    return x + (x.half().to(x.dtype) - x).detach()


# --------------------------------------------------------------------------
# Uniform (LSQ-style) quantizer
# --------------------------------------------------------------------------

def uniform_init(x: torch.Tensor, bits: int, signed: bool = False) -> UniformQuantParams:
    """Data init from per-channel min/max (quantize.py:72-85):
    ``scale = (max - min) / (qmax - qmin)``; ``beta = min - qmin * scale``."""
    qmin, qmax = uniform_qrange(bits, signed)
    t_min, t_max = x.min(dim=0).values, x.max(dim=0).values
    scale = (t_max - t_min) / (qmax - qmin)
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    return UniformQuantParams(scale=scale, beta=t_min - qmin * scale)


def uniform_forward(params: UniformQuantParams, x: torch.Tensor, bits: int,
                    signed: bool = False):
    """Training-time fake quantize (quantize.py:125-141) -> (dequant, code);
    gradients reach ``x`` (straight through) and ``scale``/``beta`` through
    the dequant expression and the clip."""
    qmin, qmax = uniform_qrange(bits, signed)
    quant = ste_round(clip((x - params.beta) / params.scale, qmin, qmax))
    return quant * params.scale + params.beta, quant


def uniform_compress(params: UniformQuantParams, x: torch.Tensor, bits: int,
                     signed: bool = False):
    """(dequant, integer codes) — quantize.py:149-152."""
    qmin, qmax = uniform_qrange(bits, signed)
    code = torch.round(clip((x - params.beta) / params.scale, qmin, qmax))
    return code * params.scale + params.beta, code


def uniform_decompress(params: UniformQuantParams, code: torch.Tensor) -> torch.Tensor:
    return code * params.scale + params.beta


# --------------------------------------------------------------------------
# Log quantizer (the non-learned variant, used for the variances)
# --------------------------------------------------------------------------

def log_forward(x: torch.Tensor, bits: int):
    """Non-learned log quantization (quantize.py:219-234): the grid comes from
    the batch's global min/max of ``log(|x| + 1e-6)`` on every call; the
    dequant is ``exp`` of the grid value, without the sign. Returns
    (dequant, code, state)."""
    qmin, qmax = uniform_qrange(bits, signed=False)
    log_x = _log(torch.abs(x) + 1e-6)
    beta = log_x.min()
    scale = (log_x.max() - beta) / (qmax - qmin)
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    quant = ste_round(clip((log_x - beta) / scale, qmin, qmax))
    return _exp(quant * scale + beta), quant, LogQuantState(beta=beta, scale=scale)


def log_compress(x: torch.Tensor, bits: int):
    """quantize.py:243-254 (the non-learned path re-inits from the data)."""
    _, _, state = log_forward(x, bits)
    qmin, qmax = uniform_qrange(bits, signed=False)
    code = torch.round(clip((_log(torch.abs(x) + 1e-6) - state.beta) / state.scale,
                            qmin, qmax)).detach()
    return _exp(code * state.scale + state.beta), code, state


def log_decompress(state: LogQuantState, code: torch.Tensor) -> torch.Tensor:
    """``exp(code * scale + beta)``: the argument in the code's float type, as
    the JAX package computes it, the ``exp`` in float64 and rounded once, so
    the result is within an ulp of the true exponential on every device."""
    return _exp(code * state.scale + state.beta)


# --------------------------------------------------------------------------
# Hybrid covariance quantizer
# --------------------------------------------------------------------------

def hybrid_init(cov2d_elements: torch.Tensor, cov_bits: int) -> HybridQuantParams:
    """quantize.py:351-353: the variances have no params; the off-diagonal
    channel's uniform grid is initialised on column 1."""
    return HybridQuantParams(cov=uniform_init(cov2d_elements[:, 1:2], cov_bits))


def _hybrid(var_out, cov_out):
    (dq_var, code_var, log_state), (dq_cov, code_cov) = var_out, cov_out
    dequant = torch.cat([dq_var[:, 0:1], dq_cov, dq_var[:, 1:2]], dim=1)
    code = torch.cat([code_var[:, 0:1], code_cov, code_var[:, 1:]], dim=1)
    return dequant, code, log_state


def hybrid_forward(params: HybridQuantParams, x: torch.Tensor, bits: int, cov_bits: int):
    """quantize.py:355-366. ``x`` is the effective covariance [N, 3]: columns
    0 and 2 through the log quantizer, column 1 through the uniform one.
    Returns (dequant [N, 3], code [N, 3], log_state)."""
    return _hybrid(log_forward(x[:, ::2], bits), uniform_forward(params.cov, x[:, 1:2], cov_bits))


def hybrid_compress(params: HybridQuantParams, x: torch.Tensor, bits: int, cov_bits: int):
    return _hybrid(log_compress(x[:, ::2], bits), uniform_compress(params.cov, x[:, 1:2], cov_bits))


def hybrid_decompress(params: HybridQuantParams, log_state: LogQuantState,
                      code: torch.Tensor) -> torch.Tensor:
    var = log_decompress(log_state, code[:, ::2])
    cov = uniform_decompress(params.cov, code[:, 1:2])
    return torch.cat([var[:, 0:1], cov, var[:, 1:2]], dim=1)


def hybrid_size(bits: int, cov_bits: int) -> float:
    """Per-element bit width: (cov_bits + 2 * var_bits) / 3 (quantize.py:368-369)."""
    return (cov_bits + 2 * bits) / 3.0
