"""Checkpoint save and load on ``torch.save``.

Counterpart of ``gaussianimage_plus_tpu/utils/checkpoint.py`` (the reference
saves ``{"gs": state_dict, "num_gs", "psnr", ...}`` with ``torch.save``,
train.py:173-175, and resumes at train.py:61-77). A file holds either a
``GaussianState`` (parameters, active mask, bound rows, count: the CLI's
``gaussian_model``) or a whole ``TrainState``: the state, the optimizer state
(Adam or Adan) with its count, ``step``, the best snapshot and the
``torch.Generator``'s state from ``get_state()``. Every tensor is stored
bit for bit, so a fit resumed from a checkpoint continues exactly as the
uninterrupted one: the next growth draws from the restored generator.

A save writes a temporary file beside ``path``, ``fsync``s it, renames it
over ``path`` and ``fsync``s the directory, so a crash or a power loss during
a save leaves the previous checkpoint or the new one readable.

Deviation: the format is the port's own (nested dicts of tensors and
numbers, read back with ``torch.load(weights_only=True)``). The port cannot
read the JAX package's Orbax directories without JAX; a JAX state crosses
through the JAX package's ``load_checkpoint`` and ``interop``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.precision import resolve_device
from ..models.gaussian_image import GaussianParams, GaussianState
from ..train.optim import AdamState, AdanState
from ..train.trainer import TrainState

FORMAT = "gaussianimage_plus_tpu_torch.checkpoint/1"
_OPTIMIZERS = {"adam": AdamState, "adan": AdanState}


def _gs_dict(gs: GaussianState) -> dict:
    return dict(gs.params._asdict(), active=gs.active, bound=gs.bound,
                num_active=gs.num_active)


def _gs(d: dict) -> GaussianState:
    return GaussianState(params=GaussianParams(d["xyz"], d["cov2d"], d["features"]),
                         active=d["active"], bound=d["bound"], num_active=d["num_active"])


def _opt_dict(opt) -> dict:
    kind = next(k for k, cls in _OPTIMIZERS.items() if isinstance(opt, cls))
    return dict({k: list(v) if isinstance(v, tuple) else v for k, v in opt._asdict().items()},
                kind=kind)


def _opt(d: dict):
    cls = _OPTIMIZERS[d["kind"]]
    return cls(**{k: tuple(d[k]) if isinstance(d[k], list) else d[k] for k in cls._fields})


def save_checkpoint(path, state, extra: Optional[dict] = None) -> None:
    """Write a ``GaussianState`` or ``TrainState`` and ``extra`` (numbers,
    such as ``next_iter`` or ``psnr``) to the file ``path``."""
    extra = {k: np.asarray(v).item() for k, v in (extra or {}).items()}
    if isinstance(state, TrainState):
        gen = state.generator
        payload = dict(kind="train_state", gaussians=_gs_dict(state.gaussians),
                       opt_state=_opt_dict(state.opt_state),
                       generator=None if gen is None else dict(device=gen.device.type,
                                                               state=gen.get_state()),
                       best_params=state.best_params._asdict(),
                       **{k: getattr(state, k) for k in ("step", "best_psnr", "best_iter",
                                                         "best_active", "best_bound",
                                                         "best_num_active")})
    elif isinstance(state, GaussianState):
        payload = dict(kind="gaussian_state", gaussians=_gs_dict(state))
    else:
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    payload.update(format=FORMAT, extra=extra)
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    # the file's bytes reach the disk before the rename, and the rename
    # before the save returns, so a power loss leaves the old or the new file
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def load_checkpoint(path, device=None):
    """Read a file ``save_checkpoint`` wrote onto ``device`` (the card
    unless ``device='cpu'``). Returns ``(state, extra)``.

    A ``TrainState``'s generator is restored when the file was written on
    the same device type; its state does not carry between the CPU and the
    card, so a state moved across has ``generator=None``, and a fit cannot
    resume from it."""
    dev = resolve_device(device)
    d = torch.load(os.fspath(path), map_location=dev, weights_only=True)
    if d.get("format") != FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this package ({d.get('format')!r})")
    gs = _gs(d["gaussians"])
    if d["kind"] == "gaussian_state":
        return gs, d["extra"]
    g = d["generator"]
    gen = None
    if g is not None and g["device"] == dev.type:
        gen = torch.Generator(device=dev)
        gen.set_state(g["state"].cpu())
    ts = TrainState(gaussians=gs, opt_state=_opt(d["opt_state"]), generator=gen,
                    best_params=GaussianParams(**d["best_params"]),
                    **{k: d[k] for k in ("step", "best_psnr", "best_iter", "best_active",
                                         "best_bound", "best_num_active")})
    return ts, d["extra"]
