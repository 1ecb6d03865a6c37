"""Carry states and decoded streams across from the JAX package, as numpy.

The port never imports JAX. These functions take the JAX package's arrays
after ``np.asarray`` (or anything with the same field names whose leaves
``np.asarray`` accepts, such as a JAX ``Encoding``) and build the port's
objects on a device, so both packages can compute from identical inputs:

- ``state_from_numpy``: a ``results/repr_states_*/*.npz`` file or a dict of
  ``GaussianState`` leaves (``xyz``, ``cov2d``, ``features``, ``active``,
  ``bound``, optional ``num_active``) -> ``GaussianState``;
  ``config_from_numpy`` builds the matching ``GaussianConfig``;
- ``encoding_from_numpy`` / ``bundle_from_numpy``: a JAX ``Encoding`` /
  ``QuantizerBundle`` (a decoded stream's, or a QAT bundle with its three
  quantizer Adam states and ``step``) -> ``Encoding`` / ``QuantizerBundle``;
- ``adam_state_from_numpy``: optax's Adam chain state over any tree of
  parameters -> the port's ``AdamState`` (the tree's leaves in field order);
  ``adan_state_from_numpy``: the JAX ``AdanState`` -> the port's;
- ``train_state_from_numpy``: an object shaped like the JAX ``TrainState``
  (``gaussians``, ``opt_state`` = optax's Adam chain state or a bare
  ``AdanState``, ``step``, the best snapshot) -> the port's ``TrainState``;
  ``train_state_to_numpy`` goes back, to a flat dict of numpy arrays named as
  ``TRAIN_STATE_KEYS`` (Adam) or ``ADAN_TRAIN_STATE_KEYS`` lists;
- ``batch_train_states_from_numpy``: a JAX batched ``TrainState`` (every leaf
  with a leading image axis, as ``parallel.init_batch_train_state`` and
  ``fit_batch`` return it) -> the port's list of ``TrainState``, one per image;
- ``gaussian3d_params_from_numpy``: the JAX ``Gaussian3DParams`` ->
  ``models.gaussian_3d.Gaussian3DParams``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .compress.pipeline import Encoding, QuantizerBundle
from .compress.quantizers import HybridQuantParams, LogQuantState, UniformQuantParams
from .compress.residual_vq import ResidualVQState, VQCodebook
from .core.precision import resolve_device
from .models.gaussian_3d import Gaussian3DParams
from .models.gaussian_image import GaussianConfig, GaussianParams, GaussianState
from .train.optim import AdamState, AdanState
from .train.trainer import TrainState


def _t(a, dev, dtype=None) -> torch.Tensor:
    arr = np.array(a)            # a writable copy: torch shares its memory
    if dtype is None and arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    t = torch.from_numpy(arr)
    return t.to(device=dev, dtype=dtype) if dtype is not None else t.to(dev)


def state_from_numpy(d, device=None) -> GaussianState:
    """Mapping of per-Gaussian arrays -> ``GaussianState`` on ``device``."""
    dev = resolve_device(device)
    active = _t(d["active"], dev, torch.bool)
    num = d["num_active"] if "num_active" in d else np.asarray(d["active"]).sum()
    return GaussianState(
        params=GaussianParams(xyz=_t(d["xyz"], dev, torch.float32),
                              cov2d=_t(d["cov2d"], dev, torch.float32),
                              features=_t(d["features"], dev, torch.float32)),
        active=active, bound=_t(d["bound"], dev, torch.float32),
        num_active=_t(np.asarray(num, np.int32), dev))


def config_from_numpy(d, **overrides) -> GaussianConfig:
    """``GaussianConfig`` for a saved state (H, W, colour activation, cap)."""
    kw = dict(H=int(d["H"]), W=int(d["W"]),
              max_num_points=int(np.asarray(d["xyz"]).shape[0]))
    if "color_norm" in d:
        kw["color_norm"] = bool(d["color_norm"])
    if "tile_cap" in d:
        kw["tile_cap"] = int(d["tile_cap"])
    if "slv" in d:
        kw["slv"] = bool(d["slv"])
    if "psd_mode" in d:
        kw["psd_mode"] = str(np.asarray(d["psd_mode"]))
    kw.update(overrides)
    return GaussianConfig(**kw)


def _uniform(p, dev) -> UniformQuantParams:
    return UniformQuantParams(scale=_t(p.scale, dev, torch.float32),
                              beta=_t(p.beta, dev, torch.float32))


def encoding_from_numpy(enc, device=None) -> Encoding:
    """An object with ``Encoding``'s fields (e.g. the JAX one) -> ``Encoding``."""
    dev = resolve_device(device)
    codes = np.asarray(enc.color_codes)
    return Encoding(
        means=_t(enc.means, dev, torch.float32),
        quant_means=_t(enc.quant_means, dev, torch.float32),
        quant_cov=_t(enc.quant_cov, dev, torch.float32),
        color_codes=_t(codes, dev, torch.int32 if codes.dtype.kind in "iu" else torch.float32),
        log_state=LogQuantState(beta=_t(enc.log_state.beta, dev, torch.float32),
                                scale=_t(enc.log_state.scale, dev, torch.float32)),
        active=_t(enc.active, dev, torch.bool),
        num_active=_t(np.asarray(enc.num_active, np.int32), dev))


def _tree_leaves(tree) -> list:
    """Leaves of a tree of NamedTuples and dataclasses, in field order
    (optax moments keep the parameters' structure)."""
    if hasattr(tree, "_fields"):
        names = tree._fields
    elif dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
    else:
        return [tree]
    return [leaf for f in names for leaf in _tree_leaves(getattr(tree, f))]


def adam_state_from_numpy(opt_state, device=None) -> AdamState:
    """optax's ``adam`` state (``opt_state[0]`` is ``ScaleByAdamState``; the
    schedule's count in ``opt_state[1]`` equals its count) -> ``AdamState``
    with the moments' leaves in field order: ``(xyz, cov2d, features)`` for
    the model, ``(scale, beta)`` for a quantizer grid."""
    dev = resolve_device(device)
    adam = opt_state[0]
    moments = lambda t: tuple(_t(a, dev, torch.float32) for a in _tree_leaves(t))
    return AdamState(count=_t(np.asarray(adam.count), dev, torch.int32),
                     mu=moments(adam.mu), nu=moments(adam.nu))


def adan_state_from_numpy(opt_state, device=None) -> AdanState:
    """The JAX ``AdanState`` (``count`` and four moments, each with the
    parameters' fields) -> ``AdanState``."""
    dev = resolve_device(device)
    moments = lambda t: tuple(_t(a, dev, torch.float32) for a in _tree_leaves(t))
    return AdanState(count=_t(np.asarray(opt_state.count), dev, torch.int32),
                     **{k: moments(getattr(opt_state, k)) for k in AdanState._fields[1:]})


def bundle_from_numpy(bundle, device=None) -> QuantizerBundle:
    """An object with ``QuantizerBundle``'s fields -> ``QuantizerBundle``:
    the grids, the VQ codebooks, and the quantizer Adam states and ``step``
    where the object has them (a JAX QAT bundle; a decoded stream's has
    none)."""
    dev = resolve_device(device)
    opts = {}
    if getattr(bundle, "xy_opt", None) is not None:
        opts = {k: adam_state_from_numpy(getattr(bundle, k), dev)
                for k in ("xy_opt", "cov_opt", "color_opt")}
        opts["step"] = _t(np.asarray(bundle.step), dev, torch.int32)
    color_vq = None
    if getattr(bundle, "color_vq", None) is not None:
        color_vq = ResidualVQState(layers=tuple(
            VQCodebook(embed=_t(cb.embed, dev, torch.float32),
                       cluster_size=_t(cb.cluster_size, dev, torch.float32),
                       embed_avg=_t(cb.embed_avg, dev, torch.float32))
            for cb in bundle.color_vq.layers))
    return QuantizerBundle(xy=_uniform(bundle.xy, dev),
                           cov=HybridQuantParams(cov=_uniform(bundle.cov.cov, dev)),
                           color=_uniform(bundle.color, dev), color_vq=color_vq, **opts)


_PARAMS = ("xyz", "cov2d", "features")
_BEST = (("step", "best_psnr", "best_iter") + tuple(f"best_{k}" for k in _PARAMS)
         + ("best_active", "best_bound", "best_num_active"))
TRAIN_STATE_KEYS = (
    _PARAMS + ("active", "bound", "num_active", "adam_count")
    + tuple(f"mu_{k}" for k in _PARAMS) + tuple(f"nu_{k}" for k in _PARAMS) + _BEST)
ADAN_TRAIN_STATE_KEYS = (
    _PARAMS + ("active", "bound", "num_active", "adan_count")
    + tuple(f"{m}_{k}" for m in AdanState._fields[1:] for k in _PARAMS) + _BEST)


def _params(p, dev) -> GaussianParams:
    return GaussianParams(*(_t(getattr(p, k), dev, torch.float32) for k in _PARAMS))


def train_state_from_numpy(ts, device=None, seed: int = 0) -> TrainState:
    """An object with the JAX ``TrainState``'s fields -> ``TrainState``.

    ``ts.opt_state`` is a JAX ``AdanState`` (it has ``exp_avg``), or optax's
    Adam chain, whose ``[0]`` is ``ScaleByAdamState`` (``count``, ``mu``,
    ``nu``, each moment with the parameters' fields) and whose schedule's
    count in ``[1]`` equals it. The JAX PRNG key is not carried over: the
    port's generator is seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scalar = lambda a, dtype: _t(np.asarray(a), dev, dtype)
    return TrainState(
        gaussians=state_from_numpy(
            {**{k: getattr(ts.gaussians.params, k) for k in _PARAMS},
             "active": ts.gaussians.active, "bound": ts.gaussians.bound,
             "num_active": ts.gaussians.num_active}, device=dev),
        opt_state=(adan_state_from_numpy(ts.opt_state, dev) if hasattr(ts.opt_state, "exp_avg")
                   else adam_state_from_numpy(ts.opt_state, dev)),
        generator=gen, step=scalar(ts.step, torch.int32),
        best_psnr=scalar(ts.best_psnr, torch.float32), best_iter=scalar(ts.best_iter, torch.int32),
        best_params=_params(ts.best_params, dev), best_active=_t(ts.best_active, dev, torch.bool),
        best_bound=_t(ts.best_bound, dev, torch.float32),
        best_num_active=scalar(ts.best_num_active, torch.int32))


def train_state_to_numpy(ts: TrainState) -> dict:
    """``TrainState`` -> {name: numpy array} over ``TRAIN_STATE_KEYS`` (an
    Adam state) or ``ADAN_TRAIN_STATE_KEYS`` (an Adan state)."""
    gs, opt = ts.gaussians, ts.opt_state
    is_adan = isinstance(opt, AdanState)
    out = {k: getattr(gs.params, k) for k in _PARAMS}
    out.update(active=gs.active, bound=gs.bound, num_active=gs.num_active,
               step=ts.step, best_psnr=ts.best_psnr, best_iter=ts.best_iter,
               best_active=ts.best_active, best_bound=ts.best_bound,
               best_num_active=ts.best_num_active)
    out["adan_count" if is_adan else "adam_count"] = opt.count
    for m in opt._fields[1:]:
        for i, k in enumerate(_PARAMS):
            out[f"{m}_{k}"] = getattr(opt, m)[i]
    for i, k in enumerate(_PARAMS):
        out[f"best_{k}"] = ts.best_params[i]
    keys = ADAN_TRAIN_STATE_KEYS if is_adan else TRAIN_STATE_KEYS
    return {k: out[k].detach().cpu().numpy() for k in keys}


def _take(tree, i: int):
    """Element ``i`` of every array leaf of a tree of NamedTuples, dataclasses
    (flax's among them), tuples and lists, in a tree of the same types."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(_take(x, i) for x in tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _take(getattr(tree, f.name), i)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(x, i) for x in tree)
    if hasattr(tree, "__array__"):
        return np.asarray(tree)[i]
    return tree


def batch_train_states_from_numpy(tss, device=None, seeds=None) -> list:
    """A batched JAX ``TrainState`` (leading image axis on every leaf) -> one
    ``TrainState`` per image; image ``i``'s generator is seeded ``seeds[i]``
    (default ``i``), since the JAX keys do not carry over."""
    n = np.asarray(tss.step).shape[0]
    return [train_state_from_numpy(_take(tss, i), device,
                                   seed=i if seeds is None else int(seeds[i]))
            for i in range(n)]


def gaussian3d_params_from_numpy(p, device=None) -> Gaussian3DParams:
    """An object with ``Gaussian3DParams``' fields (the JAX one) -> the port's."""
    dev = resolve_device(device)
    return Gaussian3DParams(*(_t(getattr(p, k), dev, torch.float32)
                              for k in Gaussian3DParams._fields))
