"""Codec: quantization-aware training, the encoder, decode and bpp accounting.

Port of ``gaussianimage_plus_tpu/compress/pipeline.py``: ``QuantConfig``,
``QuantizerBundle``, the data init (``_masked_min_max``,
``_uniform_init_masked``, ``init_quantizers``; gaussianimage_covariance.py
:148-153), the quantized forward (``_log_fwd_masked``, ``quantize_attributes``,
``render_quantized``), the per-quantizer Adams (``make_quantizer_opts``), the
QAT steps (``quant_train_chunk``), the encoder (``compress_wo_ec``,
:412-443), the decode (``_decode_attributes``, ``decompress_wo_ec``,
``prepare_decode``/``decode_frame``), ``morton_reorder`` and the bpp
accounting (``analysis_wo_ec``, :469-509). The JAX ``_uniform_fwd`` is
``quantizers.uniform_forward``. ``quant_train_macro_chunk`` (``:311-341``)
runs chunks of QAT steps step for step as successive ``quant_train_chunk``
calls: on the card, wherever ``render`` runs through a kernel
(``train.trainer.captures``: ``'pallas'`` with any binner, as on a tile grid
that 16 does not divide, ``'list'``, ``'list_t'``, ``'dense'``, ``'sweep'``), as
replays of one captured chunk (``train.trainer.ChunkGraph``), as the JAX one
fuses them into one TPU dispatch; through ``'xla'`` and on the CPU eagerly.
On the card the binned decode of ``decompress_wo_ec`` (dequantize, projection,
kernel E, kernel A) is likewise a replay of one captured graph per stream shape
(``decode_graph_key``), its rows padded to a multiple of ``ROW_BUCKET``.

Every quantizer statistic is taken over the active rows only. The QAT step
never re-sorts the rows (the JAX loop does not), masks the model update of
inactive rows after the moment update (their moments still move, unlike the
fit's ``zero_rows``), and carries the best snapshot on the device with
``torch.where``: no step synchronises with the host (the quantizers' bounds
are filled on the device, and the log quantizer's float64 ``log`` and ``exp``
are device ops), so a chunk of steps can be captured.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.binning import morton_perm, resolve_bin_method
from ..core.gaussian2d import BLOCK_H, BLOCK_W, psd_valid_mask, tile_bounds_for
from ..models.gaussian_image import (GaussianConfig, GaussianParams,
                                     GaussianState, colors_of, effective_cov2d,
                                     prepare_render, render, render_fast,
                                     render_prepared)
from ..train.losses import loss_fn
from ..train.metrics import psnr as psnr_fn
from ..train.optim import Adam, AdamState, make_adam, step_lr
from ..train.trainer import ChunkGraph, ChunkRunner, captures
from ..utils.profiling import count, span
from .quantizers import (HybridQuantParams, LogQuantState, UniformQuantParams,
                         _exp, _log, clip, fake_quantize_half, hybrid_size,
                         log_decompress, ste_round, uniform_decompress,
                         uniform_forward, uniform_qrange)
from .residual_vq import (ResidualVQState, VQCodebook, init_residual_vq, residual_vq_bits,
                          residual_vq_decode, residual_vq_forward)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    xy_bit: int = 12
    cov_bit: int = 10
    color_bit: int = 6
    xy_quant: str = "lsq"     # lsq | fp16
    cov_quant: str = "lsq"
    color_quant: str = "lsq"  # lsq | vq
    quant_lr: float = 1e-3
    quant_lr_step: int = 10000
    quant_lr_gamma: float = 0.5
    # per-tile capacity of the binned decode render; 0 = the training cap
    decode_cap: int = 0
    init_percentile: float = 100.0


class QuantizerBundle(NamedTuple):
    """Quantizer grids, and in training their optimizer states. ``color_vq``
    holds the residual-VQ codebooks when ``color_quant == 'vq'`` (then
    ``color`` is unused; the codebooks move by EMA, with no optimizer). A
    decoder needs the grids only, so the Adam states of the three learned
    grids (``Adam`` over ``(scale, beta)``) and the shared schedule count
    ``step`` default to ``None``."""

    xy: UniformQuantParams
    cov: HybridQuantParams
    color: UniformQuantParams
    color_vq: Optional[ResidualVQState] = None
    xy_opt: Optional[AdamState] = None
    cov_opt: Optional[AdamState] = None
    color_opt: Optional[AdamState] = None
    step: Optional[torch.Tensor] = None


_BIG = float(np.finfo(np.float32).max)


def _quantile(x: torch.Tensor, q: float, nan_rows: bool = False) -> torch.Tensor:
    """Per-column linear-interpolation quantile of [M, C] ``x``, computed as
    ``jnp.quantile`` computes it: the float32 rank ``q (n - 1)``, then
    ``low (1 - w) + high w`` (XLA's CPU compiler may fuse one product into
    an FMA, so the two can differ by an ulp). With ``nan_rows`` NaNs are
    left out of ``n`` (``jnp.nanquantile``; the median then averages the two
    middle values, where ``torch.nanmedian`` returns the lower one).
    ``torch.quantile`` interpolates with ``lerp``, which rounds differently."""
    xs = torch.sort(x, dim=0).values                     # NaNs sort last
    qt = torch.tensor(q, dtype=torch.float32, device=x.device)
    if nan_rows:
        n = (~torch.isnan(x)).sum(0).to(torch.float32)
    else:
        n = torch.full((x.shape[1],), float(x.shape[0]), device=x.device)
    rank = qt * (n - 1)
    low, high = torch.floor(rank), torch.ceil(rank)
    w_high = rank - low
    w_low = 1 - w_high
    zero = torch.zeros((), device=x.device)
    low = torch.maximum(zero, torch.minimum(low, n - 1)).long()
    high = torch.maximum(zero, torch.minimum(high, n - 1)).long()
    return xs.gather(0, low[None])[0] * w_low + xs.gather(0, high[None])[0] * w_high


def _masked_min_max(x: torch.Tensor, active: torch.Tensor, percentile: float = 100.0):
    """Per-column (min, max) over the active rows, or the ``[100 - p, p]``
    percentiles with the inactive rows pushed to the active rows' median, so
    that they do not drag the tails."""
    m = active[:, None]
    if percentile >= 100.0:
        big = torch.full_like(x, _BIG)
        return (torch.where(m, x, big).min(dim=0).values,
                torch.where(m, x, -big).max(dim=0).values)
    med = _quantile(torch.where(m, x, torch.full_like(x, float("nan"))), 0.5, nan_rows=True)
    xa = torch.where(m, x, med[None, :])
    # jnp.percentile's q = p / 100 in float32, as XLA compiles it: p times
    # the float32 reciprocal 0.01 (for p = 99, 0.98999995, an ulp under 99 / 100)
    lo_q = float(np.float32(100.0 - percentile) * np.float32(0.01))
    hi_q = float(np.float32(percentile) * np.float32(0.01))
    return _quantile(xa, lo_q), _quantile(xa, hi_q)


def _uniform_init_masked(x, active, bits, signed=False,
                         percentile: float = 100.0) -> UniformQuantParams:
    qmin, qmax = uniform_qrange(bits, signed)
    t_min, t_max = _masked_min_max(x, active, percentile)
    scale = (t_max - t_min) / (qmax - qmin)
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    return UniformQuantParams(scale=scale, beta=t_min - qmin * scale)


def _log_fwd_masked(x: torch.Tensor, active: torch.Tensor, bits: int):
    """Non-learned log quantizer over the active rows only (quantize.py
    :219-234), with its own scale floor ``max(scale, 1e-12)`` (the JAX
    package's; ``quantizers.log_forward`` floors at 1e-8). The ``log`` and
    ``exp`` are float64, rounded once (``quantizers._log``/``_exp``).
    Returns (dequant, code, grid)."""
    qmin, qmax = uniform_qrange(bits, signed=False)
    log_x = _log(torch.abs(x) + 1e-6)
    m = active[:, None]
    big = torch.full_like(log_x, _BIG)
    beta = torch.where(m, log_x, big).min()
    max_log = torch.where(m, log_x, -big).max()
    scale = torch.maximum((max_log - beta) / (qmax - qmin),
                          torch.full((), 1e-12, device=x.device))
    quant = ste_round(clip((log_x - beta) / scale, qmin, qmax))
    return _exp(quant * scale + beta), quant, LogQuantState(beta=beta, scale=scale)


def make_quantizer_opts(qcfg: QuantConfig) -> Tuple[Adam, Adam, Adam]:
    """The per-quantizer Adams (gaussianimage_covariance.py:119-146): xy at
    torch's default eps 1e-8 (:122), covariance and colour at 1e-15 (:131-132,
    :143-144), all on ``StepLR(quant_lr_step, quant_lr_gamma)``."""
    sched = step_lr(qcfg.quant_lr, qcfg.quant_lr_step, qcfg.quant_lr_gamma)
    return Adam(sched, eps=1e-8), Adam(sched, eps=1e-15), Adam(sched, eps=1e-15)


def _grid_leaves(p) -> Tuple[torch.Tensor, ...]:
    """The learned tensors of a grid, in the order its Adam holds them."""
    u = p.cov if isinstance(p, HybridQuantParams) else p
    return (u.scale, u.beta)


def _grid_like(p, leaves):
    u = UniformQuantParams(*leaves)
    return HybridQuantParams(cov=u) if isinstance(p, HybridQuantParams) else u


def init_quantizers(state: GaussianState, cfg: GaussianConfig, qcfg: QuantConfig,
                    generator: Optional[torch.Generator] = None,
                    vq_init_indices: Optional[Sequence[torch.Tensor]] = None) -> QuantizerBundle:
    """_init_data (gaussianimage_covariance.py:148-153) on ``state``, on its
    device, with fresh Adam states. In ``'vq'`` colour mode the residual VQ
    (codebook size 8, 2 quantizers, 5 k-means iterations; :137-138) is
    initialised on the active rows' colours (inactive rows take the first
    active row's); its first k-means centres come from ``vq_init_indices``,
    else from ``generator`` (default: a generator seeded with 0)."""
    active = state.active
    pct = qcfg.init_percentile
    with torch.no_grad():
        xy_p = _uniform_init_masked(state.params.xyz, active, qcfg.xy_bit)
        cov_eff = effective_cov2d(state.params, state.bound, cfg)
        cov_p = HybridQuantParams(cov=_uniform_init_masked(cov_eff[:, 1:2], active,
                                                           qcfg.cov_bit, percentile=pct))
        colors = colors_of(state.params, cfg)
        col_p = _uniform_init_masked(colors, active, qcfg.color_bit, percentile=pct)
        color_vq = None
        if qcfg.color_quant == "vq":
            first = torch.argmax(active.to(torch.int32))
            colors = torch.where(active[:, None], colors, colors[first][None, :])
            if generator is None and vq_init_indices is None:
                generator = torch.Generator(device=colors.device).manual_seed(0)
            color_vq = init_residual_vq(colors, num_quantizers=2, codebook_size=8,
                                        kmeans_iters=5, generator=generator,
                                        init_indices=vq_init_indices)
    xy_tx, cov_tx, col_tx = make_quantizer_opts(qcfg)
    return QuantizerBundle(
        xy=xy_p, cov=cov_p, color=col_p, color_vq=color_vq,
        xy_opt=xy_tx.init(_grid_leaves(xy_p)), cov_opt=cov_tx.init(_grid_leaves(cov_p)),
        color_opt=col_tx.init(_grid_leaves(col_p)),
        step=torch.zeros((), dtype=torch.int32, device=active.device))


def quantize_attributes(bundle: QuantizerBundle, state: GaussianState,
                        cfg: GaussianConfig, qcfg: QuantConfig, update_vq: bool = True):
    """forward_quantize's attribute path (gaussianimage_covariance.py:384-393)
    -> (means, cov_elements, colors, codes dict, log grid). In ``'vq'`` mode
    ``codes['color_vq_state']`` holds the codebooks after this batch's EMA
    step (``update_vq``)."""
    if qcfg.xy_quant == "fp16":
        means = fake_quantize_half(state.params.xyz)
        code_xy = means
    else:
        means, code_xy = uniform_forward(bundle.xy, state.params.xyz, qcfg.xy_bit)
    cov_eff = effective_cov2d(state.params, state.bound, cfg)
    var_dq, code_var, log_state = _log_fwd_masked(cov_eff[:, ::2], state.active, qcfg.cov_bit)
    cov_dq, code_cov = uniform_forward(bundle.cov.cov, cov_eff[:, 1:2], qcfg.cov_bit)
    cov_elements = torch.cat([var_dq[:, 0:1], cov_dq, var_dq[:, 1:2]], dim=1)
    codes = {"xy": code_xy,
             "cov": torch.cat([code_var[:, 0:1], code_cov, code_var[:, 1:]], dim=1)}
    raw_colors = colors_of(state.params, cfg)
    if qcfg.color_quant == "vq":
        colors, _, codes["color"], codes["color_vq_state"] = residual_vq_forward(
            bundle.color_vq, raw_colors, update=update_vq)
    else:
        colors, codes["color"] = uniform_forward(bundle.color, raw_colors, qcfg.color_bit)
    return means, cov_elements, colors, codes, log_state


def render_quantized(bundle: QuantizerBundle, state: GaussianState, cfg: GaussianConfig,
                     qcfg: QuantConfig):
    """The quantized attributes rendered as overrides -> (image, codes, log grid)."""
    means, cov_elements, colors, codes, log_state = quantize_attributes(bundle, state, cfg, qcfg)
    img = render(state, cfg, cov_override=cov_elements, means_override=means,
                 colors_override=colors)
    return img, codes, log_state


def _pick(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` over matching trees of tensors (None leaves)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    picked = [_pick(cond, x, y) for x, y in zip(a, b)]
    return type(a)(*picked) if hasattr(a, "_fields") else tuple(picked)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().requires_grad_(True)


def quant_train_chunk(state: GaussianState, model_opt_state: AdamState,
                      bundle: QuantizerBundle, gt: torch.Tensor, cfg: GaussianConfig,
                      qcfg: QuantConfig, model_lr: float, n_steps: int, best=None):
    """``n_steps`` quantization-aware steps (train_iter_quantize,
    gaussianimage_covariance.py:219-247): the L2 image loss alone (the VQ
    commitment loss is computed and never added, :224); the model Adam and
    the three quantizer Adams all step; the VQ codebooks take this batch's
    EMA step. The model Adam is ``Adam(model_lr, eps 1e-15)`` on
    ``StepLR(20000, 0.5)`` whatever the fit's schedule was (the JAX
    package's ``pipeline.py:251``); only its state carries over.

    ``best`` is the (psnr, params, (xy, cov, color) grids, color_vq) carry of
    the best quantized PSNR. A step that beats it strictly stores the
    parameters, grids and codebooks that produced its image (pre-update), so
    encoding the snapshot reproduces the PSNR; the reference copies the
    post-update state, one step later (a deliberate deviation of the JAX
    package, kept). Returns (state, model_opt_state, bundle, metrics) with
    per-step ``loss`` and ``psnr`` tensors and the ``best`` carry."""
    model_tx = make_adam(model_lr, 20000, 0.5, 1e-15)
    txs = make_quantizer_opts(qcfg)
    dev = state.active.device
    gt = gt.to(dev)
    if best is None:
        best = _initial_best(state, bundle)
    m = state.active[:, None]
    losses, psnrs = [], []
    for _ in range(n_steps):
        params = GaussianParams(*map(_leaf, state.params))
        grids = tuple(_grid_like(g, map(_leaf, _grid_leaves(g)))
                      for g in (bundle.xy, bundle.cov, bundle.color))
        b = bundle._replace(xy=grids[0], cov=grids[1], color=grids[2])
        img, codes, _ = render_quantized(b, state._replace(params=params), cfg, qcfg)
        loss = loss_fn(img, gt, "L2")
        leaves = tuple(params) + tuple(t for g in grids for t in _grid_leaves(g))
        # the unused grid (xy in fp16 mode, colour in vq mode) has no gradient
        grads = [torch.zeros_like(t) if g is None else g for t, g in
                 zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        with torch.no_grad():
            upd, model_opt_state = model_tx.update(tuple(grads[:3]), model_opt_state)
            new_params = GaussianParams(*(p + torch.where(m, u, torch.zeros_like(u))
                                          for p, u in zip(state.params, upd)))
            new_grids, new_opts = [], []
            for i, (g, tx, opt) in enumerate(zip(
                    (bundle.xy, bundle.cov, bundle.color), txs,
                    (bundle.xy_opt, bundle.cov_opt, bundle.color_opt))):
                u, opt = tx.update(tuple(grads[3 + 2 * i:5 + 2 * i]), opt)
                new_grids.append(_grid_like(g, [t + d for t, d in zip(_grid_leaves(g), u)]))
                new_opts.append(opt)
            cur_psnr = psnr_fn(img.detach(), gt)
            improved = cur_psnr > best[0]
            best = (torch.where(improved, cur_psnr, best[0]),
                    _pick(improved, state.params, best[1]),
                    _pick(improved, (bundle.xy, bundle.cov, bundle.color), best[2]),
                    _pick(improved, bundle.color_vq, best[3]))
            bundle = bundle._replace(
                xy=new_grids[0], cov=new_grids[1], color=new_grids[2], xy_opt=new_opts[0],
                cov_opt=new_opts[1], color_opt=new_opts[2], step=bundle.step + 1,
                color_vq=codes.get("color_vq_state", bundle.color_vq))
            state = state._replace(params=new_params)
            losses.append(loss.detach())
            psnrs.append(cur_psnr)
    return state, model_opt_state, bundle, {"loss": torch.stack(losses),
                                            "psnr": torch.stack(psnrs), "best": best}


def _initial_best(state: GaussianState, bundle: QuantizerBundle):
    """The ``best`` carry before the first QAT step."""
    return (torch.full((), -float("inf"), device=state.active.device), state.params,
            (bundle.xy, bundle.cov, bundle.color), bundle.color_vq)


def _qat_runner(gt: torch.Tensor, cfg: GaussianConfig, qcfg: QuantConfig, model_lr: float,
                chunk: int, warm_on_clone: bool = False) -> ChunkRunner:
    """The chunk runner of ``quant_train_macro_chunk``: carry ``(state,
    model_opt_state, bundle, best)``, outputs per chunk ``(loss, psnr)``,
    each [chunk]. A graph keeps its own copy of ``gt``. Its warm-up chunk
    and capture record ``qat.warm_chunk`` and ``qat.capture``."""
    graph = captures(cfg, gt.device)
    gt = gt.clone() if graph else gt

    def fn(carry):
        state, mos, bundle, m = quant_train_chunk(*carry[:3], gt, cfg, qcfg, model_lr, chunk,
                                                  best=carry[3])
        return (state, mos, bundle, m["best"]), (m["loss"], m["psnr"])

    return ChunkRunner(fn, graph, warm_on_clone, spans="qat")


def _qat_macro(runner: ChunkRunner, state, model_opt_state, bundle, n_chunks: int, best=None):
    best = _initial_best(state, bundle) if best is None else best
    (state, model_opt_state, bundle, best), (loss, psnr) = runner.run(
        (state, model_opt_state, bundle, best), n_chunks)
    return state, model_opt_state, bundle, {"loss": loss.reshape(-1), "psnr": psnr.reshape(-1),
                                            "best": best}


def quant_train_macro_chunk(state: GaussianState, model_opt_state: AdamState,
                            bundle: QuantizerBundle, gt: torch.Tensor, cfg: GaussianConfig,
                            qcfg: QuantConfig, model_lr: float, n_chunks: int, chunk: int,
                            best=None):
    """``n_chunks`` chunks of ``chunk`` QAT steps, step for step successive
    ``quant_train_chunk`` calls carrying ``best``: the model Adam, the three
    quantizer Adams, the VQ codebooks' EMA step and the best snapshot. On
    the card, on a route that ``train.trainer.captures``, the chunks are
    replays of one captured chunk, warmed up first on a clone of the carry;
    elsewhere they run eagerly. Returns (state, model_opt_state, bundle,
    metrics) with ``loss`` and ``psnr`` [n_chunks * chunk] and the ``best``
    carry."""
    gt = gt.to(state.active.device)
    runner = _qat_runner(gt, cfg, qcfg, model_lr, chunk, warm_on_clone=True)
    return _qat_macro(runner, state, model_opt_state, bundle, n_chunks, best)


class Encoding(NamedTuple):
    """compress_wo_ec output (gaussianimage_covariance.py:442-443)."""

    means: torch.Tensor          # dequantized xy [M, 2]
    quant_means: torch.Tensor    # integer codes [M, 2] (fp16 values in fp16 mode)
    quant_cov: torch.Tensor      # integer codes [M, 3]
    color_codes: torch.Tensor    # integer codes [M, 3] (lsq) or indices [M, L] (vq)
    log_state: LogQuantState     # frozen log grid for decode
    active: torch.Tensor         # [M] post-quantization validity
    num_active: torch.Tensor


def _decode_attributes(bundle: QuantizerBundle, enc: Encoding, qcfg: QuantConfig):
    """Dequantize the integer codes -> (means, cov_elements, colors)."""
    if qcfg.xy_quant == "fp16":
        means = enc.quant_means
    else:
        means = uniform_decompress(bundle.xy, enc.quant_means)
    var = log_decompress(enc.log_state, enc.quant_cov[:, ::2])
    cov_mid = uniform_decompress(bundle.cov.cov, enc.quant_cov[:, 1:2])
    cov_elements = torch.cat([var[:, 0:1], cov_mid, var[:, 1:2]], dim=1)
    if qcfg.color_quant == "vq":
        colors = residual_vq_decode(bundle.color_vq, enc.color_codes)
    else:
        colors = uniform_decompress(bundle.color, enc.color_codes)
    return means, cov_elements, colors


def _decoded_state(bundle, enc, bound, qcfg):
    with span("decode.dequantize"):
        means, cov, colors = _decode_attributes(bundle, enc, qcfg)
    state = GaussianState(
        params=GaussianParams(xyz=means, cov2d=cov, features=colors),
        active=enc.active, bound=bound, num_active=enc.num_active)
    return state, dict(cov_override=cov, means_override=means, colors_override=colors)


def _binned_config(cfg: GaussianConfig, qcfg: QuantConfig, device) -> GaussianConfig:
    """The config of the binned decode render.

    Parity decision: as in the JAX package (``pipeline.py:452-460``), the
    binned branch PINS the binned machinery — the binned kernel (``'pallas'``)
    on the card, the plain tiled path (``'xla'``) on the CPU — and so replaces
    ``cfg.raster_backend`` even when the caller set it explicitly (ADVICE r5
    notes this). The port keeps that behaviour: ``backend='binned'`` then
    means the same capped function on every device, and the two choices it
    can make compute that one function."""
    dcap = qcfg.decode_cap if qcfg.decode_cap > 0 else cfg.tile_cap
    pinned = "pallas" if torch.device(device).type == "cuda" else "xla"
    return dataclasses.replace(cfg, tile_cap=min(dcap, cfg.tile_cap),
                               raster_backend=pinned)


# the binned decode's CUDA graphs: rows padded to a multiple of ROW_BUCKET, at
# most DECODE_GRAPHS_MAX graphs kept, the least recently used evicted first
ROW_BUCKET = 512
DECODE_GRAPHS_MAX = 16
_DECODE_GRAPHS: "OrderedDict[tuple, _DecodeGraph]" = OrderedDict()


class _Inputs(NamedTuple):
    """What the binned decode reads: ``rows``, the per-row tensors (the
    codes, ``active``, ``bound``); ``rest``, the grids' scales and betas, the
    log grid, ``num_active`` and the VQ codebooks, flat."""

    rows: Tuple[torch.Tensor, ...]
    rest: Tuple[torch.Tensor, ...]


def _decode_inputs(bundle: QuantizerBundle, enc: Encoding, bound: torch.Tensor) -> _Inputs:
    books = () if bundle.color_vq is None else tuple(cb.embed for cb in bundle.color_vq.layers)
    return _Inputs(
        rows=(enc.quant_means, enc.quant_cov, enc.color_codes, enc.active, bound),
        rest=(bundle.xy.scale, bundle.xy.beta, bundle.cov.cov.scale, bundle.cov.cov.beta,
              bundle.color.scale, bundle.color.beta, enc.log_state.beta, enc.log_state.scale,
              enc.num_active) + books)


def _render_inputs(inp: _Inputs, cfg: GaussianConfig, qcfg: QuantConfig) -> torch.Tensor:
    """The binned decode of ``_decode_inputs``'s tensors: dequantize, then
    ``render``."""
    quant_means, quant_cov, color_codes, active, bound = inp.rows
    xs, xb, cs, cb, ls, lb, log_b, log_s, num_active, *books = inp.rest
    color_vq = ResidualVQState(layers=tuple(
        VQCodebook(embed=e, cluster_size=None, embed_avg=None) for e in books)) if books else None
    bundle = QuantizerBundle(xy=UniformQuantParams(xs, xb),
                             cov=HybridQuantParams(cov=UniformQuantParams(cs, cb)),
                             color=UniformQuantParams(ls, lb), color_vq=color_vq)
    enc = Encoding(means=None, quant_means=quant_means, quant_cov=quant_cov,
                   color_codes=color_codes, log_state=LogQuantState(beta=log_b, scale=log_s),
                   active=active, num_active=num_active)
    state, over = _decoded_state(bundle, enc, bound, qcfg)
    return render(state, cfg, **over)


@functools.lru_cache(maxsize=256)
def _graph_config(cfg: GaussianConfig, qcfg: QuantConfig, device: str, rows: int) -> GaussianConfig:
    """The binned decode's config for ``rows`` rows padded to their bucket,
    its binner resolved at ``rows``, so that the padding cannot move it:
    kernel E (``'pallas'``) wherever the binning is an exact selection, whose
    result is ``'top_k'``'s; any other method (``'hier'``) as it is."""
    bcfg = _binned_config(cfg, qcfg, device)
    tb_x, tb_y = tile_bounds_for(bcfg.H, bcfg.W, bcfg.block_h, bcfg.block_w)
    method = resolve_bin_method(bcfg.bin_method, tb_x * tb_y, rows)
    if method in ("top_k", "rank", "scatter"):
        method = "pallas"
    return dataclasses.replace(bcfg, max_num_points=-(-rows // ROW_BUCKET) * ROW_BUCKET,
                               bin_method=method)


def _key(inp: _Inputs, cfg: GaussianConfig, qcfg: QuantConfig) -> tuple:
    dev = inp.rows[0].device
    return (str(dev), _graph_config(cfg, qcfg, dev.type, inp.rows[0].shape[0]),
            qcfg.xy_quant, qcfg.color_quant,
            tuple((t.shape[1:], t.dtype) for t in inp.rows),
            tuple((t.shape, t.dtype) for t in inp.rest))


def decode_graph_key(bundle: QuantizerBundle, enc: Encoding, bound: torch.Tensor,
                     cfg: GaussianConfig, qcfg: QuantConfig) -> tuple:
    """The key of the graph that renders this input: the device, the graph's
    config (H, W, the cap, the row bucket, the binner), the quantizer modes
    and the shapes and dtypes of what the decode reads, rows padded to the
    bucket. Never the content: two streams of one key share a graph."""
    return _key(_decode_inputs(bundle, enc, bound), cfg, qcfg)


def _graphs(inp: _Inputs, cfg: GaussianConfig) -> bool:
    """Whether the binned decode of ``inp`` replays a graph: on a CUDA
    device, 16x16 tiles (the kernels' only ones), a config of the input's
    row count, and no input that requires grad."""
    rows = inp.rows
    if rows[0].device.type != "cuda" or (cfg.block_h, cfg.block_w) != (BLOCK_H, BLOCK_W):
        return False
    if cfg.max_num_points != rows[0].shape[0]:
        return False
    return not any(t.requires_grad for t in rows + inp.rest)


class _DecodeGraph:
    """One binned decode render captured into a CUDA graph (a
    ``train.trainer.ChunkGraph`` of an empty carry, so that each replay adds
    the captured launches to the kernel wrappers' counts) over static
    buffers: each call copies its input into them, the rows into the first
    rows of the bucket, and replays. The rows past the input's are inactive
    with zero codes: an inactive row fails ``valid``, so kernel E gives it
    the empty bbox and no tile holds it, and the rows before it keep their
    ids and order, so the image is unchanged. The copies are one
    ``torch._foreach_copy_`` per dtype, into views kept per row count."""

    def __init__(self, inp: _Inputs, cfg: GaussianConfig, qcfg: QuantConfig):
        n = cfg.max_num_points
        self.static = _Inputs(rows=tuple(t.new_zeros((n,) + t.shape[1:]) for t in inp.rows),
                              rest=tuple(t.clone() for t in inp.rest))
        self.cfg, self.qcfg = cfg, qcfg
        flat = inp.rows + inp.rest
        self.groups = [[i for i, t in enumerate(flat) if t.dtype == dt]
                       for dt in dict.fromkeys(t.dtype for t in flat)]
        self.views = {}           # row count -> (destinations by group, rows past the input)
        self.filled = 0           # rows that may hold an earlier input's codes
        self.graph: Optional[ChunkGraph] = None

    def _views(self, m: int):
        got = self.views.get(m)
        if got is None:
            dst = [t[:m] for t in self.static.rows] + list(self.static.rest)
            got = ([[dst[i] for i in g] for g in self.groups],
                   [t[m:] for t in self.static.rows])
            self.views[m] = got
        return got

    def load(self, inp: _Inputs) -> None:
        m = inp.rows[0].shape[0]
        dst, past = self._views(m)
        if self.filled > m:
            torch._foreach_zero_(past)
        self.filled = m
        src = inp.rows + inp.rest
        for g, d in zip(self.groups, dst):
            torch._foreach_copy_(d, [src[i] for i in g])

    def run(self) -> torch.Tensor:
        return _render_inputs(self.static, self.cfg, self.qcfg)

    def capture(self) -> None:
        self.graph = ChunkGraph(lambda carry: (carry, (self.run(),)), ())

    def replay(self) -> torch.Tensor:
        """The image of the loaded input, in a fresh tensor: the graph's own
        output is rewritten by the next replay."""
        self.graph.replay()
        return self.graph.outs[0].clone()


def _graph_render(inp: _Inputs, cfg: GaussianConfig, qcfg: QuantConfig) -> torch.Tensor:
    """The binned decode as a replay of its key's graph. A key's first call
    runs eagerly on the static buffers (the kernels are built and loaded
    then), returns that image and captures the graph."""
    key = _key(inp, cfg, qcfg)
    g = _DECODE_GRAPHS.get(key)
    if g is not None:
        _DECODE_GRAPHS.move_to_end(key)
        g.load(inp)
        count("decode.graph_replays")
        return g.replay()
    g = _DecodeGraph(inp, key[1], qcfg)
    g.load(inp)
    img = g.run()
    g.capture()
    count("decode.graph_captures")
    _DECODE_GRAPHS[key] = g
    while len(_DECODE_GRAPHS) > DECODE_GRAPHS_MAX:
        _DECODE_GRAPHS.popitem(last=False)
    return img


def decompress_wo_ec(bundle: QuantizerBundle, enc: Encoding, bound: torch.Tensor,
                     cfg: GaussianConfig, qcfg: QuantConfig,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Dequantize + one render pass -> [H, W, 3] in [0, 1].

    ``backend``: ``'binned'`` (default): membership + per-tile selection +
    the capped binned render; ``'dense'``, ``'sweep'``, ``'range'``,
    ``'list'``, ``'list_t'``: the cap-free render through ``render_fast``
    (kernel B over each enumeration; the last four fastest on a
    ``morton_reorder``-ed stream). The JAX package sends ``'dense'`` to the
    binned branch off the TPU, where its dense kernel would run interpreted;
    the port renders it cap-free on every device.

    On a CUDA device the binned decode (dequantize, projection, binning by
    kernel E, kernel A, clamp) is one CUDA graph replay per key
    (``decode_graph_key``: the input's shapes, never its content), with the
    same image as the eager render; the CPU, the cap-free backends and an
    input that requires grad run eagerly (``_graphs``)."""
    backend = backend or "binned"
    if backend == "binned":
        inp = _decode_inputs(bundle, enc, bound)
        if _graphs(inp, cfg):
            with span("decode.render"):
                return _graph_render(inp, cfg, qcfg)
    state, over = _decoded_state(bundle, enc, bound, qcfg)
    with span("decode.render"):
        if backend in ("list", "list_t", "dense", "sweep", "range"):
            sweep = {"dense": False, "sweep": True}.get(backend, backend)
            return render_fast(state, cfg, sweep=sweep, **over)
        if backend != "binned":
            raise ValueError(f"unknown decode backend {backend!r}")
        return render(state, _binned_config(cfg, qcfg, enc.active.device), **over)


def prepare_decode(bundle: QuantizerBundle, enc: Encoding, bound: torch.Tensor,
                   cfg: GaussianConfig, qcfg: QuantConfig, trim: bool = True):
    """Bin-once decode: dequantize + project + bin, once per stream, into a
    ``Prepared`` attribute table and slot ids. With ``trim`` the per-tile
    capacity (the slot ids' columns) is cut to the largest occupancy,
    rounded up to 8 — exact, since slots are front-packed."""
    state, over = _decoded_state(bundle, enc, bound, qcfg)
    cap = min(qcfg.decode_cap if qcfg.decode_cap > 0 else cfg.tile_cap, cfg.tile_cap)
    prep = prepare_render(state, cfg, cap=cap, **over)
    if trim:
        maxc = int(prep.counts.max())
        cap2 = max(8, -(-maxc // 8) * 8)
        if cap2 < prep.ids.shape[1]:
            prep = prep._replace(ids=prep.ids[:, :cap2].contiguous())
    return prep


def decode_frame(prep, cfg: GaussianConfig) -> torch.Tensor:
    """Per-frame decode render from a prepared table."""
    return render_prepared(prep, cfg)


def morton_reorder(enc: Encoding, bound: torch.Tensor,
                   cfg: GaussianConfig) -> Tuple[Encoding, torch.Tensor]:
    """Reorder the stream by the Morton code of each center's tile, invalid
    rows last. The render is unchanged (blending is a sum); the chunk-list
    render visits far fewer chunks on the reordered stream."""
    perm = morton_perm(enc.means, enc.active, cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    return (enc._replace(means=enc.means[perm], quant_means=enc.quant_means[perm],
                         quant_cov=enc.quant_cov[perm],
                         color_codes=enc.color_codes[perm], active=enc.active[perm]),
            bound[perm])


def compress_wo_ec(bundle: QuantizerBundle, state: GaussianState, cfg: GaussianConfig,
                   qcfg: QuantConfig) -> Encoding:
    """Quantize to integer codes on the state's device; deactivate points
    whose quantized covariance is not PSD (gaussianimage_covariance.py
    :412-443). In fp16 mode the xy codes are the fp16 round-trip values."""
    with torch.no_grad():
        means, cov_elements, colors, codes, log_state = quantize_attributes(
            bundle, state, cfg, qcfg, update_vq=False)
        color_codes = codes["color"]
        if qcfg.color_quant == "vq":
            color_codes = color_codes.to(torch.int32)
        active = state.active & psd_valid_mask(cov_elements)
        return Encoding(means=means, quant_means=codes["xy"], quant_cov=codes["cov"],
                        color_codes=color_codes, log_state=log_state, active=active,
                        num_active=active.sum(dtype=torch.int32))


def analysis_wo_ec(enc: Encoding, cfg: GaussianConfig, qcfg: QuantConfig,
                   bundle: Optional[QuantizerBundle] = None) -> dict:
    """bpp from bit widths (gaussianimage_covariance.py:469-509), on the host:
    lsq attributes charge their codes at the bit width plus two float32 per
    channel of grid; fp16 xy 16 bits a coordinate and no grid; the VQ colour
    branch its float32 codebooks plus ``ceil(log2(max(idx_max, 1) + 1e-9))``
    bits per index (:487-493, kept as the JAX package has it)."""
    n = int(enc.num_active)
    if qcfg.xy_quant == "fp16":
        position_bits = n * 2 * 16
    else:
        position_bits = n * 2 * qcfg.xy_bit + 32 * 2 * 2
    cholesky_bits = n * 3 * hybrid_size(qcfg.cov_bit, qcfg.cov_bit) + 32 * 3 * 2
    if qcfg.color_quant == "vq" and bundle is not None:
        idx = enc.color_codes.cpu().numpy()[enc.active.cpu().numpy()]
        max_bit = (float(np.ceil(np.log2(max(int(idx.max()), 1) + 1e-9))) if idx.size else 0)
        feature_bits = idx.size * max_bit + residual_vq_bits(bundle.color_vq)
    else:
        feature_bits = n * 3 * qcfg.color_bit + 32 * 3 * 2
    hw = cfg.H * cfg.W
    return {"bpp": (position_bits + cholesky_bits + feature_bits) / hw,
            "position_bpp": position_bits / hw, "cholesky_bpp": cholesky_bits / hw,
            "feature_dc_bpp": feature_bits / hw, "num_points": n}
