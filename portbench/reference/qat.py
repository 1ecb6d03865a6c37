"""Plain reference of quantization-aware training (QAT) and of the encoder to
integer codes, at the LSQ coding point: xy, the covariance's off-diagonal and
the colours on learned affine grids, the two variances on a log grid.

Written from the codec's equations (quantize.py:39-155, LSQ with a
straight-through round; quantize.py:219-254, the log quantizer;
gaussianimage_covariance.py:148-153, the data init; :219-247, the QAT step;
:384-443, the quantized forward and the encoder), with none of the
program's code:

- grid init (``init_grids``), per channel over the active rows: ``scale =
  (max - min) / (2^b - 1)`` (1e-8 where that is 0) and ``beta = min``; xy on
  the means, the covariance grid on the off-diagonal of the effective
  covariance (raw plus the row's floor, ``bound``), the colour grid on the
  colours;
- LSQ (``lsq``): ``q = round(clip((x - beta) / scale, 0, 2^b - 1))`` with the
  round passing its gradient straight through, ``x_hat = q scale + beta``;
  LSQ's gradient scaling is not applied (the codec computes it and then
  overwrites it, quantize.py:135), so ``scale`` and ``beta`` take plain
  autograd through ``x_hat``;
- the log quantizer (``log_quant``) on the two variances: ``l = log(|v| +
  1e-6)``, one grid over both columns of the active rows, ``beta = min l``,
  ``scale = max((max l - beta) / (2^b - 1), 1e-12)``, recomputed at every
  step and differentiated through, its min and max included; ``v_hat =
  exp(q scale + beta)``;
- a step (``follow``): the render of the fake-quantized rows
  (``render.py``), the L2 loss, autograd, then the model's Adam (``train.py``:
  ``model_lr``, eps 1e-15, StepLR 20,000 / 0.5; the updates of inactive rows
  masked after the moments) and one Adam per grid on its (scale, beta), not
  masked: ``quant_lr`` on StepLR(``quant_lr_step``, ``quant_lr_gamma``), eps
  1e-8 for xy (torch's default, :122), 1e-15 for the covariance and colour
  grids (:131-132, :143-144);
- the encoder (``encode``): the same quantizers' codes, without gradients; a
  row whose dequantized covariance is not positive definite (``xx yy - xy xy
  > 0``, ``xx > 0``, ``yy > 0``) is deactivated; the kept rows in id order.

Departures, each deliberate:

- the clip passes half its gradient at a bound (``minimum(maximum(v, lo),
  hi)``, as ``jnp.clip`` does, the rule the program keeps); ``torch.clamp``
  passes all of it. At init the smallest row's code lies on the bound;
- ``log`` and ``exp`` are taken in float64 and rounded once to float32, the
  correctly rounded values, so that no code hangs on a float32 library's
  last bit (the codec takes them in float32);
- the log grid's scale is floored at 1e-12, the coding path's floor; only
  variances that are all equal reach it;
- no VQ colour and no fp16 xy: the benchmark's configuration is LSQ.

``stream_codes`` reads a ``.gipb``'s header, grids and integer codes through
the frozen parser's own pieces (``gipb.py``). TF32 is off unless a caller
turns it on (the control, ``portbench/control_qat.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import gipb
from . import render as R
from . import train as RT

LOG_EPS = 1e-6
LOG_SCALE_FLOOR = 1e-12


class Bits(NamedTuple):
    xy: int
    cov: int
    color: int


class QuantLR(NamedTuple):
    """The grids' learning rate and its StepLR schedule."""
    lr: float = 1e-3
    step_size: int = 10000
    gamma: float = 0.5


class Grid(NamedTuple):
    scale: torch.Tensor   # [C]
    beta: torch.Tensor    # [C]


class Grids(NamedTuple):
    xy: Grid      # [2]
    cov: Grid     # [1], the off-diagonal
    color: Grid   # [3]


GRID_EPS = (1e-8, 1e-15, 1e-15)   # the xy, covariance and colour grids' Adam eps


def qmax(bits: int) -> int:
    return 2 ** bits - 1


def _f64_once(fn, x: torch.Tensor) -> torch.Tensor:
    return fn(x.double()).to(x.dtype)


def clip(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    lo_t = torch.full((), lo, dtype=v.dtype, device=v.device)
    hi_t = torch.full((), hi, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lo_t), hi_t)


def ste_round(v: torch.Tensor) -> torch.Tensor:
    return v + (torch.round(v) - v).detach()


def init_grid(x: torch.Tensor, active: torch.Tensor, bits: int) -> Grid:
    xa = x[active]
    lo, hi = xa.min(dim=0).values, xa.max(dim=0).values
    scale = (hi - lo) / qmax(bits)
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    return Grid(scale, lo)


def init_grids(rows: RT.Rows, bits: Bits) -> Grids:
    """The data-driven init on the active rows."""
    with torch.no_grad():
        cov = rows.cov2d + rows.bound
        return Grids(init_grid(rows.xyz, rows.active, bits.xy),
                     init_grid(cov[:, 1:2], rows.active, bits.cov),
                     init_grid(rows.features, rows.active, bits.color))


def lsq(g: Grid, x: torch.Tensor, bits: int):
    """(dequantized, code)."""
    q = ste_round(clip((x - g.beta) / g.scale, 0, qmax(bits)))
    return q * g.scale + g.beta, q


def log_quant(var: torch.Tensor, active: torch.Tensor, bits: int):
    """(dequantized variances, codes, (beta, scale)): one grid over both
    columns of the active rows."""
    lv = _f64_once(torch.log, torch.abs(var) + LOG_EPS)
    la = lv[active]
    beta = la.min()
    scale = torch.maximum((la.max() - beta) / qmax(bits),
                          torch.full((), LOG_SCALE_FLOOR, device=var.device))
    q = ste_round(clip((lv - beta) / scale, 0, qmax(bits)))
    return _f64_once(torch.exp, q * scale + beta), q, (beta, scale)


def quantized(xyz, cov_eff, features, active, grids: Grids, bits: Bits):
    """The fake-quantized means, effective covariances and colours, and their
    codes [M, 2], [M, 3], [M, 3] and the log grid."""
    xy_hat, q_xy = lsq(grids.xy, xyz, bits.xy)
    var_hat, q_var, lg = log_quant(cov_eff[:, ::2], active, bits.cov)
    mid_hat, q_mid = lsq(grids.cov, cov_eff[:, 1:2], bits.cov)
    col_hat, q_col = lsq(grids.color, features, bits.color)
    cov_hat = torch.cat([var_hat[:, :1], mid_hat, var_hat[:, 1:]], dim=1)
    codes = (q_xy, torch.cat([q_var[:, :1], q_mid, q_var[:, 1:]], dim=1), q_col)
    return xy_hat, cov_hat, col_hat, codes, lg


def loss_and_grads(rows: RT.Rows, grids: Grids, gt: torch.Tensor, bits: Bits,
                   tf32: bool = False, grad: bool = True):
    """(L2 loss of the fake-quantized render, gradients of xyz, cov2d,
    features, then each grid's scale and beta). Each block's loss is
    differentiated into the projected means, conics and colours, and their
    summed gradients go back through the projection and the quantizers once
    (``train.loss_and_grads``'s scheme)."""
    H, W, _ = gt.shape
    leaves = [t.detach().float().requires_grad_(grad)
              for t in (rows.xyz, rows.cov2d, rows.features,
                        *(t for g in grids for t in g))]
    xyz, cov2d, feat, *grid_leaves = leaves
    g = Grids(*(Grid(*grid_leaves[2 * i:2 * i + 2]) for i in range(3)))
    with torch.set_grad_enabled(grad):
        xy_hat, cov_hat, col_hat, _, _ = quantized(xyz, cov2d + rows.bound.float(), feat,
                                                   rows.active, g, bits)
        p = R.project(xy_hat, cov_hat, rows.active, H, W)
        mid = [t.detach().requires_grad_(grad) for t in (p.xy, p.conic, col_hat)]
        pb = p._replace(xy=mid[0], conic=mid[1])
        n = float(H * W * 3)
        total = torch.zeros((), dtype=torch.float64, device=gt.device)
        with R.matmul_precision(tf32):
            for blk in R.blocks(p, H, W):
                w, _, _, _, _ = R.block_weights(pb, blk, None)
                img = R.clip01(w @ mid[2][blk.rows]).reshape(blk.y1 - blk.y0, blk.x1 - blk.x0, 3)
                part = torch.sum((img - gt[blk.y0:blk.y1, blk.x0:blk.x1].float()) ** 2) / n
                if grad:
                    part.backward()
                total += part.detach().double()
        if not grad:
            return total, None
        back = [t.grad if t.grad is not None else torch.zeros_like(t) for t in mid]
        torch.autograd.backward([p.xy, p.conic, col_hat], back)
    return total, [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]


class GridAdam:
    """Adam on one grid's (scale, beta), unmasked, from zero moments or a
    given ``state`` (count, (mu_scale, mu_beta), (nu_scale, nu_beta)): the
    learning rate read at the count before the step, the bias corrections at
    the count after it (as ``train.Adam``)."""

    def __init__(self, quant: QuantLR, eps: float, state=None, b1=0.9, b2=0.999):
        self.quant, self.eps, self.b1, self.b2 = quant, eps, b1, b2
        self.count, self.mu, self.nu = (0, None, None) if state is None else \
            (int(state[0]), [m.float() for m in state[1]], [v.float() for v in state[2]])

    def step(self, params: Grid, grads) -> Grid:
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        q = self.quant
        lr = q.lr * q.gamma ** (self.count // q.step_size)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * (g * g) + b2 * self.nu[i]
            out.append(p - lr * ((self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.eps)))
        return Grid(*out)


class Followed(NamedTuple):
    losses: List[float]   # at each step's pre-update rows
    rows: RT.Rows         # after the last update
    grids: Grids


def follow(rows: RT.Rows, grids: Grids, gt: torch.Tensor, bits: Bits, model_lr: float,
           updates: int, model_state=None, grid_states: Optional[tuple] = None,
           quant: QuantLR = QuantLR(), tf32: bool = False) -> Followed:
    """``updates + 1`` QAT steps' losses from ``rows`` and ``grids``: the
    first at them, each later one after one more update of the rows and the
    grids; the model's Adam from zero moments or ``model_state`` (count, mu,
    nu), the grids' from zero or ``grid_states`` (one (count, mu, nu) per
    grid)."""
    params = [rows.xyz.float(), rows.cov2d.float(), rows.features.float()]
    model = RT.Adam(params, model_lr, 20000, 0.5, model_state)
    opts = [GridAdam(quant, eps, None if grid_states is None else s)
            for eps, s in zip(GRID_EPS, grid_states or (None,) * 3)]
    losses = []
    for k in range(updates + 1):
        cur = rows._replace(xyz=params[0], cov2d=params[1], features=params[2])
        loss, grads = loss_and_grads(cur, grids, gt, bits, tf32, grad=k < updates)
        losses.append(float(loss))
        if k < updates:
            with torch.no_grad():
                params = model.step(params, grads[:3], rows.active)
                grids = Grids(*(o.step(g, grads[3 + 2 * i:5 + 2 * i])
                                for i, (o, g) in enumerate(zip(opts, grids))))
    return Followed(losses, rows._replace(xyz=params[0], cov2d=params[1], features=params[2]),
                    grids)


class Codes(NamedTuple):
    """The encoder's output: the kept rows' integer codes in id order, the
    log grid, and which rows were kept."""
    xy: np.ndarray       # [n, 2] int64
    cov: np.ndarray      # [n, 3]
    color: np.ndarray    # [n, 3]
    log_beta: np.float32
    log_scale: np.float32
    keep: np.ndarray     # [M] bool


def encode(rows: RT.Rows, grids: Grids, bits: Bits) -> Codes:
    with torch.no_grad():
        cov_eff = rows.cov2d.float() + rows.bound.float()
        _, _, _, (q_xy, q_cov, q_col), (beta, scale) = quantized(
            rows.xyz.float(), cov_eff, rows.features.float(), rows.active, grids, bits)
        var = _f64_once(torch.exp, q_cov[:, ::2] * scale + beta)
        mid = q_cov[:, 1:2] * grids.cov.scale + grids.cov.beta
        xx, xy, yy = var[:, 0], mid[:, 0], var[:, 1]
        keep = rows.active & (xx * yy - xy * xy > 0) & (xx > 0) & (yy > 0)
        host = lambda q: q[keep].long().cpu().numpy()
        return Codes(host(q_xy), host(q_cov), host(q_col), np.float32(beta.item()),
                     np.float32(scale.item()), keep.cpu().numpy())


class Stream(NamedTuple):
    """A ``.gipb``'s header, grids and integer codes (LSQ xy and colours)."""
    H: int
    W: int
    bits: Bits
    grids: np.ndarray    # float32 [14]: xy scale 2, beta 2 | log beta, scale | mid scale, beta |
    #                      colour scale 3, beta 3
    xy: np.ndarray       # [n, 2] int64
    cov: np.ndarray      # [n, 3]
    color: np.ndarray    # [n, 3]


def stream_codes(buf: bytes) -> Stream:
    gipb._need(buf[:4] == gipb.MAGIC, "magic")
    r = gipb._Reader(buf, 4)
    (version, _param, xy_mode, color_mode, xy_bit, cov_bit, color_bit,
     H, W, n, _cap) = r.take(gipb._HEADER)
    gipb._need(version in (1, 2) and (xy_mode, color_mode) == (0, 0), "not an LSQ stream")
    grids = r.array(np.float32, 14)
    xy = gipb._bits(r, n * 2, xy_bit).reshape(n, 2)
    cov = gipb._stream(r, version).reshape(n, 3)
    color = gipb._stream(r, version).reshape(n, 3)
    return Stream(H, W, Bits(xy_bit, cov_bit, color_bit), grids, xy, cov, color)


def _grid_values(g: Grids, codes: Codes) -> np.ndarray:
    f = lambda t: t.detach().float().cpu().numpy().reshape(-1)
    return np.concatenate([f(g.xy.scale), f(g.xy.beta), [codes.log_beta, codes.log_scale],
                           f(g.cov.scale), f(g.cov.beta), f(g.color.scale),
                           f(g.color.beta)]).astype(np.float32)


def code_misses(buf: bytes, rows: RT.Rows, grids: Grids, bits: Bits, H: int, W: int) -> int:
    """What of the stream differs from the reference's encoding of ``rows``
    under ``grids``: each header field (size, bit widths) and grid value
    that differs counts 1, each xy, covariance and colour code 1, and each
    row the stream has too many or too few counts 7 (its codes)."""
    s = stream_codes(buf)
    ref = encode(rows, grids, bits)
    miss = int(s.H != H) + int(s.W != W) + sum(int(a != b) for a, b in zip(s.bits, bits))
    want = _grid_values(grids, ref)
    miss += int((s.grids.view(np.uint32) != want.view(np.uint32)).sum())
    n = min(len(s.xy), len(ref.xy))
    miss += 7 * abs(len(s.xy) - len(ref.xy))
    for a, b in ((s.xy, ref.xy), (s.cov, ref.cov), (s.color, ref.color)):
        miss += int((a[:n] != b[:n]).sum())
    return miss


def stream_psnr(buf: bytes, gt: torch.Tensor, tf32: bool = False) -> float:
    """The PSNR of the frozen decoder's decode of ``buf``, rendered at the
    stream's cap, against ``gt``."""
    g = gipb.decode(buf)
    t = lambda a: torch.as_tensor(a).to(gt.device)
    img = R.render_state(t(g.xy), t(g.cov), t(g.colors),
                         torch.ones(len(g.xy), dtype=torch.bool, device=gt.device),
                         g.H, g.W, g.cap, tf32=tf32)
    return RT.psnr(img, gt)


def grid_gap(got: Grids, ref: Grids) -> float:
    """The largest difference of a scale or beta of ``got`` from ``ref``'s,
    in steps of ``ref``'s grid (its scale): 0 where they agree."""
    worst = 0.0
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            d = (x.float() - y.float()).abs() / b.scale.float().abs()
            worst = max(worst, float(d.max()))
    return worst


def rows_of(xyz, cov2d, features, active, bound) -> RT.Rows:
    """Detached float32 copies, as a ``train.Rows``."""
    c = lambda t: t.detach().clone()
    return RT.Rows(c(xyz).float(), c(cov2d).float(), c(features).float(), c(active),
                   c(bound).float())
