"""Plain reference of a fit's first steps: L2 loss, autograd, Adam.

A step renders the current rows (``render.py``), takes the mean squared
error against the target, its gradient by autograd, and applies Adam as the
reference trains (torch ``Adam(lr, eps=1e-15)`` under ``StepLR``: ``mu =
(1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, the update ``-lr mu_hat
/ (sqrt(nu_hat) + eps)``), to active rows only. The covariance rendered is
the raw one plus the row's floor (``bound``). The blocks tile the image, so
the loss is summed block by block and each block's gradient taken at once:
memory holds one block.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import render as R


class Rows(NamedTuple):
    xyz: torch.Tensor       # [M, 2]
    cov2d: torch.Tensor     # [M, 3] raw
    features: torch.Tensor  # [M, 3]
    active: torch.Tensor    # [M] bool
    bound: torch.Tensor     # [M, 3]


def loss_and_grads(rows: Rows, gt: torch.Tensor, dtype=torch.float32, tf32: bool = False,
                   grad: bool = True):
    """(L2 loss, gradients of xyz, cov2d, features) at ``rows``: each block's
    loss is differentiated into the projected means, conics and colours, and
    their summed gradients go back through the projection once. Without
    ``grad`` only the loss is taken, and the gradients are None."""
    H, W, _ = gt.shape
    leaves = [t.detach().to(dtype).requires_grad_(grad)
              for t in (rows.xyz, rows.cov2d, rows.features)]
    xyz, cov2d, feat = leaves
    with torch.set_grad_enabled(grad):
        p = R.project(xyz, cov2d + rows.bound.to(dtype), rows.active, H, W)
        mid = [t.detach().requires_grad_(grad) for t in (p.xy, p.conic, feat)]
        pb = p._replace(xy=mid[0], conic=mid[1])
        n = float(H * W * 3)
        total = torch.zeros((), dtype=torch.float64, device=gt.device)
        with R.matmul_precision(tf32):
            for blk in R.blocks(p, H, W):
                w, _, _, _, _ = R.block_weights(pb, blk, None, dtype)
                img = R.clip01(w @ mid[2][blk.rows]).reshape(blk.y1 - blk.y0, blk.x1 - blk.x0, 3)
                g = gt[blk.y0:blk.y1, blk.x0:blk.x1].to(dtype)
                part = torch.sum((img - g) ** 2) / n
                if grad:
                    part.backward()
                total += part.detach().double()
            if not grad:
                return total, None
            grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in mid]
            torch.autograd.backward([p.xy, p.conic, feat], grads)
    return total, [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]


class Adam:
    """Adam on the StepLR schedule, from zero moments at count 0 or from a
    given ``state`` (count, mu, nu), as a fit holds it between steps: the
    learning rate is read at the count before the step, the bias
    corrections at the count after it."""

    def __init__(self, like: List[torch.Tensor], lr: float, step_size: int = 20000,
                 gamma: float = 0.5, state=None, b1=0.9, b2=0.999, eps=1e-15):
        self.lr, self.step_size, self.gamma = lr, step_size, gamma
        self.b1, self.b2, self.eps = b1, b2, eps
        if state is None:
            self.count = 0
            self.mu = [torch.zeros_like(t) for t in like]
            self.nu = [torch.zeros_like(t) for t in like]
        else:
            count, mu, nu = state
            self.count = int(count)
            self.mu = [m.to(t.dtype) for m, t in zip(mu, like)]
            self.nu = [v.to(t.dtype) for v, t in zip(nu, like)]

    def step(self, params, grads, active):
        lr = self.lr * self.gamma ** (self.count // self.step_size)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        out = []
        for i, (p, g) in enumerate(zip(params, grads)):
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * (g * g) + b2 * self.nu[i]
            u = -lr * ((self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.eps))
            out.append(p + torch.where(active[:, None], u, torch.zeros_like(u)))
        return out


def follow(rows: Rows, gt: torch.Tensor, lr: float, updates: int, state=None,
           step_size: int = 20000, gamma: float = 0.5, dtype=torch.float32,
           tf32: bool = False) -> List[float]:
    """The losses a fit reports at ``updates + 1`` successive steps from
    ``rows`` (each at the step's pre-update rows): the first at ``rows``, each
    later one after one more Adam update, from zero moments or from the
    optimizer ``state`` (count, mu, nu). The last loss is where the
    updates' change of the rows shows."""
    params = [t.to(dtype) for t in (rows.xyz, rows.cov2d, rows.features)]
    opt = Adam(params, lr, step_size, gamma, state)
    losses = []
    for k in range(updates + 1):
        cur = rows._replace(xyz=params[0], cov2d=params[1], features=params[2])
        loss, grads = loss_and_grads(cur, gt, dtype, tf32, grad=k < updates)
        losses.append(float(loss))
        if k < updates:
            with torch.no_grad():
                params = opt.step(params, grads, rows.active)
    return losses


def psnr(img: torch.Tensor, gt: torch.Tensor) -> float:
    mse = torch.mean((img.double() - gt.double()) ** 2)
    return float(10.0 * torch.log10(1.0 / torch.clamp(mse, min=1e-12)))
