"""The reference's optimizer recipes: Adam (eps 1e-15) with a StepLR schedule,
and Adan for the legacy parameterizations.

Port of ``gaussianimage_plus_tpu/train/optim.py``: ``step_lr`` and
``make_adam`` (``:22-35``), ``AdanState`` and ``adan`` (``:38-105``). Adam
is torch ``Adam(lr, eps=1e-15)`` + ``StepLR(step_size=20000, gamma=0.5)``
stepped every iteration (models/gaussianimage_covariance.py:98-101), which
the JAX package runs as ``optax.adam(b1=0.9, b2=0.999, eps=1e-15,
eps_root=0)``.

Both are written out on tensors instead of ``torch.optim``: the trainer masks the
updates of inactive rows after the moment update, zeroes the moment rows of
grown slots and permutes them with the Morton re-sort (``zero_rows``,
``take_rows``), none of which fits ``torch.optim.Adam``'s in-place step. As
in optax, one step count serves the bias correction and the schedule, and
the expressions follow optax's order: ``mu = (1 - b1) g + b1 mu``, ``nu =
(1 - b2) g^2 + b2 nu``, ``u = -lr(count) * mu_hat / (sqrt(nu_hat) + eps)``
with ``lr`` read at the count before the step. Nothing synchronises with the
host.

``adan`` is the reference's Adan (optimizer.py:237-294, betas (0.98, 0.92,
0.99), no gradient clipping) as the JAX package writes it: the first step
takes ``diff_1 = 0``, the bias corrections read the new count, the learning
rate the count before the step, and with ``no_prox=False`` the update is
``(p - step / denom) / (1 + lr * wd) - p`` in that order. ``zero_rows`` and
``take_rows`` act on every per-row field of either state (for Adan,
``prev_grad`` too), as the JAX ``_zero_state_rows`` and ``_morton_resort``
map over every row-shaped leaf.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class AdamState(NamedTuple):
    count: torch.Tensor        # [] int32, completed steps
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


def step_lr(base_lr: float, step_size: int = 20000, gamma: float = 0.5):
    """``StepLR`` stepped once per iteration: count -> learning rate."""

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return base_lr * gamma ** torch.div(count, step_size, rounding_mode="floor").to(torch.float32)

    return schedule


class Adam:
    """``init(params) -> AdamState``; ``update(grads, state) -> (updates,
    state)``, where ``params + updates`` is the step (optax's convention)."""

    def __init__(self, schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps

    def init(self, params) -> AdamState:
        dev = params[0].device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=tuple(torch.zeros_like(p) for p in params),
                         nu=tuple(torch.zeros_like(p) for p in params))

    def update(self, grads, state: AdamState, params=None):
        """``params`` is unused (Adan's signature)."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
        nu = tuple((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu))
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        step = -self.schedule(state.count)
        updates = tuple(step * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
                        for m, v in zip(mu, nu))
        return updates, AdamState(count=count, mu=mu, nu=nu)


def make_adam(lr: float, step_size: int = 20000, gamma: float = 0.5, eps: float = 1e-15) -> Adam:
    """The reference training optimizer (gaussianimage_covariance.py:98-101)."""
    return Adam(step_lr(lr, step_size, gamma), eps=eps)


class AdanState(NamedTuple):
    count: torch.Tensor                  # [] int32, completed steps
    exp_avg: Tuple[torch.Tensor, ...]    # m_t
    exp_avg_sq: Tuple[torch.Tensor, ...]  # n_t
    exp_avg_diff: Tuple[torch.Tensor, ...]  # diff_t
    prev_grad: Tuple[torch.Tensor, ...]  # g_{t-1}


class Adan:
    """``init(params) -> AdanState``; ``update(grads, state, params) ->
    (updates, state)``, where ``params + updates`` is the step."""

    def __init__(self, schedule, betas=(0.98, 0.92, 0.99), eps: float = 1e-8,
                 weight_decay: float = 0.0, no_prox: bool = False):
        self.schedule, self.betas, self.eps = schedule, betas, eps
        self.weight_decay, self.no_prox = weight_decay, no_prox

    def init(self, params) -> AdanState:
        zeros = lambda: tuple(torch.zeros_like(p) for p in params)
        return AdanState(count=torch.zeros((), dtype=torch.int32, device=params[0].device),
                         exp_avg=zeros(), exp_avg_sq=zeros(), exp_avg_diff=zeros(),
                         prev_grad=zeros())

    def update(self, grads, state: AdanState, params):
        b1, b2, b3 = self.betas
        eps, wd = self.eps, self.weight_decay
        count = state.count + 1
        lr = self.schedule(state.count)
        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        bc3_sqrt = torch.sqrt(1.0 - torch.pow(b3, c))
        is_first = count == 1
        out = []
        for g, m, n, d, pg, p in zip(grads, state.exp_avg, state.exp_avg_sq,
                                     state.exp_avg_diff, state.prev_grad, params):
            diff = g - torch.where(is_first, g, pg)        # step 1: diff = 0
            m_new = b1 * m + (1 - b1) * g
            d_new = b2 * d + (1 - b2) * diff
            gd = g + b2 * diff
            n_new = b3 * n + (1 - b3) * gd * gd
            denom = torch.sqrt(n_new) / bc3_sqrt + eps
            step = lr / bc1 * m_new + (lr * b2 / bc2) * d_new
            if self.no_prox:
                upd = -lr * wd * p - step / denom
            else:
                upd = (p - step / denom) / (1.0 + lr * wd) - p
            out.append((upd, m_new, n_new, d_new, g))
        upd, m, n, d, pg = (tuple(col) for col in zip(*out))
        return upd, AdanState(count=count, exp_avg=m, exp_avg_sq=n, exp_avg_diff=d, prev_grad=pg)


def adan(learning_rate, betas=(0.98, 0.92, 0.99), eps: float = 1e-8,
         weight_decay: float = 0.0, no_prox: bool = False) -> Adan:
    """Adan (arXiv 2208.06677) with a constant ``learning_rate`` or a
    schedule (count -> learning rate)."""
    sched = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
    return Adan(sched, betas, eps, weight_decay, no_prox)


def _map_rows(state, f):
    """``f`` over every per-row tensor of an ``AdamState`` or ``AdanState``
    (the tuple fields; the count stays)."""
    return state._replace(**{k: tuple(map(f, v)) for k, v in state._asdict().items()
                             if isinstance(v, tuple)})


def zero_rows(state, mask: torch.Tensor):
    """Zero the per-row state at ``mask`` [M] (slot re-activation, the
    reference's cat_tensors_to_optimizer zero padding)."""
    m = mask[:, None]
    return _map_rows(state, lambda x: torch.where(m, torch.zeros_like(x), x))


def take_rows(state, perm: torch.Tensor):
    """Permute the per-row state with the parameters (the Morton re-sort)."""
    return _map_rows(state, lambda x: x[perm])
