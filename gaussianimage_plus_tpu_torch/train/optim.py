"""The reference's optimizer recipe: Adam (eps 1e-15) with a StepLR schedule.

Port of ``step_lr`` and ``make_adam`` (``gaussianimage_plus_tpu/train/optim.py:22-35``):
torch ``Adam(lr, eps=1e-15)`` + ``StepLR(step_size=20000, gamma=0.5)`` stepped
every iteration (models/gaussianimage_covariance.py:98-101), which the JAX
package runs as ``optax.adam(b1=0.9, b2=0.999, eps=1e-15, eps_root=0)``.

Written out on tensors instead of ``torch.optim.Adam``: the trainer masks the
updates of inactive rows after the moment update, zeroes the moment rows of
grown slots and permutes them with the Morton re-sort (``zero_rows``,
``take_rows``), none of which fits ``torch.optim.Adam``'s in-place step. As
in optax, one step count serves the bias correction and the schedule, and
the expressions follow optax's order: ``mu = (1 - b1) g + b1 mu``, ``nu =
(1 - b2) g^2 + b2 nu``, ``u = -lr(count) * mu_hat / (sqrt(nu_hat) + eps)``
with ``lr`` read at the count before the step. Nothing synchronises with the
host. Adan (``opt_type='adan'``) is not ported yet.
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

    def update(self, grads, state: AdamState):
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


def zero_rows(state: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero the moment rows at ``mask`` [M] (slot re-activation, the
    reference's cat_tensors_to_optimizer zero padding)."""
    m = mask[:, None]
    zero = lambda x: torch.where(m, torch.zeros_like(x), x)
    return state._replace(mu=tuple(map(zero, state.mu)), nu=tuple(map(zero, state.nu)))


def take_rows(state: AdamState, perm: torch.Tensor) -> AdamState:
    """Permute the moment rows with the parameters (the Morton re-sort)."""
    take = lambda x: x[perm]
    return state._replace(mu=tuple(map(take, state.mu)), nu=tuple(map(take, state.nu)))
