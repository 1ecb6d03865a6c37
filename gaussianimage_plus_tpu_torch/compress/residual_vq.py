"""Residual vector quantization: k-means init, EMA codebooks, the decoder.

Port of ``gaussianimage_plus_tpu/compress/residual_vq.py``: ``kmeans``,
``init_residual_vq``, ``_vq_layer``, ``residual_vq_forward``,
``residual_vq_decode`` and ``residual_vq_bits``, the ``vector-quantize-pytorch``
machinery the reference wraps for colours (quantize.py:261-333: dim 3,
codebook size 8, 2 quantizers, decay 0.8, commitment weight 1, k-means init
with 5 iterations). Nearest codeword by L2 (``argmin`` ties go to the first
index, as in JAX); EMA update ``N <- d N + (1 - d) count``, ``m <- d m + (1 -
d) sum``, ``embed = m / N`` Laplace-smoothed; straight-through output; each
layer quantizes the residual the layers before it left.

Deviation: the JAX k-means draws its first centres with
``jax.random.choice(fold_in(PRNGKey(0), i), n, (k,), replace=n < k)`` for
layer ``i``. The port cannot reproduce that generator, so ``kmeans`` and
``init_residual_vq`` take the first-centre indices as an argument
(``init_indices``, one [k] tensor per layer), as ``models.grow`` takes its
draws; without it they draw from a ``torch.Generator`` (a permutation's first
``k``, or ``k`` draws with replacement when ``n < k``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class VQCodebook(NamedTuple):
    embed: torch.Tensor         # [K, D]
    cluster_size: torch.Tensor  # [K] EMA counts
    embed_avg: torch.Tensor     # [K, D] EMA sums


class ResidualVQState(NamedTuple):
    layers: Tuple[VQCodebook, ...]


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Index of each row's nearest centre (squared L2; ties to the first)."""
    d = torch.sum((x[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    return torch.argmin(d, dim=1)


def _counts_sums(assign: torch.Tensor, x: torch.Tensor, k: int):
    onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
    return onehot.sum(0), onehot.T @ x


def draw_init_indices(n: int, k: int, generator: Optional[torch.Generator] = None,
                      device=None) -> torch.Tensor:
    """First-centre row indices of a k-means over ``n`` rows: ``k`` distinct
    rows, or ``k`` draws with replacement when ``n < k``."""
    if n < k:
        return torch.randint(n, (k,), generator=generator, device=device)
    return torch.randperm(n, generator=generator, device=device)[:k]


def kmeans(x: torch.Tensor, k: int, iters: int, generator: Optional[torch.Generator] = None,
           init_indices: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain Lloyd k-means -> [k, D] centres. An empty cluster keeps its centre."""
    if init_indices is None:
        init_indices = draw_init_indices(x.shape[0], k, generator, x.device)
    centers = x[init_indices.to(device=x.device, dtype=torch.int64)]
    for _ in range(iters):
        counts, sums = _counts_sums(_assign(x, centers), x, k)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1), centers)
    return centers


def init_residual_vq(x: torch.Tensor, num_quantizers: int, codebook_size: int,
                     kmeans_iters: int = 5, generator: Optional[torch.Generator] = None,
                     init_indices: Optional[Sequence[torch.Tensor]] = None) -> ResidualVQState:
    """k-means init per layer on the successive residuals of the init batch;
    ``init_indices[i]`` replaces layer ``i``'s first-centre draw."""
    layers = []
    resid = x
    for i in range(num_quantizers):
        centers = kmeans(resid, codebook_size, kmeans_iters, generator,
                         None if init_indices is None else init_indices[i])
        layers.append(VQCodebook(embed=centers,
                                 cluster_size=torch.ones((codebook_size,), dtype=x.dtype,
                                                         device=x.device),
                                 embed_avg=centers))
        resid = resid - centers[_assign(resid, centers)]
    return ResidualVQState(layers=tuple(layers))


def _vq_layer(cb: VQCodebook, x: torch.Tensor, decay: float, update: bool):
    """One layer: nearest codeword, and with ``update`` the EMA step of the
    codebook on this batch. Returns (codebook, quantized rows, indices)."""
    xd = x.detach()
    assign = _assign(xd, cb.embed)
    quant = cb.embed[assign]
    if update:
        k = cb.embed.shape[0]
        counts, sums = _counts_sums(assign, xd, k)
        cluster_size = decay * cb.cluster_size + (1 - decay) * counts
        embed_avg = decay * cb.embed_avg + (1 - decay) * sums
        n = cluster_size.sum()
        smoothed = (cluster_size + 1e-5) / (n + k * 1e-5) * n
        cb = VQCodebook(embed=embed_avg / smoothed[:, None], cluster_size=cluster_size,
                        embed_avg=embed_avg)
    return cb, quant, assign


def residual_vq_forward(state: ResidualVQState, x: torch.Tensor, decay: float = 0.8,
                        commitment_weight: float = 1.0, update: bool = True):
    """Returns (output with straight-through gradient, commitment loss,
    indices [N, L], new state)."""
    resid = x
    out = torch.zeros_like(x)
    indices, new_layers = [], []
    commit = 0.0
    for cb in state.layers:
        cb, quant, assign = _vq_layer(cb, resid, decay, update)
        quant = quant.detach()
        commit = commit + torch.mean((quant - resid) ** 2)
        out = out + quant
        resid = resid - quant
        indices.append(assign)
        new_layers.append(cb)
    out_ste = x + (out - x).detach()
    return (out_ste, commitment_weight * commit, torch.stack(indices, dim=1),
            ResidualVQState(layers=tuple(new_layers)))


def residual_vq_decode(state: ResidualVQState, indices: torch.Tensor) -> torch.Tensor:
    """Sum of per-layer codebook rows; ``indices`` [N, L] integer."""
    idx = indices.to(torch.int64)
    out = None
    for i, cb in enumerate(state.layers):
        rows = cb.embed[idx[:, i]]
        out = rows if out is None else out + rows
    return out


def residual_vq_bits(state: ResidualVQState) -> int:
    """The codebooks' size in bits at float32 (analysis_wo_ec's VQ branch,
    gaussianimage_covariance.py:477-493; the indices are charged there)."""
    return sum(cb.embed.numel() * 32 for cb in state.layers)
