"""Training losses: L2, L1, SSIM, MS-SSIM and the fusion mixes.

Port of ``gaussianimage_plus_tpu/train/losses.py`` (reference models/utils.py
:60-80 on pytorch_msssim): ``ssim``, ``ms_ssim`` and ``loss_fn`` for
``'L2'`` (the default), ``'L1'``, ``'SSIM'``, ``'Fusion1'`` to ``'Fusion4'``
and ``'Fusion_hinerv'``. SSIM as pytorch_msssim builds it: a separable
Gaussian window (11 taps, sigma 1.5), K = (0.01, 0.03), per-channel
valid-mode filtering; MS-SSIM with the five standard scale weights and 2x2
average pooling between scales (an odd side gets a leading zero row or
column), and, where the image is smaller than ``win * 2^(levels - 1)``, fewer
levels with the weights renormalised, as the JAX package does.

The filtering is two float32 band-matrix products (``A_h X A_w^T`` per
channel), as in the JAX package; TF32 stays off (``core/precision.py``).
Images are [H, W, C] or [B, H, W, C] in [0, 1].
"""

from __future__ import annotations

import torch

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(win_size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    """The normalised window, built in float64 and rounded once, so it is the
    same on every device. The variance terms ``filter(x^2) - mu^2`` cancel
    ~100-fold, so an ulp in the window moves SSIM by ~5e-6: the JAX package's
    window (XLA's float32 ``exp``) puts its SSIM that far from the float64
    value, which this one matches."""
    x = torch.arange(win_size, dtype=torch.float64, device=like.device) - (win_size - 1) / 2.0
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).to(like.dtype)


def _band_matrix(n_in: int, k: int, win: torch.Tensor) -> torch.Tensor:
    """[n_in - k + 1, n_in] valid-mode sliding window: ``A[i, i + j] = win[j]``."""
    n_out = n_in - k + 1
    off = (torch.arange(n_in, device=win.device)[None, :]
           - torch.arange(n_out, device=win.device)[:, None])
    valid = (off >= 0) & (off < k)
    return torch.where(valid, win[off.clamp(0, k - 1)], torch.zeros_like(win[0]))


def _filter2d_separable(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable valid-mode filter of [B, H, W, C]."""
    _, H, W, _ = img.shape
    k = win.shape[0]
    x = img.permute(0, 3, 1, 2)
    x = torch.einsum("oh,bchw->bcow", _band_matrix(H, k, win), x)
    x = torch.einsum("pw,bchw->bchp", _band_matrix(W, k, win), x)
    return x.permute(0, 2, 3, 1)


def _ssim_components(x, y, win_size: int, sigma: float, data_range: float = 1.0):
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    win = _gaussian_window(win_size, sigma, x)
    mu_x, mu_y = _filter2d_separable(x, win), _filter2d_separable(y, win)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _filter2d_separable(x * x, win) - mu_xx
    sigma_yy = _filter2d_separable(y * y, win) - mu_yy
    sigma_xy = _filter2d_separable(x * y, win) - mu_xy
    cs = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    return ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs, cs


def _as_batched(img: torch.Tensor) -> torch.Tensor:
    return img[None] if img.ndim == 3 else img


def ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 11, sigma: float = 1.5,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM (``size_average=True``)."""
    ssim_map, _ = _ssim_components(_as_batched(x), _as_batched(y), win_size, sigma, data_range)
    return ssim_map.mean()


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling as ``F.avg_pool2d(kernel 2, padding=dim % 2)`` with
    the pad counted: an odd side's stride-2 windows reach only the leading
    zero."""
    B, H, W, C = img.shape
    img = torch.nn.functional.pad(img, (0, 0, W % 2, 0, H % 2, 0))
    h2, w2 = img.shape[1] // 2, img.shape[2] // 2
    return img.reshape(B, h2, 2, w2, 2, C).mean(dim=(2, 4))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 11, sigma: float = 1.5,
            data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM with the standard 5-scale weights; images smaller
    than ``win_size * 2^(levels - 1)`` on their shorter side use fewer
    levels, the weights renormalised to the same sum."""
    x, y = _as_batched(x), _as_batched(y)
    smaller = min(x.shape[1], x.shape[2])
    levels = len(MS_SSIM_WEIGHTS)
    while levels > 1 and (smaller // 2 ** (levels - 1)) < win_size:
        levels -= 1
    weights = torch.tensor(MS_SSIM_WEIGHTS[:levels], dtype=x.dtype, device=x.device)
    weights = weights / weights.sum() * sum(MS_SSIM_WEIGHTS)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mcs = []
    for i in range(levels):
        ssim_map, cs = _ssim_components(x, y, win_size, sigma, data_range)
        if i < levels - 1:
            mcs.append(torch.maximum(cs.mean(), zero))
            x, y = _avg_pool2(x), _avg_pool2(y)
    mcs.append(torch.maximum(ssim_map.mean(), zero))
    return torch.prod(torch.stack(mcs) ** weights)


def loss_fn(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "L2",
            lambda_value: float = 0.7) -> torch.Tensor:
    """Reference loss dispatch (models/utils.py:60-80); the target carries no
    gradient."""
    target = target.detach()
    lam = lambda_value
    l2 = lambda: torch.mean((pred - target) ** 2)
    l1 = lambda: torch.mean(torch.abs(pred - target))
    if loss_type == "L2":
        return l2()
    if loss_type == "L1":
        return l1()
    if loss_type == "SSIM":
        return 1.0 - ssim(pred, target)
    if loss_type == "Fusion1":
        return lam * l2() + (1 - lam) * (1.0 - ssim(pred, target))
    if loss_type == "Fusion2":
        return lam * l1() + (1 - lam) * (1.0 - ssim(pred, target))
    if loss_type == "Fusion3":
        return lam * l2() + (1 - lam) * l1()
    if loss_type == "Fusion4":
        return lam * l1() + (1 - lam) * (1.0 - ms_ssim(pred, target))
    if loss_type == "Fusion_hinerv":
        return lam * l1() + (1 - lam) * (1.0 - ms_ssim(pred, target, win_size=5))
    raise ValueError(f"unknown loss_type {loss_type!r}")
