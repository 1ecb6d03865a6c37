"""Port SSIM, MS-SSIM, the SSIM losses and ``evaluate`` against the JAX package.

Same numpy images through ``train/losses.py`` of both packages: at 768x512,
at odd sizes (the leading-zero pooling pad) and at sizes that cut MS-SSIM's
levels (weights renormalised), batched and unbatched. Tolerance 1e-5
absolute on SSIM and MS-SSIM, which lie in [0, 1]: the JAX package builds its
Gaussian window with XLA's float32 ``exp``, a few ulps from the port's
(float64, rounded once), and the variance terms cancel ~100-fold, so the two
differ by ~5e-6; the port is held to its own float64 evaluation within 2e-6
(the band-matrix products sum in another order). Each SSIM-based loss and its
gradient at 180x200 (five levels): loss to 1e-5, gradient to 1e-3 of its
largest entry. ``evaluate`` on a small state renders through the plain path
in both: PSNR to 1e-4 dB, MS-SSIM to 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import losses as jlosses
from gaussianimage_plus_tpu.train import trainer as jtr

from gaussianimage_plus_tpu_torch.interop import state_from_numpy
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import losses as tlosses
from gaussianimage_plus_tpu_torch.train import trainer as ttr

ATOL, ATOL_F64 = 1e-5, 2e-6
# jitted: the JAX package's eager SSIM dispatches (and compiles) op by op
J_SSIM = {"ssim": jax.jit(jlosses.ssim, static_argnames=("win_size",)),
          "ms_ssim": jax.jit(jlosses.ms_ssim, static_argnames=("win_size",))}


def _pair(shape, seed):
    """A smooth target and a noisy, biased prediction of it, in [0, 1]."""
    rng = np.random.default_rng(seed)
    *b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    gt = 0.5 + 0.4 * np.sin(xx[..., None] / (7 + np.arange(c)) + yy[..., None] / 11)
    gt = np.broadcast_to(gt, shape).copy()
    pred = np.clip(gt + rng.normal(0, 0.08, shape) + 0.03, 0, 1)
    return pred.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("shape", [(512, 768, 3), (181, 243, 3), (100, 150, 3), (37, 40, 3),
                                   (2, 64, 96, 3)],
                         ids=["768x512", "odd-5-levels", "4-levels", "2-levels", "batched"])
def test_ssim_and_ms_ssim_match_jax(shape):
    x, y = _pair(shape, 0)
    for name in ("ssim", "ms_ssim"):
        ref = float(J_SSIM[name](jnp.asarray(x), jnp.asarray(y)))
        out = float(getattr(tlosses, name)(torch.as_tensor(x), torch.as_tensor(y)))
        assert 0.0 < ref < 1.0
        assert abs(out - ref) <= ATOL, (name, out, ref)
        f64 = float(getattr(tlosses, name)(torch.as_tensor(x).double(), torch.as_tensor(y).double()))
        assert abs(out - f64) <= ATOL_F64, (name, out, f64)
    # the Hi-NeRV window (5 taps) keeps more levels on a small image
    ref = float(J_SSIM["ms_ssim"](jnp.asarray(x), jnp.asarray(y), win_size=5))
    assert abs(float(tlosses.ms_ssim(torch.as_tensor(x), torch.as_tensor(y), win_size=5)) - ref) <= ATOL


def test_avg_pool_pads_odd_sides_with_a_leading_zero():
    x = np.arange(2 * 5 * 7 * 3, dtype=np.float32).reshape(2, 5, 7, 3)
    np.testing.assert_allclose(tlosses._avg_pool2(torch.as_tensor(x)).numpy(),
                               np.asarray(jlosses._avg_pool2(jnp.asarray(x))), rtol=1e-6)
    assert tlosses._avg_pool2(torch.as_tensor(x)).shape == (2, 3, 4, 3)


@pytest.mark.parametrize("loss_type", ["SSIM", "Fusion1", "Fusion2", "Fusion4", "Fusion_hinerv"])
def test_ssim_losses_and_gradients_match_jax(loss_type):
    x, y = _pair((180, 200, 3), 1)
    lj, gj = jax.jit(jax.value_and_grad(lambda p: jlosses.loss_fn(p, jnp.asarray(y), loss_type,
                                                                  0.7)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    lt = tlosses.loss_fn(xt, torch.as_tensor(y), loss_type, 0.7)
    (gt,) = torch.autograd.grad(lt, xt)
    assert abs(float(lt.detach()) - float(lj)) <= ATOL
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-3 * np.abs(gj).max())


def test_evaluate_matches_jax():
    H, W, M = 64, 96, 64
    rng = np.random.default_rng(2)
    raw = dict(xyz=(rng.uniform(0, 1, (M, 2)) * [W, H]).astype(np.float32),
               cov2d=(rng.uniform(0, 1, (M, 3)) * [30, 3, 30]).astype(np.float32),
               features=rng.uniform(0, 1, (M, 3)).astype(np.float32),
               bound=np.tile(np.float32([[0.5, 0.0, 0.5]]), (M, 1)),
               active=np.arange(M) < 60, num_active=np.int32(60))
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    sj = jgi.GaussianState(
        params=jgi.GaussianParams(**{k: jnp.asarray(raw[k]) for k in ("xyz", "cov2d", "features")}),
        active=jnp.asarray(raw["active"]), bound=jnp.asarray(raw["bound"]),
        num_active=jnp.asarray(60, jnp.int32))
    cfg = dict(H=H, W=W, max_num_points=M)
    rj = jtr.evaluate(sj, jnp.asarray(gt), jgi.GaussianConfig(**cfg), n_renders=1)
    rt = ttr.evaluate(state_from_numpy(raw, device="cpu"), gt, tgi.GaussianConfig(**cfg), n_renders=3)
    assert abs(rt["psnr"] - rj["psnr"]) <= 1e-4
    assert abs(rt["ms_ssim"] - rj["ms_ssim"]) <= ATOL
    assert rt["num_points"] == rj["num_points"] == 60
    assert rt["eval_time"] > 0 and rt["fps"] == 1.0 / rt["eval_time"]
