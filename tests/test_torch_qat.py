"""Port QAT and the codec trainer against the JAX package, at 64x96 with 60
Gaussians (64 slots), on the CPU (``'auto'`` is the plain path in both).

- ``quant_train_chunk``: 20 steps in lsq, fp16-xy and vq colour modes, each
  from JAX's state, grids, Adam states and VQ codebooks (why not a free run:
  the test's docstring): per-step PSNR within 1e-4 dB of JAX's, the same best
  step and snapshot, each step's updates to a hundredth of an Adam step;
  and 20 steps the port carries alone.
- ``fit_image_quantized`` + ``encode_decode_eval``: a 100-step warmup (one
  prune, no growth) warm-started from one state, then 100 QAT steps, free in
  both packages: best PSNR within 0.05 dB; ``encode_decode_eval`` of JAX's
  fitted state and bundle in both: ``psnr``, ``stream_psnr`` (1e-4 dB),
  ``ms_ssim`` (1e-5), the bpp accounting, ``bpp_wc`` and ``bpp_stream``
  equal, and the ``.gipb`` written in id and in Morton order byte for byte.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.compress import pipeline as jp
from gaussianimage_plus_tpu.compress import trainer as jct
from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import trainer as jtr
from gaussianimage_plus_tpu.train.optim import make_adam as jmake_adam

from gaussianimage_plus_tpu_torch.compress import pipeline as tp
from gaussianimage_plus_tpu_torch.compress import trainer as tct
from gaussianimage_plus_tpu_torch.interop import (adam_state_from_numpy, bundle_from_numpy,
                                                  state_from_numpy)
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import trainer as ttr

H, W, M, N = 64, 96, 64, 60
PARAMS = ("xyz", "cov2d", "features")


def _scene(seed=0):
    """A state of 60 active Gaussians in 64 slots and a smooth target."""
    rng = np.random.default_rng(seed)
    raw = dict(xyz=(rng.uniform(0, 1, (M, 2)) * [W, H]).astype(np.float32),
               cov2d=(rng.uniform(0, 1, (M, 3)) * [20, 2, 20]).astype(np.float32),
               features=rng.uniform(0, 1, (M, 3)).astype(np.float32),
               bound=np.tile(np.float32([[0.5, 0.0, 0.5]]), (M, 1)),
               active=np.arange(M) < N, num_active=np.int32(N))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    gt = np.stack([xx / W, yy / H, 0.5 + 0.3 * np.sin(xx / 7)], -1).astype(np.float32)
    sj = jgi.GaussianState(
        params=jgi.GaussianParams(**{k: jnp.asarray(raw[k]) for k in PARAMS}),
        active=jnp.asarray(raw["active"]), bound=jnp.asarray(raw["bound"]),
        num_active=jnp.asarray(N, jnp.int32))
    return raw, sj, gt


def _cfgs():
    return jgi.GaussianConfig(H=H, W=W, max_num_points=M), tgi.GaussianConfig(H=H, W=W, max_num_points=M)


def _port_state(sj):
    return state_from_numpy({**{k: getattr(sj.params, k) for k in PARAMS}, "active": sj.active,
                             "bound": sj.bound, "num_active": sj.num_active}, device="cpu")


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("mode", [{}, {"xy_quant": "fp16"}, {"color_quant": "vq"}],
                         ids=["lsq", "fp16-xy", "vq"])
def test_quant_train_chunk_matches_jax(mode):
    """Each of 20 steps starts both packages from JAX's state (parameters,
    model Adam, grids, quantizer Adams, VQ codebooks); the port carries its
    own best snapshot across them.

    Not a free run: a code whose argument lies at a half-integer rounds either
    way once the two packages' float32 sums differ in the last bits, and the
    runs then part. Free runs of this size part by 3e-6 to 5e-2 dB within 20
    steps (six scenes, each mode); the gradient to a grid's ``scale`` sums
    ``quant - (x - beta) / scale`` terms that cancel ~500-fold, so Adam's
    normalised step moves the grid by 1e-4 of itself between the packages
    after three steps, enough to move a code at a tie."""
    raw, sj, gt = _scene(2)
    cj, ct = _cfgs()
    qj, qt = jp.QuantConfig(**mode), tp.QuantConfig(**mode)
    bj = jp.init_quantizers(sj, cj, qj)
    mos_j = jmake_adam(0.01, 20000, 0.5).init(sj.params)
    best_j = best_t = None
    pj, pt = [], []
    for _ in range(20):
        st, bt = _port_state(sj), bundle_from_numpy(bj, device="cpu")
        st2, mos_t, bt2, mt = tp.quant_train_chunk(st, adam_state_from_numpy(mos_j, "cpu"), bt,
                                                   torch.as_tensor(gt), ct, qt, 0.01, 1, best=best_t)
        sj, mos_j, bj, mj = jp.quant_train_chunk(sj, mos_j, bj, jnp.asarray(gt), cj, qj, 0.01, 1,
                                                 best=best_j)
        best_j, best_t = mj["best"], mt["best"]
        pj.append(float(mj["psnr"][0]))
        pt.append(float(mt["psnr"][0]))
        # the step's updates: Adam's normalised step (lr 0.01 for the model,
        # 1e-3 for the grids) to a hundredth of a step
        for k in PARAMS:
            _close(getattr(st2.params, k), getattr(sj.params, k), 1e-4, k)
        for f in ("xy", "color"):
            for g in ("scale", "beta"):
                _close(getattr(getattr(bt2, f), g), getattr(getattr(bj, f), g), 1e-5, f"{f}.{g}")
        _close(bt2.cov.cov.scale, bj.cov.cov.scale, 1e-5, "cov.scale")
        assert int(bt2.step) == int(bj.step) and int(mos_t.count) == int(bj.step)
        for i, k in enumerate(PARAMS):
            _close(mos_t.mu[i], getattr(mos_j[0].mu, k), 1e-6 * (1 + np.abs(np.asarray(
                getattr(mos_j[0].mu, k))).max()), f"mu {k}")
        if qt.color_quant == "vq":
            for lt, lj in zip(bt2.color_vq.layers, bj.color_vq.layers):
                _close(lt.embed, lj.embed, 1e-5, "codebook")
                _close(lt.cluster_size, lj.cluster_size, 1e-5, "cluster size")
    pj, pt = np.asarray(pj), np.asarray(pt)
    assert np.isfinite(pt).all() and pt.max() > pt[0] + 0.5
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-4)
    assert int(np.argmax(pt)) == int(np.argmax(pj))
    assert abs(float(best_t[0]) - float(best_j[0])) <= 1e-4
    for k in PARAMS:        # the snapshot: JAX's pre-update parameters of the best step
        _close(getattr(best_t[1], k), getattr(best_j[1], k), 0.0, f"best {k}")


def test_quant_train_chunk_free_run_is_finite_and_improves():
    """20 steps carried by the port alone (lsq): finite, rising, the best
    snapshot the pre-update state of its best step, no host round trip."""
    raw, sj, gt = _scene(2)
    cj, ct = _cfgs()
    qt = tp.QuantConfig()
    st = _port_state(sj)
    bt = tp.init_quantizers(st, ct, qt)
    mos = ttr.make_optimizer(ttr.TrainConfig(lr=0.01)).init(st.params)
    seen = [st.params]
    best = None
    psnrs = []
    for _ in range(20):
        st, mos, bt, m = tp.quant_train_chunk(st, mos, bt, torch.as_tensor(gt), ct, qt, 0.01, 1,
                                              best=best)
        best = m["best"]
        psnrs.append(float(m["psnr"][0]))
        seen.append(st.params)
    k = int(np.argmax(psnrs))
    assert np.isfinite(psnrs).all() and psnrs[-1] > psnrs[0] + 0.5
    assert float(best[0]) == max(psnrs)
    for a, b in zip(best[1], seen[k]):
        assert torch.equal(a, b)


def test_fit_image_quantized_and_encode_match_jax(tmp_path):
    """The fit runs free in both packages (a 100-step warmup with one prune,
    then 100 QAT steps), so its best PSNR is held to 0.05 dB, the bound of
    the fit's own test; the encoder then runs in both on JAX's fitted state
    and bundle, so its outputs and bytes are held exactly."""
    raw, sj, gt = _scene(1)
    cj, ct = _cfgs()
    tc = dict(iterations=200, prune_iter=50, grow_iter=100, lr=0.02)
    qj, qt = jp.QuantConfig(), tp.QuantConfig()
    res_j = jct.fit_image_quantized(gt, cj, jtr.TrainConfig(**tc), qj, N, warmup_iter=100, seed=1,
                                    init_state=sj)
    res_t = tct.fit_image_quantized(gt, ct, ttr.TrainConfig(**tc), qt, N, warmup_iter=100, seed=1,
                                    init_state=_port_state(sj))
    assert abs(res_t.best_psnr - res_j.best_psnr) <= 0.05
    assert res_t.metrics["psnr"].shape == (100,) and res_t.metrics["warmup_psnr"].shape == (100,)
    assert res_t.best_psnr == float(res_t.metrics["psnr"].max())
    assert int(res_t.state.num_active) == int(res_j.state.num_active)
    st_j, b_j = _port_state(res_j.state), bundle_from_numpy(res_j.bundle, device="cpu")
    for order in ("id", "morton"):
        pj_, pt_ = str(tmp_path / f"j_{order}.gipb"), str(tmp_path / f"t_{order}.gipb")
        sj_ = jct.encode_decode_eval(res_j.state, res_j.bundle, gt, cj, qj, write_bitstream=pj_,
                                     stream_order=order)
        st_ = tct.encode_decode_eval(st_j, b_j, gt, ct, qt, n_renders=2, write_bitstream=pt_,
                                     stream_order=order)
        assert open(pt_, "rb").read() == open(pj_, "rb").read()
        for k in ("bpp", "position_bpp", "cholesky_bpp", "feature_dc_bpp", "num_points",
                  "bpp_wc", "cholesky_bpp_wc", "feature_dc_bpp_wc", "bpp_stream"):
            assert st_[k] == sj_[k], k
        for k in ("psnr", "stream_psnr"):
            assert abs(st_[k] - sj_[k]) <= 1e-4, k
        assert abs(st_["ms_ssim"] - sj_["ms_ssim"]) <= 1e-5
        assert st_["decode_full_time"] > 0 and st_["decode_full_fps"] == 1 / st_["decode_full_time"]
        # the port's own fit through its encoder: the stream decodes to its render
        own = tct.encode_decode_eval(res_t.state, res_t.bundle, gt, ct, qt,
                                     write_bitstream=str(tmp_path / f"own_{order}.gipb"),
                                     stream_order=order)
        # (at 60 Gaussians the stream's tables outweigh its rANS gain over bpp)
        assert abs(own["psnr"] - res_t.best_psnr) <= 0.05 and own["bpp_stream"] > 0
        assert abs(own["stream_psnr"] - own["psnr"]) <= (1e-4 if order == "id" else 1e-3)
