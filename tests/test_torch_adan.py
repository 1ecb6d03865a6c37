"""The port's Adan (on the CPU) against the JAX package's.

- ``adan`` against JAX ``adan`` over 5 steps of seeded gradients on the
  three parameter arrays, at ``weight_decay`` 0 and 0.003, on a StepLR
  schedule that halves at step 3: parameters and every moment within rtol
  1e-6 (both float32, the same expression order);
- ``adan`` against the numpy derivation of the reference update (a copy of
  ``tests/test_adan.py:numpy_adan_steps``), float32 against float64: rtol
  2e-4, atol 1e-6, the JAX test's bound;
- ``zero_rows`` and ``take_rows`` on an ``AdanState`` inside a train state
  against JAX's ``_zero_state_rows`` and ``_morton_resort``, carried across
  by ``interop``: bit-equal;
- a 20-step ``train_chunk`` with ``param='cholesky'`` and one with
  ``'scale_rot'``, both ``opt_type='adan'`` (the fit CLI's remap: no growth,
  no pruning) through ``'xla'`` from one state: PSNR within 1e-3 dB of
  JAX's at every step, the bound of ``tests/test_torch_train.py:252``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import optim as joptim
from gaussianimage_plus_tpu.train import trainer as jtr

from gaussianimage_plus_tpu_torch.interop import (ADAN_TRAIN_STATE_KEYS, train_state_from_numpy,
                                                  train_state_to_numpy)
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import optim as toptim
from gaussianimage_plus_tpu_torch.train import trainer as ttr

PARAMS = ("xyz", "cov2d", "features")
SHAPES = {"xyz": 2, "cov2d": 3, "features": 3}
MOMENTS = ("exp_avg", "exp_avg_sq", "exp_avg_diff", "prev_grad")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: it is faster here,
    and test workers that each start a thread per core slow every OpenMP
    region of every worker (a 200-step fit: 1.3 s alone, minutes beside
    five others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_adan_steps(x0, grads, lr=0.01, betas=(0.98, 0.92, 0.99), eps=1e-8,
                     wd=0.0):
    """_single_tensor_adan (optimizer.py:237-294), no_prox=False, no clip."""
    b1, b2, b3 = betas
    m = np.zeros_like(x0); n = np.zeros_like(x0); d = np.zeros_like(x0)
    prev = None
    x = x0.copy()
    for t, g in enumerate(grads, start=1):
        if prev is None:
            prev = g.copy()  # step 1: neg_pre_grad = -g -> diff = 0
        diff = g - prev
        m = b1 * m + (1 - b1) * g
        d = b2 * d + (1 - b2) * diff
        gd = g + b2 * diff
        n = b3 * n + (1 - b3) * gd * gd
        bc1 = 1 - b1 ** t; bc2 = 1 - b2 ** t; bc3s = np.sqrt(1 - b3 ** t)
        denom = np.sqrt(n) / bc3s + eps
        x = x - (lr / bc1) * m / denom - (lr * b2 / bc2) * d / denom
        x = x / (1 + lr * wd)
        prev = g.copy()
    return x


@pytest.mark.parametrize("wd", [0.0, 0.003])
def test_adan_matches_jax(wd):
    M = 40
    rng = np.random.default_rng(11)
    init = {k: rng.normal(size=(M, c)).astype(np.float32) for k, c in SHAPES.items()}
    tx_j = joptim.adan(joptim.step_lr(0.01, step_size=3, gamma=0.5), weight_decay=wd)
    tx_t = toptim.adan(toptim.step_lr(0.01, step_size=3, gamma=0.5), weight_decay=wd)
    pj = jgi.GaussianParams(**{k: jnp.asarray(v) for k, v in init.items()})
    pt = tuple(torch.as_tensor(init[k]) for k in PARAMS)
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for _ in range(5):
        g = {k: (rng.normal(size=(M, c)) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
             for k, c in SHAPES.items()}
        uj, sj = tx_j.update(jgi.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}),
                             sj, pj)
        pj = jax.tree.map(lambda p, u: p + u, pj, uj)
        ut, st = tx_t.update(tuple(torch.as_tensor(g[k]) for k in PARAMS), st, pt)
        pt = tuple(p + u for p, u in zip(pt, ut))
    assert int(st.count) == int(sj.count) == 5
    for i, k in enumerate(PARAMS):
        np.testing.assert_allclose(pt[i].numpy(), np.asarray(getattr(pj, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        for mom in MOMENTS:
            np.testing.assert_allclose(getattr(st, mom)[i].numpy(),
                                       np.asarray(getattr(getattr(sj, mom), k)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{mom} {k}")


def test_adan_matches_reference_math():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(6,)).astype(np.float32)
    grads = [rng.normal(size=(6,)).astype(np.float32) for _ in range(5)]
    tx = toptim.adan(0.01, weight_decay=0.003)
    params = (torch.as_tensor(x0),)
    st = tx.init(params)
    for g in grads:
        upd, st = tx.update((torch.as_tensor(g),), st, params)
        params = (params[0] + upd[0],)
    expected = numpy_adan_steps(x0, grads, lr=0.01, wd=0.003)
    np.testing.assert_allclose(params[0].numpy(), expected, rtol=2e-4, atol=1e-6)


def _adan_train_states():
    """One JAX train state with an Adan state of seeded values, and the
    port's copy of it."""
    cfg_j = jgi.GaussianConfig(H=48, W=64, max_num_points=64)
    cfg_t = tgi.GaussianConfig(H=48, W=64, max_num_points=64)
    ts_j = jtr.init_train_state(cfg_j, jtr.TrainConfig(opt_type="adan"), 40, seed=2)
    rng = np.random.default_rng(4)
    fill = lambda p: jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), p)
    opt = ts_j.opt_state._replace(count=jnp.asarray(7, jnp.int32),
                                  **{m: fill(getattr(ts_j.opt_state, m)) for m in MOMENTS})
    ts_j = ts_j.replace(opt_state=opt)
    return cfg_j, cfg_t, ts_j, train_state_from_numpy(ts_j, device="cpu")


def _assert_ts_equal(ts_t, ts_j):
    d = train_state_to_numpy(ts_t)
    assert tuple(d) == ADAN_TRAIN_STATE_KEYS
    for k in PARAMS:
        np.testing.assert_array_equal(d[k], np.asarray(getattr(ts_j.gaussians.params, k)))
        for m in MOMENTS:
            np.testing.assert_array_equal(d[f"{m}_{k}"],
                                          np.asarray(getattr(getattr(ts_j.opt_state, m), k)),
                                          err_msg=f"{m} {k}")
    np.testing.assert_array_equal(d["active"], np.asarray(ts_j.gaussians.active))
    assert int(d["adan_count"]) == int(ts_j.opt_state.count) == 7


def test_adan_rows_match_jax():
    cfg_j, cfg_t, ts_j, ts_t = _adan_train_states()
    _assert_ts_equal(ts_t, ts_j)
    mask = np.zeros(64, bool)
    mask[[1, 5, 40, 63]] = True
    zj = ts_j.replace(opt_state=jtr._zero_state_rows(ts_j.opt_state, jnp.asarray(mask)))
    zt = ts_t._replace(opt_state=toptim.zero_rows(ts_t.opt_state, torch.as_tensor(mask)))
    _assert_ts_equal(zt, zj)
    assert not zt.opt_state.prev_grad[0][torch.as_tensor(mask)].any()
    _assert_ts_equal(ttr._morton_resort(zt, cfg_t), jtr._morton_resort(zj, cfg_j))


@pytest.mark.parametrize("param", ["cholesky", "scale_rot"])
def test_train_chunk_adan_matches_jax(param):
    H, W = 48, 64
    gt = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    cfg_j = jgi.GaussianConfig(H=H, W=W, max_num_points=64, param=param, raster_backend="xla")
    cfg_t = tgi.GaussianConfig(H=H, W=W, max_num_points=64, param=param, raster_backend="xla")
    tc = dict(iterations=20, prune_iter=20, lr=0.01, opt_type="adan", adaptive_add=False,
              prune=False)
    ts_j = jtr.init_train_state(cfg_j, jtr.TrainConfig(**tc), 32, seed=1)
    if param == "cholesky":
        # the legacy model keeps its means in atanh space: start them inside
        # the image rather than where tanh saturates
        xy = np.random.default_rng(5).uniform(-1.5, 1.5, (64, 2)).astype(np.float32)
        ts_j = ts_j.replace(gaussians=ts_j.gaussians.replace(
            params=ts_j.gaussians.params.replace(xyz=jnp.asarray(xy))))
    ts_t = train_state_from_numpy(ts_j, device="cpu")
    ts_j, m_j = jtr.train_chunk(ts_j, jnp.asarray(gt), cfg_j, jtr.TrainConfig(**tc), 20,
                                False, False)
    ts_t, m_t = ttr.train_chunk(ts_t, torch.as_tensor(gt), cfg_t, ttr.TrainConfig(**tc), 20,
                                False, False)
    p_j, p_t = np.asarray(m_j["psnr"]), m_t["psnr"].numpy()
    assert p_t.shape == (20,) and p_t[-1] > p_t[0]
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-3)
    assert isinstance(ts_t.opt_state, toptim.AdanState) and int(ts_t.opt_state.count) == 20
