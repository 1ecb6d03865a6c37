"""Port training half (on the CPU) against the JAX package.

``init_state`` semantics; ``prune`` (with the keep-one guard), ``grow`` (the
JAX package's candidate draws injected, tie-free errors, both ``final_fill``
values) and ``psd_clamp`` against JAX; the explicit Adam with masked updates,
zeroed and permuted moment rows against ``optax.adam`` over 20 steps; the
metrics and losses (the SSIM losses included); the train-state interop; a 60-step ``train_chunk``
through ``raster_backend='list_t'`` (JAX's Pallas kernels in interpret mode)
with a prune, whose PSNR must stay within 1e-3 dB of JAX's at every step (the
bound of ``tests/test_raster_list.py:211``); and a 200-step ``fit_image`` with
growth (``'auto'``, which is ``'xla'`` on the CPU in both packages): active
count within 1% and best PSNR within 0.05 dB of JAX's.
"""

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import losses as jlosses
from gaussianimage_plus_tpu.train import metrics as jmetrics
from gaussianimage_plus_tpu.train import optim as joptim
from gaussianimage_plus_tpu.train import trainer as jtr

from gaussianimage_plus_tpu_torch.interop import (TRAIN_STATE_KEYS, config_from_numpy,
                                                  state_from_numpy, train_state_from_numpy,
                                                  train_state_to_numpy)
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import losses as tlosses
from gaussianimage_plus_tpu_torch.train import metrics as tmetrics
from gaussianimage_plus_tpu_torch.train import optim as toptim
from gaussianimage_plus_tpu_torch.train import trainer as ttr

PARAMS = ("xyz", "cov2d", "features")


def _raw_state(M, n_active, H, W, seed, non_psd=0):
    """numpy leaves of a state: ``non_psd`` active rows get an indefinite
    effective covariance."""
    rng = np.random.default_rng(seed)
    cov = rng.uniform(0, 1, (M, 3)).astype(np.float32)
    cov[:non_psd] = np.array([1.0, 3.0, 1.0], np.float32)
    return dict(xyz=(rng.uniform(0, 1, (M, 2)) * [W, H]).astype(np.float32), cov2d=cov,
                features=rng.normal(size=(M, 3)).astype(np.float32),
                bound=np.tile(np.array([[0.5, 0.0, 0.5]], np.float32), (M, 1)),
                active=np.arange(M) < n_active, num_active=np.int32(n_active))


def _jax_state(raw):
    return jgi.GaussianState(
        params=jgi.GaussianParams(**{k: jnp.asarray(raw[k]) for k in PARAMS}),
        active=jnp.asarray(raw["active"]), bound=jnp.asarray(raw["bound"]),
        num_active=jnp.asarray(raw["num_active"], jnp.int32))


def _leaves(gs):
    return {k: getattr(gs.params, k) for k in PARAMS} | {
        "active": gs.active, "bound": gs.bound, "num_active": gs.num_active}


def assert_state_equal(st, sj, rtol=0.0):
    for k, b in _leaves(sj).items():
        a = _leaves(st)[k].numpy()
        if rtol:
            np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=rtol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)


def test_init_state_semantics():
    cfg = tgi.GaussianConfig(H=48, W=80, max_num_points=300)
    gen = torch.Generator().manual_seed(1)
    st = tgi.init_state(cfg, 200, gen)
    again = tgi.init_state(cfg, 200, torch.Generator().manual_seed(1))
    for a, b in zip(_leaves(st).values(), _leaves(again).values()):
        assert torch.equal(a, b)
    xy, cov = st.params.xyz, st.params.cov2d
    assert xy.shape == (300, 2) and cov.shape == (300, 3) and st.params.features.shape == (300, 3)
    assert float(xy[:, 0].min()) >= 0 and float(xy[:, 0].max()) < 80
    assert float(xy[:, 1].min()) >= 0 and float(xy[:, 1].max()) < 48
    assert float(xy[:, 0].max()) > 60 and float(xy[:, 1].max()) > 36
    assert float(cov.min()) >= 0 and float(cov.max()) < 1 and float(cov.std()) > 0.2
    assert not st.params.features.any()
    assert int(st.num_active) == 200 and int(st.active.sum()) == 200 and bool(st.active[:200].all())
    ref = jgi.init_state(jgi.GaussianConfig(H=48, W=80, max_num_points=300), 200,
                         jax.random.PRNGKey(0))
    np.testing.assert_array_equal(st.bound.numpy(), np.asarray(ref.bound))
    no_slv = tgi.init_state(tgi.GaussianConfig(H=48, W=80, max_num_points=300, slv=False), 200, gen)
    assert torch.equal(no_slv.bound, torch.tensor([[0.5, 0.0, 0.5]]).expand(300, 3))


@pytest.mark.parametrize("non_psd,n_active", [(7, 40), (40, 40)], ids=["prunes", "keep-one-guard"])
def test_prune_matches_jax(non_psd, n_active):
    raw = _raw_state(64, n_active, 48, 80, seed=2, non_psd=non_psd)
    cfg = dict(H=48, W=80, max_num_points=64)
    sj, nj = jgi.prune(_jax_state(raw), jgi.GaussianConfig(**cfg))
    st, nt = tgi.prune(state_from_numpy(raw, device="cpu"), tgi.GaussianConfig(**cfg))
    assert_state_equal(st, sj)
    assert int(nt) == int(nj)
    assert (int(nt) >= non_psd) if non_psd < n_active else (int(nt) == 0 and bool(st.active.any()))


@pytest.mark.parametrize("final_fill", [False, True], ids=["capped", "final-fill"])
def test_grow_matches_jax(final_fill):
    M, H, W = 200, 48, 80
    raw = _raw_state(M, 120, H, W, seed=3)
    raw["active"][[5, 17, 30]] = False                     # holes below the count
    raw["num_active"] = np.int32(raw["active"].sum())
    rng = np.random.default_rng(4)
    render = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    err = np.abs(render - gt).sum(-1).ravel()
    assert np.unique(err).size == err.size                 # tie-free top-k
    key = jax.random.PRNGKey(11)
    draws = np.asarray(jax.random.uniform(key, (M, 3)))
    cfg = dict(H=H, W=W, max_num_points=M)
    sj, aj, mj = jgi.grow(_jax_state(raw), jgi.GaussianConfig(**cfg), jnp.asarray(render),
                          jnp.asarray(gt), key, jnp.asarray(final_fill), base_num_samples=50)
    st, at, mt = tgi.grow(state_from_numpy(raw, device="cpu"), tgi.GaussianConfig(**cfg),
                          torch.as_tensor(render), torch.as_tensor(gt), None, final_fill,
                          base_num_samples=50, draws=torch.as_tensor(draws.copy()))
    assert int(at) == int(aj) and 0 < int(at) <= (80 if final_fill else 50)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert_state_equal(st, sj, rtol=1e-7)


def test_psd_clamp_matches_jax():
    rng = np.random.default_rng(5)
    M = 300
    raw = dict(xyz=np.zeros((M, 2), np.float32), features=np.zeros((M, 3), np.float32),
               cov2d=rng.normal(0, 3, (M, 3)).astype(np.float32),
               bound=np.abs(rng.normal(size=(M, 3))).astype(np.float32), active=np.ones(M, bool))
    pj = jgi.psd_clamp(_jax_state({**raw, "num_active": M}).params, jnp.asarray(raw["bound"]),
                       jgi.GaussianConfig(max_num_points=M))
    st = state_from_numpy(raw, device="cpu")
    pt = tgi.psd_clamp(st.params, st.bound, tgi.GaussianConfig(max_num_points=M))
    np.testing.assert_allclose(pt.cov2d.numpy(), np.asarray(pj.cov2d), rtol=1e-6, atol=1e-6)
    eff = pt.cov2d + st.bound
    assert bool(tgi.psd_valid_mask(eff).all())


def test_adam_matches_optax():
    """20 steps with the trainer's row operations: updates of inactive rows
    zeroed after the moment update, moment rows zeroed at step 7 (growth)
    and permuted at step 12 (Morton re-sort); StepLR halves at step 8."""
    M = 50
    rng = np.random.default_rng(6)
    shapes = {"xyz": 2, "cov2d": 3, "features": 3}
    init = {k: rng.normal(size=(M, c)).astype(np.float32) for k, c in shapes.items()}
    active = rng.uniform(size=M) < 0.8
    tx_j = joptim.make_adam(0.018, step_size=8, gamma=0.5)
    pj = jgi.GaussianParams(**{k: jnp.asarray(v) for k, v in init.items()})
    sj = tx_j.init(pj)
    tx_t = toptim.make_adam(0.018, step_size=8, gamma=0.5)
    pt = tuple(torch.as_tensor(init[k]) for k in PARAMS)
    stt = tx_t.init(pt)
    m_t = torch.as_tensor(active)[:, None]
    zero_mask = np.zeros(M, bool)
    zero_mask[[3, 9, 27]] = True
    perm = rng.permutation(M)
    rows = lambda f: (lambda x: f(x) if isinstance(x, jnp.ndarray) and x.ndim >= 1
                      and x.shape[0] == M else x)
    for step in range(20):
        g = {k: (rng.normal(size=(M, c)) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
             for k, c in shapes.items()}
        g = {k: np.where(active[:, None], v, 0.0).astype(np.float32) for k, v in g.items()}
        uj, sj = tx_j.update(jgi.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}), sj, pj)
        pj = optax.apply_updates(pj, jtr._mask_updates(uj, jnp.asarray(active)))
        ut, stt = tx_t.update(tuple(torch.as_tensor(g[k]) for k in PARAMS), stt)
        pt = tuple(p + torch.where(m_t, u, torch.zeros_like(u)) for p, u in zip(pt, ut))
        if step == 7:
            sj = jtr._zero_state_rows(sj, jnp.asarray(zero_mask))
            stt = toptim.zero_rows(stt, torch.as_tensor(zero_mask))
        if step == 12:
            sj = jax.tree.map(rows(lambda x: jnp.take(x, jnp.asarray(perm), axis=0)), sj)
            pj = jax.tree.map(lambda x: jnp.take(x, jnp.asarray(perm), axis=0), pj)
            stt = toptim.take_rows(stt, torch.as_tensor(perm))
            pt = tuple(p[torch.as_tensor(perm)] for p in pt)
            active, m_t = active[perm], m_t[torch.as_tensor(perm)]
    assert int(stt.count) == int(sj[0].count) == 20
    for i, k in enumerate(PARAMS):
        np.testing.assert_allclose(pt[i].numpy(), np.asarray(getattr(pj, k)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stt.mu[i].numpy(), np.asarray(getattr(sj[0].mu, k)),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(stt.nu[i].numpy(), np.asarray(getattr(sj[0].nu, k)),
                                   rtol=1e-5, atol=1e-12)


def test_metrics_and_losses_match_jax():
    rng = np.random.default_rng(7)
    a = rng.uniform(-0.1, 1.1, (24, 40, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    # rtol 1e-5: float32 means of ~1e3 terms, summed in another order
    for name in ("mse", "psnr", "clamped_mse", "clamped_psnr"):
        np.testing.assert_allclose(float(getattr(tmetrics, name)(ta, tb)),
                                   float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-5, err_msg=name)
    for lt in ("L2", "L1", "Fusion3"):
        x = ta.clone().requires_grad_(True)
        loss = tlosses.loss_fn(x, tb, lt, 0.7)
        (g,) = torch.autograd.grad(loss, x)
        lj, gj = jax.value_and_grad(lambda p: jlosses.loss_fn(p, jnp.asarray(b), lt, 0.7))(jnp.asarray(a))
        np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-6, err_msg=lt)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-6, atol=1e-12, err_msg=lt)
    # the SSIM losses: JAX's window comes from XLA's float32 exp, a few ulps
    # from the port's float64 one, which moves SSIM by ~5e-6 (test_torch_ssim.py)
    for lt in ("SSIM", "Fusion1", "Fusion4"):
        np.testing.assert_allclose(float(tlosses.loss_fn(ta, tb, lt)),
                                   float(jlosses.loss_fn(jnp.asarray(a), jnp.asarray(b), lt)),
                                   rtol=0, atol=1e-5, err_msg=lt)
    assert isinstance(ttr.make_optimizer(ttr.TrainConfig(opt_type="adan")), toptim.Adan)
    with pytest.raises(ValueError):
        ttr.make_optimizer(ttr.TrainConfig(opt_type="sgd"))


def _pair(H, W, M, backend, **kw):
    return (jgi.GaussianConfig(H=H, W=W, max_num_points=M, tile_cap=48, raster_backend=backend, **kw),
            tgi.GaussianConfig(H=H, W=W, max_num_points=M, tile_cap=48, raster_backend=backend, **kw))


def test_train_state_interop_round_trip():
    cfg_j, _ = _pair(48, 64, 64, "auto", psd_mode="clamp")
    ts_j = jtr.init_train_state(cfg_j, jtr.TrainConfig(), 32, seed=1)
    ts_t = train_state_from_numpy(ts_j, device="cpu")
    d = train_state_to_numpy(ts_t)
    assert tuple(d) == TRAIN_STATE_KEYS
    for k in PARAMS:
        np.testing.assert_array_equal(d[k], np.asarray(getattr(ts_j.gaussians.params, k)))
        np.testing.assert_array_equal(d[f"mu_{k}"], np.asarray(getattr(ts_j.opt_state[0].mu, k)))
    assert int(d["num_active"]) == 32 and d["best_psnr"] == -np.inf
    cfg = config_from_numpy({"H": 48, "W": 64, "xyz": d["xyz"], "slv": False, "psd_mode": "clamp"})
    assert cfg.slv is False and cfg.psd_mode == "clamp" and cfg.max_num_points == 64


def test_train_chunk_list_t_matches_jax():
    """60 steps through the chunk-list pair (Morton re-sort first), then a
    prune, from one interop'd state."""
    H, W = 48, 64
    gt = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    cfg_j, cfg_t = _pair(H, W, 64, "list_t")
    tc = dict(iterations=60, grow_iter=30, prune_iter=30, lr=0.02)
    ts_j = jtr.init_train_state(cfg_j, jtr.TrainConfig(**tc), 32, seed=0)
    ts_t = train_state_from_numpy(ts_j, device="cpu")
    ts_j, m_j = jtr.train_chunk(ts_j, jnp.asarray(gt), cfg_j, jtr.TrainConfig(**tc), 60, True, False)
    ts_t, m_t = ttr.train_chunk(ts_t, torch.as_tensor(gt), cfg_t, ttr.TrainConfig(**tc), 60,
                                True, False)
    p_j, p_t = np.asarray(m_j["psnr"]), m_t["psnr"].numpy()
    assert p_t.shape == (60,) and p_t[-1] > p_t[0] + 1.0
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-3)
    assert int(ts_t.gaussians.num_active) == int(ts_j.gaussians.num_active)
    assert int(ts_t.best_iter) == int(ts_j.best_iter)


def test_fit_image_with_growth_matches_jax():
    """200 steps, prune every 50, one growth with the final fill at step
    100, JAX's initial state and candidate draws injected."""
    H, W, M, seed = 48, 64, 96, 5
    gt = np.random.default_rng(8).uniform(0, 1, (H, W, 3)).astype(np.float32)
    cfg_j, cfg_t = _pair(H, W, M, "auto")
    tc = dict(iterations=200, grow_iter=100, prune_iter=50, lr=0.02)
    res_j = jtr.fit_image(jnp.asarray(gt), cfg_j, jtr.TrainConfig(**tc), 48, seed=seed)
    key = jax.random.PRNGKey(seed)
    k_init, key = jax.random.split(key)
    k_grow, _ = jax.random.split(key)
    init = state_from_numpy(_leaves(jgi.init_state(cfg_j, 48, k_init)), device="cpu")
    draws = torch.as_tensor(np.array(jax.random.uniform(k_grow, (M, 3))))
    res_t = ttr.fit_image(gt, cfg_t, ttr.TrainConfig(**tc), 48, seed=seed, gaussians=init,
                          grow_draws=[draws])
    n_j, n_t = int(res_j.state.num_active), int(res_t.state.num_active)
    assert n_j > 48 and abs(n_t - n_j) <= 0.01 * n_j
    assert abs(res_t.best_psnr - res_j.best_psnr) <= 0.05
    assert res_t.history["psnr"].shape == (200,)
    assert np.isfinite(res_t.history["psnr"].numpy()).all()
