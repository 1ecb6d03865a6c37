"""The port's ``parallel/sharded.py`` (on the CPU, gloo) against the JAX package.

- ``train_chunk(render_fn=render)`` is ``torch.equal`` to the default step;
- the tile-sharded render and its L2 loss's parameter gradient at 2 and 4
  spawned gloo ranks (``tests/test_torch_dist_workers.py``), flat and
  ``'hier'`` binning, on a 32x64 and the odd 30x52 grid: within atol 1e-5 of
  the unsharded port and of JAX's ``make_tile_sharded_render`` over 4
  virtual devices (rtol 1e-5 beside it for JAX's: sigma is evaluated in
  another order), the gradient within 1e-4 of each column's largest entry
  (autograd against the hand-written VJP: no ``world_size`` factor), and the
  same gradient on every rank;
- a 50-step chunk with a prune and a growth through the sharded render at 2
  and 4 ranks, from JAX's initial state and growth draws: PSNR within 1e-3 dB
  at every step and parameters within 2e-4 of the unsharded port's and of
  JAX's sharded chunk (the bounds of ``tests/test_parallel.py:116-139``), the
  same active set, and the ranks in lockstep (parameters, active set and best
  PSNR equal on every rank);
- ``fit_image_tile_sharded`` at 2 ranks over three chunks of growth and
  pruning, flat and ``'hier'`` with a band budget that drops candidates:
  the ranks in lockstep after every chunk (``replica_spread`` 0), the fit
  ``torch.equal`` to the same schedule run chunk by chunk, and the dropped
  candidates counted over the ranks and warned of (and in a world of one);
- ``fit_batch`` in one process and at 2 ranks (3 images: blocks of 2 and 1)
  ``torch.equal`` to each image's chunk schedule run alone, and within 0.05 dB
  (best PSNR) and 1% (active count) of JAX's ``fit_batch`` from the same
  states and draws; its block runner's per-chunk metrics ``torch.equal`` to
  each image's ``train_chunk`` metrics and, before the growth, every step's
  PSNR within 1e-3 dB of JAX's; ``batch_train_chunk`` ``torch.equal`` to
  ``train_chunk`` per image; ``fit_image_tile_sharded`` in a world of one
  fits.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.parallel import sharded as jsh
from gaussianimage_plus_tpu.train import trainer as jtr

from gaussianimage_plus_tpu_torch.core.binning import bin_gaussian_rows_hier
from gaussianimage_plus_tpu_torch.interop import (batch_train_states_from_numpy, state_from_numpy,
                                                  train_state_from_numpy)
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.parallel import sharded as tsh
from gaussianimage_plus_tpu_torch.train import trainer as ttr

from test_torch_dist_workers import run_ranks

SHAPES = [(32, 64), (30, 52)]
TC = dict(iterations=100, grow_iter=50, prune_iter=50, lr=0.02)
PARAMS = ("xyz", "cov2d", "features")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(H, W, **kw):
    return (jgi.GaussianConfig(H=H, W=W, max_num_points=64, tile_cap=32, **kw),
            tgi.GaussianConfig(H=H, W=W, max_num_points=64, tile_cap=32, **kw))


def _leaves(gs):
    return {k: np.asarray(getattr(gs.params, k)) for k in PARAMS} | {
        "active": np.asarray(gs.active), "bound": np.asarray(gs.bound),
        "num_active": np.asarray(gs.num_active)}


def render_case(H, W, bin_method):
    """(JAX state, port state, target, JAX cfg, port cfg) with coloured rows."""
    cfg_j, cfg_t = configs(H, W, bin_method=bin_method)
    sj = jgi.init_state(cfg_j, 32, jax.random.PRNGKey(2))
    rng = np.random.default_rng(H + W)
    sj = sj.replace(params=sj.params.replace(
        features=jnp.asarray(rng.uniform(0, 1, (64, 3)).astype(np.float32))))
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return sj, state_from_numpy(_leaves(sj), device="cpu"), gt, cfg_j, cfg_t


def chunk_case(H, W):
    """(JAX train state, port train state, growth draws, target, configs)."""
    cfg_j, cfg_t = configs(H, W)
    tsj = jtr.init_train_state(cfg_j, jtr.TrainConfig(**TC), 32, seed=7)
    k_grow, _ = jax.random.split(tsj.key)
    draws = torch.as_tensor(np.array(jax.random.uniform(k_grow, (64, 3))))
    gt = np.random.default_rng(0).uniform(0, 1, (8, H, W, 3)).astype(np.float32)[0]
    return tsj, train_state_from_numpy(tsj, device="cpu"), draws, gt, cfg_j, cfg_t


def _jax_render_grad(sj, cfg_j, gt):
    render_fn = jsh.make_tile_sharded_render(jsh.make_mesh((4,), ("tile",)), cfg_j, axis="tile")

    def loss(params):
        return jnp.mean((render_fn(sj.replace(params=params), cfg_j) - gt) ** 2)

    img = jax.jit(lambda s: render_fn(s, cfg_j))(sj)
    return img, jax.jit(jax.grad(loss))(sj.params)


def _port_render_grad(st, cfg_t, gt):
    params = tgi.GaussianParams(*(p.clone().requires_grad_(True) for p in st.params))
    img = tgi.render(st._replace(params=params), cfg_t)
    return img.detach(), torch.autograd.grad(torch.mean((img - torch.as_tensor(gt)) ** 2), params)


RENDER_CASES = [(H, W, b) for H, W in SHAPES for b in ("auto", "hier")]
# (bin_method, super_cap) of the multi-chunk sharded fits: flat bins, and a
# band budget of 8 that makes the 'hier' binner drop candidates
FIT_CASES = [("auto", 0), ("hier", 8)]
FIT_TC = dict(iterations=150, grow_iter=50, prune_iter=50, lr=0.02)


def fit_case(bin_method, super_cap):
    """``sharded_fit``'s arguments: three chunks of 50 steps, each with a
    prune, a growth after the first two, the final fill after the second."""
    _, cfg = configs(32, 64, bin_method=bin_method)
    gt = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (32, 64, 3)).astype(np.float32))
    return cfg, ttr.TrainConfig(**FIT_TC), gt, 32, 3, super_cap


@pytest.fixture(scope="module")
def batch():
    return batch_inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, batch):
    """One spawn per world size: the sharded renders and chunks at 2 and 4
    ranks, ``fit_batch`` at 2; and each case's references, the unsharded
    port's and JAX's sharded ones."""
    cases = [render_case(*c) for c in RENDER_CASES]
    chunks = [chunk_case(H, W) for H, W in SHAPES]
    out = {}
    for world in (2, 4):
        seq = [("sharded_render", ([(c[4], c[1], torch.as_tensor(c[2])) for c in cases],))]
        seq += [("sharded_chunk", (c[5], ttr.TrainConfig(**TC), c[1], torch.as_tensor(c[3]),
                                   c[2], 50)) for c in chunks]
        if world == 2:
            seq += [("sharded_fit", fit_case(*c)) for c in FIT_CASES]
            seq.append(("fit_batch", batch))
        out[world] = run_ranks("calls", world, tmp_path_factory.mktemp(f"world{world}"), seq)
    render_refs = [(_port_render_grad(st, cfg_t, gt), _jax_render_grad(sj, cfg_j, gt))
                   for sj, st, gt, cfg_j, cfg_t in cases]
    chunk_refs = [(ttr.train_chunk(ts0, torch.as_tensor(gt), cfg_t, ttr.TrainConfig(**TC), 50, True,
                                   True, grow_draws=draws), _jax_sharded_chunk(tsj, gt, cfg_j))
                  for tsj, ts0, draws, gt, cfg_j, cfg_t in chunks]
    return cases, chunks, out, render_refs, chunk_refs


def test_train_chunk_render_fn_default_is_bit_equal():
    _, ts0, draws, gt, _, cfg = chunk_case(32, 64)
    tcfg = ttr.TrainConfig(**TC)
    a, ma = ttr.train_chunk(ts0, torch.as_tensor(gt), cfg, tcfg, 30, True, True, grow_draws=draws)
    b, mb = ttr.train_chunk(ts0, torch.as_tensor(gt), cfg, tcfg, 30, True, True, grow_draws=draws,
                            render_fn=tgi.render)
    assert torch.equal(ma["psnr"], mb["psnr"]) and torch.equal(ma["loss"], mb["loss"])
    assert_train_states_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", range(len(RENDER_CASES)),
                         ids=[f"{H}x{W}-{b}" for H, W, b in RENDER_CASES])
def test_sharded_render_and_gradient(ranks, world, case):
    cases, _, out, render_refs, _ = ranks
    cfg_t = cases[case][4]
    (img_t, g_t), (img_j, g_j) = render_refs[case]
    for rank, res in enumerate(out[world]):
        img, grads, spread = res[0][case]
        assert img.shape == (cfg_t.H, cfg_t.W, 3) and spread == 0.0
        np.testing.assert_allclose(img.numpy(), img_t.numpy(), atol=1e-5, rtol=0)
        # JAX evaluates sigma with a matmul, the port with the kernels' fused
        # multiply-add chain: rtol 1e-5 beside atol, as the cross-package
        # render tests allow (tests/test_torch_raster.py)
        np.testing.assert_allclose(img.numpy(), np.asarray(img_j), atol=1e-5, rtol=1e-5)
        for name, a, b in zip(PARAMS, grads, g_t):
            # autograd through the sharded raster against the hand-written VJP
            # (and JAX's): sums in another order, so 1e-4 of each column's
            # largest entry, the smoke's bound for the kernels' payloads
            scale = b.abs().amax(0).numpy()
            assert (scale > 0).all()
            for ref, tag in ((b.numpy(), "port"), (np.asarray(getattr(g_j, name)), "JAX")):
                err = np.abs(a.numpy() - ref).max(0)
                assert (err <= 1e-4 * scale).all(), f"rank {rank} {name} vs {tag}: {err / scale}"
        if rank:
            for a, b in zip(grads, out[world][0][0][case][1]):
                assert torch.equal(a, b)


def _jax_sharded_chunk(tsj, gt, cfg_j):
    render_fn = jsh.make_tile_sharded_render(jsh.make_mesh((4,), ("tile",)), cfg_j, axis="tile")
    return jtr.train_chunk(tsj, jnp.asarray(gt), cfg_j, jtr.TrainConfig(**TC), 50, True, True,
                           render_fn=render_fn)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=[f"{H}x{W}" for H, W in SHAPES])
def test_sharded_chunk_with_grow_prune(ranks, world, shape):
    _, chunks, out, _, chunk_refs = ranks
    ts0 = chunks[shape][1]
    (ref, m_ref), (out_j, m_j) = chunk_refs[shape]
    for rank, res in enumerate(out[world]):
        ts, psnr, spread = res[1 + shape]
        assert spread == 0.0
        np.testing.assert_allclose(psnr.numpy(), m_ref["psnr"].numpy(), atol=1e-3, rtol=0)
        np.testing.assert_allclose(psnr.numpy(), np.asarray(m_j["psnr"]), atol=1e-3, rtol=0)
        assert torch.equal(ts.gaussians.active, ref.gaussians.active)
        np.testing.assert_array_equal(ts.gaussians.active.numpy(),
                                      np.asarray(out_j.gaussians.active))
        for name in ("xyz", "cov2d"):
            a = getattr(ts.gaussians.params, name).numpy()
            np.testing.assert_allclose(a, getattr(ref.gaussians.params, name).numpy(),
                                       atol=2e-4, rtol=0, err_msg=name)
            np.testing.assert_allclose(a, np.asarray(getattr(out_j.gaussians.params, name)),
                                       atol=2e-4, rtol=0, err_msg=name)
        assert int(ts.gaussians.num_active) > int(ts0.gaussians.num_active) - 5
        if rank:
            assert_train_states_equal(ts, out[world][0][1 + shape][0])


@pytest.mark.parametrize("case", range(len(FIT_CASES)),
                         ids=[f"{b}-super_cap{c}" for b, c in FIT_CASES])
def test_sharded_fit_ranks_in_lockstep_every_chunk(ranks, case):
    """At 2 ranks, across three chunks of growth and pruning: the ranks'
    parameters, active set and best PSNR agree after every chunk, the fit
    ends where the chunk-by-chunk schedule does, on every rank; a 'hier'
    band budget that drops candidates is counted over the ranks and warned
    of, on every rank."""
    bin_method, super_cap = FIT_CASES[case]
    results = [res[1 + len(SHAPES) + case] for res in ranks[2][2]]
    for spreads, alone, fitted, dropped, warned in results:
        assert spreads == [0.0, 0.0, 0.0]
        for a, b in zip((*alone.params, alone.active), (*fitted.params, fitted.active)):
            assert torch.equal(a, b)
        assert int(fitted.num_active) > 32
        if super_cap:
            assert dropped > 0
            assert len(warned) == 1 and f"dropped {dropped} candidates" in warned[0]
        else:
            assert dropped == 0 and not warned
    (_, _, s0, *_), (_, _, s1, *_) = results
    for a, b in zip((*s0.params, s0.active, s0.bound), (*s1.params, s1.active, s1.bound)):
        assert torch.equal(a, b)
    assert results[0][3] == results[1][3]


def test_super_overflow_world_of_one():
    """In a world of one the render's count is its binner's overflow, and
    ``fit_image_tile_sharded`` warns with what the fit dropped; flat bins
    drop nothing."""
    _, cfg = configs(32, 64, bin_method="hier")
    st = render_case(32, 64, "hier")[1]
    render_fn = tsh.make_tile_sharded_render(tsh.make_mesh(axis_names=("tile",)), cfg,
                                             super_cap=8)
    render_fn(st, cfg)
    proj = tgi.project(st.params, st.active, st.bound, cfg)
    want = int(bin_gaussian_rows_hier(proj, 32, 64, 0, 8, cap=32, super_cap=8).super_overflow)
    assert want > 0 and render_fn.super_overflow() == want
    _, cfg_flat = configs(32, 64)
    flat = tsh.make_tile_sharded_render(tsh.make_mesh(axis_names=("tile",)), cfg_flat)
    flat(st, cfg_flat)
    assert flat.super_overflow() == 0
    gt = np.random.default_rng(0).uniform(0, 1, (32, 64, 3)).astype(np.float32)
    tcfg = ttr.TrainConfig(iterations=50, grow_iter=50, prune_iter=50, lr=0.02)
    with pytest.warns(UserWarning, match="raise super_cap"):
        tsh.fit_image_tile_sharded(gt, cfg, tcfg, 32, super_cap=8, seed=3, device="cpu")


def assert_train_states_equal(a, b):
    ga, gb = a.gaussians, b.gaussians
    for x, y in zip((*ga.params, ga.active, ga.bound, ga.num_active, a.step, a.best_psnr,
                     a.best_iter, *a.best_params, a.best_active),
                    (*gb.params, gb.active, gb.bound, gb.num_active, b.step, b.best_psnr,
                     b.best_iter, *b.best_params, b.best_active)):
        assert torch.equal(x, y)
    for x, y in zip(a.opt_state, b.opt_state):
        for u, v in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)


def batch_inputs():
    """3 images, JAX's initial batch states (seeds 1-3) and each image's
    growth draws, as ``fit_batch`` takes them."""
    cfg_j, cfg_t = configs(32, 64)
    images = np.random.default_rng(1).uniform(0, 1, (3, 32, 64, 3)).astype(np.float32)
    tcfg_t = ttr.TrainConfig(**TC)
    tss_j = jsh.init_batch_train_state(cfg_j, jtr.TrainConfig(**TC), 40, 3, seed=1)
    states = batch_train_states_from_numpy(tss_j, device="cpu", seeds=[1, 2, 3])
    draws = [torch.as_tensor(np.array(jax.random.uniform(jax.random.split(k)[0], (64, 3))))
             for k in np.asarray(tss_j.key)]
    return torch.as_tensor(images), cfg_t, tcfg_t, 40, states, draws


def _alone(ts, gt, cfg, tcfg, draws):
    """Each image's schedule run alone: grow (the final fill) at 50, not at 100."""
    ts, _ = ttr.train_chunk(ts, gt, cfg, tcfg, 50, True, True, True, draws)
    return ttr.train_chunk(ts, gt, cfg, tcfg, 50, True, False)[0]


def test_fit_batch_single_process_and_two_ranks(ranks, batch):
    images, cfg, tcfg, n, states, draws = batch
    seen = []
    tss = tsh.fit_batch(images, cfg, tcfg, n, states=states, grow_draws=[[d] for d in draws],
                        progress=lambda it, m: seen.append((it, tuple(m["psnr"].shape))))
    assert seen == [(50, (3, 50)), (100, (3, 50))]
    for i, ts in enumerate(tss):
        assert_train_states_equal(ts, _alone(states[i], images[i], cfg, tcfg, draws[i]))
    for rank, res in enumerate(ranks[2][2]):
        got = res[-1]
        assert len(got) == 3
        for a, b in zip(got, tss):
            assert_train_states_equal(a, b)
    cfg_j, _ = configs(32, 64)
    tss_j = jsh.fit_batch(jnp.asarray(images.numpy()), cfg_j, jtr.TrainConfig(**TC), n, seed=1)
    for i, ts in enumerate(tss):
        n_j = int(tss_j.gaussians.num_active[i])
        assert n_j > n and abs(int(ts.gaussians.num_active) - n_j) <= 0.01 * n_j
        assert abs(float(ts.best_psnr) - float(tss_j.best_psnr[i])) <= 0.05


def test_fit_batch_block_runner_equals_per_image_loop(batch):
    """On the CPU the block runner runs each chunk of the whole block
    eagerly: the metrics it hands ``progress`` ([B, steps] and [B]) equal
    each image's ``train_chunk`` metrics, and the first chunk's PSNRs (before
    the growth) JAX's ``fit_batch`` progress within 1e-3 dB at every step.
    ``batch_train_chunk`` equals ``train_chunk`` image by image."""
    images, cfg, tcfg, n, states, draws = batch
    seen, seen_j = [], []
    tss = tsh.fit_batch(images, cfg, tcfg, n, states=states, grow_draws=[[d] for d in draws],
                        progress=lambda it, m: seen.append(m))
    for i in range(len(images)):
        ts = states[i]
        for c, end in enumerate((50, 100)):
            ts, m = ttr.train_chunk(ts, images[i], cfg, tcfg, 50, True, end == 50, end == 50,
                                    draws[i] if end == 50 else None)
            for key in ("loss", "psnr", "n_pruned", "n_added"):
                assert torch.equal(seen[c][key][i], m[key]), (i, end, key)
        assert_train_states_equal(tss[i], ts)
    assert int(seen[0]["n_added"].sum()) > 0
    cfg_j, _ = configs(32, 64)
    jsh.fit_batch(jnp.asarray(images.numpy()), cfg_j, jtr.TrainConfig(**TC), n, seed=1,
                  progress=lambda it, m: seen_j.append(np.asarray(m["psnr"])))
    np.testing.assert_allclose(seen[0]["psnr"].numpy(), seen_j[0], rtol=0, atol=1e-3)
    out, m = tsh.batch_train_chunk(states[:2], images[:2], cfg, tcfg, 20, True, True, True,
                                   draws[:2])
    for i in range(2):
        ref, mi = ttr.train_chunk(states[i], images[i], cfg, tcfg, 20, True, True, True, draws[i])
        assert_train_states_equal(out[i], ref)
        assert all(torch.equal(m[k][i], mi[k]) for k in mi)


def test_fit_batch_default_init_and_batch_helpers():
    """Without injected states, image ``i`` starts from ``init_train_state``
    seeded ``seed + i``; ``init_batch_train_state`` and ``shard_batch`` in a
    world of one; a mesh shape that is not the world's is refused."""
    _, cfg = configs(32, 64)
    tcfg = ttr.TrainConfig(iterations=50, grow_iter=50, prune_iter=50, lr=0.02)
    images = torch.rand((2, 32, 64, 3), generator=torch.Generator().manual_seed(0))
    tss = tsh.fit_batch(images, cfg, tcfg, 30, seed=5, device="cpu")
    init = tsh.init_batch_train_state(cfg, tcfg, 30, 2, seed=5, device="cpu")
    for i in range(2):
        assert torch.equal(init[i].gaussians.params.xyz,
                           ttr.init_train_state(cfg, tcfg, 30, 5 + i, device="cpu")
                           .gaussians.params.xyz)
        ref, _ = ttr.train_chunk(init[i], images[i], cfg, tcfg, 50, True, False)
        assert_train_states_equal(tss[i], ref)
    mesh = tsh.make_mesh(axis_names=("data",))
    assert mesh.shape == {"data": 1}
    assert all(a is b for a, b in zip(tsh.shard_batch(init, mesh), init))
    with pytest.raises(ValueError, match="mesh shape"):
        tsh.make_mesh((4,))
    with pytest.raises(ValueError, match="no axis"):
        tsh.shard_batch(init, mesh, axis="tile")


def test_fit_image_tile_sharded_world_of_one():
    _, cfg = configs(32, 64)
    gt = np.random.default_rng(0).uniform(0, 1, (32, 64, 3)).astype(np.float32)
    res = tsh.fit_image_tile_sharded(gt, cfg, ttr.TrainConfig(**TC), 32, seed=3, device="cpu")
    assert res.best_psnr > 10.0
    assert tsh.image_to_tile_rows(torch.as_tensor(gt), cfg).shape == (8, 256, 3)
