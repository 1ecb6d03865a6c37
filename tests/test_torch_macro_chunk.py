"""The fused dispatch on the CPU: ``train_macro_chunk``,
``quant_train_macro_chunk`` and the segments of ``fit_image``.

- ``train_macro_chunk`` against the JAX one at 48x64 from one interop'd
  state, through ``'list_t'`` (JAX's Pallas kernels in interpret mode) and
  ``'auto'`` (the plain path in both): 3 chunks of 30 steps, a prune after
  each, the growth at the end with and without the final fill, JAX's
  candidate draws injected. Tolerances of ``test_torch_train.py``: every
  step's PSNR within 1e-3 dB, ``num_active`` and ``best_iter`` equal.
- ``train_macro_chunk`` is ``torch.equal`` to the same chunks run through
  ``train_chunk`` with the growth on the last: parameters, moments, the best
  snapshot and the metrics.
- ``quant_train_macro_chunk`` (lsq and VQ colour) against the JAX one, as
  ``tests/test_compress_pipeline.py`` runs it (3 chunks of 20 steps): a free
  run of both packages, whose first step is held to 1e-4 dB and every step
  to 0.05 dB, the bound of the free QAT run in ``test_torch_qat.py`` (a code
  at a half-integer tie rounds either way once float32 sums differ in the
  last bits, and the runs part by up to 0.03 dB in 60 steps); and
  ``torch.equal`` to successive ``quant_train_chunk`` calls.
- ``fit_image`` with ``stop_after_iter``, ``checkpoint_every`` and
  ``log_every`` inside a grow period: its history, log lines and every
  checkpoint it writes equal a loop of ``train_chunk`` run by hand; resumed,
  it finishes as that loop does.
- ``fit_image`` warns with the count when the ``'hier'`` binner drops
  candidates at its best state, and not otherwise.
- ``captures`` for a CUDA device (no card needed): every backend that
  launches a kernel captures, with each binner and on an odd tile grid;
  ``'xla'`` and other plain backends, a ``render_fn`` and the CPU do not.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianimage_plus_tpu.compress import pipeline as jp
from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import trainer as jtr
from gaussianimage_plus_tpu.train.optim import make_adam as jmake_adam

from gaussianimage_plus_tpu_torch.compress import pipeline as tp
from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.interop import (adam_state_from_numpy, bundle_from_numpy,
                                                  state_from_numpy, train_state_from_numpy)
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import trainer as ttr
from gaussianimage_plus_tpu_torch.utils import checkpoint as tck

PARAMS = ("xyz", "cov2d", "features")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One OpenMP thread per test worker: workers' fits side by side
    otherwise slow each other many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_trees_equal(a, b, what):
    ta, tb = ttr._tensors(a), ttr._tensors(b)
    assert len(ta) == len(tb) > 0, what
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert torch.equal(x, y), f"{what}: tensor {i} {tuple(x.shape)} differs"


H, W, M = 48, 64, 64
TC = dict(iterations=120, grow_iter=90, prune_iter=30, lr=0.02, base_num_samples=10)


def _macro_case(backend):
    gt = np.random.default_rng(3).uniform(0, 1, (H, W, 3)).astype(np.float32)
    cfg_j = jgi.GaussianConfig(H=H, W=W, max_num_points=M, tile_cap=48, raster_backend=backend)
    cfg_t = tgi.GaussianConfig(H=H, W=W, max_num_points=M, tile_cap=48, raster_backend=backend)
    ts_j = jtr.init_train_state(cfg_j, jtr.TrainConfig(**TC), 32, seed=0)
    return gt, cfg_j, cfg_t, ts_j


@pytest.mark.parametrize("final_fill", [False, True], ids=["capped", "final-fill"])
@pytest.mark.parametrize("backend", ["list_t", "auto"])
def test_train_macro_chunk_matches_jax(backend, final_fill):
    gt, cfg_j, cfg_t, ts_j = _macro_case(backend)
    draws = torch.as_tensor(np.array(jax.random.uniform(jax.random.split(ts_j.key)[0], (M, 3))))
    ts_t = train_state_from_numpy(ts_j, device="cpu")
    ts_j, m_j = jtr.train_macro_chunk(ts_j, jnp.asarray(gt), cfg_j, jtr.TrainConfig(**TC), 3, 30,
                                      True, True, final_fill)
    ts_t, m_t = ttr.train_macro_chunk(ts_t, torch.as_tensor(gt), cfg_t, ttr.TrainConfig(**TC), 3,
                                      30, True, True, final_fill, grow_draws=draws)
    p_j, p_t = np.asarray(m_j["psnr"]), m_t["psnr"].numpy()
    assert p_t.shape == (90,) and p_t[-1] > p_t[0] + 1.0
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=1e-3)
    assert int(m_t["n_added"]) == int(m_j["n_added"]) > 0
    assert (int(m_t["n_added"]) > 10) == final_fill
    assert int(m_t["n_pruned"]) == int(m_j["n_pruned"])
    assert int(ts_t.gaussians.num_active) == int(ts_j.gaussians.num_active)
    assert int(ts_t.best_iter) == int(ts_j.best_iter)
    assert m_t["chunk_num_active"].shape == (3,)
    assert int(m_t["chunk_num_active"][-1]) == int(ts_t.gaussians.num_active)


@pytest.mark.parametrize("backend", ["list_t", "auto"])
def test_train_macro_chunk_equals_train_chunks(backend):
    gt, _, cfg, ts_j = _macro_case(backend)
    gt = torch.as_tensor(gt)
    tcfg = ttr.TrainConfig(**TC)
    draws = torch.rand((M, 3), generator=torch.Generator().manual_seed(9))
    a, ma = ttr.train_macro_chunk(train_state_from_numpy(ts_j, device="cpu"), gt, cfg, tcfg, 3,
                                  30, True, True, True, grow_draws=draws)
    b = train_state_from_numpy(ts_j, device="cpu")
    losses, psnrs, pruned, active = [], [], [], []
    for i in range(3):
        b, mb = ttr.train_chunk(b, gt, cfg, tcfg, 30, True, i == 2, True, draws)
        losses.append(mb["loss"])
        psnrs.append(mb["psnr"])
        pruned.append(mb["n_pruned"])
        active.append(b.gaussians.num_active)
    _assert_trees_equal(a, b, "train state")
    assert torch.equal(ma["loss"], torch.cat(losses)) and torch.equal(ma["psnr"], torch.cat(psnrs))
    assert torch.equal(ma["chunk_n_pruned"], torch.stack(pruned))
    assert torch.equal(ma["chunk_num_active"], torch.stack(active))
    assert torch.equal(ma["n_pruned"], sum(pruned)) and torch.equal(ma["n_added"], mb["n_added"])
    assert not ttr.captures(cfg, "cpu")


QH, QW, QM, QN = 64, 96, 64, 60


def _qat_case(seed, mode):
    """A state of 60 active Gaussians in 64 slots and a smooth target, with
    JAX's quantizers and model Adam."""
    rng = np.random.default_rng(seed)
    raw = dict(xyz=(rng.uniform(0, 1, (QM, 2)) * [QW, QH]).astype(np.float32),
               cov2d=(rng.uniform(0, 1, (QM, 3)) * [20, 2, 20]).astype(np.float32),
               features=rng.uniform(0, 1, (QM, 3)).astype(np.float32),
               bound=np.tile(np.float32([[0.5, 0.0, 0.5]]), (QM, 1)),
               active=np.arange(QM) < QN, num_active=np.int32(QN))
    yy, xx = np.mgrid[0:QH, 0:QW].astype(np.float32)
    gt = np.stack([xx / QW, yy / QH, 0.5 + 0.3 * np.sin(xx / 7)], -1).astype(np.float32)
    sj = jgi.GaussianState(
        params=jgi.GaussianParams(**{k: jnp.asarray(raw[k]) for k in PARAMS}),
        active=jnp.asarray(raw["active"]), bound=jnp.asarray(raw["bound"]),
        num_active=jnp.asarray(QN, jnp.int32))
    cj = jgi.GaussianConfig(H=QH, W=QW, max_num_points=QM)
    qj = jp.QuantConfig(**mode)
    bj = jp.init_quantizers(sj, cj, qj)
    mos_j = jmake_adam(0.01, 20000, 0.5).init(sj.params)
    port = (state_from_numpy(raw, device="cpu"), adam_state_from_numpy(mos_j, "cpu"),
            bundle_from_numpy(bj, device="cpu"))
    return gt, (sj, mos_j, bj, cj, qj), port, tgi.GaussianConfig(H=QH, W=QW, max_num_points=QM)


QAT_MODES = pytest.mark.parametrize("mode", [{}, {"color_quant": "vq"}], ids=["lsq", "vq"])


@QAT_MODES
def test_quant_train_macro_chunk_matches_jax(mode):
    gt, (sj, mos_j, bj, cj, qj), port, ct = _qat_case(2, mode)
    qt = tp.QuantConfig(**mode)
    *_, m_j = jp.quant_train_macro_chunk(sj, mos_j, bj, jnp.asarray(gt), cj, qj, 0.01, 3, 20)
    *_, m_t = tp.quant_train_macro_chunk(*port, torch.as_tensor(gt), ct, qt, 0.01, 3, 20)
    p_j, p_t = np.asarray(m_j["psnr"]), m_t["psnr"].numpy()
    assert p_t.shape == (60,) and np.isfinite(p_t).all() and p_t.max() > p_t[0] + 0.5
    assert abs(p_t[0] - p_j[0]) <= 1e-4
    np.testing.assert_allclose(p_t, p_j, rtol=0, atol=0.05)
    assert abs(float(m_t["best"][0]) - float(m_j["best"][0])) <= 0.05
    assert float(m_t["best"][0]) == float(p_t.max())


@QAT_MODES
def test_quant_train_macro_chunk_equals_quant_train_chunks(mode):
    gt, _, port, ct = _qat_case(1, mode)
    gt = torch.as_tensor(gt)
    qt = tp.QuantConfig(**mode)
    a = tp.quant_train_macro_chunk(*port, gt, ct, qt, 0.01, 3, 20)
    b, best, losses, psnrs = port, None, [], []
    for _ in range(3):
        *b, m = tp.quant_train_chunk(*b, gt, ct, qt, 0.01, 20, best=best)
        best = m["best"]
        losses.append(m["loss"])
        psnrs.append(m["psnr"])
    _assert_trees_equal(a[:3], tuple(b), "state, model Adam, bundle")
    _assert_trees_equal(a[3]["best"], best, "best carry")
    assert torch.equal(a[3]["loss"], torch.cat(losses)) and torch.equal(a[3]["psnr"],
                                                                        torch.cat(psnrs))
    if mode:
        assert len(ttr._tensors(a[2].color_vq)) == 6


class _Lines(list):
    """A ``logger`` that keeps each line."""
    write = list.append


def test_fit_image_segments_match_the_chunk_loop(tmp_path, monkeypatch):
    """Chunks of 20, the growth at 100, a log line every 60, a checkpoint
    every 40 and a stop after 130 (so at 140): every segment boundary inside
    a grow period; three rows start non-PSD, so the first chunk prunes. The
    history, the log lines and each checkpoint's state
    equal a ``train_chunk`` loop run by hand; resumed, the fit finishes as
    the loop does, with a final checkpoint at 200."""
    rng = np.random.default_rng(12)
    gt = torch.as_tensor(rng.uniform(0, 1, (32, 48, 3)).astype(np.float32))
    cfg = tgi.GaussianConfig(H=32, W=48, max_num_points=80)
    tcfg = ttr.TrainConfig(iterations=200, grow_iter=100, prune_iter=20, lr=0.02,
                           base_num_samples=15)
    draws = torch.rand((80, 3), generator=torch.Generator().manual_seed(13))
    st = tgi.init_state(cfg, 40, torch.Generator().manual_seed(4))
    cov = st.params.cov2d.clone()
    cov[:3] = torch.tensor([1.0, 3.0, 1.0]) - st.bound[:3]
    st = st._replace(params=st.params._replace(cov2d=cov))
    saved = []
    save = tck.save_checkpoint

    def spy(path, ts, extra=None):
        saved.append((extra["next_iter"], ttr._clone(ts)))
        save(path, ts, extra)

    monkeypatch.setattr(tck, "save_checkpoint", spy)
    log = _Lines()
    ck = str(tmp_path / "ck")
    kw = dict(seed=4, gaussians=st, checkpoint_dir=ck, checkpoint_every=40, log_every=60,
              logger=log)
    first = ttr.fit_image(gt, cfg, tcfg, 40, stop_after_iter=130, grow_draws=[draws], **kw)
    rest = ttr.fit_image(gt, cfg, tcfg, 40, resume=True, **kw)

    ts = ttr.init_train_state(cfg, tcfg, 40, seed=4, gaussians=st)
    hist = {"psnr": [], "n_pruned": [], "n_added": [], "num_active": []}
    states, lines = {}, {True: [], False: []}
    for end in range(20, 201, 20):
        ts, m = ttr.train_chunk(ts, gt, cfg, tcfg, 20, True, end == 100, True,
                                draws if end == 100 else None)
        hist["psnr"].append(m["psnr"])
        hist["n_pruned"].append(m["n_pruned"][None])
        hist["n_added"].append(m["n_added"][None])
        hist["num_active"].append(ts.gaussians.num_active[None])
        states[end] = ttr._clone(ts)
        if end % 60 == 0:
            lines[end <= 140].append(f"iter {end}: psnr {float(m['psnr'][-1]):.4f} "
                                     f"best {float(ts.best_psnr):.4f} "
                                     f"n {int(ts.gaussians.num_active)}")
    assert [n for n, _ in saved] == [40, 80, 120, 140, 160, 200]
    for n, s in saved:
        _assert_trees_equal(s, states[n], f"checkpoint at {n}")
    assert log == lines[True] + ["resumed at iter 140"] + lines[False]
    for key, parts in hist.items():
        want = torch.cat(parts)
        cut = 140 if key == "psnr" else 7
        assert torch.equal(first.history[key], want[:cut]), key
        assert torch.equal(rest.history[key], want[cut:]), key
    assert int(torch.cat(hist["n_added"]).sum()) > 0 and int(torch.cat(hist["n_pruned"]).sum()) > 0
    _assert_trees_equal(rest.state, ttr.restore_best(ts), "best state")


def test_fit_image_warns_when_hier_drops():
    """One 128x128 super-tile holds 600 candidates, over the 'hier' binner's
    default band budget of 512: the fit warns once with the count of the
    drops at its best state; at 500 Gaussians it does not warn."""
    rng = np.random.default_rng(14)
    gt = torch.as_tensor(rng.uniform(0, 1, (128, 128, 3)).astype(np.float32))
    tcfg = ttr.TrainConfig(iterations=4, prune_iter=2, grow_iter=2, adaptive_add=False)
    for n, warns in ((600, True), (500, False)):
        cfg = tgi.GaussianConfig(H=128, W=128, max_num_points=n, tile_cap=16, bin_method="hier")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = ttr.fit_image(gt, cfg, tcfg, n, device="cpu")
        proj = tgi.project(res.state.params, res.state.active, res.state.bound, cfg)
        dropped = int(bin_gaussians(proj, 128, 128, cap=16, method="hier").super_overflow)
        said = [str(w.message) for w in caught if "dropped" in str(w.message)]
        assert (dropped > 0) == warns
        assert said == ([f"the 'hier' binner dropped {dropped} candidates at the fit's best "
                         f"state: its render diverged from exact binning (band budget "
                         f"max(4 tile_cap, 512) = 512)"] if warns else [])


@pytest.mark.parametrize("grid", [(512, 768), (496, 752)], ids=["768x512", "odd-752x496"])
def test_captures_every_kernel_route(grid):
    """The rule needs no card: ``resolve_backend`` and ``captures`` read the
    config and the device's type only."""
    cuda = torch.device("cuda")
    cfg = tgi.GaussianConfig(H=grid[0], W=grid[1], max_num_points=5000)
    assert tgi.resolve_backend(cfg, cuda) == ("list_t" if grid[1] == 768 else "pallas")
    assert ttr.captures(cfg, cuda) and ttr.captures(cfg, "cuda")
    for binner in ("top_k", "hier", "scatter", "rank", "auto", "pallas"):
        assert ttr.captures(tgi.GaussianConfig(H=grid[0], W=grid[1], raster_backend="pallas",
                                               bin_method=binner), cuda), binner
    for backend in ("list", "list_t", "dense", "sweep"):
        assert ttr.captures(tgi.GaussianConfig(H=grid[0], W=grid[1], raster_backend=backend),
                            cuda), backend
    for backend in ("xla", "range"):
        assert not ttr.captures(tgi.GaussianConfig(H=grid[0], W=grid[1],
                                                   raster_backend=backend), cuda), backend
    assert not ttr.captures(cfg, cuda, render_fn=tgi.render)
    assert not ttr.captures(cfg, "cpu")
