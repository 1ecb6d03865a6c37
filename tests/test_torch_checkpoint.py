"""The port's checkpoints and ``fit_image``'s resume (on the CPU).

- Round trips of a ``GaussianState`` and of a ``TrainState`` with Adam and
  with Adan: every leaf ``torch.equal``, the extra numbers equal, and the
  restored generator's next draw equal to the saved one's;
- a fit stopped at 50 and resumed, on the JAX test's schedule
  (``tests/test_model_trainer.py:231-250``: 200 iterations, growth at 100,
  a prune every 50), bit-equal (``torch.equal``) to the uninterrupted fit,
  which is stricter than the JAX test's 1e-5: the generator rides in the
  checkpoint;
- resume of a completed run returns its best state with an empty history;
- a ``next_iter`` off the current schedule raises;
- a save ``fsync``s the temporary file before its rename and the directory
  after it;
- a JAX ``TrainState`` saved by the JAX package's ``save_checkpoint`` after
  its last growth, read back by its ``load_checkpoint``, carried across by
  ``interop``, saved by the port and resumed by the port's ``fit_image``:
  best PSNR within 0.05 dB of JAX's resumed run, the bound of
  ``tests/test_torch_train.py:test_fit_image_with_growth_matches_jax``.
"""

import os
import stat

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import trainer as jtr
from gaussianimage_plus_tpu.utils import checkpoint as jck

from gaussianimage_plus_tpu_torch.interop import train_state_from_numpy
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import trainer as ttr
from gaussianimage_plus_tpu_torch.train.optim import AdamState, AdanState
from gaussianimage_plus_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

H, W, M = 32, 48, 64
SCHEDULE = dict(iterations=200, grow_iter=100, prune_iter=50, lr=0.05)


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


def _gt(seed=5):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


def _leaves(x):
    """Every tensor of a nested NamedTuple, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return []


def assert_equal_trees(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i} differs"


def test_gaussian_state_round_trip(tmp_path):
    cfg = tgi.GaussianConfig(H=H, W=W, max_num_points=M)
    st = tgi.init_state(cfg, 40, torch.Generator().manual_seed(0))
    st = st._replace(active=st.active.clone().index_fill_(0, torch.tensor([5]), False),
                     num_active=st.num_active - 1)
    path = tmp_path / "gaussian_model"
    save_checkpoint(path, st, extra={"psnr": 31.5, "ms_ssim": np.float32(0.9)})
    back, extra = load_checkpoint(path, device="cpu")
    assert isinstance(back, tgi.GaussianState)
    assert_equal_trees(back, st)
    assert extra == {"psnr": 31.5, "ms_ssim": float(np.float32(0.9))}
    assert not os.path.exists(str(path) + ".tmp")


@pytest.mark.parametrize("opt_type", ["adam", "adan"])
def test_train_state_round_trip(tmp_path, opt_type):
    cfg = tgi.GaussianConfig(H=H, W=W, max_num_points=M)
    tcfg = ttr.TrainConfig(lr=0.05, opt_type=opt_type)
    ts = ttr.init_train_state(cfg, tcfg, 40, seed=1, device="cpu")
    ts, _ = ttr.train_chunk(ts, torch.as_tensor(_gt()), cfg, tcfg, 3, True, True)
    path = tmp_path / "fit_ckpt"
    save_checkpoint(path, ts, extra={"next_iter": 3})
    back, extra = load_checkpoint(path, device="cpu")
    assert isinstance(back, ttr.TrainState) and extra == {"next_iter": 3}
    assert isinstance(back.opt_state, AdanState if opt_type == "adan" else AdamState)
    assert int(back.opt_state.count) == 3 and int(back.step) == 3
    assert_equal_trees(back._replace(generator=None), ts._replace(generator=None))
    assert torch.equal(torch.rand(7, generator=back.generator),
                       torch.rand(7, generator=ts.generator))
    # a second save replaces the first
    save_checkpoint(path, ts._replace(step=ts.step + 1), extra={"next_iter": 4})
    again, extra = load_checkpoint(path, device="cpu")
    assert int(again.step) == 4 and extra["next_iter"] == 4


def _fit(**kw):
    cfg = tgi.GaussianConfig(H=H, W=W, max_num_points=M)
    return ttr.fit_image(_gt(), cfg, ttr.TrainConfig(**SCHEDULE), 16, seed=9, device="cpu", **kw)


def test_stop_and_resume_is_bit_equal(tmp_path):
    full = _fit()
    ck = str(tmp_path / "ck")
    half = _fit(checkpoint_dir=ck, checkpoint_every=50, stop_after_iter=50)
    assert half.history["psnr"].shape == (50,)
    resumed = _fit(checkpoint_dir=ck, resume=True)
    assert int(full.history["n_added"].sum()) > 0          # the growth ran after the resume
    assert resumed.history["psnr"].shape == (150,)
    assert torch.equal(resumed.history["psnr"], full.history["psnr"][50:])
    assert_equal_trees(resumed.state, full.state)
    assert resumed.best_psnr == full.best_psnr and resumed.best_iter == full.best_iter


def test_save_fsyncs_the_file_and_its_directory(tmp_path, monkeypatch):
    calls = []
    real = os.fsync

    def spy(fd):
        st = os.fstat(fd)
        calls.append(("dir" if stat.S_ISDIR(st.st_mode) else "file",
                      os.path.exists(tmp_path / "ck" / "fit_ckpt")))
        real(fd)

    monkeypatch.setattr(os, "fsync", spy)
    ts = ttr.init_train_state(tgi.GaussianConfig(H=H, W=W, max_num_points=M), ttr.TrainConfig(),
                              40, device="cpu")
    save_checkpoint(tmp_path / "ck" / "fit_ckpt", ts, extra={"next_iter": 0})
    # the file before the rename (the final path does not exist yet), the
    # directory after it
    assert calls == [("file", False), ("dir", True)]
    assert not (tmp_path / "ck" / "fit_ckpt.tmp").exists()
    assert load_checkpoint(tmp_path / "ck" / "fit_ckpt", "cpu")[1] == {"next_iter": 0}


def test_resume_of_completed_run(tmp_path):
    ck = str(tmp_path / "ck")
    full = _fit(checkpoint_dir=ck, checkpoint_every=100)
    _, extra = load_checkpoint(os.path.join(ck, "fit_ckpt"), device="cpu")
    assert extra["next_iter"] == SCHEDULE["iterations"]
    retry = _fit(checkpoint_dir=ck, resume=True)
    assert_equal_trees(retry.state, full.state)
    assert retry.best_psnr == full.best_psnr and retry.train_time == 0.0
    assert all(v.numel() == 0 for v in retry.history.values())


def test_schedule_mismatch_raises(tmp_path):
    ck = str(tmp_path / "ck")
    _fit(checkpoint_dir=ck, stop_after_iter=50)
    cfg = tgi.GaussianConfig(H=H, W=W, max_num_points=M)
    with pytest.raises(ValueError, match="prune_iter=40"):
        ttr.fit_image(_gt(), cfg, ttr.TrainConfig(**dict(SCHEDULE, prune_iter=40)), 16, seed=9,
                      device="cpu", checkpoint_dir=ck, resume=True)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    gt = _gt()
    cfg_j = jgi.GaussianConfig(H=H, W=W, max_num_points=M)
    tcfg_j = jtr.TrainConfig(**SCHEDULE)
    ck_j = str(tmp_path / "jax")
    # stops after the segment that ends with the growth (the last one)
    jtr.fit_image(jnp.asarray(gt), cfg_j, tcfg_j, 16, seed=9, checkpoint_dir=ck_j,
                  stop_after_iter=100)
    ts_j, extra = jck.load_checkpoint(os.path.join(ck_j, "fit_ckpt"),
                                      jtr.init_train_state(cfg_j, tcfg_j, 16, seed=9))
    assert int(extra["next_iter"]) == 100
    resumed_j = jtr.fit_image(jnp.asarray(gt), cfg_j, tcfg_j, 16, seed=9, checkpoint_dir=ck_j,
                              resume=True)
    ck_t = str(tmp_path / "port")
    save_checkpoint(os.path.join(ck_t, "fit_ckpt"), train_state_from_numpy(ts_j, device="cpu"),
                    extra={"next_iter": 100})
    resumed_t = _fit(checkpoint_dir=ck_t, resume=True)
    assert resumed_t.history["psnr"].shape == (100,)
    assert int(resumed_t.state.num_active) > 16
    assert abs(resumed_t.best_psnr - resumed_j.best_psnr) <= 0.05
