"""The port's LPIPS (on the CPU) against the JAX package's.

- ``lpips`` against JAX ``lpips`` with one random-weight ``.npz``, written by
  either package's ``save_npz`` and read by both (one file serves both):
  rtol 1e-5 (float32 convolutions summed in another order);
- ``tests/fixtures/lpips_fixture.npz``'s ``expected_torch`` (a torch mirror
  of the lpips package), with the weights drawn as ``tests/test_lpips.py``
  draws them: rtol 1e-5;
- ``evaluate(lpips_weights=...)`` against JAX's ``evaluate``: the LPIPS entry
  within rtol 1e-5, the PSNR within 1e-4 dB.
"""

import importlib
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.train import trainer as jtr

from gaussianimage_plus_tpu_torch.interop import state_from_numpy
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.train import trainer as ttr

# both packages' train/__init__ export the function under the module's name
jlp = importlib.import_module("gaussianimage_plus_tpu.train.lpips")
tlp = importlib.import_module("gaussianimage_plus_tpu_torch.train.lpips")
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "lpips_fixture.npz"


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


def _images(h=33, w=47, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
            rng.uniform(0, 1, (h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lpips_matches_jax(tmp_path, writer):
    path = str(tmp_path / "w.npz")
    if writer == "jax":
        jlp.save_npz(path, jlp.random_params(jax.random.PRNGKey(0)))
    else:
        tlp.save_npz(path, tlp.random_params(torch.Generator().manual_seed(0)))
    im0, im1 = _images()
    got = tlp.lpips(torch.as_tensor(im0), torch.as_tensor(im1),
                    tlp.params_from_npz(path, device="cpu"))
    ref = float(jlp.lpips(jnp.asarray(im0), jnp.asarray(im1), jlp.params_from_npz(path)))
    assert got.shape == () and ref > 0
    assert float(got) == pytest.approx(ref, rel=1e-5)
    same = tlp.lpips(torch.as_tensor(im0), torch.as_tensor(im0),
                     tlp.params_from_npz(path, device="cpu"))
    assert float(same) == pytest.approx(0.0, abs=1e-7)


def test_lpips_committed_fixture(tmp_path):
    fx = np.load(FIXTURE)
    path = str(tmp_path / "w.npz")
    jlp.save_npz(path, jlp.random_params(jax.random.PRNGKey(int(fx["seed"]))))
    got = float(tlp.lpips(fx["im0"], fx["im1"], tlp.params_from_npz(path, device="cpu")))
    assert got == pytest.approx(float(fx["expected_torch"]), rel=1e-5)


def test_evaluate_lpips_matches_jax(tmp_path):
    path = str(tmp_path / "w.npz")
    jlp.save_npz(path, jlp.random_params(jax.random.PRNGKey(3)))
    H, W = 32, 48
    cfg_j = jgi.GaussianConfig(H=H, W=W, max_num_points=64)
    cfg_t = tgi.GaussianConfig(H=H, W=W, max_num_points=64)
    st_j = jgi.init_state(cfg_j, 48, jax.random.PRNGKey(2))
    rng = np.random.default_rng(6)
    st_j = st_j.replace(params=st_j.params.replace(
        features=jnp.asarray(rng.uniform(0, 1, (64, 3)).astype(np.float32))))
    st_t = state_from_numpy({k: getattr(st_j.params, k) for k in ("xyz", "cov2d", "features")}
                            | {"active": st_j.active, "bound": st_j.bound,
                               "num_active": st_j.num_active}, device="cpu")
    gt = _images(H, W, seed=7)[0]
    ev_j = jtr.evaluate(st_j, jnp.asarray(gt), cfg_j, n_renders=1, lpips_weights=path)
    ev_t = ttr.evaluate(st_t, gt, cfg_t, n_renders=1, lpips_weights=path)
    assert ev_t["lpips"] == pytest.approx(ev_j["lpips"], rel=1e-5)
    assert abs(ev_t["psnr"] - ev_j["psnr"]) <= 1e-4
    assert "lpips" not in ttr.evaluate(st_t, gt, cfg_t, n_renders=1)
