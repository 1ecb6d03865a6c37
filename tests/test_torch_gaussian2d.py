"""Port projection (``core/gaussian2d.py``) and ``effective_cov2d`` against
the JAX package, on random inputs and on every committed fitted state; the
legacy ``project_gaussians_2d_cholesky`` and ``project_gaussians_2d_scale_rot``
and their VJPs (through a seeded cotangent on ``xys`` and ``conics``) too,
the gradients within rtol 1e-5 of each column's largest.

Integer outputs (radii, bbox, ``valid``, ``num_tiles_hit``) must be exactly
equal; conics to rtol 1e-6.
"""

import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.core import gaussian2d as jg
from gaussianimage_plus_tpu.models import gaussian_image as jgi

from gaussianimage_plus_tpu_torch.core import gaussian2d as tg
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 48 fitted 768x512 states (repr_states_2k holds the 2040x1344 one)
STATES = sorted(p for d in ("repr_states_cn", "repr_states_plain")
                for p in glob.glob(os.path.join(ROOT, "results", d, "*.npz")))


def _state_id(path):
    return f"{os.path.basename(os.path.dirname(path))[12:]}-{os.path.basename(path)[:-4]}"


def assert_projected_equal(pj, pt, what=""):
    for k in ("radii", "num_tiles_hit", "valid"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)),
                                      err_msg=f"{what} {k}")
    np.testing.assert_allclose(pt.conics.numpy(), np.asarray(pj.conics), rtol=1e-6,
                               err_msg=f"{what} conics")
    np.testing.assert_array_equal(pt.xys.numpy(), np.asarray(pj.xys))


def random_cov_inputs(n, H, W, seed):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-40, W + 40, n), rng.uniform(-40, H + 40, n)], -1)
    a = rng.lognormal(1.0, 2.0, n)
    c = rng.lognormal(1.0, 2.0, n)
    b = rng.uniform(-1.2, 1.2, n) * np.sqrt(a * c)       # some indefinite
    cov = np.stack([a, b, c], -1)
    cov[::17] = 0.0                                       # det == 0
    return xy.astype(np.float32), cov.astype(np.float32)


@pytest.mark.parametrize("H,W,seed", [(48, 80, 0), (45, 77, 1), (512, 768, 2)])
def test_projection_random(H, W, seed):
    xy, cov = random_cov_inputs(3000, H, W, seed)
    pj = jg.project_gaussians_2d_covariance(jnp.asarray(xy), jnp.asarray(cov), H, W)
    pt = tg.project_gaussians_2d_covariance(torch.as_tensor(xy), torch.as_tensor(cov), H, W)
    assert_projected_equal(pj, pt, "random")
    assert 0 < int(pt.valid.sum()) < xy.shape[0]
    tb = tg.tile_bounds_for(H, W)
    bj = jg.tile_bbox(jnp.asarray(xy), pj.radii.astype(jnp.float32), tb)
    bt = tg.tile_bbox(torch.as_tensor(xy), pt.radii.to(torch.float32), tb)
    for a, b in zip(bj, bt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_saturating_int_cast_matches_xla():
    x = np.array([np.nan, 3e9, -3e9, 2.0 ** 31, 7.9, -7.9, 0.0], np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(tg._to_int32(torch.as_tensor(x)).numpy(), ref)


@pytest.mark.parametrize("path", STATES, ids=[_state_id(p) for p in STATES])
def test_projection_committed_state(path):
    d = dict(np.load(path))
    cfg_t = config_from_numpy(d)
    cfg_j = jgi.GaussianConfig(H=cfg_t.H, W=cfg_t.W, max_num_points=cfg_t.max_num_points,
                               color_norm=cfg_t.color_norm)
    st = state_from_numpy(d, device="cpu")
    params_j = jgi.GaussianParams(xyz=jnp.asarray(d["xyz"]), cov2d=jnp.asarray(d["cov2d"]),
                                  features=jnp.asarray(d["features"]))
    pj = jgi.project(params_j, jnp.asarray(d["active"]), jnp.asarray(d["bound"]), cfg_j)
    pt = tgi.project(st.params, st.active, st.bound, cfg_t)
    assert_projected_equal(pj, pt, _state_id(path))
    assert int(pt.valid.sum()) > 4000


@pytest.mark.parametrize("param", ["covariance", "cholesky", "scale_rot"])
def test_effective_cov2d_and_means(param):
    rng = np.random.default_rng(3)
    M = 257
    raw = {"xyz": rng.normal(size=(M, 2)).astype(np.float32),
           "cov2d": rng.normal(size=(M, 3)).astype(np.float32),
           "features": rng.normal(size=(M, 3)).astype(np.float32),
           "bound": np.abs(rng.normal(size=(M, 3))).astype(np.float32),
           "active": rng.uniform(size=M) < 0.9}
    cfg_j = jgi.GaussianConfig(H=64, W=96, max_num_points=M, param=param, color_norm=True)
    cfg_t = tgi.GaussianConfig(H=64, W=96, max_num_points=M, param=param, color_norm=True)
    pj = jgi.GaussianParams(**{k: jnp.asarray(raw[k]) for k in ("xyz", "cov2d", "features")})
    st = state_from_numpy(raw, device="cpu")
    np.testing.assert_allclose(tgi.effective_cov2d(st.params, st.bound, cfg_t).numpy(),
                               np.asarray(jgi.effective_cov2d(pj, jnp.asarray(raw["bound"]), cfg_j)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tgi.means_of(st.params, cfg_t).numpy(),
                               np.asarray(jgi.means_of(pj, cfg_j)), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tgi.colors_of(st.params, cfg_t).numpy(),
                               np.asarray(jgi.colors_of(pj, cfg_j)), rtol=1e-6, atol=1e-7)


def _legacy_inputs(param, n, H, W, seed):
    rng = np.random.default_rng(seed)
    if param == "cholesky":
        means = rng.uniform(-1.1, 1.1, (n, 2)).astype(np.float32)
        shape = np.stack([rng.uniform(0.5, 6, n), rng.uniform(-3, 3, n),
                          rng.uniform(0.5, 6, n)], -1).astype(np.float32)
        shape[::13, 0] = 0.0                               # singular L
        return means, (shape,)
    means = np.stack([rng.uniform(-10, W + 10, n), rng.uniform(-10, H + 10, n)], -1)
    scales = rng.uniform(0.2, 8.0, (n, 2)).astype(np.float32)
    rot = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return means.astype(np.float32), (scales, rot)


@pytest.mark.parametrize("param", ["cholesky", "scale_rot"])
@pytest.mark.parametrize("H,W", [(32, 64), (30, 52)])
def test_legacy_projections_and_vjps(param, H, W):
    n = 96
    means, rest = _legacy_inputs(param, n, H, W, seed=7)
    fj = {"cholesky": jg.project_gaussians_2d_cholesky,
          "scale_rot": jg.project_gaussians_2d_scale_rot}[param]
    ft = {"cholesky": tg.project_gaussians_2d_cholesky,
          "scale_rot": tg.project_gaussians_2d_scale_rot}[param]
    rng = np.random.default_rng(8)
    g_xy = rng.normal(size=(n, 2)).astype(np.float32)
    g_con = rng.normal(size=(n, 3)).astype(np.float32)

    def loss_j(m, *r):
        p = fj(m, *r, H, W)
        return jnp.sum(p.xys * g_xy) + jnp.sum(jnp.where(p.valid[:, None], p.conics, 0.0) * g_con)

    args_j = (jnp.asarray(means),) + tuple(jnp.asarray(a) for a in rest)
    pj = jax.jit(fj, static_argnums=(len(args_j), len(args_j) + 1))(*args_j, H, W)
    grads_j = jax.jit(jax.grad(loss_j, argnums=tuple(range(len(args_j)))))(*args_j)
    args_t = tuple(torch.as_tensor(a).requires_grad_(True) for a in (means,) + rest)
    pt = ft(*args_t, H, W)
    for k in ("radii", "num_tiles_hit", "valid"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)), k)
    # the covariance passes through sin / cos or the L L^T products first, whose
    # last bits differ between XLA and torch, and the conic inverts it
    for k in ("xys", "conics"):
        np.testing.assert_allclose(getattr(pt, k).detach().numpy(), np.asarray(getattr(pj, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert 0 < int(pt.valid.sum()) < n
    loss_t = (torch.sum(pt.xys * torch.as_tensor(g_xy)) + torch.sum(
        torch.where(pt.valid[:, None], pt.conics, 0.0) * torch.as_tensor(g_con)))
    for a, b in zip(torch.autograd.grad(loss_t, args_t), grads_j):
        b = np.asarray(b)
        scale = np.abs(b).max(axis=0) if b.ndim > 1 else np.abs(b).max()
        err = np.abs(a.numpy() - b)
        assert (err <= 1e-5 * scale + 1e-12).all(), f"{err.max(axis=0)} vs column max {scale}"


def test_slv_and_psd_helpers():
    for n in (1, 100, 5000, 0):
        np.testing.assert_allclose(float(tg.slv_bound(512, 768, n)),
                                   float(jg.slv_bound(512, 768, n)), rtol=1e-7)
    cov = np.random.default_rng(4).normal(size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(tg.psd_valid_mask(torch.as_tensor(cov)).numpy(),
                                  np.asarray(jg.psd_valid_mask(jnp.asarray(cov))))


def test_no_jax_in_port_modules():
    """The port never imports JAX or the JAX package."""
    import ast
    import pathlib

    pkg = pathlib.Path(ROOT) / "gaussianimage_plus_tpu_torch"
    files = sorted(pkg.rglob("*.py")) + [pathlib.Path(ROOT) / "chip_smoke.py"]
    names = {str(f.relative_to(pkg)) for f in files if pkg in f.parents}
    assert {"interop.py", "core/gaussian2d.py", "core/render_tiled.py", "core/binning.py",
            "kernels/raster_binned.py", "kernels/raster_list.py", "kernels/raster_dense.py",
            "kernels/binning_tiles.py", "models/gaussian_image.py", "train/metrics.py",
            "train/losses.py", "train/optim.py", "train/trainer.py"} <= names
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "flax", "optax", "gaussianimage_plus_tpu"), \
                    f"{f}: imports {name}"
    assert jax.default_backend() == "cpu"
