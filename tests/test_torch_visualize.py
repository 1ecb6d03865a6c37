"""The port's inspection views (on the CPU) against the JAX package.

``pixel_count_map`` must equal the JAX one exactly on JAX's random initial
state at 64x96 (the JAX test's) and on the odd 30x52 grid with colours; on a
committed fitted 768x512 state, at all but 0.01% of the pixels, by at most
one (gate ties between two evaluations of sigma). Each of the six plots must
write its PNG.
"""

import os

import numpy as np
import pytest
import torch
import jax

from gaussianimage_plus_tpu.models import gaussian_image as jgi
from gaussianimage_plus_tpu.utils import visualize as jvis

from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.utils import visualize as tvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(gs):
    return {"xyz": gs.params.xyz, "cov2d": gs.params.cov2d, "features": gs.params.features,
            "active": gs.active, "bound": gs.bound, "num_active": gs.num_active}


def _pair(H, W, M, n, seed, colours=False):
    cfg_j = jgi.GaussianConfig(H=H, W=W, max_num_points=M, tile_cap=32)
    sj = jgi.init_state(cfg_j, n, jax.random.PRNGKey(seed))
    if colours:
        feats = np.random.default_rng(seed).uniform(0, 1, (M, 3)).astype(np.float32)
        sj = sj.replace(params=sj.params.replace(features=feats))
    st = state_from_numpy({k: np.asarray(v) for k, v in _leaves(sj).items()}, device="cpu")
    return sj, cfg_j, st, tgi.GaussianConfig(H=H, W=W, max_num_points=M, tile_cap=32)


@pytest.mark.parametrize("H,W,M,n,seed,colours", [(64, 96, 32, 32, 0, False),
                                                  (30, 52, 64, 48, 1, True)])
def test_pixel_count_map_matches_jax(H, W, M, n, seed, colours):
    sj, cfg_j, st, cfg_t = _pair(H, W, M, n, seed, colours)
    counts = tvis.pixel_count_map(st, cfg_t)
    assert counts.shape == (H, W) and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), jvis.pixel_count_map(sj, cfg_j))
    assert int(counts.max()) > 1


def test_pixel_count_map_fitted_state():
    d = dict(np.load(os.path.join(ROOT, "results", "repr_states_plain", "kodim01.npz")))
    cfg_t = config_from_numpy(d)
    st = state_from_numpy(d, device="cpu")
    cfg_j = jgi.GaussianConfig(H=cfg_t.H, W=cfg_t.W, max_num_points=cfg_t.max_num_points,
                               color_norm=cfg_t.color_norm, tile_cap=cfg_t.tile_cap)
    sj = jgi.GaussianState(params=jgi.GaussianParams(xyz=d["xyz"], cov2d=d["cov2d"],
                                                     features=d["features"]),
                           active=d["active"], bound=d["bound"],
                           num_active=np.int32(d["active"].sum()))
    diff = np.abs(tvis.pixel_count_map(st, cfg_t).numpy() - jvis.pixel_count_map(sj, cfg_j))
    # the port evaluates sigma with the kernels' fused multiply-add chain, the
    # JAX package with a matmul: a pair at the edge of the gate may pass in one
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, (diff.max(), int((diff > 0).sum()))


@pytest.mark.parametrize("name", ["visual_points", "visual_points_xyz", "radius_circles",
                                  "tile_occupancy_heatmap", "radius_histogram",
                                  "pixel_count_heatmap"])
def test_views_write_files(tmp_path, name):
    _, _, st, cfg = _pair(64, 96, 32, 32, 0)
    out = tmp_path / "views" / f"{name}.png"
    assert getattr(tvis, name)(st, cfg, out) == out
    assert out.exists() and out.stat().st_size > 200


def test_ellipse_params_match_jax():
    cov = np.random.default_rng(3).uniform(-2, 6, (50, 3)).astype(np.float32)
    for a, b in zip(tvis._ellipse_params(cov), jvis._ellipse_params(cov)):
        np.testing.assert_array_equal(a, b)
