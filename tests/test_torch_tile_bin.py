"""Binning methods new to the port, against the JAX package: integers equal.

- ``bin_method='pallas'``: kernel E's wrapper (its plain version on the CPU)
  against JAX ``bin_gaussians_pallas`` (Pallas in interpret mode), and
  against the port's own ``'top_k'``: ids, mask and count, at caps that clip
  a crowded tile, with invalid rows, on an odd tile grid;
- ``'hier'`` against JAX ``_bin_hier`` (through ``bin_gaussians``) with a
  ``super_cap`` small enough to overflow, and a large one: ids, mask, count
  and ``super_overflow``; without overflow it equals ``'top_k'``;
- ``'auto'`` follows the JAX rule (``'hier'`` past 32M membership entries).
"""

import numpy as np
import pytest
import torch

from gaussianimage_plus_tpu.core import binning as jb
from gaussianimage_plus_tpu.kernels.binning_pallas import bin_gaussians_pallas as jax_bin_pallas

from gaussianimage_plus_tpu_torch.core import binning as tb
from gaussianimage_plus_tpu_torch.core.gaussian2d import Projected
from gaussianimage_plus_tpu_torch.kernels import binning_tiles

from test_torch_binning import _eq, assert_bins_equal
from test_torch_raster import both_projections, scene

SCENES = {
    "crowded-cap8": dict(n=150, seed=21, n_invalid=5, crowd=40, cap=8),
    "odd-grid-cap64": dict(n=200, seed=22, n_invalid=9, H=45, W=77, cap=64),
    "cap1": dict(n=80, seed=23, cap=1),
}


def _case(n, seed, cap, n_invalid=0, crowd=0, H=48, W=80):
    xy, cov, _, _, H, W = scene(n=n, H=H, W=W, seed=seed, n_invalid=n_invalid)
    xy[n_invalid:n_invalid + crowd] = 12.0
    pj, pt = both_projections(xy, cov, H, W)
    return pj, pt, H, W, cap


@pytest.mark.parametrize("case", list(SCENES))
def test_tile_bin_matches_jax_pallas_binner(case):
    pj, pt, H, W, cap = _case(**SCENES[case])
    bt = tb.bin_gaussians(pt, H, W, cap=cap, method="pallas")
    assert_bins_equal(bt, jax_bin_pallas(pj, H, W, cap=cap), f"pallas {case}")
    assert_bins_equal(bt, tb.bin_gaussians(pt, H, W, cap=cap, method="top_k"), f"top_k {case}")
    assert bt.super_overflow is None
    if case == "crowded-cap8":
        assert int(bt.count.max()) == cap and not bool(pt.valid[:5].any())


def test_tile_bin_wrapper_validates_inputs():
    bbox = torch.zeros((10, 4), dtype=torch.int32)
    ids, count = binning_tiles.tile_bin(bbox, 5, 3, 4)
    assert ids.shape == (15, 4) and not ids.any() and not count.any()
    with pytest.raises(TypeError):
        binning_tiles.tile_bin(bbox.float(), 5, 3, 4)
    with pytest.raises(ValueError):
        binning_tiles.tile_bin(bbox[:, :3], 5, 3, 4)
    with pytest.raises(ValueError):
        binning_tiles.tile_bin(bbox, 5, 3, 0)


HIER = {
    "overflow-ss2": dict(scene=dict(n=300, seed=24, n_invalid=6, cap=16), ss=2, super_cap=40),
    "overflow-rows": dict(scene=dict(n=300, seed=25, cap=64, H=45, W=77), ss=(1, 5), super_cap=30),
    "exact-ss8": dict(scene=dict(n=200, seed=26, cap=64), ss=8, super_cap=0),
}


@pytest.mark.parametrize("case", list(HIER))
def test_hier_matches_jax(case):
    kw = HIER[case]
    pj, pt, H, W, cap = _case(**kw["scene"])
    args = dict(cap=cap, method="hier", super_size=kw["ss"], super_cap=kw["super_cap"])
    bt = tb.bin_gaussians(pt, H, W, **args)
    bj = jb.bin_gaussians(pj, H, W, **args)
    assert_bins_equal(bt, bj, f"hier {case}")
    _eq(bt.super_overflow, bj.super_overflow, f"hier {case} super_overflow")
    if kw["super_cap"]:
        assert int(bt.super_overflow) > 0
    else:
        assert int(bt.super_overflow) == 0
        assert_bins_equal(bt, tb.bin_gaussians(pt, H, W, cap=cap), "hier vs top_k")


def test_auto_picks_hier_past_32m_entries():
    """1344x2040 (10752 tiles) with 20,000 slots picks ``'hier'``; the
    Kodak point (1536 tiles, 5000 slots) picks ``'top_k'``."""
    rng = np.random.default_rng(27)
    for (H, W, N), hier in (((1344, 2040, 20_000), True), ((512, 768, 5000), False)):
        xy = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], -1).astype(np.float32)
        zero = torch.zeros(N, dtype=torch.int32)
        proj = Projected(xys=torch.as_tensor(xy), conics=torch.zeros((N, 3)), radii=zero,
                         num_tiles_hit=zero, valid=torch.zeros(N, dtype=torch.bool))
        bins = tb.bin_gaussians(proj, H, W, method="auto")
        assert (bins.super_overflow is not None) == hier
        assert not bool(bins.count.any())
