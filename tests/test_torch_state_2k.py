"""The converged 2K state for the card, on the CPU.

``results/repr_states_2k/mosaic2k.npz`` (written by
``scripts/torch_export_2k_state.py``) holds, bit for bit, the best snapshot
of the JAX package's Orbax train state ``results/ckpt2k_50k/fit_ckpt``,
restored here through the JAX ``load_checkpoint`` from a template built as
``scripts/quantize_2k.py`` builds one, and the port reads it as a 2040x1344
state of 20,000 rows.
"""

from pathlib import Path

import numpy as np

from gaussianimage_plus_tpu.models import GaussianConfig
from gaussianimage_plus_tpu.train import TrainConfig, init_train_state, restore_best
from gaussianimage_plus_tpu.utils.checkpoint import load_checkpoint

from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy

ROOT = Path(__file__).resolve().parents[1]


def test_mosaic2k_npz_is_the_orbax_best_snapshot():
    cfg = GaussianConfig(H=1344, W=2040, max_num_points=20000, tile_cap=256)
    ts, _ = load_checkpoint(ROOT / "results" / "ckpt2k_50k" / "fit_ckpt",
                            init_train_state(cfg, TrainConfig(), 10000, seed=3047))
    best = restore_best(ts)
    want = dict(xyz=best.params.xyz, cov2d=best.params.cov2d, features=best.params.features,
                active=best.active, bound=best.bound, num_active=best.num_active,
                best_psnr=np.float64(ts.best_psnr), best_iter=np.int64(ts.best_iter),
                H=np.int64(1344), W=np.int64(2040), color_norm=np.int64(0),
                tile_cap=np.int64(256))
    got = np.load(ROOT / "results" / "repr_states_2k" / "mosaic2k.npz")
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    cfg_t = config_from_numpy(got)
    st = state_from_numpy(got, device="cpu")
    assert (cfg_t.H, cfg_t.W, cfg_t.max_num_points, cfg_t.tile_cap) == (1344, 2040, 20000, 256)
    assert int(st.num_active) == int(st.active.sum()) == 19691
    assert 24.8 < float(got["best_psnr"]) < 24.9
