"""Export the converged 2040x1344 fit's best snapshot for the PyTorch port.

``results/ckpt2k_50k/fit_ckpt`` is the JAX package's Orbax ``TrainState`` of
a 50,000-step fit of the 2040x1344 Kodak mosaic (``scripts/fit_2k.py``'s
config: 20,000 rows, 10,000 initial points, cap 256, no colour norm;
24.86 dB, ``results/fit2k_50k_r4.json``). The port cannot read Orbax, so
this script restores it on the CPU through the JAX ``load_checkpoint`` (its
``RestoreArgs(restore_type=np.ndarray)`` path, since the checkpoint carries
TPU sharding metadata), from a ``TrainState`` template built as
``scripts/quantize_2k.py`` builds one, and writes the best snapshot to
``results/repr_states_2k/mosaic2k.npz`` in the ``repr_states`` keys
(``xyz``, ``cov2d``, ``features``, ``active``, ``bound``, ``num_active``,
``H``, ``W``, ``color_norm``, ``tile_cap``, ``best_psnr``, ``best_iter``)
that ``gaussianimage_plus_tpu_torch.interop.state_from_numpy`` and
``config_from_numpy`` read.

It imports JAX, so it lives outside the port. Run from the repository root::

    JAX_PLATFORMS=cpu python scripts/torch_export_2k_state.py
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CKPT = ROOT / "results" / "ckpt2k_50k" / "fit_ckpt"
OUT = ROOT / "results" / "repr_states_2k" / "mosaic2k.npz"
# scripts/fit_2k.py's defaults, under which the checkpoint was fitted
H, W, MAX_POINTS, NUM_POINTS, TILE_CAP = 1344, 2040, 20000, 10000, 256


def best_snapshot(ckpt: Path = CKPT) -> dict:
    """The checkpoint's best snapshot as numpy arrays, in the
    ``repr_states`` keys."""
    from gaussianimage_plus_tpu.models import GaussianConfig
    from gaussianimage_plus_tpu.train import TrainConfig, init_train_state, restore_best
    from gaussianimage_plus_tpu.utils.checkpoint import load_checkpoint

    cfg = GaussianConfig(H=H, W=W, max_num_points=MAX_POINTS, tile_cap=TILE_CAP)
    template = init_train_state(cfg, TrainConfig(), NUM_POINTS, seed=3047)
    ts, _ = load_checkpoint(ckpt, template)
    s = restore_best(ts)
    return dict(xyz=np.asarray(s.params.xyz), cov2d=np.asarray(s.params.cov2d),
                features=np.asarray(s.params.features), active=np.asarray(s.active),
                bound=np.asarray(s.bound), num_active=np.asarray(s.num_active),
                H=H, W=W, color_norm=0, tile_cap=TILE_CAP,
                best_psnr=float(ts.best_psnr), best_iter=int(ts.best_iter))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", type=Path, default=CKPT)
    p.add_argument("--out", type=Path, default=OUT)
    args = p.parse_args(argv)
    d = best_snapshot(args.ckpt)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **d)
    print(f"{args.out}: {int(d['num_active'])} active of {d['xyz'].shape[0]}, best "
          f"{d['best_psnr']:.4f} dB at step {d['best_iter']}, "
          f"{args.out.stat().st_size} bytes")


if __name__ == "__main__":
    main()
