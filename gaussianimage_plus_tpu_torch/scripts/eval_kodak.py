"""Evaluate saved fit checkpoints at a per-tile cap.

Port of ``scripts/eval_kodak.py``: for each ``kodim*.png`` in ``--dataset``
with a ``<ckpt_dir>/<image>/fit_ckpt`` (the ``TrainState`` checkpoint that
``fit_image(checkpoint_dir=...)`` writes), restore the best snapshot,
render it at ``--tile_cap`` and print PSNR and MS-SSIM per image and their
averages; ``--out`` writes the rows as JSON::

    python -m gaussianimage_plus_tpu_torch.scripts.eval_kodak --dataset datasets/kodak \\
        --ckpt_dir results/ckpt50k --tile_cap 256 [--out eval.json] [--device cpu]

The render is the capped binned one (``raster_backend='pallas'``: kernel A
on the card, its plain version on the CPU), since ``'auto'`` on the card is
the cap-free ``list_t``, where ``--tile_cap`` would mean nothing. A state
trained at cap C renders best at cap C; the reference's own cap is 256
(forward.cu:673). ``--max_num_points`` must match the checkpoints' rows;
``--num_points`` is accepted for the JAX script's command lines and not
used (a checkpoint carries its shapes). ``--device`` as in ``train.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main(argv) -> list:
    """Run the CLI; returns the rows."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", default="datasets/kodak")
    p.add_argument("--ckpt_dir", default="results/ckpt50k")
    p.add_argument("--tile_cap", type=int, default=256)
    p.add_argument("--num_points", type=int, default=2500)
    p.add_argument("--max_num_points", type=int, default=5000)
    p.add_argument("--out", default=None, help="optional JSON output path")
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"],
                   help="default: the CUDA card")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = p.parse_args(argv)

    from ..core.precision import resolve_device
    from ..models.gaussian_image import GaussianConfig, render
    from ..train.losses import ms_ssim
    from ..train.metrics import psnr as psnr_fn
    from ..train.trainer import restore_best
    from ..utils.checkpoint import load_checkpoint
    from ..utils.image_io import load_image

    dev = resolve_device("cpu" if args.cpu else args.device)
    rows = []
    for img_path in sorted(Path(args.dataset).glob("kodim*.png")):
        name = img_path.stem
        ckpt = Path(args.ckpt_dir) / name / "fit_ckpt"
        if not ckpt.exists():
            continue
        gt = torch.as_tensor(load_image(img_path), device=dev)
        H, W = gt.shape[:2]
        ts, _ = load_checkpoint(ckpt, dev)
        best = restore_best(ts)
        if best.active.shape[0] != args.max_num_points:
            raise SystemExit(f"{ckpt}: {best.active.shape[0]} rows, --max_num_points "
                             f"{args.max_num_points}")
        cfg = GaussianConfig(H=H, W=W, max_num_points=args.max_num_points,
                             tile_cap=args.tile_cap, raster_backend="pallas")
        with torch.no_grad():
            img = render(best, cfg)
            rec = {"image": name, "psnr": float(psnr_fn(img, gt)),
                   "ms_ssim": float(ms_ssim(img, gt)),
                   "num_points": int(best.num_active), "tile_cap": args.tile_cap}
            if args.lpips_weights:
                from ..train.lpips import lpips, params_from_npz
                rec["lpips"] = float(lpips(img, gt, params_from_npz(args.lpips_weights, dev)))
        rows.append(rec)
        print(f"{name}: PSNR {rec['psnr']:.4f} MS-SSIM {rec['ms_ssim']:.4f}", flush=True)

    if rows:
        n = len(rows)
        print(f"AVERAGE over {n}: PSNR "
              f"{sum(r['psnr'] for r in rows) / n:.4f}, MS-SSIM "
              f"{sum(r['ms_ssim'] for r in rows) / n:.4f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
