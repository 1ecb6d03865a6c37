"""Representation training CLI with the reference's flags.

Port of ``scripts/train.py`` (after the reference train.py:194-344): a
per-image fit over a dataset directory (Kodak names ``kodimNN.png`` or DIV2K
``NNNN.png``) with the reference's defaults (50,000 iterations, 2500 ->
5000 points, lr 0.018, a prune every 100, growth every 5000), the per-image
log lines and the dataset average, in the JAX script's formats::

    python -m gaussianimage_plus_tpu_torch.scripts.train -d datasets/kodak \\
        --num_images 1 --iterations 1000 [--device cpu]

For every image it writes ``<log_dir>/<image>/gaussian_model`` (the best
``GaussianState`` with its PSNR and MS-SSIM, ``utils/checkpoint.py``), the
image's ``train.txt`` and, with ``--save_imgs``, ``render.png``; the run's
``train.txt`` holds the arguments, a line per image and the average.
``--model_path`` loads ``<model_path>/<image>/gaussian_model`` and skips the
fit. A ``--model_name`` other than ``GaussianImage_Covariance`` selects the
reference's bundle for that model (train.py:256-262): Adan at lr 1e-3, no
growth and no pruning, for every one of those flags not passed explicitly.

``--device`` (default: the CUDA card; ``--cpu`` is ``--device cpu``)
replaces the JAX script's platform switch; with no card the default raises.
The default ``--dataset`` is relative to the working directory.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def parse_args(argv):
    p = argparse.ArgumentParser(description="GaussianImage++ training (PyTorch + CUDA)")
    p.add_argument("-d", "--dataset", type=str, default="datasets/kodak/")
    p.add_argument("--data_name", type=str, default="kodak")
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--prune_iter", type=int, default=100)
    p.add_argument("--grow_iter", type=int, default=5000)
    p.add_argument("--model_name", type=str, default="GaussianImage_Covariance")
    p.add_argument("--num_points", type=int, default=2500)
    p.add_argument("--max_num_points", type=int, default=5000)
    p.add_argument("--seed", type=int, default=3047)
    p.add_argument("--lr", type=float, default=0.018)
    p.add_argument("--radius_clip", type=float, default=1.0)
    p.add_argument("--clip_coe", type=float, default=3.0)
    p.add_argument("--loss_type", type=str, default="L2")
    p.add_argument("--SLV_init", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--color_norm", action="store_true")
    p.add_argument("--adaptive_add", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--prune", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--opt_type", type=str, default="adam", choices=["adam", "adan"])
    p.add_argument("--save_imgs", action="store_true")
    p.add_argument("--tile_cap", type=int, default=256)
    p.add_argument("--raster_backend", type=str, default="auto")
    p.add_argument("--num_images", type=int, default=None, help="limit image count")
    p.add_argument("--log_dir", type=str, default="./checkpoints")
    p.add_argument("--log_every", type=int, default=10000)
    p.add_argument("--model_path", type=str, default=None,
                   help="directory of per-image gaussian_model checkpoints to evaluate "
                        "instead of fitting (reference train.py:61-77)")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="LPIPS-VGG .npz weight file; adds LPIPS to the report")
    p.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"],
                   help="default: the CUDA card")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return p.parse_args(argv)


def image_list(args):
    if args.data_name == "DIV2K_valid_HR":
        names = [f"{i + 1:04}.png" for i in range(800, 900)]
    else:
        names = [f"kodim{i + 1:02}.png" for i in range(24)]
    if args.num_images:
        names = names[: args.num_images]
    return [Path(args.dataset) / n for n in names]


def remap_model_bundle(args, argv) -> None:
    """The reference's bundle for a non-Covariance model (train.py:256-262),
    for the flags not passed explicitly; a note for each explicit flag that
    differs from it."""
    if args.model_name == "GaussianImage_Covariance":
        return
    passed = {a.lstrip("-").split("=")[0] for a in argv if a.startswith("--")}
    remap = {"lr": 0.001, "opt_type": "adan", "adaptive_add": False, "prune": False}
    for k, v in remap.items():
        if k not in passed:
            setattr(args, k, v)
        elif getattr(args, k) != v:
            print(f"note: --{k}={getattr(args, k)} overrides the "
                  f"reference's {args.model_name} bundle value {v}")


def main(argv) -> Path:
    """Run the CLI; returns the run's log directory."""
    args = parse_args(argv)
    remap_model_bundle(args, argv)
    from ..core.precision import resolve_device
    from ..models.gaussian_image import GaussianConfig, render
    from ..train.trainer import FitResult, TrainConfig, evaluate, fit_image
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from ..utils.image_io import LogWriter, load_image, save_image

    dev = resolve_device("cpu" if args.cpu else args.device)
    log_dir = Path(args.log_dir) / args.data_name / (
        f"{args.model_name}_I{args.iterations}_N{args.num_points}"
        f"{'_SLV' if args.SLV_init else ''}_R{args.radius_clip}"
        f"{'_add' if args.adaptive_add else ''}{'_prune' if args.prune else ''}"
        f"{'_colornorm' if args.color_norm else ''}")
    logwriter = LogWriter(log_dir)
    logwriter.write(json.dumps(vars(args)))

    param_map = {"GaussianImage_Covariance": "covariance",
                 "GaussianImage_Cholesky": "cholesky",
                 "GaussianImage_RS": "scale_rot"}

    psnrs, ms_ssims, train_times, eval_fpses, gs_nums = [], [], [], [], []
    for image_path in image_list(args):
        gt = load_image(image_path)
        H, W = gt.shape[:2]
        cfg = GaussianConfig(
            H=H, W=W, max_num_points=args.max_num_points,
            param=param_map.get(args.model_name, "covariance"),
            slv=args.SLV_init, color_norm=args.color_norm,
            clip_coe=args.clip_coe, radius_clip=args.radius_clip,
            tile_cap=args.tile_cap, raster_backend=args.raster_backend)
        tcfg = TrainConfig(
            iterations=args.iterations, lr=args.lr, prune_iter=args.prune_iter,
            grow_iter=args.grow_iter, adaptive_add=args.adaptive_add,
            prune=args.prune, loss_type=args.loss_type, opt_type=args.opt_type)
        img_log = LogWriter(log_dir / image_path.stem)
        if args.model_path:
            state, extra = load_checkpoint(
                Path(args.model_path) / image_path.stem / "gaussian_model", dev)
            res = FitResult(state=state, best_psnr=float(extra.get("psnr", 0.0)),
                            best_iter=0, train_time=0.0, history={})
        else:
            res = fit_image(gt, cfg, tcfg, args.num_points, seed=args.seed,
                            log_every=args.log_every, logger=img_log, device=dev)
        ev = evaluate(res.state, gt, cfg, lpips_weights=args.lpips_weights)
        save_checkpoint(log_dir / image_path.stem / "gaussian_model", res.state,
                        extra={"psnr": res.best_psnr, "ms_ssim": ev["ms_ssim"]})
        if args.save_imgs:
            with torch.no_grad():
                save_image(render(res.state, cfg), log_dir / image_path.stem / "render.png")
        logwriter.write(
            f"{image_path.stem}\t{H}x{W}\tPSNR\t{ev['psnr']:.4f}\tMS-SSIM\t"
            f"{ev['ms_ssim']:.4f}\t"
            + (f"LPIPS\t{ev['lpips']:.4f}\t" if 'lpips' in ev else "")
            + f"Training\t{res.train_time:.4f}\tEval\t"
            f"{ev['eval_time']:.8f}\tFPS\t{ev['fps']:.4f}\tgs_nums\t{ev['num_points']:.2e}")
        psnrs.append(ev["psnr"])
        ms_ssims.append(ev["ms_ssim"])
        train_times.append(res.train_time)
        eval_fpses.append(ev["fps"])
        gs_nums.append(ev["num_points"])

    n = len(psnrs)
    logwriter.write(
        "Average: PSNR:{:.4f}, MS-SSIM:{:.4f}, Training:{:.4f}s, FPS:{:.4f}, gs_nums:{:.2e}".format(
            sum(psnrs) / n, sum(ms_ssims) / n, sum(train_times) / n,
            sum(eval_fpses) / n, sum(gs_nums) / n))
    return log_dir


if __name__ == "__main__":
    main(sys.argv[1:])
