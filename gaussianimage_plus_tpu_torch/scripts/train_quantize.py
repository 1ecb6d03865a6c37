"""Compression training CLI: the reference's train_quantize.py.

Port of ``scripts/train_quantize.py`` (after the reference
train_quantize.py:118-269): per image, the warmup fit, quantization-aware
fine-tuning, then the encoder with its bpp decomposition and the full
decode's time::

    python -m gaussianimage_plus_tpu_torch.scripts.train_quantize -d datasets/kodak \\
        --num_images 1 --model_path checkpoints/kodak/<run> --write_bitstream

``--model_path`` warm-starts each image's warmup from the fit CLI's
``<model_path>/<image>/gaussian_model`` (train_quantize.py:53-69, 367-377);
``--write_bitstream`` writes ``<log_dir>/<image>.gipb``, decodes it back and
reports ``bpp_stream`` and ``stream_psnr``. The log line's ``Eval time`` and
``FPS`` are the full decode's (``decode_full_time``, 100 decodes timed
back to back): the JAX script reads them from keys its
``encode_decode_eval`` does not return. ``--device`` as in ``train.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

EVAL_RENDERS = 100


def parse_args(argv):
    p = argparse.ArgumentParser(description="GaussianImage++ compression (PyTorch + CUDA)")
    p.add_argument("-d", "--dataset", type=str, default="datasets/kodak/")
    p.add_argument("--data_name", type=str, default="kodak")
    p.add_argument("--iterations", type=int, default=50000)
    p.add_argument("--warmup_iter", type=int, default=6000)
    p.add_argument("--prune_iter", type=int, default=100)
    p.add_argument("--grow_iter", type=int, default=5000)
    p.add_argument("--num_points", type=int, default=2500)
    p.add_argument("--max_num_points", type=int, default=5000)
    p.add_argument("--seed", type=int, default=3047)
    p.add_argument("--lr", type=float, default=0.018)
    p.add_argument("--loss_type", type=str, default="L2")
    p.add_argument("--SLV_init", type=lambda s: s.lower() != "false", default=True)
    p.add_argument("--color_norm", action="store_true")
    p.add_argument("--xy_bit", type=int, default=12)
    p.add_argument("--cov_bit", type=int, default=10)
    p.add_argument("--color_bit", type=int, default=6)
    p.add_argument("--xy_quant", type=str, default="lsq")
    p.add_argument("--cov_quant", type=str, default="lsq")
    p.add_argument("--color_quant", type=str, default="lsq")
    p.add_argument("--num_images", type=int, default=None)
    p.add_argument("--log_dir", type=str, default="./checkpoints_quant")
    p.add_argument("--log_every", type=int, default=10000)
    p.add_argument("--model_path", type=str, default=None,
                   help="directory of per-image fit checkpoints (<model_path>/<image>/"
                        "gaussian_model, as the fit CLI writes them) to warm-start from")
    p.add_argument("--write_bitstream", action="store_true",
                   help="write <log_dir>/<image>.gipb, decode it back, and report "
                        "bpp_stream and stream_psnr")
    p.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"],
                   help="default: the CUDA card")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return p.parse_args(argv)


def main(argv):
    """Run the CLI; returns the log directory and each image's
    ``encode_decode_eval`` statistics, by image name."""
    args = parse_args(argv)
    from ..compress.pipeline import QuantConfig
    from ..compress.trainer import encode_decode_eval, fit_image_quantized
    from ..core.precision import resolve_device
    from ..models.gaussian_image import GaussianConfig
    from ..train.trainer import TrainConfig
    from ..utils.checkpoint import load_checkpoint
    from ..utils.image_io import LogWriter, load_image

    dev = resolve_device("cpu" if args.cpu else args.device)
    log_dir = Path(args.log_dir) / args.data_name
    logwriter = LogWriter(log_dir)
    logwriter.write(json.dumps(vars(args)))

    names = [f"kodim{i + 1:02}.png" for i in range(24)]
    if args.data_name == "DIV2K_valid_HR":
        names = [f"{i + 1:04}.png" for i in range(800, 900)]
    if args.num_images:
        names = names[: args.num_images]

    agg, per_image = {}, {}
    for name in names:
        gt = load_image(Path(args.dataset) / name)
        H, W = gt.shape[:2]
        cfg = GaussianConfig(H=H, W=W, max_num_points=args.max_num_points,
                             slv=args.SLV_init, color_norm=args.color_norm)
        tcfg = TrainConfig(iterations=args.iterations, lr=args.lr,
                           prune_iter=args.prune_iter, grow_iter=args.grow_iter,
                           loss_type=args.loss_type)
        qcfg = QuantConfig(xy_bit=args.xy_bit, cov_bit=args.cov_bit,
                           color_bit=args.color_bit, xy_quant=args.xy_quant,
                           cov_quant=args.cov_quant, color_quant=args.color_quant)
        init_gs = None
        if args.model_path:
            ckpt = Path(args.model_path) / Path(name).stem / "gaussian_model"
            if ckpt.exists():
                init_gs, _ = load_checkpoint(ckpt, dev)
                logwriter.write(f"warm-start from {ckpt}")
        res = fit_image_quantized(gt, cfg, tcfg, qcfg, args.num_points,
                                  warmup_iter=args.warmup_iter, seed=args.seed,
                                  log_every=args.log_every, logger=logwriter,
                                  init_state=init_gs, device=dev)
        bs_path = (str(Path(args.log_dir) / f"{Path(name).stem}.gipb")
                   if args.write_bitstream else None)
        stats = encode_decode_eval(res.state, res.bundle, gt, cfg, qcfg,
                                   n_renders=EVAL_RENDERS, write_bitstream=bs_path)
        logwriter.write(
            "{} Eval time:{:.8f}s, FPS:{:.4f} PSNR:{:.4f}, MS_SSIM:{:.6f}, "
            "bpp:{:.4f} position_bpp:{:.4f}, cholesky_bpp:{:.4f}, feature_dc_bpp:{:.4f}".format(
                Path(name).stem, stats["decode_full_time"], stats["decode_full_fps"],
                stats["psnr"], stats["ms_ssim"], stats["bpp"],
                stats["position_bpp"], stats["cholesky_bpp"], stats["feature_dc_bpp"]))
        per_image[Path(name).stem] = stats
        for k, v in stats.items():
            agg.setdefault(k, []).append(float(v))

    n = len(agg.get("psnr", [1]))
    logwriter.write("Average: " + ", ".join(
        f"{k}:{sum(v) / n:.4f}" for k, v in agg.items()))
    return log_dir, per_image


if __name__ == "__main__":
    main(sys.argv[1:])
