"""Standalone bitstream decoder: ``.gipb`` -> PNG, with optional timing.

Counterpart of ``scripts/decode.py``. Usage::

    python -m gaussianimage_plus_tpu_torch.decode results/bitstreams_r4/kodim01.gipb \
        [-o out.png] [--backend binned|dense|sweep|range|list|list_t] [--time] \
        [--device cpu|cuda]

``--time`` measures on the card with CUDA events: after warm-up, the median
over 50 frames of the full decode (parse, dequantize, project, select,
render) with the chosen backend, and of the bin-once ``decode_frame``.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import torch

from .compress.bitstream import decode_bitstream
from .compress.pipeline import decode_frame, prepare_decode
from .models.gaussian_image import GaussianConfig
from .utils.image_io import save_image

FRAMES = 50


def _median_ms(fn, frames: int = FRAMES, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("bitstream")
    p.add_argument("-o", "--out", default=None, help="output PNG (default: <bitstream>.png)")
    p.add_argument("--backend", choices=["binned", "dense", "sweep", "range", "list", "list_t"], default=None)
    p.add_argument("--time", action="store_true", help="time the decode on the card")
    p.add_argument("--device", choices=["cpu", "cuda"], default=None,
                   help="default: the CUDA card")
    args = p.parse_args(argv)

    data = Path(args.bitstream).read_bytes()
    img, dec = decode_bitstream(data, backend=args.backend, device=args.device)
    out = args.out or (str(Path(args.bitstream).with_suffix("")) + ".png")
    save_image(img, out)
    print(f"{args.bitstream}: {dec.W}x{dec.H}, {int(dec.enc.num_active)} points, "
          f"{dec.bpp:.4f} bpp -> {out}", flush=True)

    if args.time:
        if img.device.type != "cuda":
            raise SystemExit("--time measures on the card; run with --device cuda")
        cfg = GaussianConfig(H=dec.H, W=dec.W, max_num_points=dec.enc.active.shape[0],
                             tile_cap=dec.qcfg.decode_cap or 256)
        full = _median_ms(lambda: decode_bitstream(data, backend=args.backend))
        prep = prepare_decode(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg)
        frame = _median_ms(lambda: decode_frame(prep, cfg))
        name = torch.cuda.get_device_name(0)
        print(f"{name}: full decode ({args.backend or 'binned'}, parse included) "
              f"{full:.3f} ms; bin-once decode_frame {frame:.4f} ms/frame "
              f"({1e3 / frame:.0f} FPS); median of {FRAMES}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
