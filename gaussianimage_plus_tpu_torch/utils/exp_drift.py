"""Reproducer: the first large float32 ``torch.exp`` of a fresh process on the CPU.

PyTorch's CPU ``exp`` of float32 runs MKL's vector math, split across
threads. In a fresh process it has returned one thread's chunk at ~1.5e-4
relative error: the rare failure of ``tests/test_torch_codec.py``'s stream
round trip, repaired in ``compress/quantizers.log_decompress`` (float64
``exp``, rounded once). This script starts ``--runs`` fresh processes, one
at a time or ``--jobs`` at once, and in each runs one operation first thing
after the imports, on seeded inputs:

- ``exp``: ``torch.exp`` of a float32 vector of ``--size`` log-grid values;
  reports its largest relative error against the float64 ``exp`` rounded to
  float32.
- ``log_decompress``: the repaired decoder on the same values; reports the
  same error (0 when it equals the rounding bit for bit).
- ``log_quantizer``: the QAT and encoder log quantizer
  (``compress/pipeline._log_fwd_masked``, float64 ``log`` and ``exp`` rounded
  once) on ``--size`` seeded variances; reports the largest relative error of
  its dequantized values and of its grid's ``beta`` against the float64
  ``exp`` / ``log`` rounded to float32 (0 when bit-equal).
- ``render``: the plain render (``core/render_tiled.render_table``, the
  kernels' CPU reference, float32 ``exp``) of one seeded binned scene,
  twice; reports the largest difference between the first and the second.

It prints one line per process and, last, the number of processes whose
error exceeds ``--tol`` (a correctly rounded float32 ``exp`` is within
6e-8, MKL's within about 1.1e-7; the drift was 1.5e-4)::

    python -m gaussianimage_plus_tpu_torch.utils.exp_drift --runs 20 --jobs 6
    python -m gaussianimage_plus_tpu_torch.utils.exp_drift --op log_quantizer --runs 60 --jobs 6
    python -m gaussianimage_plus_tpu_torch.utils.exp_drift --op render --runs 20 --jobs 6
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

OPS = ("exp", "log_decompress", "log_quantizer", "render")


def _log_grid(size: int, seed: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 codes, scale and beta of a log grid over [e^-4, e^4]."""
    rng = np.random.default_rng(seed)
    code = torch.as_tensor(rng.integers(0, 64, size).astype(np.float32))
    return code, torch.tensor(8.0 / 63.0), torch.tensor(-4.0)


def _rel_err(out: torch.Tensor, arg: torch.Tensor) -> float:
    ref = torch.exp(arg.double()).float()
    return float(((out - ref).abs() / ref.abs()).max())


def _render_twice(seed: int) -> float:
    from ..core.binning import bin_gaussians
    from ..core.gaussian2d import project_gaussians_2d_covariance
    from ..core.render_tiled import render_table
    from ..kernels.raster_binned import _prepare

    H, W, n = 128, 192, 600
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1).astype(np.float32)
    a, c = rng.uniform(2.0, 60.0, n), rng.uniform(2.0, 60.0, n)
    cov = np.stack([a, rng.uniform(-0.8, 0.8, n) * np.sqrt(a * c), c], -1).astype(np.float32)
    proj = project_gaussians_2d_covariance(torch.as_tensor(xy), torch.as_tensor(cov), H, W)
    bins = bin_gaussians(proj, H, W, cap=256)
    colors = torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    raw, counts = _prepare(proj.xys, proj.conics, colors, torch.ones(n), bins.ids, bins.mask)
    first = render_table(raw, counts, H, W, 16, 16)
    second = render_table(raw, counts, H, W, 16, 16)
    return float((first - second).abs().max())


def _log_quantizer(size: int, seed: int) -> float:
    from ..compress.pipeline import _log_fwd_masked

    rng = np.random.default_rng(seed)
    var = torch.as_tensor(np.exp(rng.uniform(-2.0, 6.0, (size // 2, 2))).astype(np.float32))
    active = torch.as_tensor(rng.uniform(size=size // 2) < 0.97)
    dq, code, grid = _log_fwd_masked(var, active, 10)
    log_ref = torch.log((var.abs() + 1e-6).double()).float()
    beta_ref = log_ref[active].min()
    beta_err = float((grid.beta - beta_ref).abs() / beta_ref.abs())
    return max(_rel_err(dq, code * grid.scale + grid.beta), beta_err)


def child(op: str, size: int, seed: int) -> float:
    """One fresh process's error (0.0 when bit-equal to the reference)."""
    if op == "render":
        return _render_twice(seed)
    if op == "log_quantizer":
        return _log_quantizer(size, seed)
    code, scale, beta = _log_grid(size, seed)
    arg = code * scale + beta
    if op == "exp":
        return _rel_err(torch.exp(arg), arg)
    from ..compress.quantizers import LogQuantState, log_decompress

    return _rel_err(log_decompress(LogQuantState(beta=beta, scale=scale), code), arg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", choices=OPS, default="exp")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--jobs", type=int, default=1, help="processes running at once")
    ap.add_argument("--size", type=int, default=14688, help="values (kodim01's covariances)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps({"op": args.op, "seed": args.seed,
                          "error": child(args.op, args.size, args.seed)}))
        return 0
    cmd = [sys.executable, "-m", __spec__.name, "--child", "--op", args.op,
           "--size", str(args.size)]
    drifted = 0
    for start in range(0, args.runs, args.jobs):
        procs = [subprocess.Popen(cmd + ["--seed", str(args.seed + i)], stdout=subprocess.PIPE,
                                  text=True)
                 for i in range(start, min(start + args.jobs, args.runs))]
        for p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"child failed with exit code {p.returncode}")
            res = json.loads(out.strip().splitlines()[-1])
            drifted += res["error"] > args.tol
            print(json.dumps(res), flush=True)
    print(json.dumps({"op": args.op, "runs": args.runs, "tol": args.tol, "drifted": drifted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
