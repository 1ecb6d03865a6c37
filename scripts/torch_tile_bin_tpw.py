"""Kernel E (``csrc/tile_bin.cu``) with one tile a warp against four a warp.

Builds two copies of the kernel, one that always launches ``TPW = 1`` and
one that always launches ``TPW = 4``, checks both against ``tile_bin_plain``
and times each with ``chip_smoke.device_ms_per_call`` (50 calls queued behind
a spin kernel, median of 5), in the order 1, 4, 4, 1, 1, 4, on:

- the committed 768x512 states ``results/repr_states_plain/kodim01-04``;
- the state of the smoke's binned fit (1000 steps, 'pallas' + kernel E);
- the smoke's 2K state (2040x1344, 20,000 Gaussians, 100 steps);
- the initial states of 2K-density fits (1.86 Gaussians a tile) on grids of
  2048 to 8192 tiles, to place the switch between the two.

Needs one CUDA card. Run from the repository root:

    python3 scripts/torch_tile_bin_tpw.py

Prints one line a state and writes ``chiprun_out/torch_tile_bin_tpw.json``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for  # noqa: E402
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy  # noqa: E402
from gaussianimage_plus_tpu_torch.kernels import _build, binning_tiles  # noqa: E402
from gaussianimage_plus_tpu_torch.models import gaussian_image as gi  # noqa: E402
from gaussianimage_plus_tpu_torch.train import trainer as tr  # noqa: E402

CAP = 256
# (H, W) of the synthetic grids: 2048, 3072, 4096, 6144 and 8192 tiles
GRIDS = [(512, 1024), (768, 1024), (1024, 1024), (1024, 1536), (1024, 2048)]
DENSITY = 20_000 / (84 * 128)   # the 2K state's Gaussians a tile


def build_variants(out: Path) -> dict:
    """Compile the two copies of ``tile_bin.cu`` at once; returns their
    libraries by tiles a warp."""
    src = (_build.CSRC / "tile_bin.cu").read_text()
    line = re.search(r"constexpr int kBigGrid = [^;]+;", src)
    if line is None:
        raise SystemExit("tile_bin.cu sets no kBigGrid")
    procs = {}
    for tpw, big in ((1, "1 << 30"), (4, "0")):
        cu = out / f"tile_bin_tpw{tpw}.cu"
        cu.write_text(src.replace(line.group(0), f"constexpr int kBigGrid = {big};"))
        procs[tpw] = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                       str(out / f"tile_bin_tpw{tpw}.so"), str(cu)])
    libs = {}
    for tpw, proc in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for TPW = {tpw}")
        libs[tpw] = ctypes.CDLL(str(out / f"tile_bin_tpw{tpw}.so"))
        binning_tiles._setup(libs[tpw])
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    def bbox_of(state, cfg):
        proj = gi.project(state.params, state.active, state.bound, cfg)
        tb = tile_bounds_for(cfg.H, cfg.W)
        return binning_tiles.tile_bbox_table(proj.xys, proj.radii, tb, proj.valid), tb

    states = {}
    gt = None
    for name in ("kodim01", "kodim02", "kodim03", "kodim04"):
        d = dict(np.load(ROOT / "results" / "repr_states_plain" / f"{name}.npz"))
        cfg = config_from_numpy(d)
        s = state_from_numpy(d, device=dev)
        states[name] = bbox_of(s, cfg)
        if gt is None:
            with torch.no_grad():
                gt = gi.render(s, cfg)
    cfg_fit = gi.GaussianConfig()
    cfg_bin = dataclasses.replace(cfg_fit, raster_backend="pallas", bin_method="pallas")
    res = tr.fit_image(gt, cfg_bin, tr.TrainConfig(**cs.FIT), cs.FIT_POINTS, seed=cs.FIT_SEED,
                       device=dev)
    states["binned fit"] = bbox_of(res.state, cfg_fit)
    h2, w2 = cs.K2_HW
    target2k = torch.as_tensor(np.kron(np.random.default_rng(1).uniform(0, 1, (84, 128, 3)),
                                       np.ones((16, 16, 1)))[:h2, :w2].astype(np.float32),
                               device=dev)
    cfg2k = gi.GaussianConfig(H=h2, W=w2, max_num_points=cs.K2_POINTS, raster_backend="pallas")
    res2k = tr.fit_image(target2k, cfg2k, tr.TrainConfig(iterations=cs.K2_STEPS,
                                                          prune_iter=cs.K2_STEPS),
                         cs.K2_POINTS, seed=cs.FIT_SEED, device=dev)
    states["2K"] = bbox_of(res2k.state, cfg2k)
    for h, w in GRIDS:
        n = round(DENSITY * (h // 16) * (w // 16))
        cfg = gi.GaussianConfig(H=h, W=w, max_num_points=n)
        ts = tr.init_train_state(cfg, tr.TrainConfig(), n, seed=cs.FIT_SEED, device=dev)
        states[f"init {w}x{h}"] = bbox_of(ts.gaussians, cfg)

    with tempfile.TemporaryDirectory(dir=ROOT / "build" if (ROOT / "build").is_dir() else None) as tmp:
        libs = build_variants(Path(tmp))

        def run(lib, bbox, tbx, tby):
            T = tbx * tby
            ids = torch.empty((T, CAP), dtype=torch.int32, device=dev)
            count = torch.empty((T,), dtype=torch.int32, device=dev)
            _build.check(_build.launch(dev, lib.tile_bin, bbox.data_ptr(), ids.data_ptr(),
                                       count.data_ptr(), bbox.shape[0], T, tbx, CAP), "tile_bin")
            return ids, count

        rows = {}
        for name, (bbox, (tbx, tby)) in states.items():
            ref = binning_tiles.tile_bin_plain(bbox, tbx, tby, CAP)
            for tpw, lib in libs.items():
                ids, count = run(lib, bbox, tbx, tby)
                if not (torch.equal(ids, ref[0]) and torch.equal(count, ref[1])):
                    raise SystemExit(f"{name}: TPW = {tpw} differs from tile_bin_plain")
            ms = {1: [], 4: []}
            for tpw in (1, 4, 4, 1, 1, 4):
                ms[tpw].append(cs.device_ms_per_call(lambda: run(libs[tpw], bbox, tbx, tby)))
            rows[name] = dict(tiles=tbx * tby, rows=bbox.shape[0],
                              blocks_tpw1=-(-tbx // 8) * tby, blocks_tpw4=-(-tbx // 32) * tby,
                              device_ms_tpw1=ms[1], device_ms_tpw4=ms[4])
            print(name, json.dumps(rows[name]), flush=True)
    smi = cs.nvidia_smi_line()
    print(smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_tile_bin_tpw.json").write_text(json.dumps(dict(card=smi, states=rows), indent=1))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"{time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
