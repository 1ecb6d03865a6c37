"""Where kernel A's time goes, and which schedule suits the card.

Builds ``scripts/torch_tile_forward_split.cu`` (the variants its header
lists: kernel A's earlier schedule over the gathered table and
through the slot ids, split into its loads and its arithmetic; schedules
with P pixels a thread, U rows in flight and an optional skip of rows no
pixel of a thread can pass, decided per thread or per warp; hybrids whose
block of 256 threads blends its 4 tiles 64 threads a tile, and a tile of
more than L live slots with all 256 threads; blocks that walk G tiles),
checks every full variant and the
package's kernel A bit for bit against ``tile_table_forward_plain`` on the
card, and times each with ``chip_smoke.device_ms_per_call`` (50 calls
queued behind a spin kernel, median of 5), in the order of the list and
then in reverse, on:

- kodim01's bin-once table (``prepare_decode``, trimmed), the
  ``decode_frame`` state;
- the state of the smoke's binned fit (1000 steps, 'pallas' + kernel E);
- the smoke's 2K state (2040x1344, 20,000 Gaussians, 100 steps, 'hier').

Beside them: each state's live slots per tile (max, p99, mean, empty
tiles), its (slot, pixel) pairs on the image, and the device time of what
the binned step did before kernel A read through the ids (the attribute table, the
int64 slot ids and the ``[T, K, 16]`` gather) against what it does now (the
table, the int32 slot ids, the counts), and of the gather alone.

Needs one CUDA card. Run from the repository root:

    python3 scripts/torch_tile_forward_split.py

Prints one line a state and writes ``torch_tile_forward_split.json`` into
``chip_smoke.py``'s output directory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
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
from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream  # noqa: E402
from gaussianimage_plus_tpu_torch.compress.pipeline import prepare_decode  # noqa: E402
from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians  # noqa: E402
from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for  # noqa: E402
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy  # noqa: E402
from gaussianimage_plus_tpu_torch.kernels import _build, raster_binned  # noqa: E402
from gaussianimage_plus_tpu_torch.models import gaussian_image as gi  # noqa: E402
from gaussianimage_plus_tpu_torch.train import trainer as tr  # noqa: E402

SRC = Path(__file__).resolve().with_suffix(".cu")


def build(out: Path) -> ctypes.CDLL:
    so = out / "tile_forward_variants.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
                          str(SRC)], capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if any(k in line for k in ("registers", "spill", "entry function")) or "error" in line.lower():
            print("   ", line.strip())
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.variant_count.restype = ctypes.c_int
    lib.variant_name.restype = ctypes.c_char_p
    lib.variant_name.argtypes = [ctypes.c_int]
    lib.run_variant.restype = ctypes.c_int
    lib.run_variant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                + [ctypes.c_void_p])
    return lib


def live_stats(counts: torch.Tensor, K: int, H: int, W: int) -> dict:
    """Live slots per tile and the (slot, pixel) pairs on the image."""
    tb_x, tb_y = tile_bounds_for(H, W)
    n = counts.clamp(0, K).double()
    t = torch.arange(tb_x * tb_y, device=counts.device)
    w = (W - (t % tb_x) * 16).clamp(max=16)
    h = (H - torch.div(t, tb_x, rounding_mode="floor") * 16).clamp(max=16)
    return dict(tiles=int(n.numel()), K=K, live=int(n.sum()), max=int(n.max()),
                p99=float(torch.quantile(n, 0.99)), p90=float(torch.quantile(n, 0.90)),
                mean=float(n.mean()), empty=int((n == 0).sum()),
                pairs=int((n * (w * h).double()).sum()))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    states = {}

    # kodim01's bin-once table: the decode_frame state
    data = (ROOT / "results" / "bitstreams_r4" / "kodim01.gipb").read_bytes()
    _, dec = decode_bitstream(data, device=dev)
    cfg01 = gi.GaussianConfig(H=dec.H, W=dec.W, max_num_points=dec.enc.active.shape[0],
                              tile_cap=dec.qcfg.decode_cap or 256)
    prep = prepare_decode(dec.bundle, dec.enc, dec.bound, cfg01, dec.qcfg)
    states["kodim01 bin-once"] = (prep.table, prep.ids, prep.counts, dec.H, dec.W)

    # the smoke's binned fit and 2K fit
    d_gt = dict(np.load(ROOT / "results" / "repr_states_plain" / "kodim01.npz"))
    with torch.no_grad():
        gt = gi.render(state_from_numpy(d_gt, device=dev), config_from_numpy(d_gt))
    cfg_fit = gi.GaussianConfig()
    cfg_bin = dataclasses.replace(cfg_fit, raster_backend="pallas", bin_method="pallas")
    res = tr.fit_image(gt, cfg_bin, tr.TrainConfig(**cs.FIT), cs.FIT_POINTS, seed=cs.FIT_SEED,
                       device=dev)
    h2, w2 = cs.K2_HW
    target2k = torch.as_tensor(np.kron(np.random.default_rng(1).uniform(0, 1, (84, 128, 3)),
                                       np.ones((16, 16, 1)))[:h2, :w2].astype(np.float32),
                               device=dev)
    cfg2k = gi.GaussianConfig(H=h2, W=w2, max_num_points=cs.K2_POINTS, raster_backend="pallas")
    res2k = tr.fit_image(target2k, cfg2k, tr.TrainConfig(iterations=cs.K2_STEPS,
                                                          prune_iter=cs.K2_STEPS),
                         cs.K2_POINTS, seed=cs.FIT_SEED, device=dev)
    prep_in = {}
    for name, state, cfg, method in (("binned fit", res.state, cfg_fit, "top_k"),
                                     ("2K", res2k.state, cfg2k, cfg2k.bin_method)):
        proj = gi.project(state.params, state.active, state.bound, cfg)
        colors = gi.colors_of(state.params, cfg)
        bins = bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap, method=method)
        ones = torch.ones((proj.xys.shape[0],), device=dev)
        args = (proj.xys, proj.conics, colors, ones, bins.ids, bins.mask)
        prep_in[name] = args
        states[name] = (*raster_binned._slot_table(*args), cfg.H, cfg.W)

    rows = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build" if (ROOT / "build").is_dir() else None) as tmp:
        lib = build(Path(tmp))
        names = [lib.variant_name(v).decode() for v in range(lib.variant_count())]
        for sname, (table, ids, counts, H, W) in states.items():
            T, K = ids.shape
            tb_x, _ = tile_bounds_for(H, W)
            raw = raster_binned._gather(table, ids).contiguous()
            out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)

            def run(v, out=out, raw=raw, table=table, ids=ids, counts=counts, T=T, K=K,
                    tb_x=tb_x, H=H, W=W):
                src = raw if names[v].startswith("parent raw") else table
                _build.check(_build.launch(dev, lib.run_variant, v, src.data_ptr(), ids.data_ptr(),
                                           counts.data_ptr(), out.data_ptr(), T,
                                           table.shape[0] - 1, K, tb_x, H, W), names[v])
                return out

            ref = raster_binned.tile_table_forward_plain(table, ids, counts, H, W)
            equal = {}
            for v, name in enumerate(names):
                if "only" not in name:
                    equal[name] = bool(torch.equal(run(v).clone(), ref))
            pkg = raster_binned.tile_table_forward(table, ids, counts, H, W)
            equal["package kernel A"] = bool(torch.equal(pkg, ref))
            ms = {name: [] for name in names}
            order = list(range(len(names)))
            for v in order + order[::-1]:
                ms[names[v]].append(cs.device_ms_per_call(lambda v=v: run(v)))
            ms["package kernel A"] = [cs.device_ms_per_call(
                lambda: raster_binned.tile_table_forward(table, ids, counts, H, W))
                for _ in range(2)]
            prep_ms = {}
            ids64 = ids.to(torch.int64)
            prep_ms["gather table[ids] alone"] = cs.device_ms_per_call(lambda: table[ids64])
            if sname in prep_in:
                a = prep_in[sname]
                n_rows = a[0].shape[0]

                def parent_prep():
                    ids_s = torch.where(a[5], a[4].to(torch.int64),
                                        torch.full_like(a[4], n_rows, dtype=torch.int64))
                    ids_s = torch.nn.functional.pad(ids_s, (0, K - ids_s.shape[1]), value=n_rows)
                    return (raster_binned._build_table(*a[:4])[ids_s],
                            a[5].sum(dim=1, dtype=torch.int32))

                prep_ms["parent: table, int64 slot ids, gather, counts"] = cs.device_ms_per_call(
                    parent_prep)
                prep_ms["now: table, int32 slot ids, counts"] = cs.device_ms_per_call(
                    lambda: raster_binned._slot_table(*a))
            rows[sname] = dict(stats=live_stats(counts, K, H, W), bit_equal=equal, device_ms=ms,
                               prep_device_ms=prep_ms)
            print(sname, json.dumps(rows[sname]), flush=True)
    smi = cs.nvidia_smi_line()
    print(smi)
    cs.write_report("torch_tile_forward_split.json", dict(card=smi, states=rows))
    bad = [(s, n) for s, r in rows.items() for n, ok in r["bit_equal"].items() if not ok]
    if bad:
        print(f"not bit-equal to the plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"{time.perf_counter() - t0:.1f} s")
    sys.exit(rc)
