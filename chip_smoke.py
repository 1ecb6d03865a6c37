#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gaussianimage_plus_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA card::

    python3 chip_smoke.py

It decodes every committed bitstream and renders every committed fitted
state through the port's entry points, on the card, at the flagship
configuration (768x512, ~5000 Gaussians, per-tile cap 256), and holds the two
hand-written CUDA kernels against their plain PyTorch versions. Phases:

1. card: name and power limit from ``nvidia-smi``, checked against torch;
2. build: both kernels from ``csrc/``, one ``nvcc`` per source, together;
3. kernel vs plain version on the card, at full width: kernel A
   (``tile_table_forward``) on kodim01's binned table, untrimmed (cap 256)
   and trimmed (bin-once); kernel B (``chunk_list_forward``) on a fitted
   state at kc 128 and kc 64 and on kodim01 in Morton order; both on a
   synthetic 500x760 grid. Tolerance: ``|kernel - plain| <= 2e-5 +
   1e-5 |plain|`` at every pixel but at most 0.01% of them, where the two
   evaluations of the expanded quadratic may round across the sigma >= 0 or
   alpha >= 1/255 gate;
4. main path, with every launch count set to 0 first: each of the 57
   committed streams (``results/bitstreams*/``: 48 lsq Kodak streams of
   rounds 3 and 4, 6 with VQ colour, 3 of format v1) through
   ``decode_bitstream`` (binned), ``prepare_decode`` + ``decode_frame`` and
   ``decode_bitstream(backend='list_t')``; each fitted ``repr_states`` state
   through ``render`` with ``raster_backend='auto'`` (asserted to resolve to
   ``list_t``) and ``'pallas'``. Checks: finite [512, 768, 3] images in [0, 1];
   the capped and cap-free paths agree (to the tolerance above) wherever no
   tile overflows the cap; kodim01's decode agrees with the dense oracle
   (``core/render_dense.py``, the reference's direct form: at least 80 dB, no
   pixel off by more than 5e-3, at most 1% beyond 2e-5); each kernel was
   launched;
5. timing with CUDA events: per frame (median of 50 frames) of the full
   decodes (parse included), the bin-once ``decode_frame`` and a fitted-state
   render; per call (50 calls back to back, median of 5 runs) of each kernel
   and each plain version on the card; and the device time of a full decode
   under ``torch.profiler``.

The last three lines of standard output are the kernels' JSON line, the
card's ``nvidia-smi`` name and power limit, and ``{"ok": true, ...}``. Any
failed check exits nonzero before those lines. A fuller report is written to
``chiprun_out/chip_smoke_report.json``. Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATOL, RTOL, MAX_FRAC = 2e-5, 1e-5, 1e-4
FRAMES = 50
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# float32 operations per (member, pixel) pair of both kernels: 5 FMAs for
# sigma (10), one exp, the opacity product and the min (3), 3 FMAs for the
# colour sums (6)
OPS_PER_PAIR = 19
PIX = 256

report: dict = {"phases": {}}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def compare(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Kernel output against its plain version on the same inputs; returns
    the largest absolute difference."""
    sync()
    check(out.shape == ref.shape, f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
    d = (out - ref).abs()
    bad = (d > ATOL + RTOL * ref.abs()).any(-1)
    n_bad, frac, mx = int(bad.sum()), float(bad.float().mean()), float(d.max())
    log(f"  {name}: max |kernel - plain| {mx:.3g}, {n_bad} pixels outside atol "
        f"({frac:.4%}), mean |out| {float(out.abs().mean()):.4f}")
    report["phases"].setdefault("kernel_vs_plain", []).append(
        dict(name=name, max_abs_err=mx, pixels_outside_atol=n_bad, frac=frac))
    check(frac <= MAX_FRAC, f"{name}: {n_bad} pixels outside atol {ATOL} (> {MAX_FRAC:.2%})")
    return mx


def median_ms(fn, frames: int = FRAMES, warmup: int = 3) -> float:
    """Median per-call time with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    sync()
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


def launch_ms(fn, launches: int = FRAMES, reps: int = 5) -> float:
    """Time per call of ``fn`` called back to back: CUDA events around
    ``launches`` calls, median of ``reps`` runs. The card stays busy while
    the host enqueues the next call, so the wrapper's host time hides behind
    a kernel that takes longer."""
    fn()
    sync()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / launches)
    return statistics.median(per_call)


def device_time_per_call(fn, calls: int = 10, top: int = 4):
    """Device time per call of ``fn`` under ``torch.profiler`` (the sum over
    the device-side events, kernels and copies), and the ``top`` entries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(rows, "torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows[:top]


def bound(members: int, nbytes: int) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs float32
    operations over the CUDA-core rate, in ms, and which one bounds."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = members * PIX * OPS_PER_PAIR / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed nothing")
    return out[0].strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import gaussianimage_plus_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script: {e}", file=sys.stderr)
        return 2
    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        print("chip_smoke: imported a port package from outside this checkout", file=sys.stderr)
        return 2
    try:
        run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        write_report()
        return 1
    return 0


def write_report() -> None:
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))


def run() -> None:
    from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream
    from gaussianimage_plus_tpu_torch.compress.pipeline import (
        _decode_attributes, decode_frame, morton_reorder, prepare_decode)
    from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
    from gaussianimage_plus_tpu_torch.core.gaussian2d import project_gaussians_2d_covariance
    from gaussianimage_plus_tpu_torch.core.render_dense import render_dense
    from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
    from gaussianimage_plus_tpu_torch.kernels import _build, raster_binned, raster_list
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi

    kernel_a, kernel_b = raster_binned.tile_table_forward, raster_list.chunk_list_forward
    plain_a, plain_b = raster_binned.tile_table_forward_plain, raster_list.chunk_list_forward_plain
    dev = torch.device("cuda")

    # ---- 1. card
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    check(kind in smi, f"nvidia-smi says {smi!r}, torch says {kind!r}")
    log(f"[1] card: {smi} (torch: {kind}, {torch.cuda.device_count()} visible); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    report["card"] = dict(nvidia_smi=smi, torch_name=kind, torch=torch.__version__,
                          cuda=torch.version.cuda)

    # ---- 2. build
    t0 = time.perf_counter()
    ptxas = _build.build_all(["tile_table_forward", "chunk_list_forward"])
    build_s = time.perf_counter() - t0
    log(f"[2] built both kernels in {build_s:.1f} s (sm_90a, one nvcc per source)")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"    {name}: {line.strip()}")
    report["build_s"] = build_s

    # ---- fixtures
    streams = sorted((ROOT / "results").glob("bitstreams*/*.gipb"))
    states = sorted((ROOT / "results").glob("repr_states_*/*.npz"))
    check(len(streams) == 57 and len(states) == 48,
          f"fixtures: {len(streams)} streams, {len(states)} states")
    kodim01 = (ROOT / "results" / "bitstreams_r4" / "kodim01.gipb").read_bytes()

    def stream_cfg(dec):
        return gi.GaussianConfig(H=dec.H, W=dec.W, max_num_points=dec.enc.active.shape[0],
                                 tile_cap=dec.qcfg.decode_cap or 256)

    def stream_inputs(dec, cfg, enc=None, bnd=None):
        enc = dec.enc if enc is None else enc
        bnd = dec.bound if bnd is None else bnd
        means, cov, colors = _decode_attributes(dec.bundle, enc, dec.qcfg)
        proj = gi.project(None, enc.active, bnd, cfg, cov_override=cov, means_override=means)
        return proj, colors, torch.ones((cfg.max_num_points,), device=dev)

    # ---- 3. kernel vs plain, full width
    log("[3] kernels against their plain versions on the card")
    err = {"a": 0.0, "b": 0.0}
    _, dec01 = decode_bitstream(kodim01, device=dev)
    cfg01 = stream_cfg(dec01)
    H, W = cfg01.H, cfg01.W
    prep_full = prepare_decode(dec01.bundle, dec01.enc, dec01.bound, cfg01, dec01.qcfg, trim=False)
    prep_trim = prepare_decode(dec01.bundle, dec01.enc, dec01.bound, cfg01, dec01.qcfg)
    log(f"  kodim01: {int(dec01.enc.num_active)} Gaussians, table K {prep_full.raw.shape[1]} "
        f"untrimmed / {prep_trim.raw.shape[1]} trimmed, {int(prep_trim.counts.sum())} members")
    for tag, prep in (("untrimmed cap 256", prep_full), ("trimmed bin-once", prep_trim)):
        err["a"] = max(err["a"], compare(f"A kodim01 {tag}", kernel_a(prep.raw, prep.counts, H, W),
                                         plain_a(prep.raw, prep.counts, H, W)))

    d_state = dict(np.load(states[0]))
    cfg_s = config_from_numpy(d_state)
    st = state_from_numpy(d_state, device=dev)
    proj_s = gi.project(st.params, st.active, st.bound, cfg_s)
    col_s = gi.colors_of(st.params, cfg_s)
    ones_s = torch.ones((cfg_s.max_num_points,), device=dev)
    for kc in (128, 64):
        inp = raster_list.list_inputs(proj_s, col_s, ones_s, cfg_s.H, cfg_s.W, kc)
        err["b"] = max(err["b"], compare(f"B {states[0].parent.name}/{states[0].stem} kc {kc}",
                                         kernel_b(*inp, kc, cfg_s.H, cfg_s.W),
                                         plain_b(*inp, kc, cfg_s.H, cfg_s.W)))
    enc_m, bound_m = morton_reorder(dec01.enc, dec01.bound, cfg01)
    proj_m, col_m, ones_m = stream_inputs(dec01, cfg01, enc_m, bound_m)
    inp_m = raster_list.list_inputs(proj_m, col_m, ones_m, H, W, 128)
    err["b"] = max(err["b"], compare("B kodim01 Morton order kc 128",
                                     kernel_b(*inp_m, 128, H, W), plain_b(*inp_m, 128, H, W)))

    # synthetic odd grid: 500x760 (32x48 tiles, ragged last row of tiles)
    rng = np.random.default_rng(0)
    Ho, Wo, No = 500, 760, 5000
    xy = np.stack([rng.uniform(0, Wo, No), rng.uniform(0, Ho, No)], -1).astype(np.float32)
    a, c = rng.uniform(2.0, 60.0, No), rng.uniform(2.0, 60.0, No)
    b = rng.uniform(-0.8, 0.8, No) * np.sqrt(a * c)
    cov = torch.as_tensor(np.stack([a, b, c], -1).astype(np.float32), device=dev)
    col_o = torch.as_tensor(rng.uniform(0, 1, (No, 3)).astype(np.float32), device=dev)
    ones_o = torch.ones((No,), device=dev)
    proj_o = project_gaussians_2d_covariance(torch.as_tensor(xy, device=dev), cov, Ho, Wo)
    bins_o = bin_gaussians(proj_o, Ho, Wo, cap=256)
    raw_o, counts_o = raster_binned._prepare(proj_o.xys, proj_o.conics, col_o, ones_o,
                                             bins_o.ids, bins_o.mask)
    err["a"] = max(err["a"], compare("A synthetic 500x760", kernel_a(raw_o, counts_o, Ho, Wo),
                                     plain_a(raw_o, counts_o, Ho, Wo)))
    inp_o = raster_list.list_inputs(proj_o, col_o, ones_o, Ho, Wo, 128)
    err["b"] = max(err["b"], compare("B synthetic 500x760 kc 128",
                                     kernel_b(*inp_o, 128, Ho, Wo), plain_b(*inp_o, 128, Ho, Wo)))

    # ---- 4. main path
    log("[4] main path: decode every committed stream, render every fitted state")
    kernel_a.launches = 0
    kernel_b.launches = 0
    t_main = time.perf_counter()
    agree_max = 0.0
    capped = []

    def agree(name, x, y):
        nonlocal agree_max
        d = (x - y).abs()
        bad = (d > ATOL + RTOL * y.abs()).any(-1)
        agree_max = max(agree_max, float(d.max()))
        check(float(bad.float().mean()) <= MAX_FRAC,
              f"{name}: {int(bad.sum())} pixels disagree beyond atol {ATOL}")

    def overflows(proj, cfg):
        """Some tile has more members than the cap (capped != cap-free)."""
        return int(bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap + 1).count.max()) > cfg.tile_cap

    def valid_image(name, img, shape):
        check(tuple(img.shape) == shape and img.dtype == torch.float32, f"{name}: shape {img.shape}")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, f"{name}: outside [0, 1]")

    for path in streams:
        name = f"{path.parent.name}/{path.stem}"
        data = path.read_bytes()
        img, dec = decode_bitstream(data, device=dev)           # binned (kernel A)
        cfg = stream_cfg(dec)
        valid_image(name, img, (dec.H, dec.W, 3))
        frame = decode_frame(prepare_decode(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg), cfg)
        img_l, _ = decode_bitstream(data, backend="list_t", device=dev)  # cap-free (kernel B)
        valid_image(name + " frame", frame, img.shape)
        valid_image(name + " list_t", img_l, img.shape)
        agree(name + " decode_frame vs decode", frame, img)
        proj, _, _ = stream_inputs(dec, cfg)
        if not overflows(proj, cfg):
            agree(name + " list_t vs binned", img_l, img)
        else:
            capped.append(name)
    for path in states:
        name = f"{path.parent.name}/{path.stem}"
        d = dict(np.load(path))
        cfg = config_from_numpy(d)
        check(gi.resolve_backend(cfg, dev) == "list_t", f"{name}: 'auto' resolved to "
              f"{gi.resolve_backend(cfg, dev)!r}")
        s = state_from_numpy(d, device=dev)
        img = gi.render(s, cfg)                                  # 'auto' -> list_t (kernel B)
        valid_image(name, img, (cfg.H, cfg.W, 3))
        img_p = gi.render(s, dataclasses.replace(cfg, raster_backend="pallas"))  # kernel A
        if not overflows(gi.project(s.params, s.active, s.bound, cfg), cfg):
            agree(name + " auto vs pallas", img, img_p)
        else:
            capped.append(name)
    sync()
    main_s = time.perf_counter() - t_main
    launches = {"a": kernel_a.launches, "b": kernel_b.launches}
    log(f"  {len(streams)} streams x 3 decode paths and {len(states)} states x 2 backends "
        f"in {main_s:.1f} s; launches: tile_table_forward {launches['a']}, "
        f"chunk_list_forward {launches['b']}; capped and cap-free paths agree to "
        f"{agree_max:.3g} (not compared, a tile overflows the cap: {', '.join(capped) or 'none'})")
    check(launches["a"] == 2 * len(streams) + len(states),
          f"kernel A launched {launches['a']} times in the main path")
    check(launches["b"] == len(streams) + len(states),
          f"kernel B launched {launches['b']} times in the main path")
    report["phases"]["main_path"] = dict(seconds=main_s, launches=launches,
                                         agree_max_abs=agree_max, overflowing=capped)

    # the dense oracle (direct form, independent of the tile table) on kodim01
    img01, _ = decode_bitstream(kodim01, device=dev)
    proj01, col01, ones01 = stream_inputs(dec01, cfg01)
    dense = render_dense(proj01, col01, ones01, H, W, tile_cap=cfg01.tile_cap, band_rows=16)
    d = (img01 - dense).abs()
    mse = float((d ** 2).mean())
    psnr = 10 * np.log10(1.0 / max(mse, 1e-20))
    frac = float(((d > ATOL).any(-1)).float().mean())
    log(f"  kodim01 decode vs dense oracle: max {float(d.max()):.3g}, {psnr:.1f} dB, "
        f"{frac:.3%} of pixels beyond {ATOL}")
    report["phases"]["dense_oracle"] = dict(max_abs=float(d.max()), psnr_db=psnr, frac=frac)
    check(psnr >= 80.0 and float(d.max()) <= 5e-3 and frac <= 0.01,
          "kodim01 decode disagrees with the dense oracle")

    # ---- 5. timing
    log(f"[5] times on the card, CUDA events: per frame, median of {FRAMES} frames; "
        f"kernels and plain versions per call, {FRAMES} calls back to back, median of 5 runs")
    inp_l = raster_list.list_inputs(*stream_inputs(dec01, cfg01), H, W, 128)
    times = {
        "frame: decode_bitstream binned (parse included)":
            median_ms(lambda: decode_bitstream(kodim01, device=dev)),
        "frame: decode_bitstream list_t (parse included)":
            median_ms(lambda: decode_bitstream(kodim01, backend="list_t", device=dev)),
        "frame: decode_frame (bin-once)": median_ms(lambda: decode_frame(prep_trim, cfg01)),
        "frame: render auto (list_t), fitted state": median_ms(lambda: gi.render(st, cfg_s)),
        "kernel A, kodim01 trimmed": launch_ms(lambda: kernel_a(prep_trim.raw, prep_trim.counts, H, W)),
        "kernel A, kodim01 untrimmed": launch_ms(lambda: kernel_a(prep_full.raw, prep_full.counts, H, W)),
        "plain A, kodim01 trimmed": launch_ms(lambda: plain_a(prep_trim.raw, prep_trim.counts, H, W)),
        "kernel B, kodim01 kc 128": launch_ms(lambda: kernel_b(*inp_l, 128, H, W)),
        "kernel B, kodim01 Morton kc 128": launch_ms(lambda: kernel_b(*inp_m, 128, H, W)),
        "plain B, kodim01 kc 128": launch_ms(lambda: plain_b(*inp_l, 128, H, W)),
    }
    for k, v in times.items():
        log(f"  {k}: {v:.4f} ms")
    report["times_ms"] = times

    # where a full decode's time goes: device time per frame under torch.profiler
    for backend in ("binned", "list_t"):
        busy, top = device_time_per_call(lambda: decode_bitstream(kodim01, backend=backend, device=dev))
        frame = times[f"frame: decode_bitstream {backend} (parse included)"]
        log(f"  decode_bitstream {backend}: device busy {busy:.4f} ms of a {frame:.4f} ms frame "
            f"({busy / frame:.1%}); top device time: "
            + "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in top))
        report.setdefault("decode_device_time", {})[backend] = dict(busy_ms=busy, frame_ms=frame,
                                                                    top=top)

    # bounds at the timed inputs: what this run's data needs
    members_a = int(prep_trim.counts.sum())
    bytes_a = members_a * 64 + prep_trim.counts.numel() * 4 + H * W * 3 * 4
    table, bbox, lst, cnt, lo2, hi2 = inp_l
    T = lst.shape[0]
    tb_x = -(-W // 16)
    t = torch.arange(T, device=dev)
    tx, ty = (t % tb_x).float()[:, None], (t // tb_x).float()[:, None]
    members_b = int(((tx >= bbox[None, :, 0]) & (tx < bbox[None, :, 1]) & (ty >= bbox[None, :, 2])
                     & (ty < bbox[None, :, 3]) & (table[None, :, 15] > 0)).sum())
    bytes_b = (table.numel() + bbox.numel() + lst.numel() + 3 * T) * 4 + H * W * 3 * 4
    for tag, inp in (("stream order", inp_l), ("Morton order", inp_m)):
        cnt, lo2, hi2 = inp[3:]
        rows = int((cnt + (hi2 - lo2).clamp(min=0)).sum()) * 128
        log(f"  kernel B on kodim01, {tag}: {rows} table rows visited over {T} tiles "
            f"({rows / members_b:.1f} per member)")
        report.setdefault("kernel_b_rows_visited", {})[tag] = rows
    bound_a, by_a = bound(members_a, bytes_a)
    bound_b, by_b = bound(members_b, bytes_b)
    kernels = [
        dict(name="tile_table_forward", route="cuda",
             source="gaussianimage_plus_tpu_torch/csrc/tile_table_forward.cu",
             replaces="gaussianimage_plus_tpu/kernels/raster_pallas.py:218 (_run_fwd); "
                      "gaussianimage_plus_tpu/kernels/raster_flat_pallas.py:82 "
                      "(rasterize_prepared_flat)",
             launches=launches["a"], max_abs_err=err["a"], ms=times["kernel A, kodim01 trimmed"],
             plain_ms=times["plain A, kodim01 trimmed"], bound_ms=bound_a, bound_by=by_a, library_ms=None,
             shape=f"kodim01 bin-once table {tuple(prep_trim.raw.shape)}, {members_a} members"),
        dict(name="chunk_list_forward", route="cuda",
             source="gaussianimage_plus_tpu_torch/csrc/chunk_list_forward.cu",
             replaces="gaussianimage_plus_tpu/kernels/raster_list_pallas.py:252 "
                      "(rasterize_list_pallas); gaussianimage_plus_tpu/kernels/"
                      "raster_list_pallas.py:376 (rasterize_list_t_pallas)",
             launches=launches["b"], max_abs_err=err["b"], ms=times["kernel B, kodim01 kc 128"],
             plain_ms=times["plain B, kodim01 kc 128"], bound_ms=bound_b, bound_by=by_b,
             library_ms=None,
             shape=f"kodim01 table {tuple(table.shape)}, kc 128, lmax {lst.shape[1]}, "
                   f"{members_b} members"),
    ]
    report["kernels"] = kernels
    write_report()
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
