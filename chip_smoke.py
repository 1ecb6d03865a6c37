#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``gaussianimage_plus_tpu_torch``) on one card.

Run from the root of a checkout, on a machine with one NVIDIA card::

    python3 chip_smoke.py

It decodes every committed bitstream and renders every committed fitted
state through the port's entry points, on the card, at the flagship
configuration (768x512, ~5000 Gaussians, per-tile cap 256), fits 768x512
images through the cap-free and the binned trainers, a 752x496 crop (an odd
tile grid) and a 2040x1344 image (20,000 Gaussians), runs the coding path
(QAT, the encoder, the ``.gipb`` written and decoded back), and holds the
six hand-written CUDA kernels against their plain PyTorch versions. Phases:

1. card: name and power limit from ``nvidia-smi``, checked against torch;
2. build: the six kernels from ``csrc/``, one ``nvcc`` per source, together;
3. kernel vs plain version on the card, at full width: kernel A
   (``tile_table_forward``: a block of 128 threads a tile reads the tile's
   rows of the attribute table through the slot ids, a thread 2 pixels of
   a column) on kodim01's slot ids, untrimmed (cap 256) and trimmed
   (bin-once), on a synthetic 500x760 grid and (after phase 4) on the binned
   fit state after growth and the 2K state: bit-equal to its plain version
   (the same sigma chain, each pixel's rows in slot order). Kernel B
   (``chunk_list_forward``) on a fitted
   state at kc 128 and kc 64 and on kodim01 in Morton order, and over the
   dense, sweep and range enumerations on kodim01 in stream and Morton order
   and on the fitted state, on the synthetic grid and on the converged
   2040x1344 state (``results/repr_states_2k/mosaic2k.npz``, Morton order,
   kc 128). Tolerance: ``|kernel - plain| <= 2e-5 +
   1e-5 |plain|`` at every pixel but at most 0.01% of them, where the two
   evaluations of the expanded quadratic may round across the sigma >= 0 or
   alpha >= 1/255 gate. Kernel C (``chunk_backward``: a block's warps share
   its rows' (row, bbox tile) pairs and sum in Gaussian-centred offsets) on a
   fitted state in Morton order at kc 128 and kc 64, on kodim01 in stream
   order, through ``dense_backward``, on the synthetic grid and on the 2K
   state (two seeded normal cotangents); kernel D
   (``tile_table_backward``) on kodim01's binned table, on the synthetic grid
   (ragged edge tiles), on a synthetic tile forced over its cap (kernel B on
   it too: more members than its shared list holds), and (after
   phase 4) on the binned fit state after growth and on the 2K state; each
   with the L2 cotangent ``2 (render - target) / (3 H W)`` and a seeded normal
   one. Tolerance, per payload column: ``max |kernel - plain| <= 1e-4 max
   |plain|`` (the gate is bit-equal, the sums run in another order); two
   launches give the same bits. Kernel E (``tile_bin``: a block filters the
   bbox table down to the ids over a window of one tile row, and each tile's
   warp picks its members from that list) against the ``'top_k'``
   selection on kodim01's fitted state, the synthetic tile over its cap and
   (after phase 4) the fit and 2K states: ids, mask and count equal exactly,
   and equal to ``'hier'`` wherever its ``super_overflow`` is 0;
4. main paths, each with every launch count set to 0 just before it and read
   just after. ``fit_image``, ``fit_image_quantized`` and ``fit_batch`` run
   their chunks as replays of one captured CUDA graph wherever ``render``
   runs through a kernel (``train.trainer.captures``: every path of this
   phase, the odd grid's ``'pallas'`` + ``'top_k'`` and the 2K ``'hier'``
   fit among them); the launch counts equal an eager run's. Decode: each of the 57 committed streams
   (``results/bitstreams*/``: 48 lsq Kodak streams of rounds 3 and 4, 6 with
   VQ colour, 3 of format v1) through ``decode_bitstream`` (binned),
   ``prepare_decode`` + ``decode_frame`` and
   ``decode_bitstream(backend='list_t')``; each fitted ``repr_states`` state
   through ``render`` with ``raster_backend='auto'`` (asserted to resolve to
   ``list_t``) and ``'pallas'``. Checks: finite [512, 768, 3] images in [0, 1];
   the capped and cap-free paths agree (to the tolerance above) wherever no
   tile overflows the cap; kodim01's decode agrees with the dense oracle
   (``core/render_dense.py``, the reference's direct form: at least 80 dB, no
   pixel off by more than 5e-3, at most 1% beyond 2e-5); each kernel was
   launched. Fit: ``fit_image`` of the port's render of
   ``results/repr_states_plain/kodim01.npz`` from 2500 random Gaussians, 1000
   steps, a prune every 100 and one growth with the final fill at step 500
   (up to 5000), ``'auto'`` asserted to resolve to ``list_t``. Checks: kernel
   C launched once a step and kernel B at least once; the growth added
   Gaussians; finite PSNRs; best PSNR at least 5 dB above the first step's.
   Then 100 steps from one initial state through ``'auto'`` (kernels B and C)
   and through ``'xla'`` (the plain binned path and its VJP, cap 256, no
   tile over the cap): their PSNRs agree within 0.05 dB at every step.
   (a) Binned fit: the same fit through ``raster_backend='pallas'``,
   ``bin_method='pallas'`` (kernels A, D and E once a step each; grows; best
   PSNR 5 dB above the first step's). (b) The same 100 steps through
   ``'pallas'`` + kernel E: within 0.05 dB of ``'xla'`` at every step.
   (c) Odd grid: ``fit_image`` of the top-left 496x752 crop (47x31 = 1457
   tiles), ``'auto'`` asserted to resolve to ``'pallas'`` (binning with
   ``'top_k'``), 2500 Gaussians of at most 5000, 200 steps, a prune every 100
   (kernel D once a step; best PSNR 3 dB above the first step's). (d) 2K:
   ``fit_image`` at 1344x2040 with 20,000 Gaussians, 100 steps through
   ``'pallas'``, a prune every 50, ``bin_method='auto'`` asserted to pick
   ``'hier'``; the target is ``bench.py``'s seeded block image, made
   with numpy (finite losses; ``super_overflow`` reported). (e) Every fitted
   state through ``render_fast`` with the dense, sweep and range kernels
   against ``'list_t'`` (the forward tolerance), and one state's gradients
   through ``render`` with ``'dense'`` and ``'sweep'`` against ``'list_t'``'s
   (kernel C's tolerance, per parameter column). (f) The coding path:
   ``fit_image_quantized`` at 768x512 with the default ``QuantConfig``,
   warm-started from the ``'auto'`` fit's best state, 100 warmup steps (one
   prune, no growth) and 1000 QAT steps through ``'auto'`` (asserted
   ``list_t``; kernels B and C once a step; finite PSNRs; the best at or
   above the first QAT step's); 100 QAT steps, each through ``'auto'`` and
   through ``'xla'`` from the plain path's state, whose PSNRs (of the step's
   render and of the state it makes) agree within 0.05 dB; ``encode_decode_eval``
   writing the ``.gipb`` in id and in Morton order (``bpp`` equals
   ``analysis_wo_ec``'s formula, ``bpp_stream`` under it, the stream's PSNR
   within 1e-4 / 1e-3 dB of the encoding's, which is within 0.05 dB of the best
   QAT PSNR), the bytes decoded through ``decode_bitstream`` (kernel A),
   ``prepare_decode`` + ``decode_frame`` (A) and ``backend='list_t'`` (B) to
   images that agree to the forward tolerance; a VQ-colour run (200 QAT
   steps, encoded, written, decoded back to the encoding's PSNR); and
   ``evaluate`` on the QAT state. (g) The entry points, on an 8-bit PNG of
   the fit's target in a temporary directory: (g1) the fit CLI
   (``scripts.train.main``, 1000 steps, 2500 -> 5000 points, growth at 500,
   ``--save_imgs``): its ``train.txt`` lines in the JAX CLI's format, B and
   C once a step, ``evaluate`` of its ``gaussian_model`` repeating the logged
   PSNR, at least 20 dB; (g2) ``fit_image`` uninterrupted, stopped at 300
   with a checkpoint every 100, and resumed: ``torch.equal`` to each other
   and to (g1)'s ``gaussian_model``, and resume of the completed run; the
   save and load time of a ``TrainState`` at the fit's best state; (g3) the
   Cholesky model with Adan (the fit CLI's remap: lr 1e-3, no growth, no
   pruning; means drawn in atanh space over the image), 1000 steps through
   ``'auto'`` (B and C once a step, the best PSNR 3 dB above the first
   step's), 100 steps from one start through ``'auto'`` and ``'xla'``
   within 0.05 dB at every step, and the fit CLI with ``--model_name GaussianImage_RS``
   for 200 steps; (g4) the quantize CLI warm-started from (g1), 100 warmup
   and 200 QAT steps, ``--write_bitstream``: the ``.gipb`` through
   ``decode.main`` (kernel A) and ``decode_bitstream(backend='list_t')``
   (kernel B) within 1e-4 dB of the encoder's PSNR; (g5) the eval CLI at
   cap 256 on (g2)'s ``fit_ckpt`` within 1e-4 dB of ``evaluate``, with a
   random-weight LPIPS ``.npz`` whose value on the card is within 1e-4 of
   the CPU's. (g) repeats paths whose launches phase 4 counts already: its
   launches are reported apart (``report["phases"]["entry points"]``) and
   left out of ``launches_by_state`` and ``loss_ms``. Then, in a NCCL
   process group of one: (p1) ``parallel.fit_batch`` of the renders of the
   first four landscape committed states (``repr_states_plain/kodim01``,
   ``02``, ``03``, ``05``), seeds 3047-3050,
   ``'auto'`` (kernels B and C), 300 steps with a prune every 50 and the
   growth at 150, each chunk of the block one graph replay: each image's
   final train state, per-chunk metrics and the launch counts
   ``torch.equal`` to the same chunk schedule run on it alone, eagerly, each
   best PSNR 5 dB above its first step's; (p2) 100 steps through
   ``make_tile_sharded_render`` and through ``'xla'`` from one state, within
   0.05 dB at every step, and ``fit_image_tile_sharded`` (200 steps, a prune
   every 100, the growth at 100) rising 5 dB, with its step time and peak
   memory; (p3) the 2K fit's state through one sharded render with
   ``bin_method='hier'`` (band budget 4096): within 1e-5 of the unsharded
   ``'xla'`` render (flat ``'top_k'`` bins), ``super_overflow`` 0, its
   gradient within 1e-4 of each column's max of the unsharded one; (l1) the legacy 3DGS model at 768x512 (5000 points, SH
   degree 3): 20 steps on the card and on the CPU from one start within 0.05
   dB at every step, then 300 Adam steps on the card (the loss falls, the
   PSNR rises), its step time and device busy share; (l2)
   ``pixel_count_map`` at the fit state on the card against the CPU's (at
   most 0.01% of pixels differ). Their launches are reported apart too
   (``report["phases"]["parallel"]``, ``["legacy"]``). (h) The fused
   dispatch (run after phase 5's timings, so that those keep their
   protocol): the Kodak ``'auto'`` fit run again graphed, ``torch.equal``
   (best state, history) to phase 4's and to the same schedule run eagerly
   through ``train_chunk``, launches equal, with both wall times and peak
   memories; the graphed fits of phases (a) (binned), (c) (the odd grid) and
   (d) (2K ``'pallas'`` + ``'hier'``) and phase (f)'s coding path
   ``torch.equal`` to their schedules run eagerly (``train_chunk``,
   ``quant_train_chunk``), launches equal; a ``'dense'`` and a ``'sweep'``
   macro chunk (3 x 20 steps) at the Kodak fit state and 3 x 20 QAT steps on
   the odd grid, each ``torch.equal`` to its chunks run eagerly; phase (p1)'s
   ``fit_batch`` against each image alone (held there); a 2040x1344
   ``'auto'`` fit (B + C, 10,000 -> 20,000 rows, 100 steps, a prune every
   50) on the render of the 2K state, graphed and eager ``torch.equal``,
   rising 1 dB; then, for the Kodak ``'auto'``, ``'pallas'`` + E,
   ``'dense'`` and ``'sweep'`` steps, the odd grid's, the 2K ``'hier'`` and
   ``'auto'`` steps, QAT at 768x512 and on the odd grid, and ``fit_batch``'s
   block of four, the step time of 5 replayed chunks (CUDA events), the
   capture's time, the replays' device busy (profiler) beside the eager
   median of 50 steps at the same state.
   Its launches are reported apart (``report["phases"]["fused dispatch"]``);
5. timing with CUDA events: per frame (median of 50 frames) of the full
   decodes (parse included), the bin-once ``decode_frame`` and a fitted-state
   render; per train step (median of 50) after the growth, through ``'auto'``
   (kernels B and C; with Adam, then with Adan, both before the process's
   first profiler session, and with Adam again after the profiler sessions),
   ``'xla'`` (the plain path) and ``'pallas'`` with
   ``'top_k'`` and with kernel E binning, and the 2K step; per call (50 calls
   back to back, median of 5 runs) of each kernel, each plain version and
   ``torch.topk`` on kernel E's key (the kernels' JSON ``ms``); beside it
   each kernel's own device time per call, the same 50 calls queued behind
   a spin kernel so that the card never waits for the host (the JSON
   ``device_ms``: back to back, a kernel that runs faster than its Python
   wrapper is timed by the host); each kernel at every state its main-path
   launches run at: A at kodim01's bin-once table and the binned tables of
   the fit and 2K states, B at kodim01 (each enumeration) and the timed fit
   state, with the table rows each visits, C at the fit state and kodim01's
   stream-order table, D at the fit state, kodim01's binned table and the 2K
   state, with its live slots, largest tile bbox and each stage's device time
   under ``torch.profiler``, E at the fit, kodim01 and 2K states; at A's
   three states the ``[T, K, 16]`` gather ``table[ids]`` that fed kernel A
   before it read through the slot ids, timed alone (A's ``library_ms``: the
   port no longer runs it); kernel F (``chunk_lists``, the chunk-list
   enumeration) at the timed fit state and the 2K state, its lists equal to
   the plain enumeration's, both sides' device time a call and F's bound
   (its bytes), as the JSON's sixth row;
   per kernel
   and state the launches of phase 4's paths (the odd-grid fit's taken at
   the fit state, path (e)'s gradients at kodim01's), the bound, and
   ``loss_ms`` = the sum over states of launches x (device_ms - bound_ms),
   which ranks the kernels for redesign; and the device time of a full
   decode and of each train step under the profiler, with every gather
   among a step's entries. The coding path: a QAT step (median of 50) and
   its device time under the profiler, the encoder (``compress_wo_ec`` +
   ``serialize_bitstream``), the full decode of the stream it wrote, and
   kernels A, B and C at the QAT state (B and C on the quantized overrides
   of the QAT result, A on the written stream's binned table), where the
   coding path's launches are counted.
   In some runs the profiler traces none of the kernels launched through the
   port's own libraries: the log then names them, and D's stages are not
   measured.

Each kernel's row in the JSON line carries ``device_ms_by_state``,
``ms_by_state``, ``launches_by_state``, ``bound_ms_by_state`` and
``loss_ms`` beside its single-state ``ms``, ``device_ms`` and ``bound_ms``.
The last six lines of standard output are phase (g)'s numbers, phases
(p) and (l)'s, phase (h)'s, the kernels' JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, ...}``. Any
failed check exits nonzero before those lines. A fuller report is written to
``chiprun_out/chip_smoke_report.json``. Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATOL, RTOL, MAX_FRAC = 2e-5, 1e-5, 1e-4
FRAMES = 50
SPIN_CYCLES = 20_000_000   # ~10 ms of torch.cuda._sleep on the H100
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# float32 operations per (member, pixel) pair of both kernels: 5 FMAs for
# sigma (10), one exp, the opacity product and the min (3), 3 FMAs for the
# colour sums (6)
OPS_PER_PAIR = 19
# kernel C: the gate, as in the forward, at every (member, pixel) pair on the
# image (13); then, only where the gate passes, v_alpha = rgb . v_out (5), 3
# FMAs for v_rgb (6), the sign and product of v_sigma (2), an FMA for v_opac
# (2), 5 FMAs and an add for the moments (11). The pixel features px*py and
# py^2 depend on the lane alone and are not counted, as in the forward.
OPS_GATE_C, OPS_PASS_C = 13, 26
PIX = 256
C_REL = 1e-4          # kernel C: per payload column, |kernel - plain| <= C_REL max |plain|
FIT = dict(iterations=1000, prune_iter=100, grow_iter=500)
FIT_POINTS, FIT_SEED = 2500, 3047
AGREE_STEPS, AGREE_DB = 100, 0.05
# the coding path: warmup and QAT steps (the reference runs 6000 and 44,000),
# the 'auto' vs 'xla' QAT steps, the VQ run's QAT steps, timed full decodes
QAT = dict(warmup_iter=100, steps=1000)
QAT_AGREE_STEPS, VQ_STEPS, CODING_RENDERS = 100, 200, 50
ODD_HW, ODD_FIT, ODD_RISE_DB = (496, 752), dict(iterations=200, prune_iter=100), 3.0
K2_HW, K2_POINTS, K2_STEPS = (1344, 2040), 20_000, 100
# phase 4 (g), the entry points: the fit CLI's schedule (the reference runs
# 50,000 steps), the stop before its growth, the Cholesky + Adan fit's steps
# and its rise, the RS run of the fit CLI, the quantize CLI's warmup and QAT
# steps (the reference: 6000 and 44,000), the CLI's default points and cap
ENTRY = dict(iterations=1000, prune_iter=100, grow_iter=500, log_every=500, stop=300,
             adan_steps=1000, adan_rise_db=3.0, rs_iterations=200, warmup=100, qat=200)
ENTRY_POINTS, ENTRY_MAX, ENTRY_DB = 2500, 5000, 20.0
# phase 4 (p), parallel/ in a NCCL group of one: fit_batch's images and schedule
# (the growth at 150 has to end a chunk, so a prune every 50), the sharded
# step's agreement steps, the sharded fit's schedule (growth at 100); the rise
# each must show; the 2K render's band budget (a full-width band of 4 tile rows
# of the 2K grid can hold more candidates than the default 1024)
PAR = dict(images=4, max_points=5000, iterations=300, prune_iter=50, grow_iter=150, rise_db=5.0,
           agree_steps=100, fit=dict(iterations=200, prune_iter=100, grow_iter=100),
           fit_rise_db=5.0, super_cap_2k=4096)
# phase 4 (l), the legacy 3DGS model at 768x512: points, SH degree, the steps
# held card against CPU, the Adam steps on the card; the pixel-count ties allowed
LEGACY = dict(points=5000, sh_degree=3, agree_steps=20, steps=300)
COUNT_FRAC = 1e-4
# phase 4 (h), the fused dispatch: the converged 2K state whose render is the
# 2K fit's target, that fit's points (scripts/fit_2k.py's), steps and rise;
# the Kodak fit's rise (phase 4's); the chunk replays timed a route; the
# macro chunks of 'dense', 'sweep' and the odd grid's QAT held against eager
STATE_2K = ROOT / "results" / "repr_states_2k" / "mosaic2k.npz"
FUSED = dict(k2_points=10_000, k2_fit=dict(iterations=100, prune_iter=50), k2_rise_db=1.0,
             rise_db=5.0, replays=5, chunks=3, chunk=20)

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


def compare_payload(name: str, kernel, plain, args) -> float:
    """Kernel C against its plain version on the same inputs, per payload
    column, and two launches against each other, bit for bit; returns the
    largest absolute difference."""
    out, again = kernel(*args), kernel(*args)
    ref = plain(*args)
    sync()
    check(out.shape == ref.shape, f"{name}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
    check(torch.equal(out, again), f"{name}: two launches differ")
    check(not bool(out[:, 9:].any()), f"{name}: padding columns not zero")
    d = (out[:, :9] - ref[:, :9]).abs().amax(dim=0)
    scale = ref[:, :9].abs().amax(dim=0)
    rel = float((d / scale.clamp(min=1e-30)).max())
    mx = float(d.max())
    log(f"  {name}: max |kernel - plain| {mx:.3g}, worst column {rel:.3g} of its max; "
        f"two launches bit-equal")
    report["phases"].setdefault("kernel_vs_plain", []).append(
        dict(name=name, max_abs_err=mx, worst_column_rel=rel))
    check(bool((d <= C_REL * scale).all()), f"{name}: a payload column is off by more than "
          f"{C_REL} of its max ({rel:.3g})")
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


def device_time_per_call(fn, calls: int = 10, kernels=()):
    """Device time per call of ``fn`` under ``torch.profiler`` (the sum over
    the device-side events, kernels and copies), every entry by name, most
    time first, and which of the port's CUDA functions ``kernels`` (names) it
    did not trace:
    in some runs on the H100 the profiler has traced torch's kernels and
    none of those launched through the port's own libraries, and the sum
    then leaves them out."""
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
    rows.sort(key=lambda r: -r[1])
    missing = [k for k in kernels if not any(k in name for name, _ in rows)]
    return sum(ms for _, ms in rows), rows, missing


def device_ms_per_call(fn, calls: int = FRAMES, reps: int = 5) -> float:
    """A kernel's own device time per call, with the host's time hidden:
    ``calls`` calls between two CUDA events, queued behind a spin kernel
    (``torch.cuda._sleep``, doubled until it outlasts the host's queueing)
    so that the card runs them back to back without waiting for the host;
    median of ``reps`` runs. Back to back (``launch_ms``) the card waits for
    a wrapper whose host time exceeds its kernel's."""
    fn()
    sync()
    per_call = []
    cycles = SPIN_CYCLES
    while len(per_call) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        spun_long_enough = not start.query()
        end.synchronize()
        if spun_long_enough:
            per_call.append(start.elapsed_time(end) / calls)
        else:
            check(cycles < 64 * SPIN_CYCLES, f"the host took {host_ms:.1f} ms to queue {calls} calls")
            cycles *= 2
    return statistics.median(per_call)


def kernel_f(states: dict) -> dict:
    """Kernel F (``raster_list.chunk_lists``) against the plain enumeration
    (``chunk_lists_plain``: the [T, Np] membership, its ``any`` and ``topk``)
    at each state ``tag: (table, bbox, Np, kc, lmax, H, W)``: the lists,
    counts and member counts equal, both sides' device time a call (queued)
    and the kernel's back to back, and its bound, its bytes: the bbox and
    valid column read (20 B a row), the marks written and read (T * nch
    bytes each way) and the lists written ((lmax + 4) x 4 B a tile)."""
    from gaussianimage_plus_tpu_torch.kernels import raster_list

    rows = {}
    for tag, args in states.items():
        table, _, Np, kc, lmax, h, w = args
        (lst, cnt, lo2, hi2), members = raster_list.chunk_lists(*args)
        want = raster_list.chunk_lists_plain(*args)
        sync()
        check(all(torch.equal(a, b) for a, b in zip((lst, cnt, lo2, hi2, members),
                                                     (*want[0], want[1]))),
              f"kernel F, {tag}: the lists differ from the plain enumeration's")
        T, nch = lst.shape[0], Np // kc
        b_ms, b_by = bound(0, table.shape[0] * 20 + 2 * T * nch + T * (lmax + 4) * 4)
        # the plain chain launches ~30 kernels a call: 50 calls queued behind
        # the spin kernel would fill the card's queue of pending launches and
        # make the host wait for the spin; 10 stay inside it
        row = dict(ms=launch_ms(lambda a=args: raster_list.chunk_lists(*a)),
                   device_ms=device_ms_per_call(lambda a=args: raster_list.chunk_lists(*a)),
                   plain_device_ms=device_ms_per_call(
                       lambda a=args: raster_list.chunk_lists_plain(*a), calls=10),
                   bound_ms=b_ms, bound_by=b_by, tiles=T, chunks=nch, rows=table.shape[0],
                   lmax=lmax, member_chunks=int(members.sum()), most_members=int(members.max()),
                   overflow_tiles=int((members > lmax).sum()))
        log(f"  kernel F, {tag} ({h}x{w}, {table.shape[0]} rows, kc {kc}, {nch} chunks, lmax "
            f"{lmax}): lists equal to the plain enumeration's; {row['member_chunks'] / T:.2f} "
            f"member chunks a tile (at most {row['most_members']}); {row['device_ms']:.4f} ms "
            f"device time a call ({row['ms']:.4f} back to back), plain {row['plain_device_ms']:.4f}"
            f" ms; bound {b_ms:.5f} ms ({b_by})")
        rows[tag] = row
    return rows


def bound(ops: int, nbytes: int) -> tuple[float, str]:
    """Least time the card could take: bytes over HBM rate vs float32
    operations over the CUDA-core rate, in ms, and which one bounds."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gate_counts(t: torch.Tensor, rows: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """(member, pixel) pairs of the (tile ``t``, table row ``rows``) members:
    those on the image, and those that pass the forward's gate there,
    evaluated with the plain version's arithmetic (``core/render_tiled.py``)."""
    from gaussianimage_plus_tpu_torch.core import render_tiled as rt
    from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for

    tb_x, _ = tile_bounds_for(h, w)
    pp = torch.arange(PIX, device=rows.device)
    px, py = (pp % 16).double(), torch.div(pp, 16, rounding_mode="floor").double()
    tx0 = ((t % tb_x) * 16).float()
    ty0 = (torch.div(t, tb_x, rounding_mode="floor") * 16).float()
    sigma = rt._sigma(rt._quad_coeffs(rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3] - tx0,
                                      rows[:, 4] - ty0), px, py)
    alpha = torch.clamp(rows[:, 8, None] * torch.exp(-sigma), max=1.0)
    on_image = ((tx0[:, None] + px.float() < w) & (ty0[:, None] + py.float() < h)
                & (rows[:, 15, None] > 0))
    passing = on_image & (sigma >= 0.0) & (alpha >= rt.ALPHA_THRESHOLD)
    return int(on_image.sum()), int(passing.sum())


def gate_pairs(table: torch.Tensor, bbox: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """``gate_counts`` of a kernel C input (bbox members of the table rows)."""
    from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for
    from gaussianimage_plus_tpu_torch.kernels.raster_list import _bbox_members

    tb_x, tb_y = tile_bounds_for(h, w)
    t, r = _bbox_members(table, bbox, tb_x, tb_x * tb_y).nonzero(as_tuple=True)
    return gate_counts(t, table[r], h, w)


def gate_slots(table: torch.Tensor, ids: torch.Tensor, counts: torch.Tensor, h: int, w: int,
               batch: int = 1 << 16) -> tuple[int, int]:
    """``gate_counts`` of a kernel A or D input (the live slots, rows of the
    attribute table through the slot ids), in batches of slots so that the
    2K state fits in memory."""
    live = torch.arange(ids.shape[1], device=ids.device)[None, :] < counts[:, None]
    t, k = live.nonzero(as_tuple=True)
    rows = table[ids[t, k].long()]
    on_image = passing = 0
    for i in range(0, t.numel(), batch):
        a, b = gate_counts(t[i:i + batch], rows[i:i + batch], h, w)
        on_image, passing = on_image + a, passing + b
    return on_image, passing


def list_members(table: torch.Tensor, bbox: torch.Tensor, h: int, w: int) -> int:
    """(row, tile) members of a kernel B input: the pairs it blends."""
    from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for
    from gaussianimage_plus_tpu_torch.kernels.raster_list import _bbox_members

    tb_x, tb_y = tile_bounds_for(h, w)
    return int(_bbox_members(table, bbox, tb_x, tb_x * tb_y).sum())


def rows_visited(cnt: torch.Tensor, lo2: torch.Tensor, hi2: torch.Tensor, kc: int) -> int:
    """Table rows kernel B tests for membership over all tiles."""
    return int((cnt + (hi2 - lo2).clamp(min=0)).sum()) * kc


def bbox_tiles(bbox: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tiles on the grid of each int32 tile bbox ``(xmin, xmax, ymin, ymax)``."""
    from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for

    tb_x, tb_y = tile_bounds_for(h, w)
    bw = (bbox[:, 1].clamp(max=tb_x) - bbox[:, 0].clamp(min=0)).clamp(min=0)
    bh = (bbox[:, 3].clamp(max=tb_y) - bbox[:, 2].clamp(min=0)).clamp(min=0)
    return bw * bh


class LaunchBook:
    """Seconds and kernel launches of tagged calls, kept in ``info`` apart
    from phase 4's path launches (the phases that repeat counted paths)."""

    def __init__(self, kernels: dict):
        self.kernels, self.info = kernels, {}

    def counts(self) -> dict:
        return {k: fn.launches for k, fn in self.kernels.items()}

    def timed(self, tag: str, fn):
        """``fn()`` with its seconds and launches per kernel under ``tag``."""
        c0, t0 = self.counts(), time.perf_counter()
        value = fn()
        sync()
        self.info[tag] = dict(seconds=time.perf_counter() - t0,
                              launches={k: n - c0[k] for k, n in self.counts().items()})
        return value

    def launches(self, tag: str) -> str:
        return ", ".join(f"{k.upper()} {n}" for k, n in self.info[tag]["launches"].items() if n)


def entry_points(dev, target: torch.Tensor, fit_state, kernels: dict) -> tuple:
    """Phase 4 (g): the port's entry points as a user runs them, on an
    8-bit PNG of ``target`` in a temporary directory. Returns the phase's
    report and its one-line summary. Its launches repeat paths phase 4
    counts already, so they are reported here apart and are left out of
    ``path_launches``, ``launches_by_state`` and ``loss_ms``."""
    from gaussianimage_plus_tpu_torch import decode as decode_cli
    from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream
    from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.scripts import eval_kodak, train_quantize
    from gaussianimage_plus_tpu_torch.scripts import train as train_cli
    from gaussianimage_plus_tpu_torch.train import trainer as tr
    from gaussianimage_plus_tpu_torch.train.metrics import psnr as psnr_fn
    from gaussianimage_plus_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    # train/__init__ exports the function lpips under the module's name
    lp = importlib.import_module("gaussianimage_plus_tpu_torch.train.lpips")
    from gaussianimage_plus_tpu_torch.utils.image_io import load_image, save_image

    E = ENTRY
    book = LaunchBook(kernels)
    info, timed, launches = book.info, book.timed, book.launches

    def same_state(a, b) -> bool:
        return (all(torch.equal(x, y) for x, y in zip(a.params, b.params))
                and torch.equal(a.active, b.active) and torch.equal(a.num_active, b.num_active))

    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        kodak = tmp / "kodak"
        save_image(target, kodak / "kodim01.png")
        gt = torch.as_tensor(load_image(kodak / "kodim01.png"), device=dev)
        h, w = gt.shape[:2]
        cfg = gi.GaussianConfig(H=h, W=w, max_num_points=ENTRY_MAX)
        check(gi.resolve_backend(cfg, dev) == "list_t",
              f"entry points: 'auto' resolved to {gi.resolve_backend(cfg, dev)!r}")
        common = ["-d", str(kodak), "--num_images", "1", "--prune_iter", str(E["prune_iter"]),
                  "--num_points", str(ENTRY_POINTS), "--max_num_points", str(ENTRY_MAX)]

        # (g1) the fit CLI, in process
        log(f"[4] main path (g): the entry points on an 8-bit PNG of the fit's target ({w}x{h}); "
            f"(g1) scripts.train.main, {E['iterations']} steps, {ENTRY_POINTS} -> {ENTRY_MAX} "
            f"points, growth at {E['grow_iter']}")
        fit_dir = timed("fit CLI", lambda: train_cli.main(
            [*common, "--iterations", str(E["iterations"]), "--grow_iter", str(E["grow_iter"]),
             "--log_every", str(E["log_every"]), "--save_imgs", "--log_dir", str(tmp / "fit")]))
        lines = (fit_dir / "train.txt").read_text().splitlines()
        check(len(lines) == 3 and json.loads(lines[0])["iterations"] == E["iterations"],
              f"fit CLI: train.txt holds {lines}")
        f_ = lines[1].split("\t")
        check(f_[:3] == ["kodim01", f"{h}x{w}", "PSNR"] and f_[4:13:2] == ["MS-SSIM", "Training",
              "Eval", "FPS", "gs_nums"] and lines[2].startswith("Average: PSNR:"),
              f"fit CLI: lines {lines[1:]!r} are not in the JAX CLI's format")
        psnr_cli, train_s = float(f_[3]), float(f_[7])
        n1 = info["fit CLI"]["launches"]
        check(n1["c"] == E["iterations"] and n1["b"] >= E["iterations"],
              f"fit CLI: launches {n1} in {E['iterations']} steps")
        model, extra = load_checkpoint(fit_dir / "kodim01" / "gaussian_model", dev)
        ev = tr.evaluate(model, gt, cfg, n_renders=1)
        check(f"{ev['psnr']:.4f}" == f_[3], f"fit CLI: evaluate of gaussian_model gives "
              f"{ev['psnr']:.4f} dB, the log {f_[3]}")
        check(psnr_cli >= ENTRY_DB, f"fit CLI: PSNR {psnr_cli} under {ENTRY_DB} dB")
        check((fit_dir / "kodim01" / "render.png").is_file(), "fit CLI: no render.png")
        log(f"  fit CLI: PSNR {psnr_cli:.4f} dB, MS-SSIM {f_[5]}, {f_[13]} points; Training "
            f"{train_s:.2f} s of {info['fit CLI']['seconds']:.2f} s wall; launches {launches('fit CLI')}")
        info["fit CLI"].update(psnr=psnr_cli, ms_ssim=float(f_[5]), training_s=train_s,
                               eval_ms=float(f_[9]) * 1e3, lines=lines[1:])

        # (g2) resume on the card: uninterrupted, stopped before the growth, resumed
        tcfg = tr.TrainConfig(iterations=E["iterations"], prune_iter=E["prune_iter"],
                              grow_iter=E["grow_iter"])
        fit = lambda **kw: tr.fit_image(gt, cfg, tcfg, ENTRY_POINTS, seed=FIT_SEED, device=dev, **kw)
        ck = tmp / "eval" / "kodim01"
        full = timed("fit, uninterrupted", fit)
        timed("fit, stopped", lambda: fit(checkpoint_dir=str(ck), checkpoint_every=E["prune_iter"],
                                           stop_after_iter=E["stop"]))
        resumed = timed("fit, resumed", lambda: fit(checkpoint_dir=str(ck), resume=True))
        p_full, p_res = full.history["psnr"], resumed.history["psnr"]
        tail = p_full[E["stop"]:]
        differ = (tail != p_res).nonzero() if tail.shape == p_res.shape else None
        check(differ is not None and differ.numel() == 0,
              f"resume: the resumed PSNRs part from the uninterrupted fit's at step "
              f"{E['stop'] + int(differ[0]) + 1 if differ is not None and differ.numel() else '?'}")
        check(same_state(full.state, model), "the uninterrupted fit differs from the fit CLI's "
              "gaussian_model (two runs of one fit on the card)")
        check(same_state(resumed.state, full.state) and resumed.best_psnr == full.best_psnr,
              "resume: the resumed state differs from the uninterrupted fit's")
        again = timed("fit, resume of the completed run", lambda: fit(checkpoint_dir=str(ck),
                                                                       resume=True))
        check(same_state(again.state, full.state) and again.history["psnr"].numel() == 0
              and again.train_time == 0.0, "resume of the completed run")
        # a TrainState at the 'auto' fit's best state (~4800 active): save and load
        ts_big = tr.init_train_state(cfg, tcfg, 0, gaussians=fit_state)
        save_s, load_s = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            save_checkpoint(tmp / "timing_ckpt", ts_big, extra={"next_iter": 0})
            save_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            load_checkpoint(tmp / "timing_ckpt", dev)
            sync()
            load_s.append(time.perf_counter() - t0)
        ckpt_bytes = (tmp / "timing_ckpt").stat().st_size
        info["checkpoint"] = dict(save_ms=statistics.median(save_s) * 1e3,
                                  load_ms=statistics.median(load_s) * 1e3, bytes=ckpt_bytes,
                                  active=int(fit_state.num_active))
        log(f"  resume: {E['iterations']} steps uninterrupted, stopped at {E['stop']} (before the "
            f"growth at {E['grow_iter']}) and resumed: params, active, num_active and best PSNR "
            f"{full.best_psnr:.4f} dB torch.equal, and equal to the fit CLI's gaussian_model; "
            f"resume of the completed run returns it with an empty history. TrainState of "
            f"{int(fit_state.num_active)} active: save {info['checkpoint']['save_ms']:.2f} ms, "
            f"load {info['checkpoint']['load_ms']:.2f} ms (median of 5), {ckpt_bytes} bytes")
        info["resume"] = dict(best_psnr=full.best_psnr, stop=E["stop"])

        # (g3) the legacy Cholesky model with Adan, the fit CLI's remap values;
        # its means start in atanh space over the image, as the reference's
        # Cholesky model draws them (init_state draws pixel positions, where
        # tanh saturates, in both packages)
        cfg_ch = dataclasses.replace(cfg, param="cholesky")
        tcfg_ad = tr.TrainConfig(iterations=E["adan_steps"], prune_iter=E["prune_iter"], lr=1e-3,
                                 opt_type="adan", adaptive_add=False, prune=False)
        gen = torch.Generator(device=dev)
        gen.manual_seed(FIT_SEED)
        init = gi.init_state(cfg_ch, ENTRY_POINTS, gen)
        u = torch.rand((ENTRY_MAX, 2), generator=gen, device=dev)
        init = init._replace(params=init.params._replace(
            xyz=torch.atanh((2.0 * u - 1.0).clamp(-0.999, 0.999))))
        fit_ad = timed("cholesky + Adan fit", lambda: tr.fit_image(
            gt, cfg_ch, tcfg_ad, ENTRY_POINTS, seed=FIT_SEED, gaussians=init))
        p_ad = fit_ad.history["psnr"].cpu().numpy()
        n3 = info["cholesky + Adan fit"]["launches"]
        rise = fit_ad.best_psnr - float(p_ad[0])
        log(f"  (g3) cholesky + Adan (lr 1e-3, no growth, no pruning), {E['adan_steps']} steps: "
            f"PSNR first {p_ad[0]:.4f}, last {p_ad[-1]:.4f}, best {fit_ad.best_psnr:.4f} dB "
            f"(+{rise:.4f}) in {info['cholesky + Adan fit']['seconds']:.2f} s; launches "
            f"{launches('cholesky + Adan fit')}")
        check(n3["c"] == E["adan_steps"] and n3["b"] >= E["adan_steps"],
              f"cholesky + Adan: launches {n3} in {E['adan_steps']} steps")
        check(bool(np.isfinite(p_ad).all()), "cholesky + Adan: non-finite PSNR")
        check(rise >= E["adan_rise_db"], f"cholesky + Adan: best PSNR rose {rise:.4f} dB, "
              f"not {E['adan_rise_db']}")
        ts0 = tr.init_train_state(cfg_ch, tcfg_ad, ENTRY_POINTS, gaussians=init)
        g0 = ts0.gaussians
        most = int(bin_gaussians(gi.project(g0.params, g0.active, g0.bound, cfg_ch), h, w,
                                 cap=cfg_ch.tile_cap + 1).count.max())
        check(most <= cfg_ch.tile_cap, f"cholesky agreement run: a tile holds {most} > cap")
        agree_ad = {}
        for backend in ("auto", "xla"):
            _, m = tr.train_chunk(ts0, gt, dataclasses.replace(cfg_ch, raster_backend=backend),
                                  tcfg_ad, AGREE_STEPS, False, False)
            agree_ad[backend] = m["psnr"].cpu().numpy()
        ad_db = float(np.abs(agree_ad["auto"] - agree_ad["xla"]).max())
        log(f"  {AGREE_STEPS} cholesky + Adan steps 'auto' vs 'xla' (at most {most} in a tile): "
            f"at most {ad_db:.3g} dB apart")
        check(ad_db <= AGREE_DB, f"cholesky + Adan: 'auto' and 'xla' differ by {ad_db:.3g} dB")
        info["cholesky + Adan fit"].update(psnr_first=float(p_ad[0]), psnr_last=float(p_ad[-1]),
                                           best_psnr=fit_ad.best_psnr, rise_db=rise,
                                           auto_vs_xla_max_db=ad_db)
        rs_dir = timed("RS CLI", lambda: train_cli.main(
            [*common, "--model_name", "GaussianImage_RS", "--iterations", str(E["rs_iterations"]),
             "--log_every", str(E["rs_iterations"]), "--log_dir", str(tmp / "rs")]))
        rs_lines = (rs_dir / "train.txt").read_text().splitlines()
        rs_args, rs_f = json.loads(rs_lines[0]), rs_lines[1].split("\t")
        n_rs = info["RS CLI"]["launches"]
        check((rs_args["opt_type"], rs_args["lr"], rs_args["prune"]) == ("adan", 0.001, False)
              and np.isfinite(float(rs_f[3])) and n_rs["c"] == E["rs_iterations"],
              f"RS CLI: {rs_lines[:2]}, launches {n_rs}")
        info["RS CLI"].update(psnr=float(rs_f[3]))
        log(f"  GaussianImage_RS through the fit CLI (Adan, lr 1e-3), {E['rs_iterations']} steps: "
            f"PSNR {float(rs_f[3]):.4f} dB; launches {launches('RS CLI')}")

        # (g4) the quantize CLI, warm-started from (g1), writing the .gipb
        q_dir, q_stats = timed("quantize CLI", lambda: train_quantize.main(
            [*common, "--iterations", str(E["warmup"] + E["qat"]), "--warmup_iter",
             str(E["warmup"]), "--model_path", str(fit_dir), "--write_bitstream",
             "--log_dir", str(tmp / "quant"), "--log_every", str(E["prune_iter"])]))
        q_lines = (q_dir / "train.txt").read_text().splitlines()
        check(f"warm-start from {fit_dir / 'kodim01' / 'gaussian_model'}" in q_lines,
              "quantize CLI: no warm-start line")
        q_line = next(x for x in q_lines if x.startswith("kodim01 Eval time:"))
        q = q_stats["kodim01"]
        check(all(np.isfinite(q[k]) for k in ("psnr", "ms_ssim", "bpp")),
              f"quantize CLI: {q_line}")
        n_q = info["quantize CLI"]["launches"]
        check(n_q["c"] == E["warmup"] + E["qat"], f"quantize CLI: launches {n_q}")
        gipb = tmp / "quant" / "kodim01.gipb"
        data = gipb.read_bytes()
        timed("decode CLI", lambda: decode_cli.main([str(gipb), "-o", str(tmp / "decoded.png")]))
        img_a, _ = decode_bitstream(data, device=dev)
        img_b = timed("decode list_t", lambda: decode_bitstream(data, backend="list_t",
                                                                device=dev)[0])
        psnr_a, psnr_b = float(psnr_fn(img_a, gt)), float(psnr_fn(img_b, gt))
        n_da, n_db = info["decode CLI"]["launches"], info["decode list_t"]["launches"]
        log(f"  (g4) quantize CLI: {E['warmup']} warmup + {E['qat']} QAT steps: PSNR "
            f"{q['psnr']:.4f} dB, MS-SSIM {q['ms_ssim']:.5f}, bpp {q['bpp']:.5f}, bpp_stream "
            f"{q['bpp_stream']:.5f} ({len(data)} bytes) in {info['quantize CLI']['seconds']:.2f} s; "
            f"the .gipb through decode.main (A {n_da['a']}) {psnr_a:.6f} dB and list_t (B "
            f"{n_db['b']}) {psnr_b:.6f} dB")
        check(n_da["a"] > 0 and n_db["b"] > 0, f"decode launches {n_da}, {n_db}")
        check(max(abs(psnr_a - q["psnr"]), abs(psnr_b - q["psnr"])) <= 1e-4,
              f"the .gipb decodes to {psnr_a} / {psnr_b} dB, the encoder's PSNR is {q['psnr']}")
        info["quantize CLI"].update(psnr=q["psnr"], ms_ssim=q["ms_ssim"], bpp=q["bpp"],
                                    bpp_stream=q["bpp_stream"], decode_psnr_a=psnr_a,
                                    decode_psnr_b=psnr_b, line=q_line)

        # (g5) the eval CLI on (g2)'s fit_ckpt, with random-weight LPIPS
        npz = tmp / "lpips.npz"
        lp.save_npz(str(npz), lp.random_params(torch.Generator().manual_seed(0)))
        rows = timed("eval CLI", lambda: eval_kodak.main(
            ["--dataset", str(kodak), "--ckpt_dir", str(tmp / "eval"), "--tile_cap", "256",
             "--max_num_points", str(ENTRY_MAX), "--lpips_weights", str(npz),
             "--out", str(tmp / "eval.json")]))
        check(len(rows) == 1 and info["eval CLI"]["launches"]["a"] > 0,
              f"eval CLI: rows {rows}, launches {info['eval CLI']['launches']}")
        ts_e, _ = load_checkpoint(ck / "fit_ckpt", dev)
        best = tr.restore_best(ts_e)
        cfg_cap = dataclasses.replace(cfg, tile_cap=256, raster_backend="pallas")
        ev_e = tr.evaluate(best, gt, cfg_cap, n_renders=1, lpips_weights=str(npz))
        with torch.no_grad():
            img_e = gi.render(best, cfg_cap)
        lpips_cpu = float(lp.lpips(img_e.cpu(), gt.cpu(), lp.params_from_npz(str(npz), "cpu")))
        r = rows[0]
        log(f"  (g5) eval CLI at cap 256: PSNR {r['psnr']:.6f} dB (evaluate {ev_e['psnr']:.6f}), "
            f"MS-SSIM {r['ms_ssim']:.5f}, LPIPS (random weights) {r['lpips']:.7f} on the card, "
            f"{lpips_cpu:.7f} on the CPU")
        check(abs(r["psnr"] - ev_e["psnr"]) <= 1e-4, f"eval CLI: {r['psnr']} vs evaluate "
              f"{ev_e['psnr']}")
        check(np.isfinite(r["lpips"]) and abs(r["lpips"] - lpips_cpu) <= 1e-4
              and abs(ev_e["lpips"] - r["lpips"]) <= 1e-4,
              f"LPIPS: card {r['lpips']}, evaluate {ev_e['lpips']}, CPU {lpips_cpu}")
        info["eval CLI"].update(psnr=r["psnr"], evaluate_psnr=ev_e["psnr"], lpips=r["lpips"],
                                lpips_cpu=lpips_cpu)

    line = ("entry points (not in loss_ms): fit CLI {:.4f} dB in {:.1f} s; resume torch.equal; "
            "cholesky + Adan +{:.3f} dB, 'auto' vs 'xla' {:.3g} dB; TrainState save {:.2f} / "
            "load {:.2f} ms; quantize CLI {:.4f} dB, {:.5f} bpp; eval CLI {:.4f} dB, "
            "LPIPS {:.6f}").format(
        psnr_cli, info["fit CLI"]["seconds"], rise, ad_db, info["checkpoint"]["save_ms"],
        info["checkpoint"]["load_ms"], q["psnr"], q["bpp"], r["psnr"], r["lpips"])
    return info, line


def parallel_and_legacy(dev, fit_target: torch.Tensor, fit_state, state2k, cfg2k,
                        target2k: torch.Tensor, kernels: dict) -> tuple:
    """Phase 4 (p) and (l): ``parallel/`` in a process group of one (the
    caller's NCCL group), the legacy 3DGS model and ``pixel_count_map``.
    Returns the two phases' reports, a one-line summary and (p1)'s batch
    (targets, config, schedule and final states) for phase (h). Their launches
    (kernels B and C in ``fit_batch``) repeat the fit path's, so they are
    reported here apart, as phase (g)'s are."""
    from gaussianimage_plus_tpu_torch.core.binning import bin_gaussian_rows_hier
    from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for
    from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
    from gaussianimage_plus_tpu_torch.models import gaussian_3d as g3
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.parallel import sharded as psh
    from gaussianimage_plus_tpu_torch.train import trainer as tr
    from gaussianimage_plus_tpu_torch.utils.visualize import pixel_count_map

    book = LaunchBook(kernels)
    P = PAR

    def peak_gb(fn):
        torch.cuda.reset_peak_memory_stats()
        value = fn()
        sync()
        return value, torch.cuda.max_memory_allocated() / 1e9

    # (p1) fit_batch: 4 images, one Gaussian set each, against each run alone
    h, w = fit_target.shape[:2]
    cfg = gi.GaussianConfig(H=h, W=w, max_num_points=P["max_points"])
    check(gi.resolve_backend(cfg, dev) == "list_t",
          f"fit_batch: 'auto' resolved to {gi.resolve_backend(cfg, dev)!r}")
    names, targets = [], []
    with torch.no_grad():
        for path in sorted((ROOT / "results" / "repr_states_plain").glob("*.npz")):
            d = dict(np.load(path))
            # the landscape states: the portraits are 512 wide
            if len(names) < P["images"] and int(d["H"]) >= h and int(d["W"]) >= w:
                names.append(path.stem)
                targets.append(gi.render(state_from_numpy(d, device=dev),
                                         config_from_numpy(d))[:h, :w].contiguous())
    targets = torch.stack(targets)
    tcfg = tr.TrainConfig(iterations=P["iterations"], prune_iter=P["prune_iter"],
                          grow_iter=P["grow_iter"])
    log(f"[4] main path (p1): parallel.fit_batch of the renders of repr_states_plain/"
        f"{', '.join(names)}, a NCCL group of one, seeds {FIT_SEED}-"
        f"{FIT_SEED + len(names) - 1}, {FIT_POINTS} Gaussians up to {cfg.max_num_points}, "
        f"{P['iterations']} steps, a prune every {P['prune_iter']}, growth at {P['grow_iter']}")
    hist_b = []     # per chunk: loss and psnr [B, chunk], n_pruned and n_added [B]

    def progress(it, m):
        hist_b.append(m)

    tss = book.timed("fit_batch", lambda: psh.fit_batch(
        targets, cfg, tcfg, FIT_POINTS, mesh=psh.make_mesh(), seed=FIT_SEED, progress=progress,
        device=dev))
    hist_a = [[] for _ in targets]

    def each_alone():
        out = []
        for i, target in enumerate(targets):
            ts = tr.init_train_state(cfg, tcfg, FIT_POINTS, seed=FIT_SEED + i, device=dev)
            for end in range(tcfg.prune_iter, tcfg.iterations + 1, tcfg.prune_iter):
                grow = end % tcfg.grow_iter == 0 and end < tcfg.iterations
                ts, m = tr.train_chunk(ts, target, cfg, tcfg, tcfg.prune_iter, True, grow,
                                       end == tcfg.iterations - tcfg.grow_iter)
                hist_a[i].append(m)
            out.append(ts)
        return out

    alone = book.timed("each image alone", each_alone)
    # fit_batch replays one graph a chunk for the block ('auto' -> list_t
    # captures): its states, per-chunk metrics and launches equal the eager
    # chunks of each image alone
    for i in range(len(targets)):
        check(all(torch.equal(hist_b[c][k][i], m[k]) for c, m in enumerate(hist_a[i])
                  for k in ("loss", "psnr", "n_pruned", "n_added")),
              f"fit_batch: image {i}'s history differs from its schedule run alone")
    check(all(len(tr._tensors(a)) == len(tr._tensors(b)) and
              all(torch.equal(x, y) for x, y in zip(tr._tensors(a), tr._tensors(b)))
              for a, b in zip(tss, alone)),
          "fit_batch: a train state is not torch.equal to its schedule run alone")
    check(book.info["fit_batch"]["launches"] == book.info["each image alone"]["launches"],
          f"fit_batch: launches {book.launches('fit_batch')}, alone "
          f"{book.launches('each image alone')}")
    best = np.array([float(ts.best_psnr) for ts in tss])
    rise = best - hist_b[0]["psnr"][:, 0].cpu().numpy()
    n_b, n_a = book.info["fit_batch"], book.info["each image alone"]
    steps = len(names) * P["iterations"]
    log(f"  fit_batch: {n_b['seconds']:.2f} s ({n_b['seconds'] / len(names):.2f} s an image), "
        f"each image alone {n_a['seconds']:.2f} s ({n_a['seconds'] / len(names):.2f} s an "
        f"image); best PSNR " + " / ".join(f"{b:.4f}" for b in best) + " dB, rise "
        + " / ".join(f"{r:.2f}" for r in rise) + " dB; active "
        + " / ".join(str(int(ts.gaussians.num_active)) for ts in tss)
        + f"; launches {book.launches('fit_batch')} (alone: {book.launches('each image alone')})")
    check(len(tss) == len(names), f"fit_batch: {len(tss)} states for {len(names)} images")
    check(bool((rise >= P["rise_db"]).all()), f"fit_batch: best PSNR rose {rise} dB, not "
          f"{P['rise_db']}")
    check(n_b["launches"]["c"] == steps and n_b["launches"]["b"] >= steps,
          f"fit_batch: launches {n_b['launches']} in {steps} steps")
    batch = dict(targets=targets, cfg=cfg, tcfg=tcfg, states=tss,
                 graphed=tr.captures(cfg, dev))
    info_p = dict(fit_batch=dict(book.info["fit_batch"], best_psnr=best.tolist(),
                                 rise_db=rise.tolist(), equal_alone=True,
                                 alone_seconds=n_a["seconds"], alone_launches=n_a["launches"],
                                 active=[int(ts.gaussians.num_active) for ts in tss]))

    # (p2) the tile-sharded step and fit in a world of one, against 'xla'
    cfg_x = dataclasses.replace(cfg, raster_backend="xla")
    mesh = psh.make_mesh(axis_names=("tile",))
    render_fn = psh.make_tile_sharded_render(mesh, cfg_x, axis="tile")
    tc_a = tr.TrainConfig(iterations=P["agree_steps"], prune_iter=P["agree_steps"])
    ts0 = tr.init_train_state(cfg_x, tc_a, FIT_POINTS, seed=FIT_SEED + 10, device=dev)
    _, m_s = tr.train_chunk(ts0, fit_target, cfg_x, tc_a, P["agree_steps"], False, False,
                            render_fn=render_fn)
    _, m_x = tr.train_chunk(ts0, fit_target, cfg_x, tc_a, P["agree_steps"], False, False)
    p_s, p_x = m_s["psnr"].cpu().numpy(), m_x["psnr"].cpu().numpy()
    agree_db = float(np.abs(p_s - p_x).max())
    log(f"[4] main path (p2): {P['agree_steps']} steps through make_tile_sharded_render vs "
        f"'xla', one start: PSNR {p_s[-1]:.4f} vs {p_x[-1]:.4f} dB at the last step, at most "
        f"{agree_db:.3g} dB apart")
    check(agree_db <= AGREE_DB, f"sharded and 'xla' steps differ by {agree_db:.3g} dB")
    tc_f = tr.TrainConfig(**P["fit"])
    res_s, fit_gb = peak_gb(lambda: book.timed("fit_image_tile_sharded", lambda: (
        psh.fit_image_tile_sharded(fit_target, cfg_x, tc_f, FIT_POINTS, mesh=mesh, seed=FIT_SEED,
                                   device=dev))))
    res_x = book.timed("fit_image xla", lambda: tr.fit_image(fit_target, cfg_x, tc_f, FIT_POINTS,
                                                               seed=FIT_SEED, device=dev))
    p_fit = res_s.history["psnr"].cpu().numpy()
    fit_rise = res_s.best_psnr - float(p_fit[0])
    ts_t = tr.init_train_state(cfg_x, tc_f, 0, gaussians=res_s.state)
    tx = tr.make_optimizer(tc_f)
    cur = [ts_t, ts_t]

    def step_sharded():
        cur[0] = tr.train_step(cur[0], fit_target, cfg_x, tc_f, tx, render_fn)[0]

    def step_xla():
        cur[1] = tr.train_step(cur[1], fit_target, cfg_x, tc_f, tx)[0]

    step_ms, step_gb = peak_gb(lambda: median_ms(step_sharded))
    xla_ms = median_ms(step_xla)
    spread = psh.replica_spread((*res_s.state.params, res_s.state.active), mesh)
    log(f"  fit_image_tile_sharded, {tc_f.iterations} steps (prune every {tc_f.prune_iter}, "
        f"growth at {tc_f.grow_iter}): PSNR first {p_fit[0]:.4f}, best {res_s.best_psnr:.4f} dB "
        f"(+{fit_rise:.3f}), {int(res_s.state.num_active)} active (the 'xla' fit: best "
        f"{res_x.best_psnr:.4f} dB, {int(res_x.state.num_active)} active) in "
        f"{book.info['fit_image_tile_sharded']['seconds']:.2f} s, peak {fit_gb:.3f} GB; a step "
        f"at its best state {step_ms:.4f} ms (median of {FRAMES}; 'xla' {xla_ms:.4f} ms), peak "
        f"{step_gb:.3f} GB; replica spread {spread}")
    check(fit_rise >= P["fit_rise_db"], f"sharded fit rose {fit_rise:.3f} dB, not "
          f"{P['fit_rise_db']}")
    check(np.isfinite(p_fit).all() and spread == 0.0, "sharded fit: non-finite or spread")
    info_p["sharded"] = dict(agree_max_db=agree_db, agree_steps=P["agree_steps"],
                             fit_best_psnr=res_s.best_psnr, fit_rise_db=fit_rise,
                             fit_active=int(res_s.state.num_active),
                             xla_best_psnr=res_x.best_psnr,
                             xla_active=int(res_x.state.num_active),
                             fit_seconds=book.info["fit_image_tile_sharded"]["seconds"],
                             xla_fit_seconds=book.info["fit_image xla"]["seconds"],
                             fit_peak_gb=fit_gb, step_ms=step_ms, step_peak_gb=step_gb,
                             xla_step_ms=xla_ms)

    # (p3) the 2K state: one sharded render with the row-band hier binner
    h2, w2 = cfg2k.H, cfg2k.W
    cfg_h = dataclasses.replace(cfg2k, bin_method="hier", raster_backend="xla")
    render_2k = psh.make_tile_sharded_render(mesh, cfg_h, axis="tile",
                                             super_cap=P["super_cap_2k"])

    def render_grad(fn, cfg_):
        params = gi.GaussianParams(*(p.detach().clone().requires_grad_(True)
                                     for p in state2k.params))
        img = fn(state2k._replace(params=params), cfg_)
        return img.detach(), torch.autograd.grad(torch.mean((img - target2k) ** 2), params)

    (img_s, g_s), gb_2k = peak_gb(lambda: render_grad(render_2k, cfg_h))
    # the unsharded reference bins exactly (flat top_k): its own 'hier' may overflow
    cfg_u = dataclasses.replace(cfg_h, bin_method="top_k")
    (img_u, g_u), gb_u = peak_gb(lambda: render_grad(gi.render, cfg_u))
    proj2k = gi.project(state2k.params, state2k.active, state2k.bound, cfg_h)
    tb2 = tile_bounds_for(h2, w2)
    # the render's own count, summed over the mesh; the default budget's beside it
    ovf = render_2k.super_overflow()
    ovf_default = int(bin_gaussian_rows_hier(proj2k, h2, w2, 0, tb2[0] * tb2[1],
                                             cap=cfg_h.tile_cap).super_overflow)
    img_d = float((img_s - img_u).abs().max())
    rel = max(float(((a - b).abs().amax(0) / b.abs().amax(0).clamp(min=1e-30)).max())
              for a, b in zip(g_s, g_u))
    log(f"[4] main path (p3): the 2K state ({w2}x{h2}, {int(state2k.num_active)} active), one "
        f"sharded render with bin_method='hier', super_cap {P['super_cap_2k']}: max |sharded - "
        f"unsharded 'xla' (top_k)| {img_d:.3g}, super_overflow {ovf} (at the default budget: "
        f"{ovf_default}), gradient within {rel:.3g} of each column's max; peak {gb_2k:.3f} GB "
        f"(unsharded 'xla' {gb_u:.3f} GB)")
    check(img_d <= 1e-5 and ovf == 0 and rel <= C_REL,
          f"2K sharded render: {img_d}, super_overflow {ovf}, gradient {rel}")
    info_p["2K"] = dict(max_abs=img_d, super_overflow=ovf, super_overflow_default=ovf_default,
                        super_cap=P["super_cap_2k"], grad_worst_column_rel=rel,
                        peak_gb=gb_2k, unsharded_peak_gb=gb_u)
    info_p["launches"] = {k: v["launches"] for k, v in book.info.items()}

    # (l1) the legacy 3DGS model: card against CPU, then Adam on the card
    L = LEGACY
    cfg3 = g3.Gaussian3DConfig(H=h, W=w, num_points=L["points"], sh_degree=L["sh_degree"])
    p0 = g3.init_params_3d(cfg3, torch.Generator(device=dev).manual_seed(FIT_SEED))
    p0_cpu = g3.Gaussian3DParams(*(x.cpu() for x in p0))
    n3 = L["agree_steps"]
    _, m_card = book.timed("3DGS card", lambda: g3.fit_image_3d(fit_target, cfg3, iterations=n3,
                                                                 params=p0))
    _, m_cpu = book.timed("3DGS CPU", lambda: g3.fit_image_3d(fit_target.cpu(), cfg3,
                                                               iterations=n3, params=p0_cpu))
    h_card = m_card["history"]["psnr"].cpu().numpy()
    h_cpu = m_cpu["history"]["psnr"].numpy()
    db3 = float(np.abs(h_card - h_cpu).max())
    p300, m300 = book.timed("3DGS Adam", lambda: g3.fit_image_3d(
        fit_target, cfg3, iterations=L["steps"], params=p0))
    loss3 = m300["history"]["loss"].cpu().numpy()
    psnr3 = m300["history"]["psnr"].cpu().numpy()
    box = [p300]

    def step3():    # a step of fit_image_3d (with its optimizer set-up and metrics)
        box[0] = g3.fit_image_3d(fit_target, cfg3, iterations=1, params=box[0])[0]

    ms3 = median_ms(step3)
    busy3, rows3, _ = device_time_per_call(step3)
    log(f"[4] main path (l1): the 3DGS model at {cfg3.W}x{cfg3.H}, {cfg3.num_points} points, SH "
        f"degree {cfg3.sh_degree}: {n3} steps on the card and on the CPU from one start, PSNR at "
        f"most {db3:.3g} dB apart ({book.info['3DGS card']['seconds']:.2f} s vs "
        f"{book.info['3DGS CPU']['seconds']:.2f} s); {L['steps']} Adam steps: loss "
        f"{loss3[0]:.5f} -> {loss3[-1]:.5f}, PSNR {psnr3[0]:.4f} -> {psnr3[-1]:.4f} dB in "
        f"{book.info['3DGS Adam']['seconds']:.2f} s; a step {ms3:.4f} ms (median of {FRAMES}), "
        f"device busy {busy3:.4f} ms ({busy3 / ms3:.1%}); top device time: "
        + "; ".join(f"{name[:50]} {ms:.4f} ms" for name, ms in rows3[:4]))
    check(db3 <= AGREE_DB, f"3DGS: card and CPU differ by {db3:.3g} dB")
    check(np.isfinite(loss3).all() and loss3[-1] < loss3[0] and psnr3[-1] > psnr3[0],
          f"3DGS: loss {loss3[0]} -> {loss3[-1]}, PSNR {psnr3[0]} -> {psnr3[-1]}")
    info_l = dict(agree_max_db=db3, agree_steps=n3, loss_first=float(loss3[0]),
                  loss_last=float(loss3[-1]), psnr_first=float(psnr3[0]),
                  psnr_last=float(psnr3[-1]), step_ms=ms3, busy_ms=busy3,
                  seconds={k: book.info[k]["seconds"] for k in ("3DGS card", "3DGS CPU",
                                                                "3DGS Adam")})

    # (l2) pixel_count_map at the fit state, card against CPU
    cfg_c = cfg
    counts = pixel_count_map(fit_state, cfg_c)
    counts_cpu = pixel_count_map(type(fit_state)(
        params=gi.GaussianParams(*(p.cpu() for p in fit_state.params)),
        active=fit_state.active.cpu(), bound=fit_state.bound.cpu(),
        num_active=fit_state.num_active.cpu()), cfg_c)
    differ = float((counts.cpu() != counts_cpu).float().mean())
    log(f"[4] main path (l2): pixel_count_map at the fit state: {int(counts.max())} at most in a "
        f"pixel, mean {float(counts.float().mean()):.2f}; {differ:.4%} of pixels differ from the "
        f"CPU's")
    check(tuple(counts.shape) == (cfg_c.H, cfg_c.W) and differ <= COUNT_FRAC,
          f"pixel_count_map: {differ:.4%} of pixels differ from the CPU's")
    info_l["pixel_count"] = dict(max=int(counts.max()), differ_frac=differ)
    line = ("parallel and legacy (not in loss_ms): fit_batch {:.2f} s an image (alone {:.2f}), "
            "torch.equal; sharded vs 'xla' {:.3g} dB, sharded fit +{:.2f} dB, step {:.4f} ms, "
            "peak {:.2f} GB; 2K sharded {:.3g}, overflow {}, peak {:.2f} GB; 3DGS card vs CPU "
            "{:.3g} dB, step {:.4f} ms (busy {:.1%}); pixel counts differ {:.4%}").format(
        n_b["seconds"] / len(names), n_a["seconds"] / len(names), agree_db, fit_rise, step_ms,
        step_gb, img_d, ovf, gb_2k, db3, ms3, busy3 / ms3, differ)
    return info_p, info_l, line, batch


def eager_fit(target: torch.Tensor, cfg, fit: dict, points: int, init_state=None) -> tuple:
    """``fit_image``'s schedule (a prune every ``prune_iter``, growth at each
    grow period's end but the last, the final fill at ``iterations -
    grow_iter``) run chunk by chunk through ``train_chunk``, eagerly, from
    ``fit_image``'s initial state: (best state, history, best PSNR, best
    step)."""
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    tc = tr.TrainConfig(**fit)
    chunk = tc.prune_iter
    ts = tr.init_train_state(cfg, tc, points, seed=FIT_SEED, gaussians=init_state,
                             device=target.device)
    hist = {"loss": [], "psnr": [], "n_pruned": [], "n_added": [], "num_active": []}
    for end in range(chunk, tc.iterations + 1, chunk):
        grow = tc.adaptive_add and end % tc.grow_iter == 0 and end < tc.iterations
        ts, m = tr.train_chunk(ts, target, cfg, tc, chunk, tc.prune, grow,
                               end == tc.iterations - tc.grow_iter)
        hist["loss"].append(m["loss"])
        hist["psnr"].append(m["psnr"])
        hist["n_pruned"].append(m["n_pruned"][None])
        hist["n_added"].append(m["n_added"][None])
        hist["num_active"].append(ts.gaussians.num_active[None])
    return (tr.restore_best(ts), {k: torch.cat(v) for k, v in hist.items()},
            float(ts.best_psnr), int(ts.best_iter))


def fused_dispatch(dev, kernels: dict, fit_target: torch.Tensor, cfg_fit, res, fits: dict,
                   cfg_q, tcfg_q, qcfg, res_q, qat_s: float, batch: dict, names: dict) -> tuple:
    """Phase 4 (h): the fused dispatch. ``fit_image``, ``fit_image_quantized``
    and ``fit_batch`` run their chunks as replays of one captured CUDA graph
    (``train.trainer.ChunkGraph``) wherever ``render`` runs through a kernel
    (``train.trainer.captures``); here each graphed run is held
    ``torch.equal`` to the same schedule run eagerly through ``train_chunk``
    (and ``quant_train_chunk``), with equal launch counts: the Kodak
    ``'auto'`` fit (B + C), run again graphed with its wall time and peak
    memory; ``fits``, phase 4's graphed fits (the binned fit of (a), the odd
    grid's ``'auto'`` of (c), the 2K ``'pallas'`` + ``'hier'`` fit of (d));
    the coding path of (f); a ``'dense'`` and a ``'sweep'`` macro chunk at the
    Kodak fit state; QAT on the odd grid; ``fit_batch`` of (p1) (``batch``),
    whose states, history and launches (p1) holds against each image alone;
    and a 2040x1344 ``'auto'`` fit (B + C), 10,000 -> 20,000 rows, on the
    render of the converged 2K state ``results/repr_states_2k/mosaic2k.npz``,
    which must rise. Then per route the step time of replays (CUDA events
    around ``FUSED['replays']`` chunk replays, the capture timed apart)
    beside the eager median of 50 steps at the same state, and the replays'
    device busy from the profiler. Returns the phase's report and a one-line
    summary; its launches repeat phase 4's paths and are reported apart."""
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.parallel import sharded as psh
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    info: dict = {}

    def counts() -> dict:
        return {k: fn.launches for k, fn in kernels.items()}

    def run(fn):
        """``fn()``, its seconds (host clock to a sync), launches and peak
        memory."""
        for k in kernels.values():
            k.launches = 0
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        value = fn()
        sync()
        return value, time.perf_counter() - t0, counts(), torch.cuda.max_memory_allocated(dev)

    def same(tag, a, b):
        ta, tb = tr._tensors(a), tr._tensors(b)
        check(len(ta) == len(tb) > 0, f"(h) {tag}: {len(ta)} against {len(tb)} tensors")
        for i, (x, y) in enumerate(zip(ta, tb)):
            check(torch.equal(x, y), f"(h) {tag}: graphed and eager differ in tensor {i} "
                  f"{tuple(x.shape)}")

    def launch_note(n: dict) -> str:
        return ", ".join(f"{k.upper()} {v}" for k, v in n.items() if v)

    def against_eager(tag, target, cfg, fit, points, g, g_n, g_s):
        """A graphed fit against its schedule run eagerly: (eager seconds,
        eager peak memory)."""
        check(tr.captures(cfg, dev), f"(h) {tag}: not a capturing route")
        (e_state, e_hist, e_best, e_iter), e_s, e_n, e_mem = run(
            lambda: eager_fit(target, cfg, fit, points))
        same(f"{tag} best state", g.state, e_state)
        for k, v in e_hist.items():
            same(f"{tag} history {k}", g.history[k], v)
        check(g.best_psnr == e_best and g.best_iter == e_iter, f"(h) {tag}: best differs")
        check(g_n == e_n, f"(h) {tag}: launches graphed {g_n}, eager {e_n}")
        info[tag] = dict(graphed_s=g_s, eager_s=e_s, launches=e_n, steps=fit["iterations"])
        return e_s, e_mem

    def fit_pair(tag, target, cfg, fit, points, rise_db):
        """``fit_image`` run graphed here against the eager chunk loop."""
        tc = tr.TrainConfig(**fit)
        g, g_s, g_n, g_mem = run(lambda: tr.fit_image(target, cfg, tc, points, seed=FIT_SEED,
                                                      device=dev))
        e_s, e_mem = against_eager(tag, target, cfg, fit, points, g, g_n, g_s)
        psnr = g.history["psnr"]
        check(g.best_psnr >= float(psnr[0]) + rise_db, f"(h) {tag}: best {g.best_psnr:.4f} dB "
              f"not {rise_db} dB above the first step's {float(psnr[0]):.4f}")
        info[tag].update(peak_gb_graphed=g_mem / 1e9, peak_gb_eager=e_mem / 1e9,
                         best_psnr=g.best_psnr, first_psnr=float(psnr[0]))
        log(f"  (h) {tag}: {fit['iterations']} steps graphed {g_s:.3f} s, eager {e_s:.3f} s; "
            f"torch.equal (best state, history), launches equal ({launch_note(g_n)}); PSNR "
            f"{float(psnr[0]):.4f} -> best {g.best_psnr:.4f} dB; peak memory graphed "
            f"{g_mem / 1e9:.3f} GB, eager {e_mem / 1e9:.3f} GB")
        return g

    def chunk_pair(tag, state, cfg, target, n_chunks, chunk):
        """``train_macro_chunk`` (replays, warmed up on a clone) against
        ``n_chunks`` eager ``train_chunk`` calls, each with its prune."""
        check(tr.captures(cfg, dev), f"(h) {tag}: not a capturing route")
        tc = tr.TrainConfig(prune_iter=chunk)
        ts0 = tr.init_train_state(cfg, tc, 0, gaussians=state)
        (a, ma), g_s, g_n, _ = run(lambda: tr.train_macro_chunk(ts0, target, cfg, tc, n_chunks,
                                                                chunk, True, False))

        def eager():
            b, parts = ts0, []
            for _ in range(n_chunks):
                b, mb = tr.train_chunk(b, target, cfg, tc, chunk, True, False)
                parts.append((mb["loss"], mb["psnr"]))
            return b, [torch.cat(p_) for p_ in zip(*parts)]

        (b, (loss, psnr)), e_s, e_n, _ = run(eager)
        same(f"{tag} train state", a, b)
        same(f"{tag} loss and PSNR", (ma["loss"], ma["psnr"]), (loss, psnr))
        check(all(g_n[k] * n_chunks == e_n[k] * (n_chunks + 1) for k in e_n),
              f"(h) {tag}: launches graphed {g_n} (a warm-up chunk on a clone), eager {e_n}")
        info[tag] = dict(graphed_s=g_s, eager_s=e_s, launches=e_n, steps=n_chunks * chunk)
        log(f"  (h) {tag}: {n_chunks} x {chunk} steps graphed {g_s:.3f} s (and a warm-up "
            f"chunk), eager {e_s:.3f} s; torch.equal (train state, loss, PSNR), launches "
            f"{launch_note(g_n)} against {launch_note(e_n)}")

    def qat_pair(tag, state, cfg, target, n_chunks, chunk, model_lr):
        """``quant_train_macro_chunk`` against ``n_chunks`` eager
        ``quant_train_chunk`` calls carrying ``best``."""
        check(tr.captures(cfg, dev), f"(h) {tag}: not a capturing route")
        bundle = pl.init_quantizers(state, cfg, qcfg)
        mos = tr.make_optimizer(tcfg_q).init(state.params)
        a, g_s, g_n, _ = run(lambda: pl.quant_train_macro_chunk(
            state, mos, bundle, target, cfg, qcfg, model_lr, n_chunks, chunk))

        def eager():
            b, best, psnrs = (state, mos, bundle), None, []
            for _ in range(n_chunks):
                *b, m = pl.quant_train_chunk(*b, target, cfg, qcfg, model_lr, chunk, best=best)
                best = m["best"]
                psnrs.append(m["psnr"])
            return tuple(b), best, torch.cat(psnrs)

        (b, best, psnr), e_s, e_n, _ = run(eager)
        same(f"{tag} QAT state", a[:3], b)
        same(f"{tag} best", a[3]["best"], best)
        same(f"{tag} PSNR", a[3]["psnr"], psnr)
        check(all(g_n[k] * n_chunks == e_n[k] * (n_chunks + 1) for k in e_n),
              f"(h) {tag}: launches graphed {g_n} (a warm-up chunk on a clone), eager {e_n}")
        info[tag] = dict(graphed_s=g_s, eager_s=e_s, launches=e_n, steps=n_chunks * chunk,
                         best_psnr=float(best[0]))
        log(f"  (h) {tag}: {n_chunks} x {chunk} QAT steps graphed {g_s:.3f} s (and a warm-up "
            f"chunk), eager {e_s:.3f} s; torch.equal (state, bundle, best, PSNR), launches "
            f"{launch_note(g_n)} against {launch_note(e_n)}; best {float(best[0]):.4f} dB")
        return bundle, mos

    def step_times(tag, runner, carry, chunk, eager_step, kernel_names, per=1):
        """Per-step ms of ``FUSED['replays']`` chunk replays (CUDA events),
        the capture's ms, the replays' device busy a step, beside the eager
        median of 50 steps; ``per`` images a step (fit_batch's block)."""
        runner.run(carry, 1)                        # the eager warm-up chunk
        sync()
        t0 = time.perf_counter()
        runner.graph = tr.ChunkGraph(runner.fn, carry)
        sync()
        capture_ms = (time.perf_counter() - t0) * 1e3
        n = FUSED["replays"]
        runner.run(carry, 1)
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        runner.run(carry, n)
        end.record()
        end.synchronize()
        graphed = start.elapsed_time(end) / (n * chunk)
        busy, rows, missing = device_time_per_call(lambda: runner.run(carry, 1), calls=2,
                                                   kernels=kernel_names)
        busy /= chunk
        eager = median_ms(eager_step)
        info.setdefault("steps", {})[tag] = dict(
            graphed_ms=graphed, eager_ms=eager, busy_ms=busy, capture_ms=capture_ms,
            chunk=chunk, replays=n, images=per, top=[(k, ms / chunk) for k, ms in rows[:6]],
            not_traced=missing)
        log(f"  (h) {tag} step: graphed {graphed:.4f} ms ({n} replays of {chunk} steps), eager "
            f"{eager:.4f} ms (median of {FRAMES}); device busy under replay {busy:.4f} ms a step "
            f"({busy / graphed:.1%} of the graphed step); capture {capture_ms:.1f} ms"
            + (f"; {graphed / per:.4f} ms graphed an image-step" if per > 1 else "")
            + (f"; not traced: {', '.join(missing)}" if missing else ""))
        return graphed, eager, busy

    def train_steps(tag, state, cfg, target, chunk, kernel_names):
        tc = tr.TrainConfig(prune_iter=chunk)
        ts = tr.init_train_state(cfg, tc, 0, gaussians=state)
        if gi.resolve_backend(cfg, dev) in ("list", "list_t", "sweep"):
            ts = tr._morton_resort(ts, cfg)
        tx = tr.make_optimizer(tc)
        box = [ts]

        def one_step():
            box[0] = tr.train_step(box[0], target, cfg, tc, tx)[0]

        runner = tr._fit_runner(target, cfg, tc, chunk, True)
        img = torch.zeros((cfg.H, cfg.W, 3), device=dev)
        return step_times(tag, runner, (ts, img), chunk, one_step, kernel_names)

    def qat_steps(tag, state, bundle, mos, cfg, target, chunk, model_lr, kernel_names):
        box = [(state, mos, bundle, None)]

        def qat_step():
            s_, m_, b_, best_ = box[0]
            s_, m_, b_, mm = pl.quant_train_chunk(s_, m_, b_, target, cfg, qcfg, model_lr, 1,
                                                  best=best_)
            box[0] = (s_, m_, b_, mm["best"])

        step_times(tag, pl._qat_runner(target, cfg, qcfg, model_lr, chunk),
                   (state, mos, bundle, pl._initial_best(state, bundle)), chunk, qat_step,
                   kernel_names)

    log("[4] main path (h): the fused dispatch, graphed against eager")
    # the Kodak 'auto' fit, graphed again: equal to phase 4's run and to the eager loop
    g_fit = fit_pair("Kodak fit, 'auto'", fit_target, cfg_fit, FIT, FIT_POINTS, FUSED["rise_db"])
    same("Kodak fit against phase 4's", g_fit.state, res.state)
    # phase 4's graphed fits (binned, odd grid, 2K 'hier') against their eager loops
    for tag, (target, cfg, fit, points, g, g_n, g_s) in fits.items():
        e_s, _ = against_eager(tag, target, cfg, fit, points, g, g_n, g_s)
        log(f"  (h) {tag}: phase 4's graphed fit torch.equal to the eager loop (best state, "
            f"history), launches equal ({launch_note(g_n)}); {fit['iterations']} steps graphed "
            f"{g_s:.3f} s, eager {e_s:.3f} s")

    # the coding path of phase (f) against its schedule run eagerly
    warm = QAT["warmup_iter"]

    def eager_coding():
        ts = tr.init_train_state(cfg_q, tcfg_q, FIT_POINTS, FIT_SEED, gaussians=res.state)
        warm_psnr = []
        for _ in range(warm // tcfg_q.prune_iter):
            ts, m = tr.train_chunk(ts, fit_target, cfg_q, tcfg_q, tcfg_q.prune_iter, tcfg_q.prune,
                                   False)
            warm_psnr.append(m["psnr"])
        state = tr.restore_best(ts)
        lr = tcfg_q.lr * tcfg_q.lr_gamma ** (warm // tcfg_q.lr_step_size)
        carry = [state, tr.make_adam(lr, tcfg_q.lr_step_size, tcfg_q.lr_gamma).init(state.params),
                 pl.init_quantizers(state, cfg_q, qcfg, generator=ts.generator)]
        best, psnrs, losses = None, [], []
        for _ in range(QAT["steps"] // tcfg_q.prune_iter):
            *carry, m = pl.quant_train_chunk(*carry, fit_target, cfg_q, qcfg, lr,
                                             tcfg_q.prune_iter, best=best)
            best = m["best"]
            psnrs.append(m["psnr"])
            losses.append(m["loss"])
        return (carry[0]._replace(params=best[1]),
                carry[2]._replace(xy=best[2][0], cov=best[2][1], color=best[2][2],
                                  color_vq=best[3]),
                float(best[0]), torch.cat(warm_psnr), torch.cat(psnrs), torch.cat(losses), lr)

    (q_state, q_bundle, q_best, q_warm, q_psnr, q_loss, model_lr), q_s, q_n, _ = run(eager_coding)
    check(tr.captures(cfg_q, dev), "(h) coding path: not a capturing route")
    same("coding path state", res_q.state, q_state)
    same("coding path bundle", res_q.bundle, q_bundle)
    same("coding path PSNR", (res_q.metrics["warmup_psnr"], res_q.metrics["psnr"],
                              res_q.metrics["loss"]), (q_warm, q_psnr, q_loss))
    check(res_q.best_psnr == q_best, "(h) coding path: best PSNR differs")
    info["coding path"] = dict(graphed_s=qat_s, eager_s=q_s, launches=q_n, best_psnr=q_best)
    log(f"  (h) coding path: {warm} + {QAT['steps']} steps graphed {qat_s:.3f} s (phase (f)), "
        f"eager {q_s:.3f} s; torch.equal (state, bundle, PSNRs), best {q_best:.4f} dB")

    # 'dense' and 'sweep' chunks (B + C) at the Kodak fit state
    cfg_dense = dataclasses.replace(cfg_fit, raster_backend="dense")
    cfg_sweep = dataclasses.replace(cfg_fit, raster_backend="sweep")
    for cfg_ in (cfg_dense, cfg_sweep):
        chunk_pair(f"'{cfg_.raster_backend}' chunks", res.state, cfg_, fit_target,
                   FUSED["chunks"], FUSED["chunk"])
    # QAT on the odd grid ('auto' -> 'pallas' + 'top_k': A + D)
    odd = fits["odd-grid fit, 'auto' -> 'pallas' + 'top_k'"]
    target_odd, cfg_odd, res_odd = odd[0], odd[1], odd[4]
    bundle_odd, mos_odd = qat_pair("QAT, odd grid", res_odd.state, cfg_odd, target_odd,
                                   FUSED["chunks"], FUSED["chunk"], model_lr)
    # fit_batch (p1): each chunk of the block one replay; (p1) held it equal
    n_img = len(batch["states"])
    p1 = report["phases"]["parallel"]["fit_batch"]
    check(batch["graphed"], "(h) fit_batch: its route does not capture")
    info["fit_batch"] = dict(graphed_s=p1["seconds"], eager_s=p1["alone_seconds"],
                             launches=p1["launches"], images=n_img,
                             steps=batch["tcfg"].iterations)
    log(f"  (h) fit_batch: {n_img} images x {batch['tcfg'].iterations} steps graphed "
        f"{p1['seconds']:.3f} s ({p1['seconds'] / n_img:.3f} s an image), each image alone "
        f"eagerly {p1['alone_seconds']:.3f} s ({p1['alone_seconds'] / n_img:.3f} s an image); "
        f"torch.equal (states, history) and launches equal in (p1)")

    # the 2K 'auto' fit (B + C) on the render of the converged 2K state
    d2 = dict(np.load(STATE_2K))
    cfg2 = config_from_numpy(d2)
    check(gi.resolve_backend(cfg2, dev) == "list_t",
          f"(h) 2K: 'auto' resolved to {gi.resolve_backend(cfg2, dev)!r}")
    with torch.no_grad():
        target2 = gi.render(state_from_numpy(d2, device=dev), cfg2).contiguous()
    g2 = fit_pair("2K fit, 'auto'", target2, cfg2, FUSED["k2_fit"], FUSED["k2_points"],
                  FUSED["k2_rise_db"])

    # per-step times: replays against the eager step, at each route's state
    na, nb, nc, nd = names["a"], names["b"], names["c"], names["d"]
    train_steps(f"Kodak 'auto', {int(res.state.num_active)} active", res.state, cfg_fit,
                fit_target, FIT["prune_iter"], nb + nc)
    res_bin = fits["binned fit, 'pallas' + E"][4]
    cfg_bin = fits["binned fit, 'pallas' + E"][1]
    train_steps(f"Kodak 'pallas' + E, {int(res_bin.state.num_active)} active", res_bin.state,
                cfg_bin, fit_target, FIT["prune_iter"], na + nd + names["e"])
    train_steps(f"odd grid 'auto' ('pallas' + 'top_k'), {int(res_odd.state.num_active)} active",
                res_odd.state, cfg_odd, target_odd, ODD_FIT["prune_iter"], na + nd)
    for cfg_ in (cfg_dense, cfg_sweep):
        train_steps(f"Kodak '{cfg_.raster_backend}', {int(res.state.num_active)} active",
                    res.state, cfg_, fit_target, FIT["prune_iter"], nb + nc)
    target2h, cfg2h, fit2h, _, res2h, _, _ = fits["2K fit, 'pallas' + 'hier'"]
    train_steps(f"2K 'pallas' + 'hier', {int(res2h.state.num_active)} active", res2h.state,
                cfg2h, target2h, fit2h["prune_iter"], na + nd)
    train_steps(f"2K 'auto', {int(g2.state.num_active)} active", g2.state, cfg2, target2,
                FUSED["k2_fit"]["prune_iter"], nb + nc)
    st_q, b_q = res_q.state, res_q.bundle
    qat_steps(f"QAT 'auto', {int(st_q.num_active)} active", st_q, b_q,
              tr.make_optimizer(tcfg_q).init(st_q.params), cfg_q, fit_target,
              tcfg_q.prune_iter, model_lr, nb + nc)
    qat_steps(f"QAT odd grid, {int(res_odd.state.num_active)} active", res_odd.state, bundle_odd,
              mos_odd, cfg_odd, target_odd, tcfg_q.prune_iter, model_lr, na + nd)
    # fit_batch's block step: one replay steps every image of the block
    bcfg, btc = batch["cfg"], batch["tcfg"]
    tss_b = [tr._morton_resort(ts, bcfg) for ts in batch["states"]]
    txb = tr.make_optimizer(btc)
    box_b = [tss_b]

    def block_step():
        box_b[0] = [tr.train_step(ts, t_, bcfg, btc, txb)[0]
                    for ts, t_ in zip(box_b[0], batch["targets"])]

    step_times(f"fit_batch block of {n_img}", tr.ChunkRunner(
        psh._block_chunk(list(batch["targets"]), bcfg, btc, btc.prune_iter, True), True),
        psh._block_carry(tss_b, bcfg), btc.prune_iter, block_step, nb + nc, per=n_img)
    st = info["steps"]
    line = "(h) fused dispatch: " + "; ".join(
        f"{k} {v['graphed_ms']:.4f} ms graphed / {v['eager_ms']:.4f} eager (busy "
        f"{v['busy_ms']:.4f}, capture {v['capture_ms']:.0f} ms)" for k, v in st.items()) + (
        "; graphed / eager: " + ", ".join(
            f"{k} {v['graphed_s']:.2f} / {v['eager_s']:.2f} s" for k, v in info.items()
            if "graphed_s" in v))
    return info, line


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


def write_report(name: str = "chip_smoke_report.json", data=None) -> None:
    """Write ``data`` (default: this run's report) as JSON into the output
    directory."""
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / name).write_text(json.dumps(report if data is None else data, indent=1))


def run() -> None:
    from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream
    from gaussianimage_plus_tpu_torch.compress.pipeline import (
        _decode_attributes, decode_frame, morton_reorder, prepare_decode)
    from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians, morton_perm
    from gaussianimage_plus_tpu_torch.core.gaussian2d import (project_gaussians_2d_covariance,
                                                              tile_bounds_for)
    from gaussianimage_plus_tpu_torch.core.render_dense import render_dense
    from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
    from gaussianimage_plus_tpu_torch.kernels import (_build, binning_tiles, raster_binned,
                                                      raster_dense, raster_list)
    from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
    from gaussianimage_plus_tpu_torch.train import trainer as tr

    kernel_a, kernel_b = raster_binned.tile_table_forward, raster_list.chunk_list_forward
    plain_a, plain_b = raster_binned.tile_table_forward_plain, raster_list.chunk_list_forward_plain
    kernel_c, plain_c = raster_list.chunk_backward, raster_list.chunk_backward_plain
    kernel_d, plain_d = raster_binned.tile_table_backward, raster_binned.tile_table_backward_plain
    kernel_e, plain_e = binning_tiles.tile_bin, binning_tiles.tile_bin_plain
    kernels = {"a": kernel_a, "b": kernel_b, "c": kernel_c, "d": kernel_d, "e": kernel_e}
    path_launches: dict = {}

    def reset_launches() -> None:
        for k in kernels.values():
            k.launches = 0

    def read_launches(path: str) -> dict:
        n = {key: k.launches for key, k in kernels.items()}
        path_launches[path] = n
        return n

    def compare_a(name, inputs, h, w):
        """Kernel A on (table, slot ids, counts) against its plain version on
        the card: the same sigma chain and each pixel's rows in slot order,
        so the two must agree bit for bit."""
        out, ref = kernel_a(*inputs, h, w), plain_a(*inputs, h, w)
        mx = compare(name, out, ref)
        check(torch.equal(out, ref), f"{name}: not bit-equal to the plain version (max {mx:.3g})")
        return mx
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
    ptxas = _build.build_all(["tile_table_forward", "chunk_list_forward", "chunk_backward",
                              "tile_table_backward", "tile_bin", "chunk_lists"])
    build_s = time.perf_counter() - t0
    log(f"[2] built the six kernels in {build_s:.1f} s (sm_90a, one nvcc per source)")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"    {name}: {line.strip()}")
    report["build_s"] = build_s

    # ---- fixtures
    streams = sorted((ROOT / "results").glob("bitstreams*/*.gipb"))
    states = sorted(p for d in ("repr_states_cn", "repr_states_plain")
                    for p in (ROOT / "results" / d).glob("*.npz"))
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
    err = {"a": 0.0, "b": 0.0, "c": 0.0, "d": 0.0, "e": 0.0}
    _, dec01 = decode_bitstream(kodim01, device=dev)
    cfg01 = stream_cfg(dec01)
    H, W = cfg01.H, cfg01.W
    prep_full = prepare_decode(dec01.bundle, dec01.enc, dec01.bound, cfg01, dec01.qcfg, trim=False)
    prep_trim = prepare_decode(dec01.bundle, dec01.enc, dec01.bound, cfg01, dec01.qcfg)
    log(f"  kodim01: {int(dec01.enc.num_active)} Gaussians, slot ids K {prep_full.ids.shape[1]} "
        f"untrimmed / {prep_trim.ids.shape[1]} trimmed, {int(prep_trim.counts.sum())} members")
    for tag, prep in (("untrimmed cap 256", prep_full), ("trimmed bin-once", prep_trim)):
        err["a"] = max(err["a"], compare_a(f"A kodim01 {tag}", prep, H, W))

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
    # kernel B over the dense, sweep and range enumerations (the chunks the
    # three TPU kernels visit, the range's through the residual interval):
    # kodim01 in stream and Morton order (kept for the timings) and a fitted state
    enum_inputs = {}
    for order, (proj_, col_, ones_), (h_, w_), timed in (
            ("stream order", stream_inputs(dec01, cfg01), (H, W), True),
            ("Morton order", (proj_m, col_m, ones_m), (H, W), True),
            (f"{states[0].parent.name}/{states[0].stem}", (proj_s, col_s, ones_s),
             (cfg_s.H, cfg_s.W), False)):
        for kname, kc, lists in (("dense", raster_dense.DENSE_KC, raster_dense.dense_lists),
                                 ("sweep", raster_dense.SWEEP_KC, raster_dense.sweep_lists),
                                 ("range", raster_dense.SWEEP_KC, raster_dense.range_lists)):
            table_, bbox_, n_, np_ = raster_list._table_bbox(proj_, col_, ones_, h_, w_, kc)
            inp_ = (table_, bbox_) + tuple(lists(table_, bbox_, n_, np_, kc, h_, w_))
            err["b"] = max(err["b"], compare(f"B {order} {kname} kc {kc}",
                                             kernel_b(*inp_, kc, h_, w_),
                                             plain_b(*inp_, kc, h_, w_)))
            if timed:
                enum_inputs[(kname, order)] = (inp_, kc)

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
    tab_o = raster_binned._slot_table(proj_o.xys, proj_o.conics, col_o, ones_o, bins_o.ids,
                                      bins_o.mask)
    err["a"] = max(err["a"], compare_a("A synthetic 500x760", tab_o, Ho, Wo))
    inp_o = raster_list.list_inputs(proj_o, col_o, ones_o, Ho, Wo, 128)
    err["b"] = max(err["b"], compare("B synthetic 500x760 kc 128",
                                     kernel_b(*inp_o, 128, Ho, Wo), plain_b(*inp_o, 128, Ho, Wo)))

    # kernel C, with the L2 cotangent against the fit's target and a seeded normal one
    d_gt = dict(np.load(ROOT / "results" / "repr_states_plain" / "kodim01.npz"))
    cfg_gt = config_from_numpy(d_gt)
    with torch.no_grad():
        gt = gi.render(state_from_numpy(d_gt, device=dev), cfg_gt)

    def l2_cotangent(img, target=gt):
        return (2.0 * (img - target) / img.numel()).contiguous()

    def normal_cotangent(h, w, seed):
        r = np.random.default_rng(seed)
        return torch.as_tensor(r.normal(size=(h, w, 3)).astype(np.float32), device=dev)

    def morton_state(s, cfg):
        perm = morton_perm(s.params.xyz, s.active, cfg.H, cfg.W)
        return s._replace(params=gi.GaussianParams(*(p[perm] for p in s.params)),
                          active=s.active[perm], bound=s.bound[perm])

    def c_inputs(proj, colors, h, w, kc):
        table, bbox, _, _ = raster_list._table_bbox(proj, colors, torch.ones(
            (proj.xys.shape[0],), device=dev), h, w, kc)
        return table, bbox

    def compare_c(tag, proj, colors, h, w, kc, cotangents):
        table, bbox = c_inputs(proj, colors, h, w, kc)
        for ctag, cot in cotangents.items():
            err["c"] = max(err["c"], compare_payload(f"C {tag} kc {kc}, {ctag} cotangent",
                                                     kernel_c, plain_c, (table, bbox, cot)))

    st_m = morton_state(st, cfg_s)
    proj_sm, col_sm = gi.project(st_m.params, st_m.active, st_m.bound, cfg_s), gi.colors_of(st_m.params, cfg_s)
    with torch.no_grad():
        cot_sm = {"L2": l2_cotangent(gi.render(st_m, cfg_s)),
                  "normal": normal_cotangent(cfg_s.H, cfg_s.W, 1)}
    for kc in (128, 64):
        compare_c(f"{states[0].parent.name}/{states[0].stem} Morton", proj_sm, col_sm,
                  cfg_s.H, cfg_s.W, kc, cot_sm)
    img01_s, _ = decode_bitstream(kodim01, device=dev)
    proj01_s, col01_s, _ = stream_inputs(dec01, cfg01)
    compare_c("kodim01 stream order", proj01_s, col01_s, H, W, 128,
              {"L2": l2_cotangent(img01_s), "normal": normal_cotangent(H, W, 2)})
    n_s = cfg_s.max_num_points
    ones_sm = torch.ones((n_s,), device=dev)

    def packed(grads):
        v_xy, v_con, v_col, v_op = grads
        return torch.cat([v_xy, v_con, v_col, v_op[:, None], v_xy.new_zeros((v_xy.shape[0], 7))], 1)

    t128, b128, _, _ = raster_list._table_bbox(proj_sm, col_sm, ones_sm, cfg_s.H, cfg_s.W,
                                               raster_dense.DENSE_KC)
    err["c"] = max(err["c"], compare_payload(
        "C dense_backward, fitted state Morton, L2 cotangent",
        lambda cot: packed(raster_dense.dense_backward(proj_sm, col_sm, ones_sm, cot, cfg_s.H, cfg_s.W)),
        lambda cot: packed(raster_list.split_payload(plain_c(t128, b128, cot), n_s, ones_sm)),
        (cot_sm["L2"],)))
    compare_c("synthetic 500x760", proj_o, col_o, Ho, Wo, 128,
              {"normal": normal_cotangent(Ho, Wo, 3)})
    # kernels B and C on the converged 2K state (2040x1344, 19,691 of 20,000
    # rows) in Morton order, as the 2K 'auto' fit trains it (list_t, kc 128)
    d_2k = dict(np.load(STATE_2K))
    cfg_2k = config_from_numpy(d_2k)
    st_2k = morton_state(state_from_numpy(d_2k, device=dev), cfg_2k)
    proj_2k = gi.project(st_2k.params, st_2k.active, st_2k.bound, cfg_2k)
    col_2k = gi.colors_of(st_2k.params, cfg_2k)
    inp_2k = raster_list.list_inputs(proj_2k, col_2k, torch.ones((cfg_2k.max_num_points,),
                                                                 device=dev),
                                     cfg_2k.H, cfg_2k.W, 128)
    err["b"] = max(err["b"], compare("B 2K state Morton kc 128",
                                     kernel_b(*inp_2k, 128, cfg_2k.H, cfg_2k.W),
                                     plain_b(*inp_2k, 128, cfg_2k.H, cfg_2k.W)))
    compare_c("2K state Morton", proj_2k, col_2k, cfg_2k.H, cfg_2k.W, 128,
              {"normal": normal_cotangent(cfg_2k.H, cfg_2k.W, 4),
               "normal, another seed": normal_cotangent(cfg_2k.H, cfg_2k.W, 5)})

    # kernel D on binned tables (cap 256), kernel E against 'top_k' and 'hier'
    def d_inputs(proj, colors, h, w, bins=None):
        if bins is None:
            bins = bin_gaussians(proj, h, w, cap=256)
        n = proj.xys.shape[0]
        table, ids, counts = raster_binned._slot_table(proj.xys, proj.conics, colors,
                                                       torch.ones((n,), device=dev), bins.ids,
                                                       bins.mask)
        bbox = raster_binned.tile_bbox_table(proj.xys, proj.radii, tile_bounds_for(h, w))
        return table, counts, ids, bbox

    def compare_d(tag, proj, colors, h, w, cotangents, bins=None):
        inp = d_inputs(proj, colors, h, w, bins)
        for ctag, cot in cotangents.items():
            err["d"] = max(err["d"], compare_payload(f"D {tag}, {ctag} cotangent",
                                                     kernel_d, plain_d, (*inp, cot)))
        return inp

    def compare_e(tag, proj, h, w, cap=256):
        tb_ = tile_bounds_for(h, w)
        bbox = binning_tiles.tile_bbox_table(proj.xys, proj.radii, tb_, proj.valid)
        ids, count = kernel_e(bbox, *tb_, cap)
        ref = bin_gaussians(proj, h, w, cap=cap, method="top_k")
        hier = bin_gaussians(proj, h, w, cap=cap, method="hier")
        sync()
        mask = torch.arange(cap, device=dev)[None, :] < count[:, None]
        check(torch.equal(ids, ref.ids) and torch.equal(mask, ref.mask)
              and torch.equal(count, ref.count), f"E {tag}: differs from 'top_k'")
        overflow = int(hier.super_overflow)
        same_hier = (torch.equal(ids, hier.ids) and torch.equal(mask, hier.mask)
                     and torch.equal(count, hier.count))
        check(same_hier or overflow > 0, f"E {tag}: differs from 'hier' without super overflow")
        log(f"  E {tag}: ids, mask and count equal 'top_k' ({int(count.sum())} members, at most "
            f"{int(count.max())} in a tile); 'hier' super_overflow {overflow}, "
            f"{'equal' if same_hier else 'differs'}")
        report["phases"].setdefault("kernel_vs_plain", []).append(
            dict(name=f"E {tag}", equal_top_k=True, hier_super_overflow=overflow,
                 equal_hier=same_hier))
        return bbox

    cot01 = l2_cotangent(img01_s)
    inp_d01 = compare_d("kodim01 stream order", proj01_s, col01_s, H, W,
                        {"L2": cot01, "normal": normal_cotangent(H, W, 4)})
    r_o = np.random.default_rng(5)
    target_o = torch.as_tensor(r_o.uniform(0, 1, (Ho, Wo, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        img_o = torch.clamp(kernel_a(*tab_o, Ho, Wo), 0, 1)
    compare_d("synthetic 500x760", proj_o, col_o, Ho, Wo,
              {"L2": l2_cotangent(img_o, target_o), "normal": normal_cotangent(Ho, Wo, 6)})
    # a tile forced over its cap: 400 centres inside the tile at (80, 80)
    xy_c = xy.copy()
    xy_c[:400] = np.float32(80.0) + r_o.uniform(0.2, 15.8, (400, 2)).astype(np.float32)
    proj_c = project_gaussians_2d_covariance(torch.as_tensor(xy_c, device=dev), cov, Ho, Wo)
    bins_c = bin_gaussians(proj_c, Ho, Wo, cap=256)
    most_c = int(bin_gaussians(proj_c, Ho, Wo, cap=2048).count.max())
    check(most_c > 256 and int(bins_c.count.max()) == 256, f"over-cap case: {most_c} in a tile")
    log(f"  over-cap case: {most_c} members in the crowded tile, cap 256")
    compare_d(f"synthetic over cap ({most_c} in a tile)", proj_c, col_o, Ho, Wo,
              {"normal": normal_cotangent(Ho, Wo, 7)}, bins_c)
    # kernel B on the same crowded tile: more members than its shared list
    # holds, so the tile blends its list several times
    inp_crowd = raster_list.list_inputs(proj_c, col_o, ones_o, Ho, Wo, 128)
    err["b"] = max(err["b"], compare(f"B synthetic crowded tile ({most_c} members) kc 128",
                                     kernel_b(*inp_crowd, 128, Ho, Wo),
                                     plain_b(*inp_crowd, 128, Ho, Wo)))
    compare_e(f"synthetic over cap ({most_c} in a tile)", proj_c, Ho, Wo)
    st_gt = state_from_numpy(d_gt, device=dev)
    proj_gt = gi.project(st_gt.params, st_gt.active, st_gt.bound, cfg_gt)
    bbox_e01 = compare_e("repr_states_plain/kodim01", proj_gt, cfg_gt.H, cfg_gt.W)

    # ---- 4. main paths
    log("[4] main path: decode every committed stream, render every fitted state")
    reset_launches()
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
    launches = read_launches("decode and render")
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

    # the fit: a 768x512 target from 2500 random Gaussians, grown to 5000
    cfg_fit = gi.GaussianConfig()
    fit_target = gt
    tcfg = tr.TrainConfig(**FIT)
    check(gi.resolve_backend(cfg_fit, dev) == "list_t",
          f"fit: 'auto' resolved to {gi.resolve_backend(cfg_fit, dev)!r}")
    log(f"[4] main path: fit_image of the render of results/repr_states_plain/kodim01.npz, "
        f"{FIT_POINTS} Gaussians up to {cfg_fit.max_num_points}, {FIT}")
    def run_fit(tag, target, cfg, fit, points, rise_db, grows):
        """``fit_image`` as one main path, with its checks; returns
        (result, launches)."""
        tc = tr.TrainConfig(**fit)
        reset_launches()
        t_fit = time.perf_counter()
        res_ = tr.fit_image(target, cfg, tc, points, seed=FIT_SEED, device=dev)
        sync()
        fit_s = time.perf_counter() - t_fit
        n = read_launches(tag)
        hist = {k: v.cpu().numpy() for k, v in res_.history.items()}
        psnr_ = hist["psnr"]
        steps = fit["iterations"]
        at = {s_: float(psnr_[s_ - 1]) for s_ in sorted({1, min(100, steps), steps // 2, steps})}
        grow_note = ""
        info = dict(seconds=fit_s, launches=n, psnr_at=at, best_psnr=res_.best_psnr,
                    best_iter=res_.best_iter, num_active_per_chunk=hist["num_active"].tolist(),
                    pruned=int(hist["n_pruned"].sum()))
        if grows:
            g = fit["grow_iter"] // fit["prune_iter"] - 1        # the chunk that grows
            n_before = int(hist["num_active"][g] - hist["n_added"][g])
            n_after = int(hist["num_active"][g])
            grow_note = f"active {n_before} -> {n_after} at the growth, "
            info.update(active_before_growth=n_before, active_after_growth=n_after)
            check(n_after > n_before, f"{tag}: the growth did not add Gaussians "
                  f"({n_before} -> {n_after})")
        log(f"  {tag}: {steps} steps in {fit_s:.1f} s; launches: "
            + ", ".join(f"{k.__name__} {n[key]}" for key, k in kernels.items())
            + "; PSNR at steps " + "/".join(map(str, at)) + ": "
            + " / ".join(f"{v:.4f}" for v in at.values())
            + f" dB; best {res_.best_psnr:.4f} dB at step {res_.best_iter}; {grow_note}"
            f"{int(res_.state.num_active)} in the best state; pruned "
            f"{int(hist['n_pruned'].sum())} in all")
        report["phases"][tag] = info
        check(bool(np.isfinite(hist["loss"]).all() and np.isfinite(psnr_).all()),
              f"{tag}: non-finite loss or PSNR")
        check(res_.best_psnr >= psnr_[0] + rise_db, f"{tag}: best PSNR {res_.best_psnr:.3f} dB "
              f"is not {rise_db} dB above the first step's {psnr_[0]:.3f} dB")
        return res_, n

    res, launches_fit = run_fit("fit", fit_target, cfg_fit, FIT, FIT_POINTS, 5.0, True)
    check(launches_fit["c"] == FIT["iterations"], f"fit: kernel C launched {launches_fit['c']} times")
    check(launches_fit["b"] >= FIT["iterations"], f"fit: kernel B launched {launches_fit['b']} times")

    # the same 100 steps through kernels B + C and through the plain binned path
    ts0 = tr.init_train_state(cfg_fit, tcfg, FIT_POINTS, seed=FIT_SEED + 1, device=dev)
    g0 = ts0.gaussians
    most = int(bin_gaussians(gi.project(g0.params, g0.active, g0.bound, cfg_fit), cfg_fit.H,
                             cfg_fit.W, cap=cfg_fit.tile_cap + 1).count.max())
    check(most <= cfg_fit.tile_cap, f"agreement run: a tile holds {most} > cap at init")
    agree_psnr = {}
    cfg_bin = dataclasses.replace(cfg_fit, raster_backend="pallas", bin_method="pallas")
    for backend, cfg in (("auto", dataclasses.replace(cfg_fit, raster_backend="auto")),
                         ("xla", dataclasses.replace(cfg_fit, raster_backend="xla")),
                         ("pallas", cfg_bin)):
        reset_launches()
        _, m = tr.train_chunk(ts0, fit_target, cfg, tcfg, AGREE_STEPS, False, False)
        agree_psnr[backend] = m["psnr"].cpu().numpy()
        read_launches(f"{AGREE_STEPS} steps {backend}")
    agree_db = float(np.abs(agree_psnr["auto"] - agree_psnr["xla"]).max())
    log(f"  {AGREE_STEPS} steps 'auto' (kernels B + C) vs 'xla' (plain, cap 256, at most {most} "
        f"in a tile at init): PSNR {agree_psnr['auto'][-1]:.4f} vs {agree_psnr['xla'][-1]:.4f} dB "
        f"at the last step, at most {agree_db:.3g} dB apart")
    report["phases"]["auto_vs_xla"] = dict(max_db=agree_db, steps=AGREE_STEPS,
                                           psnr_auto=agree_psnr["auto"].tolist(),
                                           psnr_xla=agree_psnr["xla"].tolist())
    check(agree_db <= AGREE_DB, f"'auto' and 'xla' fits differ by {agree_db:.3g} dB")

    # (a) the binned fit: kernels A, D and E once a step
    log(f"[4] main path (a): the same fit through raster_backend='pallas', bin_method='pallas'")
    res_bin, launches_bin = run_fit("binned fit", fit_target, cfg_bin, FIT, FIT_POINTS, 5.0, True)
    for key in "ade":
        check(launches_bin[key] == FIT["iterations"],
              f"binned fit: kernel {key.upper()} launched {launches_bin[key]} times")

    # (b) 'pallas' + kernel E against 'xla' + 'top_k': one capped function
    n_b = path_launches[f"{AGREE_STEPS} steps pallas"]
    bin_db = float(np.abs(agree_psnr["pallas"] - agree_psnr["xla"]).max())
    log(f"[4] main path (b): {AGREE_STEPS} steps 'pallas' + kernel E (launches: A {n_b['a']}, "
        f"D {n_b['d']}, E {n_b['e']}) vs 'xla' + top_k: PSNR {agree_psnr['pallas'][-1]:.4f} vs "
        f"{agree_psnr['xla'][-1]:.4f} dB at the last step, at most {bin_db:.3g} dB apart")
    report["phases"]["pallas_vs_xla"] = dict(max_db=bin_db, steps=AGREE_STEPS,
                                             psnr_pallas=agree_psnr["pallas"].tolist())
    check(all(n_b[key] == AGREE_STEPS for key in "ade"), f"(b): launches {n_b}")
    check(bin_db <= AGREE_DB, f"'pallas' and 'xla' fits differ by {bin_db:.3g} dB")

    # (c) an odd tile grid: 'auto' resolves to the binned pair
    oh, ow = ODD_HW
    cfg_odd = gi.GaussianConfig(H=oh, W=ow)
    check(gi.resolve_backend(cfg_odd, dev) == "pallas",
          f"odd grid: 'auto' resolved to {gi.resolve_backend(cfg_odd, dev)!r}")
    log(f"[4] main path (c): fit_image of the top-left {oh}x{ow} crop "
        f"({-(-ow // 16)}x{-(-oh // 16)} tiles), 'auto' -> 'pallas', {ODD_FIT}")
    target_odd = fit_target[:oh, :ow].contiguous()
    res_odd, launches_odd = run_fit("odd-grid fit", target_odd, cfg_odd, ODD_FIT, FIT_POINTS,
                                    ODD_RISE_DB, False)
    check(launches_odd["d"] == ODD_FIT["iterations"] == launches_odd["a"],
          f"odd grid: kernels A and D launched {launches_odd['a']} and {launches_odd['d']} times")

    # (d) the 2K point: 'pallas' with 'hier' binning
    h2, w2 = K2_HW
    target2k = torch.as_tensor(np.kron(np.random.default_rng(1).uniform(0, 1, (84, 128, 3)),
                                       np.ones((16, 16, 1)))[:h2, :w2].astype(np.float32),
                               device=dev)
    cfg2k = gi.GaussianConfig(H=h2, W=w2, max_num_points=K2_POINTS, raster_backend="pallas")
    ts2k = tr.init_train_state(cfg2k, tcfg, K2_POINTS, seed=FIT_SEED, device=dev)
    g2k = ts2k.gaussians
    bins2k = bin_gaussians(gi.project(g2k.params, g2k.active, g2k.bound, cfg2k), h2, w2,
                           cap=cfg2k.tile_cap, method=cfg2k.bin_method)
    check(bins2k.super_overflow is not None, "2K: bin_method='auto' did not pick 'hier'")
    log(f"[4] main path (d): fit_image at {h2}x{w2}, {K2_POINTS} Gaussians, {K2_STEPS} steps, "
        f"'pallas' with 'auto' -> 'hier' binning (super_overflow at init "
        f"{int(bins2k.super_overflow)})")
    # two chunks, so that the second replays the graph the first warms up
    fit2k = dict(iterations=K2_STEPS, prune_iter=K2_STEPS // 2)
    res2k, launches_2k = run_fit("2K fit", target2k, cfg2k, fit2k, K2_POINTS, 0.0, False)
    check(launches_2k["a"] == launches_2k["d"] == K2_STEPS, f"2K: launches {launches_2k}")
    s2k = res2k.state
    proj2k = gi.project(s2k.params, s2k.active, s2k.bound, cfg2k)
    bins2k = bin_gaussians(proj2k, h2, w2, cap=cfg2k.tile_cap, method=cfg2k.bin_method)
    log(f"  2K best state: super_overflow {int(bins2k.super_overflow)}, at most "
        f"{int(bins2k.count.max())} in a tile")
    report["phases"]["2K fit"]["super_overflow"] = int(bins2k.super_overflow)

    # (e) the dense, sweep and range kernels against list_t
    log("[4] main path (e): every fitted state through render_fast, dense / sweep / range vs list_t")
    reset_launches()
    by_enum = dict.fromkeys(("list_t", "dense", "sweep", "range"), 0)   # kernel B, per enumeration

    def render_counted(kname, s, cfg, sweep):
        n0 = kernel_b.launches
        img = gi.render_fast(s, cfg, sweep=sweep)
        by_enum[kname] += kernel_b.launches - n0
        return img

    for path in states:
        name = f"{path.parent.name}/{path.stem}"
        d = dict(np.load(path))
        cfg = config_from_numpy(d)
        s = state_from_numpy(d, device=dev)
        ref = render_counted("list_t", s, cfg, "list_t")
        for kname, sweep in (("dense", False), ("sweep", True), ("range", "range")):
            img = render_counted(kname, s, cfg, sweep)
            valid_image(f"{name} {kname}", img, (cfg.H, cfg.W, 3))
            agree(f"{name} {kname} vs list_t", img, ref)
    sync()
    launches_e = read_launches("render_fast dense / sweep / range")
    check(launches_e["b"] == 4 * len(states), f"(e): kernel B launched {launches_e['b']} times")
    check(all(n == len(states) for n in by_enum.values()), f"(e): kernel B per enumeration {by_enum}")

    by_enum_g = dict.fromkeys(("list_t", "dense", "sweep"), 0)   # kernel B, per enumeration

    def loss_grads(st_, cfg, backend):
        n0 = kernel_b.launches
        params = gi.GaussianParams(*(p.detach().clone().requires_grad_(True) for p in st_.params))
        img = gi.render(st_._replace(params=params), dataclasses.replace(cfg, raster_backend=backend))
        grads = torch.autograd.grad(torch.mean((img - gt) ** 2), params)
        by_enum_g[backend] += kernel_b.launches - n0
        return grads

    reset_launches()
    g_ref = loss_grads(st, cfg_s, "list_t")
    grad_rel = 0.0
    for backend in ("dense", "sweep"):
        for a, b, pname in zip(loss_grads(st, cfg_s, backend), g_ref, ("xyz", "cov2d", "features")):
            dcol, scale = (a - b).abs().amax(0), b.abs().amax(0)
            grad_rel = max(grad_rel, float((dcol / scale.clamp(min=1e-30)).max()))
            check(bool((dcol <= C_REL * scale).all()), f"(e) {backend} {pname} gradient differs "
                  f"from list_t's by more than {C_REL} of a column's max")
    sync()
    launches_g = read_launches("render dense / sweep gradients")
    check(launches_g["b"] == launches_g["c"] == 3, f"(e) gradients: launches {launches_g}")
    log(f"  {len(states)} states x 3 kernels agree with list_t (launches: B {launches_e['b']}); "
        f"gradients of {states[0].parent.name}/{states[0].stem} through dense and sweep within "
        f"{grad_rel:.3g} of each column's max of list_t's (launches: B {launches_g['b']}, "
        f"C {launches_g['c']})")
    report["phases"]["dense_sweep_range"] = dict(launches=launches_e, grad_launches=launches_g,
                                                 kernel_b_per_enumeration=by_enum,
                                                 grad_worst_column_rel=grad_rel)

    # (f) the coding path: warm-started QAT through kernels B and C, the
    # encoder, the .gipb written and decoded back through kernels A and B
    from gaussianimage_plus_tpu_torch.compress import pipeline as pl
    from gaussianimage_plus_tpu_torch.compress import trainer as ctr
    from gaussianimage_plus_tpu_torch.train.metrics import psnr as psnr_fn

    qcfg = pl.QuantConfig()
    cfg_q = gi.GaussianConfig()
    check(gi.resolve_backend(cfg_q, dev) == "list_t",
          f"coding path: 'auto' resolved to {gi.resolve_backend(cfg_q, dev)!r}")
    warm, qat_steps = QAT["warmup_iter"], QAT["steps"]
    tcfg_q = tr.TrainConfig(iterations=warm + qat_steps, prune_iter=100)
    log(f"[4] main path (f): fit_image_quantized at {cfg_q.W}x{cfg_q.H}, up to "
        f"{cfg_q.max_num_points} Gaussians, default QuantConfig (xy {qcfg.xy_bit}-bit LSQ, "
        f"covariance {qcfg.cov_bit}-bit hybrid, colour {qcfg.color_bit}-bit LSQ), warm-started "
        f"from the 'auto' fit's best state ({int(res.state.num_active)} active), warmup "
        f"{warm} steps (one prune, no growth), {qat_steps} QAT steps; cut from the reference's "
        f"6000 warmup and 44,000 QAT steps for the time limit, nothing else cut")
    reset_launches()
    t_q = time.perf_counter()
    res_q = ctr.fit_image_quantized(fit_target, cfg_q, tcfg_q, qcfg, FIT_POINTS, warmup_iter=warm,
                                    seed=FIT_SEED, init_state=res.state)
    sync()
    qat_s = time.perf_counter() - t_q
    n_q = read_launches("coding path: fit_image_quantized")
    p_q = res_q.metrics["psnr"].cpu().numpy()
    check(p_q.shape == (qat_steps,) and bool(np.isfinite(p_q).all()), "QAT: non-finite PSNR")
    check(n_q["c"] == warm + qat_steps and n_q["b"] >= warm + qat_steps,
          f"QAT: kernels B and C launched {n_q['b']} and {n_q['c']} times in {warm + qat_steps} steps")
    check(res_q.best_psnr >= float(p_q[0]), f"QAT: best {res_q.best_psnr:.4f} dB under the first "
          f"QAT step's {float(p_q[0]):.4f} dB")
    log(f"  fit_image_quantized: {warm + qat_steps} steps in {qat_s:.1f} s; launches: "
        + ", ".join(f"{k.__name__} {n_q[key]}" for key, k in kernels.items())
        + f"; QAT PSNR first {float(p_q[0]):.4f}, last {float(p_q[-1]):.4f}, best "
        f"{res_q.best_psnr:.4f} dB; {int(res_q.state.num_active)} active")
    report["phases"]["coding path: fit_image_quantized"] = dict(
        seconds=qat_s, launches=n_q, qat_psnr_first=float(p_q[0]), qat_psnr_last=float(p_q[-1]),
        best_psnr=res_q.best_psnr, warmup_psnr_last=float(res_q.metrics["warmup_psnr"][-1]))

    # QAT steps through kernels B + C against the plain capped path, each from
    # the plain path's state: the two free runs part (a code at a half-integer
    # tie rounds either way once float32 sums differ in the last bits), so a
    # step is held from one start: the PSNR of its render and of the state it
    # makes (both rendered through the plain quantized forward)
    st_a = res.state
    most_q = int(bin_gaussians(gi.project(st_a.params, st_a.active, st_a.bound, cfg_q), cfg_q.H,
                               cfg_q.W, cap=cfg_q.tile_cap + 1).count.max())
    check(most_q <= cfg_q.tile_cap, f"QAT agreement: a tile holds {most_q} > cap at the start")
    cfg_x = dataclasses.replace(cfg_q, raster_backend="xla")
    carry = (st_a, tr.make_optimizer(tcfg_q).init(st_a.params), pl.init_quantizers(st_a, cfg_x, qcfg),
             None)
    qat_psnr = {k: [] for k in ("auto", "xla", "auto next", "xla next")}

    def quant_psnr(b_, s_):
        with torch.no_grad():
            return psnr_fn(pl.render_quantized(b_, s_, cfg_x, qcfg)[0], fit_target)

    reset_launches()
    for _ in range(QAT_AGREE_STEPS):
        s_, m_, b_, best_ = carry
        s_a, _, b_a, m_a = pl.quant_train_chunk(s_, m_, b_, fit_target, cfg_q, qcfg, tcfg_q.lr, 1,
                                                best=best_)
        s_x, m_x, b_x, m_x_ = pl.quant_train_chunk(s_, m_, b_, fit_target, cfg_x, qcfg, tcfg_q.lr, 1,
                                                   best=best_)
        qat_psnr["auto"].append(m_a["psnr"][0])
        qat_psnr["xla"].append(m_x_["psnr"][0])
        qat_psnr["auto next"].append(quant_psnr(b_a, s_a))
        qat_psnr["xla next"].append(quant_psnr(b_x, s_x))
        carry = (s_x, m_x, b_x, m_x_["best"])
    qat_psnr = {k: torch.stack(v).cpu().numpy() for k, v in qat_psnr.items()}
    n_agree = read_launches(f"coding path: {QAT_AGREE_STEPS} QAT steps auto beside xla")
    check(n_agree["c"] == QAT_AGREE_STEPS and n_agree["b"] >= QAT_AGREE_STEPS,
          f"QAT 'auto': launches {n_agree} in {QAT_AGREE_STEPS} steps")
    qat_db = float(np.abs(qat_psnr["auto"] - qat_psnr["xla"]).max())
    qat_next_db = float(np.abs(qat_psnr["auto next"] - qat_psnr["xla next"]).max())
    log(f"  {QAT_AGREE_STEPS} QAT steps, each through 'auto' (kernels B + C) and 'xla' (plain, at "
        f"most {most_q} in a tile) from the plain path's state: the step's PSNR at most "
        f"{qat_db:.3g} dB apart, the PSNR of the state it makes at most {qat_next_db:.3g} dB "
        f"apart (last {qat_psnr['auto next'][-1]:.4f} vs {qat_psnr['xla next'][-1]:.4f} dB)")
    report["phases"]["qat_auto_vs_xla"] = dict(
        max_db=qat_db, next_max_db=qat_next_db, steps=QAT_AGREE_STEPS,
        **{f"psnr_{k.replace(' ', '_')}": v.tolist() for k, v in qat_psnr.items()})
    check(max(qat_db, qat_next_db) <= AGREE_DB,
          f"QAT 'auto' and 'xla' steps differ by {max(qat_db, qat_next_db):.3g} dB")

    # encode, write, decode back: stream order and Morton order
    coded = {}
    with tempfile.TemporaryDirectory() as tmp:
        for order in ("id", "morton"):
            path_s = Path(tmp) / f"kodim01_qat_{order}.gipb"
            reset_launches()
            stats = ctr.encode_decode_eval(res_q.state, res_q.bundle, fit_target, cfg_q, qcfg,
                                           n_renders=CODING_RENDERS, write_bitstream=str(path_s),
                                           stream_order=order)
            data = path_s.read_bytes()
            img_s, dec_s = decode_bitstream(data, device=dev)              # binned: kernel A
            cfg_s2 = stream_cfg(dec_s)
            prep_s = prepare_decode(dec_s.bundle, dec_s.enc, dec_s.bound, cfg_s2, dec_s.qcfg)
            frame_s = decode_frame(prep_s, cfg_s2)                            # kernel A
            img_sl, _ = decode_bitstream(data, backend="list_t", device=dev)  # kernel B
            sync()
            n_e = read_launches(f"coding path: encode_decode_eval {order}")
            for tag, im in (("decode_bitstream", img_s), ("decode_frame", frame_s),
                            ("list_t", img_sl)):
                valid_image(f"QAT stream {order} {tag}", im, (cfg_q.H, cfg_q.W, 3))
            agree(f"QAT stream {order}: decode_frame vs decode", frame_s, img_s)
            proj_sq, _, _ = stream_inputs(dec_s, cfg_s2)
            if not overflows(proj_sq, cfg_s2):
                agree(f"QAT stream {order}: list_t vs binned", img_sl, img_s)
            n_pts = stats["num_points"]
            hw = cfg_q.H * cfg_q.W
            bpp_formula = ((n_pts * 2 * qcfg.xy_bit + 128) + (n_pts * 3 * qcfg.cov_bit + 192)
                           + (n_pts * 3 * qcfg.color_bit + 192)) / hw
            tol_db = 1e-4 if order == "id" else 1e-3
            log(f"  encode_decode_eval ({order} order): {n_pts} points, PSNR {stats['psnr']:.4f} "
                f"dB, MS-SSIM {stats['ms_ssim']:.5f}, bpp {stats['bpp']:.5f}, bpp_wc "
                f"{stats['bpp_wc']:.5f}, bpp_stream {stats['bpp_stream']:.5f} ({len(data)} bytes), "
                f"stream PSNR {stats['stream_psnr']:.5f} dB, full decode "
                f"{stats['decode_full_time'] * 1e3:.4f} ms a frame; launches: "
                + ", ".join(f"{k.__name__} {n_e[key]}" for key, k in kernels.items()))
            check(abs(stats["bpp"] - bpp_formula) <= 1e-12, f"{order}: bpp {stats['bpp']} is not "
                  f"analysis_wo_ec's formula {bpp_formula}")
            check(stats["bpp_stream"] < stats["bpp"], f"{order}: bpp_stream {stats['bpp_stream']} "
                  f"not under bpp {stats['bpp']}")
            check(abs(stats["stream_psnr"] - stats["psnr"]) <= tol_db,
                  f"{order}: stream PSNR {stats['stream_psnr']} vs {stats['psnr']}")
            check(abs(stats["psnr"] - res_q.best_psnr) <= AGREE_DB,
                  f"{order}: encoded PSNR {stats['psnr']:.4f} vs best QAT {res_q.best_psnr:.4f} dB")
            check(n_e["a"] > 0 and n_e["b"] > 0, f"{order}: decode launches {n_e}")
            coded[order] = dict(stats, bytes=len(data))
            if order == "id":
                stream_q = data
        report["phases"]["coding path: encode"] = coded

        # the VQ colour path: QAT straight from the fit's best state, encoded and decoded back
        qcfg_vq = pl.QuantConfig(color_quant="vq")
        reset_launches()
        res_vq = ctr.fit_image_quantized(fit_target, cfg_q, tr.TrainConfig(iterations=VQ_STEPS,
                                                                           prune_iter=100),
                                         qcfg_vq, FIT_POINTS, warmup_iter=0, seed=FIT_SEED,
                                         init_state=res.state)
        path_vq = Path(tmp) / "kodim01_qat_vq.gipb"
        stats_vq = ctr.encode_decode_eval(res_vq.state, res_vq.bundle, fit_target, cfg_q, qcfg_vq,
                                          write_bitstream=str(path_vq))
        img_vq, dec_vq = decode_bitstream(path_vq.read_bytes(), device=dev)
        sync()
        n_vq = read_launches("coding path: VQ colour")
    valid_image("VQ stream", img_vq, (cfg_q.H, cfg_q.W, 3))
    p_vq = res_vq.metrics["psnr"].cpu().numpy()
    check(bool(np.isfinite(p_vq).all()) and np.isfinite(stats_vq["psnr"]), "VQ: non-finite PSNR")
    check(dec_vq.qcfg.color_quant == "vq" and abs(stats_vq["stream_psnr"] - stats_vq["psnr"]) <= 1e-4,
          f"VQ: the stream decodes to {stats_vq['stream_psnr']} dB, the encoding {stats_vq['psnr']}")
    check(n_vq["c"] == VQ_STEPS, f"VQ: kernel C launched {n_vq['c']} times")
    log(f"  VQ colour: {VQ_STEPS} QAT steps, best {res_vq.best_psnr:.4f} dB; encoded PSNR "
        f"{stats_vq['psnr']:.4f} dB, bpp {stats_vq['bpp']:.5f}, bpp_stream "
        f"{stats_vq['bpp_stream']:.5f}, stream PSNR {stats_vq['stream_psnr']:.5f} dB")
    report["phases"]["coding path: VQ colour"] = dict(stats_vq, best_psnr=res_vq.best_psnr,
                                                       launches=n_vq)

    # evaluate on the QAT result, MS-SSIM of the decoded image beside it
    reset_launches()
    ev = tr.evaluate(res_q.state, fit_target, cfg_q, n_renders=CODING_RENDERS)
    read_launches("coding path: evaluate")
    log(f"  evaluate (QAT state, unquantized render): PSNR {ev['psnr']:.4f} dB, MS-SSIM "
        f"{ev['ms_ssim']:.5f}, {ev['eval_time'] * 1e3:.4f} ms a render ({ev['fps']:.0f} FPS); "
        f"MS-SSIM of the decoded stream {coded['id']['ms_ssim']:.5f}")
    check(np.isfinite(ev["psnr"]) and 0 < ev["ms_ssim"] <= 1, f"evaluate: {ev}")
    report["phases"]["coding path: evaluate"] = ev

    # kernels D and E on the states the paths produced
    log("[3] kernels A, D and E on the fit and 2K states")
    g_b = res_bin.state
    proj_b, col_b = gi.project(g_b.params, g_b.active, g_b.bound, cfg_fit), gi.colors_of(g_b.params, cfg_fit)
    with torch.no_grad():
        cot_b = l2_cotangent(gi.render(g_b, cfg_bin), fit_target)
    inp_d = compare_d("binned fit state after growth", proj_b, col_b, cfg_fit.H, cfg_fit.W,
                      {"L2": cot_b, "normal": normal_cotangent(cfg_fit.H, cfg_fit.W, 8)})
    err["a"] = max(err["a"], compare_a("A binned fit state after growth",
                                       (inp_d[0], inp_d[2], inp_d[1]), cfg_fit.H, cfg_fit.W))
    bbox_e = compare_e("binned fit state after growth", proj_b, cfg_fit.H, cfg_fit.W)
    with torch.no_grad():
        cot2k = l2_cotangent(gi.render(s2k, cfg2k), target2k)
    inp_d2k = compare_d("2K state", proj2k, gi.colors_of(s2k.params, cfg2k), h2, w2,
                        {"L2": cot2k, "normal": normal_cotangent(h2, w2, 9)}, bins2k)
    err["a"] = max(err["a"], compare_a("A 2K state", (inp_d2k[0], inp_d2k[2], inp_d2k[1]),
                                       h2, w2))
    bbox_e2k = compare_e("2K state", proj2k, h2, w2)

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

    # (g) the entry points: launches reported apart, not in path_launches
    report["phases"]["entry points"], entry_line = entry_points(dev, fit_target, res.state,
                                                                kernels)

    # (p) and (l): parallel/ in a NCCL process group of one, the legacy 3DGS
    # model, the pixel counts; launches reported apart, as (g)'s
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as pg_dir:
        dist.init_process_group("nccl", init_method=f"file://{pg_dir}/store", rank=0,
                                world_size=1)
        try:
            report["phases"]["parallel"], report["phases"]["legacy"], par_line, batch = \
                parallel_and_legacy(dev, fit_target, res.state, s2k, cfg2k, target2k, kernels)
        finally:
            dist.destroy_process_group()

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
        "kernel A, kodim01 trimmed": launch_ms(lambda: kernel_a(*prep_trim, H, W)),
        "kernel A, kodim01 untrimmed": launch_ms(lambda: kernel_a(*prep_full, H, W)),
        "plain A, kodim01 trimmed": launch_ms(lambda: plain_a(*prep_trim, H, W)),
        "kernel B, kodim01 kc 128": launch_ms(lambda: kernel_b(*inp_l, 128, H, W)),
        "kernel B, kodim01 Morton kc 128": launch_ms(lambda: kernel_b(*inp_m, 128, H, W)),
        "plain B, kodim01 kc 128": launch_ms(lambda: plain_b(*inp_l, 128, H, W)),
    }
    # kernel B over the dense, sweep and range enumerations, on kodim01 in
    # stream and Morton order
    for (kname, order), (inp_, kc) in enum_inputs.items():
        times[f"kernel B, kodim01 {order}, {kname} kc {kc}"] = launch_ms(
            lambda inp_=inp_, kc=kc: kernel_b(*inp_, kc, H, W))
        if order == "stream order":
            times[f"plain B, kodim01 {order}, {kname} kc {kc}"] = launch_ms(
                lambda inp_=inp_, kc=kc: plain_b(*inp_, kc, H, W))
    # a train step after the growth: the fit's best state, in Morton order, fresh Adam
    ts_t = tr._morton_resort(tr.init_train_state(cfg_fit, tcfg, 0, gaussians=res.state), cfg_fit)
    tx = tr.make_optimizer(tcfg)
    cur = [ts_t]

    def one_step():
        cur[0] = tr.train_step(cur[0], fit_target, cfg_fit, tcfg, tx)[0]

    n_timed = int(ts_t.gaussians.num_active)
    times[f"train step, {n_timed} active, auto (list_t)"] = step_ms = median_ms(one_step)
    # the same step with Adan (the legacy models' optimizer), timed next to
    # Adam's and, like it, before the first profiler session of the process
    tcfg_adan = dataclasses.replace(tcfg, opt_type="adan")
    tx_adan = tr.make_optimizer(tcfg_adan)
    cur_adan = [tr._morton_resort(tr.init_train_state(cfg_fit, tcfg_adan, 0, gaussians=res.state),
                                  cfg_fit)]

    def one_step_adan():
        cur_adan[0] = tr.train_step(cur_adan[0], fit_target, cfg_fit, tcfg_adan, tx_adan)[0]

    times[f"train step, {n_timed} active, auto (list_t), Adan"] = step_adan_ms = median_ms(
        one_step_adan)
    log(f"  train step, {n_timed} active, auto (list_t): Adam {step_ms:.4f} ms, Adan "
        f"{step_adan_ms:.4f} ms")
    # kernel C at the timed fit's shapes, with the L2 cotangent of its render
    g_t = ts_t.gaussians
    proj_t, col_t = gi.project(g_t.params, g_t.active, g_t.bound, cfg_fit), gi.colors_of(g_t.params, cfg_fit)
    with torch.no_grad():
        cot_t = l2_cotangent(gi.render(g_t, cfg_fit), fit_target)
    table_c, bbox_c = c_inputs(proj_t, col_t, cfg_fit.H, cfg_fit.W, 128)
    err["c"] = max(err["c"], compare_payload("C timed fit state Morton kc 128, L2 cotangent",
                                             kernel_c, plain_c, (table_c, bbox_c, cot_t)))
    times["kernel C, fit state kc 128"] = launch_ms(lambda: kernel_c(table_c, bbox_c, cot_t))
    times["plain C, fit state kc 128"] = launch_ms(lambda: plain_c(table_c, bbox_c, cot_t))
    # and at kodim01's stream-order table (the gradients of path (e) run there)
    table_c01, bbox_c01 = c_inputs(proj01_s, col01_s, H, W, 128)
    times["kernel C, kodim01 stream order kc 128"] = launch_ms(
        lambda: kernel_c(table_c01, bbox_c01, cot01))
    # the same gradient on the sweep's table (kc 64 padding: sweep_backward)
    table_c64, bbox_c64 = c_inputs(proj_t, col_t, cfg_fit.H, cfg_fit.W, raster_dense.SWEEP_KC)
    times["kernel C, fit state kc 64"] = launch_ms(lambda: kernel_c(table_c64, bbox_c64, cot_t))
    times["plain C, fit state kc 64"] = launch_ms(lambda: plain_c(table_c64, bbox_c64, cot_t))
    # kernel B at the same state: 'auto' renders it through list_t (kc 128)
    inp_fit = raster_list.list_inputs(proj_t, col_t, torch.ones((proj_t.xys.shape[0],), device=dev),
                                      cfg_fit.H, cfg_fit.W, 128)
    err["b"] = max(err["b"], compare("B timed fit state Morton kc 128",
                                     kernel_b(*inp_fit, 128, cfg_fit.H, cfg_fit.W),
                                     plain_b(*inp_fit, 128, cfg_fit.H, cfg_fit.W)))
    times["kernel B, fit state kc 128"] = launch_ms(
        lambda: kernel_b(*inp_fit, 128, cfg_fit.H, cfg_fit.W))
    # kernel F at the timed fit state and the converged 2K state
    f_rows = kernel_f({
        "fit state": (*inp_fit[:2], inp_fit[0].shape[0], 128, inp_fit[2].shape[1],
                      cfg_fit.H, cfg_fit.W),
        "2K state": (*inp_2k[:2], inp_2k[0].shape[0], 128, inp_2k[2].shape[1],
                     cfg_2k.H, cfg_2k.W)})
    report["kernel_f"] = f_rows
    # kernel D at three states: the binned fit state after growth (its plain
    # version beside it), kodim01's binned table and the 2K state; kernel E at
    # the fit state
    d_states = {"binned fit state": (inp_d, cot_b, cfg_fit.H, cfg_fit.W),
                "kodim01 binned table": (inp_d01, cot01, H, W),
                "2K state": (inp_d2k, cot2k, h2, w2)}
    for tag, (inp_, cot_, _, _) in d_states.items():
        times[f"kernel D, {tag}"] = launch_ms(lambda inp_=inp_, cot_=cot_: kernel_d(*inp_, cot_))
    times["plain D, binned fit state"] = launch_ms(lambda: plain_d(*inp_d, cot_b))
    # kernel A on the binned tables of the fit and 2K states (the training
    # steps' launches), beside kodim01's bin-once table
    a_states = {"kodim01": (*prep_trim, H, W),
                "fit": (inp_d[0], inp_d[2], inp_d[1], cfg_fit.H, cfg_fit.W),
                "2K": (inp_d2k[0], inp_d2k[2], inp_d2k[1], h2, w2)}
    for tag in ("fit", "2K"):
        times[f"kernel A, {tag} state"] = launch_ms(lambda a=a_states[tag]: kernel_a(*a))
    tb_fit = tile_bounds_for(cfg_fit.H, cfg_fit.W)
    e_states = {"fit": (bbox_e, *tb_fit), "kodim01": (bbox_e01, *tile_bounds_for(H, W)),
                "2K": (bbox_e2k, *tile_bounds_for(h2, w2))}
    times["kernel E, binned fit state"] = launch_ms(lambda: kernel_e(bbox_e, *tb_fit, 256))
    for tag in ("kodim01", "2K"):
        times[f"kernel E, {tag} state"] = launch_ms(lambda e=e_states[tag]: kernel_e(*e, 256))
    times["plain E, binned fit state"] = launch_ms(lambda: plain_e(bbox_e, *tb_fit, 256))
    n_e = bbox_e.shape[0]
    t_e = torch.arange(tb_fit[0] * tb_fit[1], device=dev)
    tx_e = (t_e % tb_fit[0])[:, None]
    ty_e = torch.div(t_e, tb_fit[0], rounding_mode="floor")[:, None]
    member_e = ((tx_e >= bbox_e[None, :, 0]) & (tx_e < bbox_e[None, :, 1]) &
                (ty_e >= bbox_e[None, :, 2]) & (ty_e < bbox_e[None, :, 3]))
    key_e = torch.where(member_e, n_e - torch.arange(n_e, dtype=torch.int32, device=dev)[None, :],
                        torch.zeros((), dtype=torch.int32, device=dev))
    times["torch.topk(key, 256), binned fit state"] = launch_ms(lambda: torch.topk(key_e, 256, dim=1))
    for k, v in times.items():
        log(f"  {k}: {v:.4f} ms")
    report["times_ms"] = times
    # each kernel's own device time per call (queued behind a spin kernel),
    # beside the event time of 50 calls back to back above; kernel D's stages
    # from one profiler session each (none when the profiler did not trace them)
    names_a, names_b = ["tile_table_forward_kernel"], ["chunk_list_forward_kernel"]
    names_d = ["slot_start_kernel", "tile_payload_kernel", "payload_gather_kernel"]
    device_ms = {
        "kernel A, kodim01 trimmed": device_ms_per_call(lambda: kernel_a(*prep_trim, H, W)),
        "kernel B, kodim01 kc 128": device_ms_per_call(lambda: kernel_b(*inp_l, 128, H, W)),
        "kernel B, kodim01 Morton kc 128": device_ms_per_call(lambda: kernel_b(*inp_m, 128, H, W)),
        "kernel B, fit state kc 128": device_ms_per_call(
            lambda: kernel_b(*inp_fit, 128, cfg_fit.H, cfg_fit.W)),
        "kernel C, fit state kc 128": device_ms_per_call(lambda: kernel_c(table_c, bbox_c, cot_t)),
        "kernel C, kodim01 stream order kc 128": device_ms_per_call(
            lambda: kernel_c(table_c01, bbox_c01, cot01)),
        "kernel E, binned fit state": device_ms_per_call(lambda: kernel_e(bbox_e, *tb_fit, 256)),
    }
    for tag in ("fit", "2K"):
        device_ms[f"kernel A, {tag} state"] = device_ms_per_call(
            lambda a=a_states[tag]: kernel_a(*a))
    for tag in ("kodim01", "2K"):
        device_ms[f"kernel E, {tag} state"] = device_ms_per_call(
            lambda e=e_states[tag]: kernel_e(*e, 256))
    for (kname, order), (inp_, kc) in enum_inputs.items():
        device_ms[f"kernel B, kodim01 {order}, {kname} kc {kc}"] = device_ms_per_call(
            lambda inp_=inp_, kc=kc: kernel_b(*inp_, kc, H, W))
    d_stages = {}
    for tag, (inp_, cot_, _, _) in d_states.items():
        fn_d = functools.partial(kernel_d, *inp_, cot_)
        device_ms[f"kernel D, {tag}"] = device_ms_per_call(fn_d)
        _, rows_, missing_ = device_time_per_call(fn_d, kernels=names_d)
        d_stages[tag] = None if missing_ else [sum(ms for name, ms in rows_ if n in name)
                                               for n in names_d]
    for k, v in device_ms.items():
        log(f"  {k}: {v:.4f} ms device time a call (queued), {times[k]:.4f} ms back to back")
    report["device_ms"] = device_ms
    # kernel A's yardstick: the [T, K, 16] gather table[ids] that the binned
    # path ran before kernel A read through the slot ids (the port no longer
    # calls it), at each of A's states
    gather_ms = {}
    for tag, (table_, ids_, *_) in a_states.items():
        gather_ms[tag] = device_ms_per_call(lambda t_=table_, i_=ids_.long(): t_[i_])
        log(f"  table[ids] gather, {tag} state ({tuple(ids_.shape)} slots): {gather_ms[tag]:.4f} "
            f"ms device time a call (queued)")
    report["gather_device_ms"] = gather_ms
    # the same step through the plain binned path and its VJP, for comparison
    cfg_xla = dataclasses.replace(cfg_fit, raster_backend="xla")
    cur_xla = [tr.init_train_state(cfg_fit, tcfg, 0, gaussians=res.state)]

    def one_step_xla():
        cur_xla[0] = tr.train_step(cur_xla[0], fit_target, cfg_xla, tcfg, tx)[0]

    times[f"train step, {n_timed} active, xla (plain)"] = step_xla_ms = median_ms(one_step_xla)
    log(f"  train step, {n_timed} active, xla (plain): {step_xla_ms:.4f} ms")
    steps = [("auto (list_t)", one_step, step_ms, names_b + ["chunk_backward_kernel"]),
             ("auto (list_t), Adan", one_step_adan, step_adan_ms,
              names_b + ["chunk_backward_kernel"]),
             ("xla (plain)", one_step_xla, step_xla_ms, [])]

    def stepper(state, cfg, target):
        """A train step from ``state`` with a fresh Adam, one step per call."""
        box = [tr.init_train_state(cfg, tcfg, 0, gaussians=state)]

        def fn():
            box[0] = tr.train_step(box[0], target, cfg, tcfg, tx)[0]

        return fn

    # the binned step after the growth (stream order: clipping follows id order),
    # and the 2K step
    n_bin, n_2k = int(res_bin.state.num_active), int(res2k.state.num_active)
    for tag, state, cfg, target, names in (
            (f"{n_bin} active, pallas, top_k binning", res_bin.state,
             dataclasses.replace(cfg_bin, bin_method="top_k"), fit_target, names_a + names_d),
            (f"{n_bin} active, pallas, kernel E binning", res_bin.state, cfg_bin, fit_target,
             names_a + names_d + ["tile_bin_kernel"]),
            (f"2K, {n_2k} active, pallas, hier binning", res2k.state, cfg2k, target2k,
             names_a + names_d)):
        fn = stepper(state, cfg, target)
        times[f"train step, {tag}"] = ms = median_ms(fn)
        log(f"  train step, {tag}: {ms:.4f} ms")
        steps.append((tag, fn, ms, names))
    for tag, fn, ms_step, names in steps:
        busy, rows_, missing = device_time_per_call(fn, kernels=names)
        check(busy > 0, f"torch.profiler recorded no device time in a {tag} step")
        top = rows_[:6]
        # the [T, K, 16] table gather was once the binned steps' largest entry
        gathers = [(name, ms) for name, ms in rows_ if "gather" in name.lower()]
        log(f"  train step {tag}: device busy {busy:.4f} ms of a {ms_step:.4f} ms step "
            f"({busy / ms_step:.1%}); top device time: "
            + "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in top)
            + "; gathers: " + ("; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in gathers)
                               or "none")
            + (f"; not traced, so left out: {', '.join(missing)}" if missing else ""))
        report.setdefault("train_step_device_time", {})[tag] = dict(
            busy_ms=busy, step_ms=ms_step, active=n_timed, top=top, gathers=gathers,
            not_traced=missing)
    # the Adam step again, after the profiler sessions above: host time that
    # a profiler session leaves behind shows here
    times[f"train step, {n_timed} active, auto (list_t), after the profiler"] = step_after_ms = \
        median_ms(one_step)
    log(f"  train step, {n_timed} active, auto (list_t), after the profiler sessions: "
        f"{step_after_ms:.4f} ms (before: {step_ms:.4f})")
    step_dt = report["train_step_device_time"]
    entry_line += (f"; Adan step {step_adan_ms:.4f} ms (busy "
                   f"{step_dt['auto (list_t), Adan']['busy_ms']:.4f}), Adam {step_ms:.4f} ms "
                   f"(busy {step_dt['auto (list_t)']['busy_ms']:.4f})")

    # where a full decode's time goes: device time per frame under torch.profiler
    for backend, names in (("binned", names_a), ("list_t", names_b)):
        busy, rows_, missing = device_time_per_call(
            lambda: decode_bitstream(kodim01, backend=backend, device=dev), kernels=names)
        top = rows_[:4]
        check(busy > 0, f"torch.profiler recorded no device time in a {backend} decode")
        frame = times[f"frame: decode_bitstream {backend} (parse included)"]
        log(f"  decode_bitstream {backend}: device busy {busy:.4f} ms of a {frame:.4f} ms frame "
            f"({busy / frame:.1%}); top device time: "
            + "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in top)
            + (f"; not traced, so left out: {', '.join(missing)}" if missing else ""))
        report.setdefault("decode_device_time", {})[backend] = dict(
            busy_ms=busy, frame_ms=frame, top=top, not_traced=missing)

    # the coding path: a QAT step after the warmup, from the QAT result with a
    # fresh model Adam; the encoder; the full decode of the stream it wrote
    from gaussianimage_plus_tpu_torch.compress.bitstream import serialize_bitstream

    st_q, b_q = res_q.state, res_q.bundle
    box_q = [(st_q, tr.make_optimizer(tcfg_q).init(st_q.params), b_q, None)]

    def qat_step():
        s_, m_, b_, best_ = box_q[0]
        s_, m_, b_, mm = pl.quant_train_chunk(s_, m_, b_, fit_target, cfg_q, qcfg, tcfg_q.lr, 1,
                                              best=best_)
        box_q[0] = (s_, m_, b_, mm["best"])

    times["QAT step, auto (list_t)"] = qat_ms = median_ms(qat_step)
    busy_q, rows_q, missing_q = device_time_per_call(qat_step,
                                                     kernels=names_b + ["chunk_backward_kernel"])
    check(busy_q > 0, "torch.profiler recorded no device time in a QAT step")
    log(f"  QAT step ({int(st_q.num_active)} active, auto (list_t)): {qat_ms:.4f} ms; device busy "
        f"{busy_q:.4f} ms ({busy_q / qat_ms:.1%}); top device time: "
        + "; ".join(f"{name[:60]} {ms:.4f} ms" for name, ms in rows_q[:6])
        + (f"; not traced, so left out: {', '.join(missing_q)}" if missing_q else ""))
    report.setdefault("train_step_device_time", {})["QAT, auto (list_t)"] = dict(
        busy_ms=busy_q, step_ms=qat_ms, active=int(st_q.num_active), top=rows_q[:6],
        not_traced=missing_q)
    times["encode: compress_wo_ec + serialize_bitstream"] = median_ms(
        lambda: serialize_bitstream(b_q, pl.compress_wo_ec(b_q, st_q, cfg_q, qcfg), cfg_q, qcfg),
        frames=10)
    times["frame: decode_bitstream binned, QAT stream (parse included)"] = median_ms(
        lambda: decode_bitstream(stream_q, device=dev))
    busy_dq, _, _ = device_time_per_call(lambda: decode_bitstream(stream_q, device=dev),
                                         kernels=names_a)
    for k in ("encode: compress_wo_ec + serialize_bitstream",
              "frame: decode_bitstream binned, QAT stream (parse included)"):
        log(f"  {k}: {times[k]:.4f} ms")
    log(f"  decode_bitstream binned, QAT stream: device busy {busy_dq:.4f} ms a frame")
    report["decode_device_time"]["binned, QAT stream"] = dict(
        busy_ms=busy_dq, frame_ms=times["frame: decode_bitstream binned, QAT stream (parse included)"])
    # kernels A, B and C at the QAT state: B and C on the quantized overrides
    # of the QAT result, A on the binned table of the stream it wrote
    with torch.no_grad():
        means_q, cov_q, cols_q, _, _ = pl.quantize_attributes(b_q, st_q, cfg_q, qcfg,
                                                              update_vq=False)
        proj_q = gi.project(st_q.params, st_q.active, st_q.bound, cfg_q, cov_override=cov_q,
                            means_override=means_q)
        cot_q = l2_cotangent(gi.render(st_q, cfg_q, cov_override=cov_q, means_override=means_q,
                                       colors_override=cols_q), fit_target)
    inp_q = raster_list.list_inputs(proj_q, cols_q, torch.ones((cfg_q.max_num_points,), device=dev),
                                    cfg_q.H, cfg_q.W, 128)
    err["b"] = max(err["b"], compare("B QAT state kc 128", kernel_b(*inp_q, 128, cfg_q.H, cfg_q.W),
                                     plain_b(*inp_q, 128, cfg_q.H, cfg_q.W)))
    table_cq, bbox_cq = c_inputs(proj_q, cols_q, cfg_q.H, cfg_q.W, 128)
    err["c"] = max(err["c"], compare_payload("C QAT state kc 128, L2 cotangent", kernel_c, plain_c,
                                             (table_cq, bbox_cq, cot_q)))
    _, dec_q = decode_bitstream(stream_q, device=dev)
    cfg_dq = stream_cfg(dec_q)
    proj_dq, col_dq, ones_dq = stream_inputs(dec_q, cfg_dq)
    bins_dq = bin_gaussians(proj_dq, cfg_dq.H, cfg_dq.W, cap=cfg_dq.tile_cap)
    a_states["qat"] = (*raster_binned._slot_table(proj_dq.xys, proj_dq.conics, col_dq, ones_dq,
                                                  bins_dq.ids, bins_dq.mask), cfg_dq.H, cfg_dq.W)
    err["a"] = max(err["a"], compare_a("A QAT stream binned (cap 256)", a_states["qat"][:3],
                                       cfg_dq.H, cfg_dq.W))
    # the coding path's decodes bin the QAT stream with kernel E (inside the decode graph)
    tb_dq = tile_bounds_for(cfg_dq.H, cfg_dq.W)
    e_states["qat"] = (binning_tiles.tile_bbox_table(proj_dq.xys, proj_dq.radii, tb_dq,
                                                     proj_dq.valid), *tb_dq)
    for key, fn in (("kernel A, QAT stream", lambda: kernel_a(*a_states["qat"])),
                    ("kernel E, qat state", lambda: kernel_e(*e_states["qat"], 256)),
                    ("kernel B, QAT state kc 128", lambda: kernel_b(*inp_q, 128, cfg_q.H, cfg_q.W)),
                    ("kernel C, QAT state kc 128", lambda: kernel_c(table_cq, bbox_cq, cot_q))):
        times[key], device_ms[key] = launch_ms(fn), device_ms_per_call(fn)
        log(f"  {key}: {device_ms[key]:.4f} ms device time a call (queued), {times[key]:.4f} ms "
            f"back to back")

    # bounds at the timed inputs: what this run's data needs
    def a_bound(table_, ids_, counts_, h_, w_):
        """Kernel A: OPS_PER_PAIR at each live (slot, pixel) pair on the image;
        bytes: the live slots' ids and table rows, counts and the image
        written (no gathered [T, K, 16] table exists)."""
        live_ = int(counts_.clamp(0, ids_.shape[1]).sum())
        on_, _ = gate_slots(table_, ids_, counts_, h_, w_)
        return bound(on_ * OPS_PER_PAIR, live_ * (4 + 64) + counts_.numel() * 4 + h_ * w_ * 3 * 4)

    def c_bound(table_, bbox_, h_, w_):
        """Kernel C: the gate at each (member, pixel) pair on the image, the
        rest where it passes; bytes: table, bbox, payload and image."""
        on_, pass_ = gate_pairs(table_, bbox_, h_, w_)
        return (bound(on_ * OPS_GATE_C + pass_ * OPS_PASS_C,
                      (2 * table_.numel() + bbox_.numel()) * 4 + h_ * w_ * 3 * 4), on_, pass_)

    def e_bound(bbox_, tbx, tby):
        """Kernel E: the bytes of the bbox table read once and the ids and
        counts written."""
        return bound(0, bbox_.numel() * 4 + tbx * tby * (256 + 1) * 4)

    members_a = int(prep_trim.counts.sum())
    table, bbox, lst, cnt, lo2, hi2 = inp_l
    T = lst.shape[0]
    members_b = list_members(table, bbox, H, W)
    bytes_b = (table.numel() + bbox.numel() + lst.numel() + 3 * T) * 4 + H * W * 3 * 4
    for tag, inp in (("stream order", inp_l), ("Morton order", inp_m)):
        rows = rows_visited(*inp[3:], 128)
        log(f"  kernel B on kodim01, {tag}: {rows} table rows visited over {T} tiles "
            f"({rows / members_b:.1f} per member)")
        report.setdefault("kernel_b_rows_visited", {})[tag] = rows
    members_fit = list_members(inp_fit[0], inp_fit[1], cfg_fit.H, cfg_fit.W)
    rows_fit = rows_visited(*inp_fit[3:], 128)
    bytes_fit = ((inp_fit[0].numel() + inp_fit[1].numel() + inp_fit[2].numel() + 3 * T) * 4
                 + cfg_fit.H * cfg_fit.W * 3 * 4)
    bound_fit, by_fit = bound(members_fit * PIX * OPS_PER_PAIR, bytes_fit)
    log(f"  kernel B on the fit state (Morton order, kc 128): {members_fit} members, {rows_fit} "
        f"table rows visited ({rows_fit / members_fit:.1f} per member)")
    report["kernel_b_fit_state"] = dict(members=members_fit, rows_visited=rows_fit)
    members_q = list_members(inp_q[0], inp_q[1], cfg_q.H, cfg_q.W)
    bound_q = bound(members_q * PIX * OPS_PER_PAIR,
                    (inp_q[0].numel() + inp_q[1].numel() + inp_q[2].numel() + 3 * T) * 4
                    + cfg_q.H * cfg_q.W * 3 * 4)
    bound_a, by_a = a_bound(*a_states["kodim01"])
    bound_b, by_b = bound(members_b * PIX * OPS_PER_PAIR, bytes_b)
    enum_bounds = {}
    for (kname, order), (inp_, kc) in enum_inputs.items():
        table_, bbox_, lst_, cnt_, lo2_, hi2_ = inp_
        rows = rows_visited(cnt_, lo2_, hi2_, kc)
        bytes_ = (table_.numel() + bbox_.numel() + lst_.numel() + 3 * T) * 4 + H * W * 3 * 4
        bound_, by_ = bound(members_b * PIX * OPS_PER_PAIR, bytes_)
        enum_bounds[(kname, order)] = (bound_, by_)
        key = f"kernel B, kodim01 {order}, {kname} kc {kc}"
        ms, dev_ms = times[key], device_ms[key]
        log(f"  kernel B on kodim01, {order}, {kname} (kc {kc}): {rows} table rows visited "
            f"({rows / members_b:.1f} per member), {ms:.4f} ms back to back, {dev_ms:.4f} ms "
            f"device time, bound {bound_:.5f} ms ({by_})")
        report.setdefault("kernel_b_enumerations", {})[f"{kname}, {order}"] = dict(
            kc=kc, rows_visited=rows, ms=ms, device_ms=dev_ms, bound_ms=bound_, bound_by=by_)
    live = table_c[:, 15] > 0
    area = ((bbox_c[:, 1] - bbox_c[:, 0]) * (bbox_c[:, 3] - bbox_c[:, 2]))[live]
    members_c, largest_c = int(area.sum()), int(area.max())
    (bound_c, by_c), on_image_c, passing_c = c_bound(table_c, bbox_c, cfg_fit.H, cfg_fit.W)
    pass_frac_c = passing_c / on_image_c
    log(f"  kernel C on the fit state: {int(live.sum())} valid rows, {members_c} (row, tile) "
        f"members, largest bbox {largest_c} tiles; {on_image_c} (member, pixel) pairs on the "
        f"image, {passing_c} ({pass_frac_c:.4%}) pass the gate")
    report["kernel_c_input"] = dict(rows=int(live.sum()), members=members_c, largest_bbox_tiles=largest_c,
                                    pairs_on_image=on_image_c, pairs_passing=passing_c,
                                    pass_fraction=pass_frac_c)
    # kernel D at each state: the gate at every live (slot, pixel) pair on the
    # image, the rest where it passes; bytes: the live table rows and ids,
    # counts, bbox, cotangent, output. Its stages' device time from the
    # profiler above (slot_start_kernel, tile_payload_kernel, payload_gather_kernel).
    d_bounds = {}
    for tag, (inp_, cot_, h_, w_) in d_states.items():
        table_, counts_, ids_, bbox_ = inp_
        live_ = int(counts_.clamp(0, ids_.shape[1]).sum())
        tiles_ = bbox_tiles(bbox_, h_, w_)
        on_, pass_ = gate_slots(table_, ids_, counts_, h_, w_)
        bytes_ = (live_ * (64 + 4) + counts_.numel() * 4 + bbox_.numel() * 4
                  + h_ * w_ * 3 * 4 + bbox_.shape[0] * 9 * 4)
        bound_, by_ = bound(on_ * OPS_GATE_C + pass_ * OPS_PASS_C, bytes_)
        stages = (" stage 0 (slot_start_kernel) {:.4f} ms, stage 1 (tile_payload_kernel) {:.4f} "
                  "ms, stage 2 (payload_gather_kernel) {:.4f} ms".format(*d_stages[tag])
                  if d_stages[tag] else " stages not measured: the profiler did not trace them")
        log(f"  kernel D, {tag} ({h_}x{w_}, table {tuple(table_.shape)}, slot ids "
            f"{tuple(ids_.shape)}): {live_} live slots, "
            f"{int(counts_.max())} in the fullest tile, {bbox_.shape[0]} Gaussians, tile bbox mean "
            f"{float(tiles_.float().mean()):.1f} / largest {int(tiles_.max())} tiles; {pass_} of "
            f"{on_} (slot, pixel) pairs pass the gate;" + stages)
        report.setdefault("kernel_d_states", {})[tag] = dict(
            live_slots=live_, fullest_tile=int(counts_.max()), gaussians=bbox_.shape[0],
            bbox_tiles_mean=float(tiles_.float().mean()), bbox_tiles_largest=int(tiles_.max()),
            pairs_on_image=on_, pairs_passing=pass_, stage_ms=d_stages[tag])
        d_bounds[tag] = (bound_, by_)
        if tag == "binned fit state":
            ids_d, bbox_d = ids_, bbox_
            members_d, on_image_d, passing_d, bound_d, by_d = live_, on_, pass_, bound_, by_
    bound_e, by_e = e_bound(*e_states["fit"])
    total = {key: sum(n[key] for n in path_launches.values()) for key in kernels}
    report["path_launches"] = path_launches

    # (h) the fused dispatch, after phase 5's step timings (so that those keep
    # their protocol); launches reported apart, as (g)'s
    phase4 = report["phases"]
    fits = {"binned fit, 'pallas' + E": (fit_target, cfg_bin, FIT, FIT_POINTS, res_bin,
                                         launches_bin, phase4["binned fit"]["seconds"]),
            "odd-grid fit, 'auto' -> 'pallas' + 'top_k'": (
                target_odd, cfg_odd, ODD_FIT, FIT_POINTS, res_odd, launches_odd,
                phase4["odd-grid fit"]["seconds"]),
            "2K fit, 'pallas' + 'hier'": (target2k, cfg2k, fit2k, K2_POINTS, res2k, launches_2k,
                                          phase4["2K fit"]["seconds"])}
    report["phases"]["fused dispatch"], fused_line = fused_dispatch(
        dev, kernels, fit_target, cfg_fit, res, fits, cfg_q, tcfg_q, qcfg, res_q, qat_s, batch,
        dict(a=names_a, b=names_b, c=["chunk_backward_kernel"], d=names_d,
             e=["tile_bin_kernel"]))

    # rule 2's ranking: each kernel's launches on the main paths taken at the
    # state they run at (the odd-grid fit's at the fit state, which it is cut
    # from, and the gradients of path (e) at kodim01's), its device time and
    # bound there, and loss_ms = sum over states of launches x (device_ms -
    # bound_ms)
    state_of_path = {"decode and render": "kodim01", "fit": "fit", "binned fit": "fit",
                     "odd-grid fit": "fit", "2K fit": "2K",
                     "render dense / sweep gradients": "kodim01"}
    # the coding path's launches at the QAT state (its 100 warmup steps
    # among them, on the state before quantization)
    state_of_path.update({p_: "qat" for p_ in path_launches if p_.startswith("coding path")})
    state_of_path.update({f"{AGREE_STEPS} steps {b}": "fit" for b in ("auto", "xla", "pallas")})
    enum_state = {"list_t": "kodim01", "dense": "kodim01 dense", "sweep": "kodim01 sweep",
                  "range": "kodim01 range"}
    launches_by_state = {key: {} for key in kernels}
    for path, n in path_launches.items():
        for key, count in n.items():
            if key == "b" and path in ("render_fast dense / sweep / range",
                                       "render dense / sweep gradients"):
                split = by_enum if path.startswith("render_fast") else by_enum_g
                check(sum(split.values()) == count, f"{path}: kernel B launches {split} vs {count}")
                parts = [(enum_state[e], c) for e, c in split.items()]
            else:
                check(count == 0 or path in state_of_path, f"{path}: no state for kernel {key}")
                parts = [(state_of_path.get(path), count)]
            for tag, c in parts:
                if c:
                    launches_by_state[key][tag] = launches_by_state[key].get(tag, 0) + c
    kc_d, kc_s = raster_dense.DENSE_KC, raster_dense.SWEEP_KC
    timed_states = {
        "a": {"kodim01": ("kernel A, kodim01 trimmed", (bound_a, by_a)),
              "fit": ("kernel A, fit state", a_bound(*a_states["fit"])),
              "2K": ("kernel A, 2K state", a_bound(*a_states["2K"])),
              "qat": ("kernel A, QAT stream", a_bound(*a_states["qat"]))},
        "b": {"kodim01": ("kernel B, kodim01 kc 128", (bound_b, by_b)),
              "fit": ("kernel B, fit state kc 128", (bound_fit, by_fit)),
              "qat": ("kernel B, QAT state kc 128", bound_q),
              **{enum_state[k]: (f"kernel B, kodim01 stream order, {k} kc {kc_}",
                                 enum_bounds[(k, "stream order")])
                 for k, kc_ in (("dense", kc_d), ("sweep", kc_s), ("range", kc_s))}},
        "c": {"fit": ("kernel C, fit state kc 128", (bound_c, by_c)),
              "qat": ("kernel C, QAT state kc 128", c_bound(table_cq, bbox_cq, cfg_q.H, cfg_q.W)[0]),
              "kodim01": ("kernel C, kodim01 stream order kc 128",
                          c_bound(table_c01, bbox_c01, H, W)[0])},
        "d": {"fit": ("kernel D, binned fit state", d_bounds["binned fit state"]),
              "kodim01": ("kernel D, kodim01 binned table", d_bounds["kodim01 binned table"]),
              "2K": ("kernel D, 2K state", d_bounds["2K state"])},
        "e": {tag: (f"kernel E, {'binned fit' if tag == 'fit' else tag} state",
                    e_bound(*e_states[tag])) for tag in ("fit", "kodim01", "2K", "qat")},
    }
    by_state, loss_ms = {}, {}
    for key, rows_ in timed_states.items():
        missing = set(launches_by_state[key]) - set(rows_)
        check(not missing, f"kernel {key.upper()}: launches at untimed states {missing}")
        by_state[key] = {tag: dict(ms=times[tkey], device_ms=device_ms[tkey], bound_ms=b_ms,
                                   bound_by=b_by, launches=launches_by_state[key].get(tag, 0))
                         for tag, (tkey, (b_ms, b_by)) in rows_.items()}
        loss_ms[key] = sum(r["launches"] * (r["device_ms"] - r["bound_ms"])
                           for r in by_state[key].values())
        log(f"  kernel {key.upper()} by state: " + "; ".join(
            f"{tag} {r['device_ms']:.4f} ms device ({r['ms']:.4f} back to back), bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']}), {r['launches']} launches"
            for tag, r in by_state[key].items()) + f"; loss {loss_ms[key]:.2f} ms")
    report["by_state"], report["loss_ms"] = by_state, loss_ms

    def state_keys(key):
        rows_ = by_state[key]
        return dict(device_ms_by_state={t: r["device_ms"] for t, r in rows_.items()},
                    ms_by_state={t: r["ms"] for t, r in rows_.items()},
                    launches_by_state={t: r["launches"] for t, r in rows_.items()},
                    bound_ms_by_state={t: r["bound_ms"] for t, r in rows_.items()},
                    loss_ms=loss_ms[key])
    kernel_rows = [
        dict(name="tile_table_forward", route="cuda",
             source="gaussianimage_plus_tpu_torch/csrc/tile_table_forward.cu",
             replaces="gaussianimage_plus_tpu/kernels/raster_pallas.py:218 (_run_fwd); "
                      "gaussianimage_plus_tpu/kernels/raster_flat_pallas.py:82 "
                      "(rasterize_prepared_flat)",
             launches=total["a"], max_abs_err=err["a"],
             ms=times["kernel A, kodim01 trimmed"], device_ms=device_ms["kernel A, kodim01 trimmed"],
             plain_ms=times["plain A, kodim01 trimmed"], bound_ms=bound_a, bound_by=by_a,
             library_ms=gather_ms["kodim01"], library_ms_by_state=gather_ms,
             library_call="table[ids] (the [T, K, 16] gather that fed kernel A before it "
                          "read through the slot ids), device time a call",
             shape=f"kodim01 bin-once slot ids {tuple(prep_trim.ids.shape)}, {members_a} members"),
        dict(name="chunk_list_forward", route="cuda",
             source="gaussianimage_plus_tpu_torch/csrc/chunk_list_forward.cu",
             replaces="gaussianimage_plus_tpu/kernels/raster_list_pallas.py:252 "
                      "(rasterize_list_pallas); gaussianimage_plus_tpu/kernels/"
                      "raster_list_pallas.py:376 (rasterize_list_t_pallas); "
                      "gaussianimage_plus_tpu/kernels/raster_dense_pallas.py:368 "
                      "(rasterize_dense_pallas); gaussianimage_plus_tpu/kernels/"
                      "raster_dense_pallas.py:481 (rasterize_sweep_pallas); "
                      "gaussianimage_plus_tpu/kernels/raster_dense_pallas.py:593 "
                      "(rasterize_range_pallas)",
             launches=total["b"], max_abs_err=err["b"],
             ms=times["kernel B, kodim01 kc 128"], device_ms=device_ms["kernel B, kodim01 kc 128"],
             plain_ms=times["plain B, kodim01 kc 128"], bound_ms=bound_b, bound_by=by_b,
             library_ms=None,
             shape=f"kodim01 table {tuple(table.shape)}, kc 128, lmax {lst.shape[1]}, "
                   f"{members_b} members"),
        dict(name="chunk_backward", route="cuda",
             source="gaussianimage_plus_tpu_torch/csrc/chunk_backward.cu",
             replaces="gaussianimage_plus_tpu/kernels/raster_list_pallas.py:701 "
                      "(list_backward layout='rows', body :429-518); gaussianimage_plus_tpu/"
                      "kernels/raster_list_pallas.py:681 (list_backward layout='lanes', body "
                      ":521-614); gaussianimage_plus_tpu/kernels/raster_dense_pallas.py:292 "
                      "(dense_backward, body :102-183); gaussianimage_plus_tpu/kernels/"
                      "raster_dense_pallas.py:330 (sweep_backward, body :185-273)",
             launches=total["c"], max_abs_err=err["c"],
             ms=times["kernel C, fit state kc 128"], device_ms=device_ms["kernel C, fit state kc 128"],
             plain_ms=times["plain C, fit state kc 128"],
             bound_ms=bound_c, bound_by=by_c, library_ms=None,
             shape=f"fit state after growth, table {tuple(table_c.shape)}, {int(live.sum())} "
                   f"valid rows, {members_c} (row, tile) members, largest bbox {largest_c} tiles, "
                   f"{passing_c} of {on_image_c} (member, pixel) pairs ({pass_frac_c:.4%}) pass "
                   f"the gate"),
        dict(name="tile_table_backward", route="cuda",
             source="gaussianimage_plus_tpu_torch/csrc/tile_table_backward.cu",
             replaces="gaussianimage_plus_tpu/kernels/raster_pallas.py:241 (_run_bwd, body "
                      ":151-204; with the scatter-add :426-440 and _gather_grads :364)",
             launches=total["d"], max_abs_err=err["d"],
             ms=times["kernel D, binned fit state"], device_ms=device_ms["kernel D, binned fit state"],
             plain_ms=times["plain D, binned fit state"],
             bound_ms=bound_d, bound_by=by_d, library_ms=None,
             shape=f"binned fit state after growth, slot ids {tuple(ids_d.shape)}, {members_d} live "
                   f"slots, {bbox_d.shape[0]} Gaussians, {passing_d} of {on_image_d} (slot, "
                   f"pixel) pairs pass the gate"),
        dict(name="tile_bin", route="cuda",
             source="gaussianimage_plus_tpu_torch/csrc/tile_bin.cu",
             replaces="gaussianimage_plus_tpu/kernels/binning_pallas.py:92 "
                      "(bin_gaussians_pallas, body :43-89)",
             launches=total["e"], max_abs_err=err["e"],
             ms=times["kernel E, binned fit state"], device_ms=device_ms["kernel E, binned fit state"],
             plain_ms=times["plain E, binned fit state"],
             bound_ms=bound_e, bound_by=by_e,
             library_ms=times["torch.topk(key, 256), binned fit state"],
             shape=f"binned fit state after growth, {t_e.numel()} tiles x {n_e} rows, cap 256"),
    ]
    for row, key in zip(kernel_rows, "abcde"):
        row.update(state_keys(key))
    kernel_rows.append(dict(
        name="chunk_lists", route="cuda", source="gaussianimage_plus_tpu_torch/csrc/chunk_lists.cu",
        replaces="none: the XLA enumeration of gaussianimage_plus_tpu/kernels/raster_list_pallas.py"
                 ":125 (_member_matrix) and :138 (_chunk_lists)",
        ms=f_rows["fit state"]["ms"], device_ms=f_rows["fit state"]["device_ms"],
        plain_ms=f_rows["fit state"]["plain_device_ms"], bound_ms=f_rows["fit state"]["bound_ms"],
        bound_by=f_rows["fit state"]["bound_by"], library_ms=None,
        device_ms_by_state={t: r["device_ms"] for t, r in f_rows.items()},
        plain_device_ms_by_state={t: r["plain_device_ms"] for t, r in f_rows.items()},
        bound_ms_by_state={t: r["bound_ms"] for t, r in f_rows.items()},
        shape="; ".join(f"{t}: {r['tiles']} tiles x {r['chunks']} chunks, lmax {r['lmax']}"
                        for t, r in f_rows.items())))
    report["kernels"] = kernel_rows
    write_report()
    log(entry_line)
    log(par_line)
    log(fused_line)
    log(json.dumps({"kernels": kernel_rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
