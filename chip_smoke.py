#!/usr/bin/env python3
"""Per-kernel timer of the PyTorch + CUDA port's six kernels on one card.

Run from the root of a checkout, on a machine with one NVIDIA card::

    python3 chip_smoke.py

It names the card (``nvidia-smi``: name and power limit), builds the six
kernels of ``gaussianimage_plus_tpu_torch/csrc/`` and times each kernel and
its plain PyTorch version at the states of ``PERF.md`` §6's kernel table:

- ``kodim01``: the stream ``results/bitstreams_r4/kodim01.gipb`` (A on its
  bin-once table; B in stream order and over the dense, sweep and range
  enumerations; C and D with the L2 cotangent against the render of
  ``results/repr_states_plain/kodim01.npz``; E on that state's bboxes);
- ``fit``, the fit state after growth: ``fit_image`` of that render from 2500
  random Gaussians (1000 steps, a prune every 100, the growth at 500) through
  ``'auto'`` (B, C and F, in Morton order) and through ``'pallas'`` with
  kernel E binning (A, D and E);
- ``2K``: A, D and E at a 100-step 2040x1344 ``'pallas'`` + ``'hier'`` fit of
  20,000 Gaussians on a seeded block image; F at the converged 2K state
  ``results/repr_states_2k/mosaic2k.npz`` in Morton order;
- ``qat``: ``fit_image_quantized`` from the fit state (100 warmup and 1000
  QAT steps): B and C on its quantized rows, A and E on its ``.gipb``.

Per kernel and state: ``device_ms``, the device time a call (50 calls queued
behind a spin kernel, so that the card never waits for the host); ``ms``, 50
calls back to back (a kernel faster than its Python wrapper is timed by the
host there); ``plain_ms``, the plain version's, back to back (kernel F's
plain chain also queued, ``plain_device_ms``); ``max_abs_err`` between the
two; ``bound_ms``, the least time the card could take (bytes over the HBM
rate or float32 operations over the CUDA-core rate of
``portbench/peaks.json``); ``launches_in_timer_runs``, the kernel's launches
in this script's own runs that reached the state (not those of a benchmark
cell); ``loss_ms``, the sum over states of those launches x (device_ms -
bound_ms).

Every timed call is held to its plain version on the same arguments: A, B,
E and F bit for bit, C and D within 1e-4 of each payload column's largest
plain value (``tests/test_torch_kernels_cuda.py``'s rule); a kernel off
that mark raises before anything is printed. The last three lines of
standard output are the kernels' JSON line, the card's ``nvidia-smi`` line
and ``{"ok": true, ...}``; a fuller report goes to
``chiprun_out/chip_smoke_report.json``. Nothing here imports JAX or the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from gaussianimage_plus_tpu_torch.compress import pipeline as pl
from gaussianimage_plus_tpu_torch.compress import trainer as ctr
from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream
from gaussianimage_plus_tpu_torch.core import render_tiled as rt
from gaussianimage_plus_tpu_torch.core.binning import bin_gaussians
from gaussianimage_plus_tpu_torch.core.gaussian2d import tile_bounds_for
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy
from gaussianimage_plus_tpu_torch.kernels import (_build, binning_tiles, raster_binned,
                                                  raster_dense, raster_list, wrappers)
from gaussianimage_plus_tpu_torch.models import gaussian_image as gi
from gaussianimage_plus_tpu_torch.train import trainer as tr

ROOT = Path(__file__).resolve().parent
RESULTS = ROOT / "results"
CALLS = 50
SPIN_CYCLES = 20_000_000   # ~10 ms of torch.cuda._sleep on the H100
PIX = 256                  # pixels of a 16x16 tile
# float32 operations per (member, pixel) pair of kernels A and B: 5 FMAs for
# sigma (10), one exp, the opacity product and the min (3), 3 FMAs for the
# colour sums (6)
OPS_PER_PAIR = 19
# kernels C and D: the gate, as in the forward, at every (member, pixel) pair
# on the image (13); then, only where the gate passes, v_alpha = rgb . v_out
# (5), 3 FMAs for v_rgb (6), the sign and product of v_sigma (2), an FMA for
# v_opac (2), 5 FMAs and an add for the moments (11)
OPS_GATE, OPS_PASS = 13, 26
FIT = dict(iterations=1000, prune_iter=100, grow_iter=500)
FIT_POINTS, FIT_SEED = 2500, 3047
QAT = dict(warmup_iter=100, steps=1000)
K2_HW, K2_POINTS, K2_FIT = (1344, 2040), 20_000, dict(iterations=100, prune_iter=50)
# per kernel: its wrapper's name, the TPU kernels it replaces (file:line in
# gaussianimage_plus_tpu/kernels/) and the state of its single-state fields
KERNELS = {
    "a": ("tile_table_forward", "raster_pallas.py:218 (_run_fwd); raster_flat_pallas.py:82 "
          "(rasterize_prepared_flat)", "kodim01"),
    "b": ("chunk_list_forward", "raster_list_pallas.py:252 (rasterize_list_pallas), :376 "
          "(rasterize_list_t_pallas); raster_dense_pallas.py:368 (rasterize_dense_pallas), :481 "
          "(rasterize_sweep_pallas), :593 (rasterize_range_pallas)", "kodim01"),
    "c": ("chunk_backward", "raster_list_pallas.py:701 (list_backward layout='rows'), :681 "
          "(layout='lanes'); raster_dense_pallas.py:292 (dense_backward), :330 (sweep_backward)",
          "fit"),
    "d": ("tile_table_backward", "raster_pallas.py:241 (_run_bwd; with the scatter-add :426-440 "
          "and _gather_grads :364)", "fit"),
    "e": ("tile_bin", "binning_pallas.py:92 (bin_gaussians_pallas)", "fit"),
    "f": ("chunk_lists", "none: the XLA enumeration of raster_list_pallas.py:125 "
          "(_member_matrix) and :138 (_chunk_lists)", "fit"),
}


def per_call_ms(fn, calls: int = CALLS, queued: bool = True, reps: int = 5) -> float:
    """Time a call of ``fn``: ``calls`` calls between two CUDA events,
    median of ``reps`` runs. ``queued``, they wait behind a spin kernel
    (``torch.cuda._sleep``, doubled until it outlasts the host's queueing),
    so that the card runs them back to back: the device time of the call.
    Otherwise the card waits for a wrapper whose host time exceeds its
    kernel's."""
    fn()
    torch.cuda.synchronize()
    per_call, cycles = [], SPIN_CYCLES
    while len(per_call) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        spun_long_enough = not queued or not start.query()
        end.synchronize()
        if spun_long_enough:
            per_call.append(start.elapsed_time(end) / calls)
        elif cycles >= 64 * SPIN_CYCLES:
            raise RuntimeError(f"the host cannot queue {calls} calls behind the spin kernel")
        else:
            cycles *= 2
    return statistics.median(per_call)


def max_diff(out, ref) -> float:
    """Largest |kernel - plain| over the tensors of two results."""
    if isinstance(out, (tuple, list)):
        return max(max_diff(a, b) for a, b in zip(out, ref))
    return float((out.double() - ref.double()).abs().max()) if out.numel() else 0.0


def check_close(key: str, tag: str, out, ref) -> None:
    """Raise unless kernel ``key``'s result at state ``tag`` is its plain
    version's: bit for bit, or for C and D within 1e-4 of each column's max."""
    if key in "cd":
        d, scale = (out.double() - ref.double()).abs().amax(0), ref.double().abs().amax(0)
        ok = out.shape == ref.shape and bool((d <= 1e-4 * scale).all())
    else:
        ok = max_diff(out, ref) == 0.0
    if not ok:
        raise RuntimeError(f"kernel {key.upper()} at {tag}: differs from its plain version")


# (member, pixel) counts of the bounds. portbench/reference/counts.py counts
# pairs within a Gaussian's radius, not a tile member's 256 pixels, so these
# stay here: gate_counts, gate_slots, gate_pairs and bbox_members.
def gate_counts(t: torch.Tensor, rows: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """(member, pixel) pairs of the (tile ``t``, table row ``rows``) members:
    those on the image, and those that pass the forward's gate there,
    evaluated with the plain version's arithmetic (``core/render_tiled.py``)."""
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


def bbox_members(table: torch.Tensor, bbox: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[T, N] (tile, table row) members of a kernel B or C input."""
    tb_x, tb_y = tile_bounds_for(h, w)
    return raster_list._bbox_members(table, bbox, tb_x, tb_x * tb_y)


def gate_pairs(table: torch.Tensor, bbox: torch.Tensor, h: int, w: int) -> tuple[int, int]:
    """``gate_counts`` of a kernel C input (bbox members of the table rows)."""
    t, r = bbox_members(table, bbox, h, w).nonzero(as_tuple=True)
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


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def run() -> dict:
    dev = torch.device("cuda")
    smi, kind = nvidia_smi_line(), torch.cuda.get_device_name(0)
    if kind not in smi:
        raise RuntimeError(f"nvidia-smi says {smi!r}, torch says {kind!r}")
    peaks = json.loads((ROOT / "portbench" / "peaks.json").read_text())[kind]
    print(f"card: {smi} (torch: {kind}); torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    _build.build_all([name for name, _, _ in KERNELS.values()])
    kernel = dict(zip("abcdef", wrappers()))
    plain = dict(a=raster_binned.tile_table_forward_plain, b=raster_list.chunk_list_forward_plain,
                 c=raster_list.chunk_backward_plain, d=raster_binned.tile_table_backward_plain,
                 e=binning_tiles.tile_bin_plain, f=raster_list.chunk_lists_plain)
    cases = {k: {} for k in KERNELS}       # key -> state -> (arguments, (ops, bytes))
    launches = {k: {} for k in KERNELS}    # key -> state -> launches that reached it

    def counted(tag, fn):
        """``fn()``, its launches added to the state ``tag``."""
        before = {k: fn_.launches for k, fn_ in kernel.items()}
        value = fn()
        torch.cuda.synchronize()
        for k, fn_ in kernel.items():
            launches[k][tag] = launches[k].get(tag, 0) + fn_.launches - before[k]
        return value

    def ones(n):
        return torch.ones((n,), device=dev)

    def l2(img, target):
        return (2.0 * (img - target) / img.numel()).contiguous()

    def add_a(tag, table, ids, counts, h, w):
        live = int(counts.clamp(0, ids.shape[1]).sum())
        on, _ = gate_slots(table, ids, counts, h, w)
        cases["a"][tag] = ((table, ids, counts, h, w),
                           (on * OPS_PER_PAIR, live * (4 + 64) + counts.numel() * 4 + h * w * 12))

    def add_b(tag, inp, kc, h, w, members=None):
        members = int(bbox_members(inp[0], inp[1], h, w).sum()) if members is None else members
        nbytes = (inp[0].numel() + inp[1].numel() + inp[2].numel() + 3 * inp[2].shape[0]) * 4
        cases["b"][tag] = ((*inp, kc, h, w), (members * PIX * OPS_PER_PAIR, nbytes + h * w * 12))
        return members

    def add_c(tag, proj, colors, target_img, h, w):
        n = proj.xys.shape[0]
        table, bbox, _, _ = raster_list._table_bbox(proj, colors, ones(n), h, w, 128)
        on, passing = gate_pairs(table, bbox, h, w)
        cases["c"][tag] = ((table, bbox, target_img),
                           (on * OPS_GATE + passing * OPS_PASS,
                            (2 * table.numel() + bbox.numel()) * 4 + h * w * 12))

    def add_d(tag, proj, colors, cot, h, w, bins=None):
        """D on the binned table (cap 256); returns (table, ids, counts)."""
        tb = tile_bounds_for(h, w)
        bins = bin_gaussians(proj, h, w, cap=256) if bins is None else bins
        n = proj.xys.shape[0]
        table, ids, counts = raster_binned._slot_table(proj.xys, proj.conics, colors, ones(n),
                                                       bins.ids, bins.mask)
        bbox = raster_binned.tile_bbox_table(proj.xys, proj.radii, tb)
        live = int(counts.clamp(0, ids.shape[1]).sum())
        on, passing = gate_slots(table, ids, counts, h, w)
        cases["d"][tag] = ((table, counts, ids, bbox, cot),
                           (on * OPS_GATE + passing * OPS_PASS,
                            live * (64 + 4) + counts.numel() * 4 + bbox.numel() * 4 + h * w * 12
                            + n * 9 * 4))
        return table, ids, counts

    def add_e(tag, proj, h, w):
        tb = tile_bounds_for(h, w)
        bbox = binning_tiles.tile_bbox_table(proj.xys, proj.radii, tb, proj.valid)
        cases["e"][tag] = ((bbox, *tb, 256), (0, bbox.numel() * 4 + tb[0] * tb[1] * (256 + 1) * 4))

    def add_f(tag, inp, kc, h, w):
        table, bbox, lst = inp[:3]
        T, Np = lst.shape[0], table.shape[0]
        cases["f"][tag] = ((table, bbox, Np, kc, lst.shape[1], h, w),
                           (0, Np * 20 + 2 * T * (Np // kc) + T * (lst.shape[1] + 4) * 4))

    def stream_rows(dec):
        cfg = gi.GaussianConfig(H=dec.H, W=dec.W, max_num_points=dec.enc.active.shape[0],
                                tile_cap=dec.qcfg.decode_cap or 256)
        means, cov, colors = pl._decode_attributes(dec.bundle, dec.enc, dec.qcfg)
        proj = gi.project(None, dec.enc.active, dec.bound, cfg, cov_override=cov,
                          means_override=means)
        return cfg, proj, colors

    # kodim01: the committed stream, and the fitted state whose render is the target
    d_gt = dict(np.load(RESULTS / "repr_states_plain" / "kodim01.npz"))
    cfg_gt, st_gt = config_from_numpy(d_gt), state_from_numpy(d_gt, device=dev)
    with torch.no_grad():
        gt = gi.render(st_gt, cfg_gt).contiguous()
    H, W = cfg_gt.H, cfg_gt.W
    img01, dec01 = counted("kodim01", lambda: decode_bitstream(
        (RESULTS / "bitstreams_r4" / "kodim01.gipb").read_bytes(), device=dev))
    cfg01, proj01, col01 = stream_rows(dec01)
    prep = pl.prepare_decode(dec01.bundle, dec01.enc, dec01.bound, cfg01, dec01.qcfg)
    add_a("kodim01", prep.table, prep.ids, prep.counts, H, W)
    members01 = add_b("kodim01", raster_list.list_inputs(proj01, col01, ones(proj01.xys.shape[0]),
                                                         H, W, 128), 128, H, W)
    for name, kc, lists in (("dense", raster_dense.DENSE_KC, raster_dense.dense_lists),
                            ("sweep", raster_dense.SWEEP_KC, raster_dense.sweep_lists),
                            ("range", raster_dense.SWEEP_KC, raster_dense.range_lists)):
        table, bbox, n, np_ = raster_list._table_bbox(proj01, col01, ones(proj01.xys.shape[0]),
                                                      H, W, kc)
        add_b(f"kodim01 {name}", (table, bbox, *lists(table, bbox, n, np_, kc, H, W)), kc, H, W,
              members01)
    cot01 = l2(img01, gt)
    add_c("kodim01", proj01, col01, cot01, H, W)
    add_d("kodim01", proj01, col01, cot01, H, W)
    add_e("kodim01", gi.project(st_gt.params, st_gt.active, st_gt.bound, cfg_gt), H, W)

    # the fit state after growth: 'auto' (B, C, F) and 'pallas' + kernel E (A, D, E)
    cfg = gi.GaussianConfig()
    tcfg = tr.TrainConfig(**FIT)
    res = counted("fit", lambda: tr.fit_image(gt, cfg, tcfg, FIT_POINTS, seed=FIT_SEED, device=dev))
    g = tr._morton_resort(tr.init_train_state(cfg, tcfg, 0, gaussians=res.state), cfg).gaussians
    proj, col = gi.project(g.params, g.active, g.bound, cfg), gi.colors_of(g.params, cfg)
    inp_fit = raster_list.list_inputs(proj, col, ones(proj.xys.shape[0]), H, W, 128)
    add_b("fit", inp_fit, 128, H, W)
    add_f("fit", inp_fit, 128, H, W)
    with torch.no_grad():
        add_c("fit", proj, col, l2(gi.render(g, cfg), gt), H, W)
    cfg_bin = dataclasses.replace(cfg, raster_backend="pallas", bin_method="pallas")
    g = counted("fit", lambda: tr.fit_image(gt, cfg_bin, tcfg, FIT_POINTS, seed=FIT_SEED,
                                            device=dev)).state
    with torch.no_grad():
        cot = l2(gi.render(g, cfg_bin), gt)
    proj = gi.project(g.params, g.active, g.bound, cfg)
    add_a("fit", *add_d("fit", proj, gi.colors_of(g.params, cfg), cot, H, W), H, W)
    add_e("fit", proj, H, W)

    # 2K: the 'pallas' + 'hier' fit (A, D, E) and the converged state (F)
    h2, w2 = K2_HW
    blocks = np.random.default_rng(1).uniform(0, 1, (-(-h2 // 16), -(-w2 // 16), 3))
    target2k = torch.as_tensor(np.kron(blocks, np.ones((16, 16, 1)))[:h2, :w2].astype(np.float32),
                               device=dev)
    cfg2k = gi.GaussianConfig(H=h2, W=w2, max_num_points=K2_POINTS, raster_backend="pallas")
    s2k = counted("2K", lambda: tr.fit_image(target2k, cfg2k, tr.TrainConfig(**K2_FIT), K2_POINTS,
                                             seed=FIT_SEED, device=dev)).state
    proj = gi.project(s2k.params, s2k.active, s2k.bound, cfg2k)
    with torch.no_grad():
        cot = l2(gi.render(s2k, cfg2k), target2k)
    add_a("2K", *add_d("2K", proj, gi.colors_of(s2k.params, cfg2k), cot, h2, w2,
                       bin_gaussians(proj, h2, w2, cap=cfg2k.tile_cap, method=cfg2k.bin_method)),
          h2, w2)
    add_e("2K", proj, h2, w2)
    d2k = dict(np.load(RESULTS / "repr_states_2k" / "mosaic2k.npz"))
    c2k = config_from_numpy(d2k)
    s = tr._morton_resort(tr.init_train_state(c2k, tcfg, 0, gaussians=state_from_numpy(
        d2k, device=dev)), c2k).gaussians
    proj = gi.project(s.params, s.active, s.bound, c2k)
    add_f("2K", raster_list.list_inputs(proj, gi.colors_of(s.params, c2k), ones(proj.xys.shape[0]),
                                        c2k.H, c2k.W, 128), 128, c2k.H, c2k.W)

    # the QAT state: B and C on its quantized rows, A and E on its stream's binned table
    qcfg = pl.QuantConfig()
    tcfg_q = tr.TrainConfig(iterations=QAT["warmup_iter"] + QAT["steps"],
                            prune_iter=FIT["prune_iter"])
    res_q = counted("qat", lambda: ctr.fit_image_quantized(
        gt, cfg, tcfg_q, qcfg, FIT_POINTS, warmup_iter=QAT["warmup_iter"], seed=FIT_SEED,
        init_state=res.state))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "kodim01_qat.gipb"
        counted("qat", lambda: ctr.encode_decode_eval(res_q.state, res_q.bundle, gt, cfg, qcfg,
                                                      write_bitstream=str(path)))
        _, dec_q = decode_bitstream(path.read_bytes(), device=dev)
    sq = res_q.state
    with torch.no_grad():
        means, cov, cols, _, _ = pl.quantize_attributes(res_q.bundle, sq, cfg, qcfg,
                                                        update_vq=False)
        proj = gi.project(sq.params, sq.active, sq.bound, cfg, cov_override=cov,
                          means_override=means)
        cot = l2(gi.render(sq, cfg, cov_override=cov, means_override=means, colors_override=cols),
                 gt)
    add_b("qat", raster_list.list_inputs(proj, cols, ones(cfg.max_num_points), H, W, 128), 128,
          H, W)
    add_c("qat", proj, cols, cot, H, W)
    cfg_dq, proj, col = stream_rows(dec_q)
    bins = bin_gaussians(proj, H, W, cap=cfg_dq.tile_cap)
    add_a("qat", *raster_binned._slot_table(proj.xys, proj.conics, col, ones(proj.xys.shape[0]),
                                           bins.ids, bins.mask), H, W)
    add_e("qat", proj, H, W)

    # the timings
    rows = {}
    for key, states in cases.items():
        by_state = {}
        for tag, (args, (ops, nbytes)) in states.items():
            fn, ref = (lambda f=kernel[key], a=args: f(*a)), (lambda f=plain[key], a=args: f(*a))
            t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
            t_ops = ops / peaks["f32_flops"] * 1e3
            out, want = fn(), ref()
            check_close(key, tag, out, want)
            r = dict(device_ms=per_call_ms(fn), ms=per_call_ms(fn, queued=False),
                     plain_ms=per_call_ms(ref, calls=10, queued=False, reps=3),
                     max_abs_err=max_diff(out, want), bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations",
                     launches_in_timer_runs=launches[key].get(tag, 0))
            if key == "f":     # the plain chain syncs with nothing, so it queues too
                r["plain_device_ms"] = per_call_ms(ref, calls=10)
            by_state[tag] = r
            print(f"  kernel {key.upper()}, {tag}: " + ", ".join(
                f"{k} {v:.5g}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()),
                flush=True)
        rows[key] = by_state
    # the yardsticks of the library column: the [T, K, 16] gather that fed
    # kernel A before it read through the slot ids, and torch.topk on kernel
    # E's key, at the fit state
    gather = {tag: per_call_ms(lambda t=args[0], i=args[1].long(): t[i])
              for tag, (args, _) in cases["a"].items()}
    bbox, tb_x, tb_y, _ = cases["e"]["fit"][0]
    t, b, n = torch.arange(tb_x * tb_y, device=dev)[:, None], bbox[None], bbox.shape[0]
    tx, ty = t % tb_x, torch.div(t, tb_x, rounding_mode="floor")
    member = (tx >= b[..., 0]) & (tx < b[..., 1]) & (ty >= b[..., 2]) & (ty < b[..., 3])
    key_e = torch.where(member, n - torch.arange(n, dtype=torch.int32, device=dev), 0)
    library = dict(a=gather[KERNELS["a"][2]],
                   e=per_call_ms(lambda: torch.topk(key_e, 256, dim=1), queued=False))

    kernel_rows = []
    for key, (name, replaces, main) in KERNELS.items():
        by_state, r = rows[key], rows[key][main]
        row = dict(name=name, route="cuda", source=f"gaussianimage_plus_tpu_torch/csrc/{name}.cu",
                   replaces=replaces, launches_in_timer_runs=sum(
                       x["launches_in_timer_runs"] for x in by_state.values()),
                   max_abs_err=max(x["max_abs_err"] for x in by_state.values()),
                   **{k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                   library_ms=library.get(key), shape=f"{main}: " + ", ".join(
                       str(tuple(a.shape)) for a in cases[key][main][0] if torch.is_tensor(a)),
                   loss_ms=sum(x["launches_in_timer_runs"] * (x["device_ms"] - x["bound_ms"])
                               for x in by_state.values()))
        for field in ("device_ms", "ms", "plain_ms", "launches_in_timer_runs", "bound_ms"):
            row[f"{field}_by_state"] = {tag: x[field] for tag, x in by_state.items()}
        if key == "a":
            row.update(library_ms_by_state=gather,
                       library_call="table[ids] (the [T, K, 16] gather that fed kernel A before it "
                                    "read through the slot ids), device time a call")
        if key == "f":
            row.update(plain_device_ms=r["plain_device_ms"], plain_device_ms_by_state={
                t: x["plain_device_ms"] for t, x in by_state.items()})
        kernel_rows.append(row)
    return dict(card=dict(nvidia_smi=smi, torch_name=kind, torch=torch.__version__,
                          cuda=torch.version.cuda), kernels=kernel_rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    report = run()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": report["kernels"]}))
    print(report["card"]["nvidia_smi"])
    kind = report["card"]["torch_name"]
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
