"""Coding jobs in a closed loop: one user compressing Kodak-size photos into
``.gipb`` streams, one after another, on one card.

Set-up reads the configuration's committed fitted states (its ``targets``
glob, sha-checked), makes each target the reference's float32 render of its
state rounded to 8 bits (a portrait state is transposed to the
configuration's size first, and so is its render), draws the job order from
the seed (a permutation of the targets, cycled to ``jobs_drawn`` jobs), and
warms the program up with a short job through every stage a job runs: the
warmup's eager chunk, capture and replay, the QAT's eager chunk, capture and
replay, the encode, the stream's write and its decode.

A job is the codec's recipe through the public calls:
``compress.trainer.fit_image_quantized`` warm-started from the target's
fitted state (``warmup_iter`` steps, a prune every ``prune_iter``, no
growth, then ``qat_iter`` QAT steps), then ``encode_decode_eval(n_renders=0)``
writing the ``.gipb`` under ``TMPDIR`` in id order. The window opens at the
first job's call and closes when the job during which ``--seconds`` ran out
returns; ``train_ms_per_step`` is the window over all its jobs' steps, warmup
and QAT, with both phases' eager chunks and captures, the encode and the
round-trip decode inside it.

``correct`` holds every job of the window to the plain reference
(``reference/qat.py``, and ``reference/gipb.py`` for the bytes):

- ``qinit_gap``: the grids ``init_quantizers`` set against the reference's
  init on the same restored rows, in steps of the reference's grid;
- ``qat_loss_gap``: QAT steps 1 and 2 (the eager chunk), each the forward
  of the program's own rows and grids at the step's start: the restored
  rows under the initial grids, then the carry after the first update,
  which ``taps`` copies by running the eager chunk's first step apart,
  relative;
- ``qat_update_miss``: that first update against the reference's from the
  restored rows, fresh Adams and the initial grids: the share of its values
  off by more than half an Adam step, %. An Adam's first step is its
  gradient's sign times the rate, so a row whose gradient differs in
  rounding moves by the rate either way: compared one value at a time, an
  update is sound or a whole step off. Not the loss after it: one value
  that lands on the other side of a rounding boundary moves its row by a
  whole code (a 6-bit colour code of the fitted states' grid is ~0.38), and
  the loss with it by ~4e-4 of itself;
- ``qat_replay_loss_gap``: steps ``c + 1`` and ``c + 2`` (``c`` =
  ``prune_iter``; the first replay on the card) from the carry the eager
  chunk handed on: rows, the model's and the grids' Adam states, the grids,
  copied once a job by a wrapper around the QAT runner's chunk function
  (``taps``), relative. Two steps: the forward, then one update, which
  after ``c`` steps is no longer a gradient's sign; later steps of the free
  run drift apart by code flips as above (to 3e-3 at step ``c + 4``);
- ``code_miss``: the written bytes read by the frozen parser against the
  reference's encoding of the returned snapshot under the returned grids:
  header fields, grid values and codes that differ, exact;
- ``stream_psnr_gap``: the ``stream_psnr`` the job reports against the PSNR
  of the frozen decoder's render of the same bytes against the target, dB.

The traced run records the program's spans over its window
(``profiling.recording()``), then runs one more job with its QAT phase
profiled from ``init_quantizers`` to the end of its first replay, then the
steady segment: ``steady_chunks`` graphed ``quant_train_macro_chunk`` chunks
from the last job's returned snapshot and grids, profiled after the capture,
with CUDA events around each replay, and the counted work of a QAT step at
that state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import shutil
import sys
import tempfile
import time
import types
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from portbench import trace as T
from portbench.cell import Cell, fixture_files, split_fields
from portbench.reference import counts as C
from portbench.reference import qat as RQ
from portbench.reference import qat_counts as QC
from portbench.reference import render as R
from portbench.reference import train as RT


class Handed(NamedTuple):
    """What a QAT run's eager chunk hands on to the first replay."""
    rows: RT.Rows
    model: tuple           # the model's Adam: (count, mu, nu)
    grids: RQ.Grids
    grid_states: tuple     # each grid's Adam: (count, mu, nu)


class Job(NamedTuple):
    target: int
    restored: Optional[RT.Rows]    # the rows init_quantizers started from
    qinit: Optional[RQ.Grids]      # the grids it set
    losses: torch.Tensor           # QAT steps 1-2
    stepped: Optional[Handed]      # the carry after QAT step 1
    handed: Optional[Handed]
    replayed: torch.Tensor         # QAT steps c + 1 and c + 2
    state: object                  # the returned snapshot (GaussianState)
    bundle: object                 # the returned grids (QuantizerBundle)
    stream: bytes                  # the written .gipb
    stream_psnr: float             # as the job reports it


def grids_of(bundle) -> RQ.Grids:
    c = lambda t: t.detach().clone()
    return RQ.Grids(RQ.Grid(c(bundle.xy.scale), c(bundle.xy.beta)),
                    RQ.Grid(c(bundle.cov.cov.scale), c(bundle.cov.cov.beta)),
                    RQ.Grid(c(bundle.color.scale), c(bundle.color.beta)))


def rows_of_state(state) -> RT.Rows:
    p = state.params
    return RQ.rows_of(p.xyz, p.cov2d, p.features, state.active, state.bound)


def _adam(opt) -> tuple:
    return (opt.count.clone(), tuple(m.clone() for m in opt.mu),
            tuple(v.clone() for v in opt.nu))


def handed(carry) -> Handed:
    """A copy of a QAT chunk's carry ``(state, model Adam, bundle, best)``."""
    state, mos, bundle, _ = carry
    return Handed(rows_of_state(state), _adam(mos), grids_of(bundle),
                  tuple(_adam(o) for o in (bundle.xy_opt, bundle.cov_opt, bundle.color_opt)))


@contextlib.contextmanager
def _first_step_apart(got: dict):
    """For the block, ``compress.pipeline.quant_train_chunk`` of ``n`` steps
    runs as a chunk of one step, whose carry is copied into ``got['stepped']``,
    then a chunk of ``n - 1``: step for step the same work (each step takes
    only the carry; the two chunks' losses and PSNRs are concatenated)."""
    from gaussianimage_plus_tpu_torch.compress import pipeline

    chunk = pipeline.quant_train_chunk

    def apart(state, mos, bundle, gt, cfg, qcfg, model_lr, n_steps, best=None):
        if n_steps < 2:
            return chunk(state, mos, bundle, gt, cfg, qcfg, model_lr, n_steps, best=best)
        *carry, m1 = chunk(state, mos, bundle, gt, cfg, qcfg, model_lr, 1, best=best)
        got["stepped"].append(handed((*carry, None)))
        *carry, m = chunk(*carry, gt, cfg, qcfg, model_lr, n_steps - 1, best=m1["best"])
        return (*carry, {"loss": torch.cat([m1["loss"], m["loss"]]),
                         "psnr": torch.cat([m1["psnr"], m["psnr"]]), "best": m["best"]})

    pipeline.quant_train_chunk = apart
    try:
        yield
    finally:
        pipeline.quant_train_chunk = chunk


@contextlib.contextmanager
def taps():
    """Wraps ``init_quantizers`` and the QAT runner of ``compress.trainer``
    so that each job's restored rows and initial grids (``init``), its carry
    after QAT step 1 (``stepped``: the runner's first, eager call runs its
    first step apart, ``_first_step_apart``) and the carry that call returns
    (``handed``, which the graph on the card is loaded with before its first
    replay) are copied into the yielded dict's lists."""
    from gaussianimage_plus_tpu_torch.compress import trainer as ctr

    got = {"init": [], "stepped": [], "handed": []}
    init, runner = ctr.init_quantizers, ctr._qat_runner

    def tapped_init(state, *a, **kw):
        bundle = init(state, *a, **kw)
        got["init"].append((rows_of_state(state), grids_of(bundle)))
        return bundle

    def tapped_runner(*a, **kw):
        r = runner(*a, **kw)
        inner, first = r.fn, [True]

        def fn(carry):
            if not first[0]:
                return inner(carry)
            first[0] = False
            with _first_step_apart(got):
                out = inner(carry)
            got["handed"].append(handed(out[0]))
            return out

        r.fn = fn
        return r

    ctr.init_quantizers, ctr._qat_runner = tapped_init, tapped_runner
    try:
        yield got
    finally:
        ctr.init_quantizers, ctr._qat_runner = init, runner


class Inputs(NamedTuple):
    cfg: object
    tcfg: object           # iterations = warmup + QAT
    qcfg: object
    warmup: int
    bits: RQ.Bits
    quant: RQ.QuantLR
    model_lr: float        # the QAT model Adam's, the warmup's rate decayed to its end
    starts: List[RT.Rows]  # each target's fitted state, at the configuration's size
    targets: List[torch.Tensor]
    order: np.ndarray      # target of each job


def _check_supported(cfg, tcfg, qcfg) -> None:
    """The reference models this point of the configuration space."""
    if (cfg.param, cfg.slv, cfg.color_norm, cfg.clip_coe, cfg.radius_clip, cfg.psd_mode) != \
            ("covariance", True, False, 3.0, 1.0, "prune"):
        raise ValueError("the reference renders the covariance parameterization with SLV, "
                         "raw colours, clip 3, radius clip 1 and psd_mode 'prune' only")
    if (tcfg.loss_type, tcfg.opt_type) != ("L2", "adam"):
        raise ValueError("the reference trains with L2 and Adam only")
    if (qcfg.xy_quant, qcfg.cov_quant, qcfg.color_quant, qcfg.init_percentile) != \
            ("lsq", "lsq", "lsq", 100.0):
        raise ValueError("the reference quantizes with LSQ grids set from the full range only")


def transposed(rows: RT.Rows) -> RT.Rows:
    """A portrait state as the landscape image's: x and y swapped."""
    swap = lambda t: t[:, [2, 1, 0]].contiguous()
    return rows._replace(xyz=rows.xyz[:, [1, 0]].contiguous(), cov2d=swap(rows.cov2d),
                         bound=swap(rows.bound))


def make_inputs(cell: Cell, seed: int, device: torch.device) -> Inputs:
    """Everything a run feeds the program, from the seed."""
    from gaussianimage_plus_tpu_torch.compress.pipeline import QuantConfig
    from gaussianimage_plus_tpu_torch.models.gaussian_image import GaussianConfig
    from gaussianimage_plus_tpu_torch.train.trainer import TrainConfig

    conf = cell.config
    warmup, qat = int(conf["warmup_iter"]), int(conf["qat_iter"])
    cfg = GaussianConfig(**split_fields(conf, GaussianConfig))
    tcfg = TrainConfig(**{**split_fields(conf, TrainConfig), "iterations": warmup + qat})
    qcfg = QuantConfig(**split_fields(conf, QuantConfig))
    _check_supported(cfg, tcfg, qcfg)
    H, W = cfg.H, cfg.W
    starts, targets = [], []
    for f in fixture_files(cell, conf["targets"]):
        s = np.load(f)
        h, w = int(s["H"]), int(s["W"])
        if (h, w) not in ((H, W), (W, H)) or s["xyz"].shape[0] != cfg.max_num_points:
            raise ValueError(f"{f.name} is {h}x{w} with {s['xyz'].shape[0]} rows, not "
                             f"{H}x{W} with {cfg.max_num_points}")
        t = lambda k: torch.as_tensor(s[k]).to(device)
        rows = RT.Rows(t("xyz").float(), t("cov2d").float(), t("features").float(),
                       t("active").bool(), t("bound").float())
        rows = rows if (h, w) == (H, W) else transposed(rows)
        starts.append(rows)
        targets.append(R.to_8bit(R.render_state(rows.xyz, rows.cov2d + rows.bound,
                                                rows.features, rows.active, H, W)))
    drawn = int(cell.traffic["jobs_drawn"])
    order = np.resize(np.random.default_rng(seed).permutation(len(targets)), drawn)
    model_lr = tcfg.lr * tcfg.lr_gamma ** (warmup // tcfg.lr_step_size)
    return Inputs(cfg, tcfg, qcfg, warmup, RQ.Bits(qcfg.xy_bit, qcfg.cov_bit, qcfg.color_bit),
                  RQ.QuantLR(qcfg.quant_lr, qcfg.quant_lr_step, qcfg.quant_lr_gamma), model_lr,
                  starts, targets, order)


def run_job(inp: Inputs, seed: int, j: int, path: str, tcfg=None, warmup: Optional[int] = None):
    """Job ``j``: ``fit_image_quantized`` from a copy of its target's fitted
    state, then ``encode_decode_eval`` writing ``path``; (result, stats)."""
    from gaussianimage_plus_tpu_torch.compress.trainer import (encode_decode_eval,
                                                               fit_image_quantized)
    from gaussianimage_plus_tpu_torch.models.gaussian_image import (GaussianParams,
                                                                    GaussianState)

    k = int(inp.order[j % len(inp.order)])
    r = inp.starts[k]
    n = torch.count_nonzero(r.active).to(torch.int32)
    state = GaussianState(
        params=GaussianParams(xyz=r.xyz.clone(), cov2d=r.cov2d.clone(),
                              features=r.features.clone()),
        active=r.active.clone(), bound=r.bound.clone(), num_active=n)
    gt = inp.targets[k]
    res = fit_image_quantized(gt, inp.cfg, tcfg or inp.tcfg, inp.qcfg, inp.cfg.max_num_points,
                              warmup_iter=inp.warmup if warmup is None else warmup,
                              seed=seed + j, init_state=state)
    stats = encode_decode_eval(res.state, res.bundle, gt, inp.cfg, inp.qcfg, n_renders=0,
                               write_bitstream=path, stream_order="id")
    return res, stats


def keep(inp: Inputs, j: int, res, stats, path: str, got: dict) -> Job:
    """What the checks need of job ``j``; reads and removes its stream."""
    c = inp.tcfg.prune_iter
    loss = res.metrics["loss"].detach()
    restored, qinit = got["init"][0] if got["init"] else (None, None)
    data = Path(path).read_bytes()
    os.remove(path)
    first = lambda k: got[k][0] if got[k] else None
    return Job(int(inp.order[j % len(inp.order)]), restored, qinit, loss[:2].cpu(),
               first("stepped"), first("handed"), loss[c:c + 2].cpu(),
               res.state, res.bundle, data, float(stats["stream_psnr"]))


def _rel(got, ref) -> List[float]:
    return [abs(a - b) / b for a, b in zip(got, ref)]


def first_steps(inp: Inputs, job: Job, gt, tf32: bool = False):
    """(relative gaps of the job's QAT steps 1 and 2, the update's miss).

    Each step's loss against the reference's forward of the program's own
    rows and grids at the step's start: the restored rows under the initial
    grids, then the carry after the first update. The miss: the share, %, of
    the first update's values (the active rows' eight parameters, the twelve
    grid values) that differ from the reference's update from the restored
    rows, fresh Adams and the initial grids by more than half an Adam step
    (``model_lr / 2``, ``quant_lr / 2``). With ``tf32`` the reference's own
    losses and update, computed so, stand in the program's place."""
    if job.restored is None or job.stepped is None or len(job.losses) < 2:
        return [math.inf] * 2, math.inf
    follow = lambda rows, grids, n, t: RQ.follow(rows, grids, gt, inp.bits, inp.model_lr, n,
                                                 quant=inp.quant, tf32=t)
    ref = follow(job.restored, job.qinit, 1, False)
    step2 = follow(job.stepped.rows, job.stepped.grids, 0, False).losses[0]
    if tf32:
        ctl = follow(job.restored, job.qinit, 1, True)
        got = [ctl.losses[0], follow(job.stepped.rows, job.stepped.grids, 0, True).losses[0]]
        rows, grids = ctl.rows, ctl.grids
    else:
        got, rows, grids = job.losses.tolist(), job.stepped.rows, job.stepped.grids
    off = total = 0
    for a, b in zip(rows[:3], ref.rows[:3]):
        d = (a - b).abs()[job.restored.active]
        off += int((d > inp.model_lr / 2).sum())
        total += d.numel()
    for ga, gb in zip(grids, ref.grids):
        for a, b in zip(ga, gb):
            off += int(((a - b).abs() > inp.quant.lr / 2).sum())
            total += a.numel()
    return _rel(got, [ref.losses[0], step2]), 100.0 * off / total


def replay_gaps(inp: Inputs, job: Job, gt, tf32: bool = False) -> List[float]:
    """Relative gaps of the job's steps c + 1 and c + 2 (with ``tf32``: of
    the reference's, computed so) to the reference's from the handed-on
    carry."""
    h = job.handed
    if h is None or len(job.replayed) < 2:
        return [math.inf] * 2
    follow = lambda t: RQ.follow(h.rows, h.grids, gt, inp.bits, inp.model_lr, 1, h.model,
                                 h.grid_states, inp.quant, t).losses
    return _rel(follow(True) if tf32 else job.replayed.tolist(), follow(False))


def qinit_gap(inp: Inputs, job: Job) -> float:
    if job.restored is None:
        return math.inf
    return RQ.grid_gap(job.qinit, RQ.init_grids(job.restored, inp.bits))


def code_miss(inp: Inputs, job: Job) -> int:
    return RQ.code_misses(job.stream, rows_of_state(job.state), grids_of(job.bundle), inp.bits,
                          inp.cfg.H, inp.cfg.W)


def stream_gap(job: Job, gt, tf32: bool = False) -> float:
    """|the job's ``stream_psnr`` (or, with ``tf32``, the reference's own
    decode computed so) - the reference decode's PSNR|, dB."""
    got = RQ.stream_psnr(job.stream, gt, tf32=True) if tf32 else job.stream_psnr
    return abs(got - RQ.stream_psnr(job.stream, gt))


class Traffic:
    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.inp = make_inputs(cell, seed, device)
        self.dir = tempfile.mkdtemp(prefix="portbench-qat-")
        self.jobs: List[Job] = []
        self._stack = contextlib.ExitStack()
        self.got = self._stack.enter_context(taps())
        self._warm()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _run(self, j: int, tcfg=None, warmup=None):
        for v in self.got.values():
            v.clear()
        path = os.path.join(self.dir, f"job{j}.gipb")
        res, stats = run_job(self.inp, self.seed, j, path, tcfg, warmup)
        return res, stats, path

    def _keep(self, j: int, res, stats, path) -> None:
        self.jobs.append(keep(self.inp, j, res, stats, path, self.got))

    def _warm(self) -> None:
        """A job of two chunks a phase: each phase's eager chunk, capture and
        a replay, then the encode, the write and the decode, at the cell's
        shapes."""
        c = self.inp.tcfg.prune_iter
        _, _, path = self._run(0, dataclasses.replace(self.inp.tcfg, iterations=4 * c), 2 * c)
        os.remove(path)
        self._sync()

    def window(self, seconds: float, tracer=None) -> dict:
        from gaussianimage_plus_tpu_torch.utils import profiling

        rec = profiling.recording() if tracer is not None else contextlib.nullcontext()
        ends = []
        j = 0
        lo = time.time_ns()
        t0 = time.perf_counter()
        with rec:
            while True:
                if j == len(self.inp.order):
                    raise RuntimeError(f"the window outlasted the {j} jobs drawn")
                self._keep(j, *self._run(j))
                j += 1
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= seconds:
                    break
        elapsed = time.perf_counter() - t0
        self.window_ns = (lo, time.time_ns())
        print("portbench: jobs ended at " + " ".join(f"{e:.3f}" for e in ends) + " s",
              file=sys.stderr)
        steps = j * self.inp.tcfg.iterations
        return {"train_ms_per_step": elapsed * 1e3 / steps, "attempted": j, "failed": 0}

    def check(self) -> List[tuple]:
        self._stack.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        limits = self.cell.traffic["limits"]
        worst = dict.fromkeys(limits, 0.0)
        for job in self.jobs:
            gt = self.inp.targets[job.target]
            start, miss = first_steps(self.inp, job, gt)
            later = replay_gaps(self.inp, job, gt)
            got = {"qinit_gap": qinit_gap(self.inp, job), "qat_loss_gap": max(start),
                   "qat_update_miss": miss, "qat_replay_loss_gap": max(later),
                   "code_miss": code_miss(self.inp, job), "stream_psnr_gap": stream_gap(job, gt)}
            print("portbench: qat loss gaps by step " + " ".join(f"{g:.3e}" for g in start) +
                  f", update miss {miss:.3e}%; first replay " +
                  " ".join(f"{g:.3e}" for g in later) +
                  f"; qinit {got['qinit_gap']:.3e}, code misses {got['code_miss']}, "
                  f"stream psnr gap {got['stream_psnr_gap']:.3e} dB", file=sys.stderr)
            worst = {k: max(worst[k], got[k]) for k in worst}
        return [(k, worst[k], limits[k]) for k in limits]

    def install(self, tracer) -> None:
        """Nothing to wrap: the window's per-layer readings are the program's
        own spans, recorded over the traced window (``window``)."""

    def traced(self, tracer) -> dict:
        """After the window: one more job, its QAT phase profiled from
        ``init_quantizers`` to the end of its first replay (the job then runs
        to its end and is checked with the others), then the steady segment
        under the profiler; the counts at the steady segment's state."""
        from gaussianimage_plus_tpu_torch import kernels
        from gaussianimage_plus_tpu_torch.compress import trainer as ctr
        from gaussianimage_plus_tpu_torch.compress.pipeline import quant_train_macro_chunk
        from gaussianimage_plus_tpu_torch.train import trainer
        from gaussianimage_plus_tpu_torch.train.optim import make_adam
        from gaussianimage_plus_tpu_torch.utils import profiling

        inp, jobs = self.inp, len(self.jobs)
        held, stack, init = {}, contextlib.ExitStack(), ctr.init_quantizers

        def profiled_init(*a, **kw):
            held["qat"] = stack.enter_context(T.profiled(until=(trainer.ChunkGraph, "replay")))
            return init(*a, **kw)

        ctr.init_quantizers = profiled_init
        try:
            with profiling.recording(), stack:
                out = self._run(jobs)
        finally:
            ctr.init_quantizers = init
        self._keep(jobs, *out)
        self.job_profile = T.Profile(held["qat"].prof)

        last = self.jobs[-1]
        gt = inp.targets[last.target]
        chunk = inp.tcfg.prune_iter
        s, b = last.state, last.bundle
        mos = make_adam(inp.model_lr, 20000, 0.5).init(s.params)
        tracer.replays = T.EventTimer()

        def replay(fn, graph):
            with tracer.replays.time(chunk):
                return fn(graph)

        tracer.wrap(trainer.ChunkGraph, "__init__", "capture", sync=True)
        tracer.wrap(trainer.ChunkGraph, "replay", "replay", around=replay)
        before = [k.launches for k in kernels.wrappers()]
        with T.profiled() as steady:
            tracer.annotate = True
            quant_train_macro_chunk(s, mos, b, gt, inp.cfg, inp.qcfg, inp.model_lr,
                                    int(self.cell.traffic["steady_chunks"]), chunk)
            tracer.annotate = False
        ms, steps = tracer.replays.read()
        launches = {k.__name__: k.launches - n for k, n in zip(kernels.wrappers(), before)}
        rows, grids = rows_of_state(s), grids_of(b)
        with torch.no_grad():
            xy, cov, col, _, _ = RQ.quantized(rows.xyz, rows.cov2d + rows.bound, rows.features,
                                              rows.active, grids, inp.bits)
            p = R.project(xy, cov, rows.active, inp.cfg.H, inp.cfg.W)
        pairs = C.pairs(p, inp.cfg.H, inp.cfg.W)
        lo, hi = self.window_ns
        return {"jobs": jobs,
                "qat_window": types.SimpleNamespace(lo=lo * 1e-9, hi=hi * 1e-9),
                "qat_steady": {"profile": T.Profile(steady.prof, after="pb:capture"),
                               "steps": steps, "step_ms": ms / max(steps, 1),
                               "launches": launches,
                               "step": QC.step(pairs, int(rows.active.sum()))}}

    def device_window(self, tracer) -> T.Profile:
        """The profile of the job after the window, from its QAT phase's
        start to the end of its first replay."""
        return self.job_profile
