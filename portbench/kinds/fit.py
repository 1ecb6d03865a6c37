"""Fit jobs in a closed loop: one user fitting a set of images, one at a time.

Set-up makes every input from the seed: the targets, the reference's float32
renders of the configuration's fitted states rounded to 8 bits (the PNGs
users fit are 8-bit), a seeded order over them, and each job's initial rows
(``init_state``'s distribution: means uniform over the image, raw
covariances uniform in [0, 1), colours zero, the first ``num_points`` rows
active, SLV floors at ``num_points``). It warms up the program with a short
fit through every stage a job runs (eager chunk, capture, replays, growth).

A job is one ``train.trainer.fit_image`` call, the whole public call. The
window opens at the first job's call and closes when the job during which
``--seconds`` ran out returns. ``train_ms_per_step`` is the window over all
steps of its jobs: warm-up chunk, capture, replays, prune, growth and
``restore_best`` all lie inside it.

``correct`` holds every job of the window to the plain reference
(``reference/train.py``), which follows the fit's steps (projection, render,
L2 loss, autograd, Adam) from what the job started each stretch with:

- the start, steps 1-3 from the job's initial rows and zero moments, which
  the eager warm-up chunk runs: ``loss_gap`` (steps 1-2: the render, the
  colours' gradient, Adam) and ``loss3_gap`` (step 3: the geometry's first
  move; a geometry gradient within rounding of zero takes a whole Adam step
  of either sign there, so sound runs read at step 3 what a lower precision
  reads at step 2);
- the graphed part, steps ``c + 1`` to ``c + 4`` (``c`` = ``prune_iter``):
  the first replay on the card. The reference starts from the carry the
  first chunk handed on (rows, active set and bounds after its prune, and
  Adam's count and moments), which set-up's wrapper around the chunk
  function copies once a job, and makes three updates: ``replay_loss_gap``
  compares the four losses, the last of which is where the three updates'
  change of the rows shows;
- the prune that ends the first chunk, by itself: the carry's active set
  against the rule applied to the carry's rows (``prune_miss``, exact);
- the answer: the PSNR the fit reports of the state it returned (after
  prune, growth and ``restore_best``), against the reference's render of
  that state (``psnr_gap``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from portbench import trace as T
from portbench.cell import Cell, fixture_files, split_fields
from portbench.reference import counts as C
from portbench.reference import render as R
from portbench.reference import train as RT


class Carry(NamedTuple):
    """What a fit's first chunk hands on to the next: the rows and Adam's
    (count, mu, nu)."""
    rows: RT.Rows
    adam: tuple


class Job(NamedTuple):
    target: int
    init: RT.Rows
    losses: torch.Tensor     # the fit's first three step losses
    carry: Optional[Carry]   # what its first chunk handed on
    replayed: torch.Tensor   # the losses of steps c + 1 to c + 4
    claim: float             # the PSNR the fit reports of the state it returned
    state: object            # the returned GaussianState


def handed(carry) -> Carry:
    """A copy of the rows and Adam state of a chunk's carry ``(ts, img)``."""
    g, opt = carry[0].gaussians, carry[0].opt_state
    rows = RT.Rows(*(t.detach().clone() for t in (g.params.xyz, g.params.cov2d,
                                                  g.params.features, g.active, g.bound)))
    return Carry(rows, (opt.count.clone(), tuple(m.clone() for m in opt.mu),
                        tuple(v.clone() for v in opt.nu)))


@contextlib.contextmanager
def carries():
    """Wraps each fit's chunk function so that the carry its first call
    returns, which the graph on the card is loaded with before its first
    replay (and the second chunk starts from elsewhere), is copied into the
    yielded list: a dozen small copies a job."""
    from gaussianimage_plus_tpu_torch.train import trainer

    got: List[Carry] = []
    orig = trainer._fit_runner

    def runner(*a, **kw):
        r = orig(*a, **kw)
        inner, first = r.fn, [True]

        def fn(carry):
            out = inner(carry)
            if first[0]:
                first[0] = False
                got.append(handed(out[0]))
            return out

        r.fn = fn
        return r

    trainer._fit_runner = runner
    try:
        yield got
    finally:
        trainer._fit_runner = orig


def start_gaps(init: RT.Rows, gt, tcfg, losses, dtype=torch.float32, tf32=False) -> List[float]:
    """Relative gaps of ``losses`` (steps 1-3) to the reference's from the
    initial rows."""
    ref = RT.follow(init, gt, tcfg.lr, 2, None, tcfg.lr_step_size, tcfg.lr_gamma, dtype, tf32)
    got = list(losses)
    if len(got) < len(ref):
        return [math.inf] * len(ref)
    return [abs(a - b) / b for a, b in zip(got, ref)]


def prune_misses(init: RT.Rows, carry: Optional[Carry]) -> float:
    """Rows whose active flag in the handed-on carry differs from the prune's
    rule on the carry's rows: active at the start and positive definite
    (``xx > 0``, ``yy > 0``, ``xx yy - xy^2 > 0`` of the covariance plus its
    bound), or, where that would leave none, active at the start. Rows whose
    determinant lies within rounding of 0 are left out."""
    if carry is None:
        return math.inf
    cov = carry.rows.cov2d + carry.rows.bound
    xx, xy, yy = cov.unbind(-1)
    det = xx * yy - xy * xy
    keep = init.active & (det > 0) & (xx > 0) & (yy > 0)
    if not bool(keep.any()):
        keep = init.active
    near = det.abs() <= 1e-5 * (xx * yy).abs()
    return float(((keep != carry.rows.active) & ~near).sum())


def replay_gaps(carry: Optional[Carry], gt, tcfg, losses, dtype=torch.float32,
                tf32=False) -> List[float]:
    """Relative gaps of ``losses`` (steps c + 1 to c + 4) to the
    reference's from the handed-on carry."""
    if carry is None or len(losses) < 4:
        return [math.inf] * 4
    ref = RT.follow(carry.rows, gt, tcfg.lr, 3, carry.adam, tcfg.lr_step_size,
                    tcfg.lr_gamma, dtype, tf32)
    return [abs(a - b) / b for a, b in zip(list(losses), ref)]


def _check_supported(cfg, tcfg) -> None:
    """The reference models this point of the configuration space."""
    if (cfg.param, cfg.slv, cfg.color_norm, cfg.clip_coe, cfg.radius_clip, cfg.psd_mode) != \
            ("covariance", True, False, 3.0, 1.0, "prune"):
        raise ValueError("the reference renders the covariance parameterization with SLV, "
                         "raw colours, clip 3, radius clip 1 and psd_mode 'prune' only")
    if (tcfg.loss_type, tcfg.opt_type, tcfg.color_reg) != ("L2", "adam", 0.0) or \
            (tcfg.xyz_lr_scale, tcfg.cov_lr_scale, tcfg.color_lr_scale) != (1.0, 1.0, 1.0):
        raise ValueError("the reference trains with L2, Adam and unit lr scales only")


class Inputs(NamedTuple):
    cfg: object
    tcfg: object
    n: int
    targets: List[torch.Tensor]
    order: np.ndarray
    inits: List[RT.Rows]


def make_inputs(cell: Cell, seed: int, device: torch.device) -> Inputs:
    """Everything a run feeds the program, from the seed."""
    from gaussianimage_plus_tpu_torch.models.gaussian_image import GaussianConfig
    from gaussianimage_plus_tpu_torch.train.trainer import TrainConfig

    conf = cell.config
    cfg = GaussianConfig(**split_fields(conf, GaussianConfig))
    tcfg = TrainConfig(**split_fields(conf, TrainConfig))
    _check_supported(cfg, tcfg)
    n = int(conf["num_points"])
    H, W, M = cfg.H, cfg.W, cfg.max_num_points
    targets = []
    for f in fixture_files(cell, conf["targets"]):
        s = np.load(f)
        h, w = int(s["H"]), int(s["W"])
        if (h, w) not in ((H, W), (W, H)):
            raise ValueError(f"{f.name} is {h}x{w}, not {H}x{W}")
        t = lambda k: torch.as_tensor(s[k]).to(device)
        img = R.render_state(t("xyz"), t("cov2d") + t("bound"), t("features"), t("active"), h, w)
        # a portrait image is fitted transposed, at the configuration's size
        targets.append(R.to_8bit(img if (h, w) == (H, W) else img.transpose(0, 1).contiguous()))
    order = np.random.default_rng(seed).permutation(len(targets))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lp = min(H * W / (9.0 * math.pi * n), 300.0)
    bound = torch.tensor([lp, 0.0, lp], dtype=torch.float32, device=device).expand(M, 3)
    active = torch.arange(M, device=device) < n
    size = torch.tensor([float(W), float(H)], device=device)
    inits = []
    for _ in range(int(cell.traffic["jobs_drawn"])):
        xy = torch.rand((M, 2), generator=gen, device=device) * size
        cov = torch.rand((M, 3), generator=gen, device=device)
        inits.append(RT.Rows(xy, cov, torch.zeros((M, 3), device=device), active,
                             bound.contiguous()))
    return Inputs(cfg, tcfg, n, targets, order, inits)


def fit(inp: Inputs, seed: int, j: int, tcfg=None):
    """Job ``j``: ``fit_image`` of its target from a copy of its initial rows."""
    from gaussianimage_plus_tpu_torch.models.gaussian_image import (GaussianParams,
                                                                    GaussianState)
    from gaussianimage_plus_tpu_torch.train.trainer import fit_image

    rows = inp.inits[j % len(inp.inits)]
    state = GaussianState(
        params=GaussianParams(xyz=rows.xyz.clone(), cov2d=rows.cov2d.clone(),
                              features=rows.features.clone()),
        active=rows.active.clone(), bound=rows.bound.clone(),
        num_active=torch.tensor(inp.n, dtype=torch.int32, device=rows.xyz.device))
    gt = inp.targets[inp.order[j % len(inp.order)]]
    return fit_image(gt, inp.cfg, tcfg or inp.tcfg, inp.n, seed=seed + j, gaussians=state)


def claim(res) -> float:
    """The PSNR a fit reports of its returned state, the post-update rows
    of step ``best_iter``: the next step's pre-update PSNR in the history
    (prune drops only rows that render nothing, growth adds rows of colour
    zero, the re-sort only permutes), or, where the best step is the last,
    the best PSNR itself, one update earlier."""
    psnr = res.history["psnr"]
    b = int(res.best_iter)
    return float(psnr[b]) if b < psnr.shape[0] else float(res.best_psnr)


class Traffic:
    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.dev = cell, seed, device
        self.cfg, self.tcfg, self.n, self.targets, self.order, self.inits = \
            make_inputs(cell, seed, device)
        self.jobs: List[Job] = []
        self._stack = contextlib.ExitStack()
        self.carries = self._stack.enter_context(carries())
        self._warm()

    def _fit(self, j: int, tcfg=None):
        self.carries.clear()
        return fit(Inputs(self.cfg, self.tcfg, self.n, self.targets, self.order, self.inits),
                   self.seed, j, tcfg)

    def _warm(self) -> None:
        """A short fit through each stage a job runs: the eager chunk, the
        capture, replays and a growth, at the cell's shapes."""
        c = self.tcfg.prune_iter
        self._fit(0, dataclasses.replace(self.tcfg, iterations=3 * c, grow_iter=2 * c))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float, tracer=None) -> dict:
        t0 = time.perf_counter()
        j = 0
        ends = []
        while True:
            res = self._fit(j)
            self._keep(j, res)
            j += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        print("portbench: jobs ended at " + " ".join(f"{e:.3f}" for e in ends) + " s",
              file=sys.stderr)
        elapsed = time.perf_counter() - t0
        self.window_s = elapsed
        steps = j * self.tcfg.iterations
        return {"train_ms_per_step": elapsed * 1e3 / steps, "attempted": j, "failed": 0}

    def _keep(self, j: int, res) -> None:
        c = self.tcfg.prune_iter
        loss = res.history["loss"].detach()
        self.jobs.append(Job(int(self.order[j % len(self.order)]), self.inits[j % len(self.inits)],
                             loss[:3].cpu(), self.carries[0] if self.carries else None,
                             loss[c:c + 4].cpu(), claim(res), res.state))

    def check(self) -> List[tuple]:
        self._stack.close()
        limits = self.cell.config["limits"]
        loss_gap = loss3_gap = replay_gap = psnr_gap = prune_miss = 0.0
        H, W = self.cfg.H, self.cfg.W
        for job in self.jobs:
            gt = self.targets[job.target]
            gaps = start_gaps(job.init, gt, self.tcfg, job.losses.tolist())
            later = replay_gaps(job.carry, gt, self.tcfg, job.replayed.tolist())
            print("portbench: loss gaps by step " + " ".join(f"{g:.3e}" for g in gaps) +
                  "; first replay " + " ".join(f"{g:.3e}" for g in later), file=sys.stderr)
            loss_gap = max([loss_gap] + gaps[:2])
            loss3_gap = max(loss3_gap, gaps[2])
            replay_gap = max([replay_gap] + later)
            prune_miss = max(prune_miss, prune_misses(job.init, job.carry))
            s = job.state
            img = R.render_state(s.params.xyz, s.params.cov2d + s.bound, s.params.features,
                                 s.active, H, W)
            psnr_gap = max(psnr_gap, abs(job.claim - RT.psnr(img, gt)))
        return [("loss_gap", loss_gap, limits["loss_gap"]),
                ("loss3_gap", loss3_gap, limits["loss3_gap"]),
                ("replay_loss_gap", replay_gap, limits["replay_loss_gap"]),
                ("prune_miss", prune_miss, limits["prune_miss"]),
                ("psnr_gap", psnr_gap, limits["psnr_gap"])]

    def install(self, tracer) -> None:
        """Spans around the fused dispatch: the eager warm-up chunk, the
        capture, and CUDA events around each replay."""
        from gaussianimage_plus_tpu_torch.train import trainer

        tracer.replays = T.EventTimer()
        chunk = self.tcfg.prune_iter

        def runner(fn, *a, **kw):
            r = fn(*a, **kw)
            inner = r.fn

            def eager(carry):
                if self.dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                    return inner(carry)
                with tracer.span("warm_chunk", sync=True):
                    return inner(carry)

            r.fn = eager
            return r

        def replay(fn, graph):
            with tracer.replays.time(chunk):
                return fn(graph)

        tracer.wrap(trainer, "_fit_runner", "fit_runner", around=runner)
        tracer.wrap(trainer.ChunkGraph, "__init__", "capture", sync=True)
        tracer.wrap(trainer.ChunkGraph, "replay", "replay", around=replay)

    def traced(self, tracer) -> dict:
        """After the window: one more job of the same traffic, profiled from
        its call to the end of its first growth (its first segment: the
        eager chunk, the capture, the replays and the growth; a whole job's
        trace, millions of device operations at Kodak, takes minutes to
        read), then the steady segment, ``steady_chunks`` graphed chunks
        of the public ``train_macro_chunk`` from the last job's returned
        state, under the profiler; the counts at that state."""
        from gaussianimage_plus_tpu_torch import kernels
        from gaussianimage_plus_tpu_torch.train import trainer
        from gaussianimage_plus_tpu_torch.train.trainer import (init_train_state,
                                                                train_macro_chunk)

        window_ms, window_steps = tracer.replays.read()
        spans = {k: list(v) for k, v in tracer.spans.items()}
        jobs = len(self.jobs)
        with T.profiled(until=(trainer, "_grow_ts")) as held:
            tracer.annotate = True
            with tracer.span("fit_image"):
                res = self._fit(jobs)
            tracer.annotate = False
        self._keep(jobs, res)
        self.job_profile = T.Profile(held.prof)

        last = self.jobs[-1]
        gt = self.targets[last.target]
        ts = init_train_state(self.cfg, self.tcfg, self.n, seed=self.seed,
                              gaussians=last.state)
        chunks = int(self.cell.traffic["steady_chunks"])
        tracer.replays = T.EventTimer()
        before = [k.launches for k in kernels.wrappers()]
        with T.profiled() as held:
            tracer.annotate = True
            train_macro_chunk(ts, gt, self.cfg, self.tcfg, n_chunks=chunks,
                              chunk=self.tcfg.prune_iter, do_prune=self.tcfg.prune,
                              do_grow=False)
            tracer.annotate = False
        steady_ms, steady_steps = tracer.replays.read()
        launches = {k.__name__: k.launches - b for k, b in zip(kernels.wrappers(), before)}
        s = last.state
        p = R.project(s.params.xyz, s.params.cov2d + s.bound, s.active, self.cfg.H, self.cfg.W)
        pairs = C.pairs(p, self.cfg.H, self.cfg.W)
        return {
            "jobs": jobs,
            "spans": spans,
            "replay": (window_ms, window_steps),
            "window_s": self.window_s,
            "steady": {"profile": T.Profile(held.prof, after="pb:capture"),
                       "steps": steady_steps, "step_ms": steady_ms / max(steady_steps, 1),
                       "launches": launches,
                       "forward": C.forward(pairs), "backward": C.backward(pairs),
                       "step": C.step(pairs, int(s.active.sum()))},
        }

    def device_window(self, tracer) -> T.Profile:
        """The profile of the job after the window, to its first growth."""
        return self.job_profile
