"""Rank workers for the port's multi-process tests (gloo on the CPU).

No tests live here, and nothing here imports JAX: a spawned rank imports
this module by name, and importing JAX in every rank would cost seconds
each. ``run_ranks`` starts ``world`` processes with the spawn start method,
joins them within a time limit (killing every rank on a timeout or a failure,
so a hung collective never hangs the suite) and returns each rank's result.
The process group starts from a file in the test's own directory (a
``file://`` store: no TCP port, so parallel test workers cannot collide),
with a collective timeout of its own.
"""

from __future__ import annotations

import datetime
import multiprocessing
import time
import traceback
import warnings
from pathlib import Path

import torch
import torch.distributed as dist

from gaussianimage_plus_tpu_torch.models.gaussian_image import GaussianParams
from gaussianimage_plus_tpu_torch.parallel import multihost, sharded
from gaussianimage_plus_tpu_torch.train import trainer

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _rank_main(rank: int, world: int, tmp: str, name: str) -> None:
    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pt"
    try:
        args = torch.load(Path(tmp) / "args.pt", weights_only=False)
        dist.init_process_group("gloo", init_method=f"file://{Path(tmp) / 'store'}",
                                rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
        try:
            result = globals()[name](rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": result}, out)
    except Exception:                       # reported to the parent, which fails the test
        torch.save({"error": traceback.format_exc()}, out)


def run_ranks(name: str, world: int, tmp_path, *args, timeout: float = 240.0) -> list:
    """``name(rank, world, *args)`` on ``world`` spawned gloo ranks; returns
    the ranks' results in rank order, or raises with a rank's traceback."""
    tmp = str(tmp_path)
    # the arguments go through a file: multiprocessing would pickle tensors
    # into shared memory, whose descriptors the spawned ranks cannot take
    torch.save(args, Path(tmp) / "args.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, name), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    if hung:
        raise TimeoutError(f"{name}: {len(hung)} of {world} ranks still running after {timeout} s")
    results = []
    for r, p in enumerate(procs):
        path = Path(tmp) / f"rank{r}.pt"
        if not path.exists():
            raise RuntimeError(f"{name}: rank {r} exited with code {p.exitcode} and no result")
        res = torch.load(path, weights_only=False)
        if "error" in res:
            raise RuntimeError(f"{name}: rank {r} failed:\n{res['error']}")
        results.append(res["ok"])
    return results


def calls(rank, world, seq):
    """Each ``(worker name, args)`` of ``seq`` in turn, in one group."""
    return [globals()[name](rank, world, *args) for name, args in seq]


def _with_grad(st):
    return st._replace(params=GaussianParams(*(p.detach().clone().requires_grad_(True)
                                               for p in st.params)))


def sharded_render(rank, world, cases):
    """The tile-sharded render and its L2 loss's parameter gradient, per
    case ``(cfg, GaussianState, target)``."""
    mesh = sharded.make_mesh(axis_names=("tile",))
    out = []
    for cfg, st, gt in cases:
        st = _with_grad(st)
        img = sharded.make_tile_sharded_render(mesh, cfg, axis="tile")(st, cfg)
        grads = torch.autograd.grad(torch.mean((img - gt) ** 2), st.params)
        out.append((img.detach(), grads, sharded.replica_spread(grads, mesh)))
    return out


def sharded_chunk(rank, world, cfg, tcfg, ts, gt, draws, n_steps):
    """``n_steps`` of ``train_chunk`` with the tile-sharded render, then a
    prune and a growth (``draws`` injected): the final state, the per-step
    PSNRs and the spread over the ranks of the parameters, the active mask
    and the best PSNR."""
    mesh = sharded.make_mesh(axis_names=("tile",))
    render_fn = sharded.make_tile_sharded_render(mesh, cfg, axis="tile")
    ts, m = trainer.train_chunk(ts, gt, cfg, tcfg, n_steps, True, True, grow_draws=draws,
                                render_fn=render_fn)
    g = ts.gaussians
    spread = sharded.replica_spread((*g.params, g.active, ts.best_psnr), mesh)
    return ts._replace(generator=None), m["psnr"], spread


def sharded_fit(rank, world, cfg, tcfg, gt, num_points, seed, super_cap):
    """``fit_image_tile_sharded``, and beside it the same chunk schedule run
    chunk by chunk through ``train_chunk`` with the sharded render: the
    spread over the ranks of the parameters, the active set and the best
    PSNR after each chunk, both fits' final (best) states, the candidates
    the chunk-by-chunk render dropped (summed over the ranks) and the
    warnings the fit gave."""
    mesh = sharded.make_mesh(axis_names=("tile",))
    render_fn = sharded.make_tile_sharded_render(mesh, cfg, super_cap=super_cap)
    ts = trainer.init_train_state(cfg, tcfg, num_points, seed, device="cpu")
    spreads = []
    for _, do_grow, final_fill in sharded._chunk_schedule(tcfg):
        ts, _ = trainer.train_chunk(ts, gt, cfg, tcfg, tcfg.prune_iter, tcfg.prune, do_grow,
                                    final_fill, render_fn=render_fn)
        g = ts.gaussians
        spreads.append(sharded.replica_spread((*g.params, g.active, ts.best_psnr), mesh))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = sharded.fit_image_tile_sharded(gt, cfg, tcfg, num_points, mesh=mesh,
                                             super_cap=super_cap, seed=seed, device="cpu")
    return (spreads, trainer.restore_best(ts), res.state, render_fn.super_overflow(),
            [str(w.message) for w in caught])


def fit_batch(rank, world, images, cfg, tcfg, num_points, states, draws):
    """``fit_batch`` over the world's mesh, every rank passing the whole
    batch; ``states`` and ``draws`` (one growth's per image), when given,
    replace each image's initial state and growth draws."""
    tss = sharded.fit_batch(images, cfg, tcfg, num_points, mesh=sharded.make_mesh(), seed=1,
                            device="cpu", states=states,
                            grow_draws=None if draws is None else [[d] for d in draws])
    return [ts._replace(generator=None) for ts in tss]


def fit_global_batch(rank, world, images, cfg, tcfg, num_points):
    """``fit_global_batch``, each rank passing its own block of ``images``
    (``initialize`` is a no-op inside an initialised group); the chunk ends
    its progress callback saw."""
    multihost.initialize(device="cpu")
    n = len(images) // world
    seen = []
    tss = multihost.fit_global_batch(images[rank * n:(rank + 1) * n], cfg, tcfg, num_points,
                                     seed=1, device="cpu",
                                     progress=lambda it, m: seen.append(it))
    return [ts._replace(generator=None) for ts in tss], seen


def shard_uneven(rank, world):
    """``shard_global_batch`` with rank ``r`` passing ``r + 1`` images: the
    message it is refused with."""
    try:
        multihost.shard_global_batch(torch.zeros((rank + 1, 4, 4, 3)), multihost.global_mesh(),
                                     device="cpu")
    except ValueError as e:
        return str(e)
    return "not refused"
