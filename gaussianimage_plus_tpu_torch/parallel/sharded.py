"""Batched per-image fitting (data parallel) and the tile-sharded render.

Port of ``gaussianimage_plus_tpu/parallel/sharded.py``: ``make_mesh``
(``:50-56``), ``init_batch_train_state`` (``:63-67``), ``shard_batch``
(``:70-77``), ``batch_train_chunk`` (``:80-94``), ``batch_train_chunk_dp``
(``:97-124``), ``fit_batch`` (``:127-170``), ``_raster_tiles_local``
(``:177-216``), ``image_to_tile_rows`` (``:219-225``),
``make_tile_sharded_render`` (``:228-316``) and ``fit_image_tile_sharded``
(``:319-331``), on ``torch.distributed``.

- **Images (data parallel).** Each image is its own problem: a rank fits its
  contiguous block of the batch, one image after another within a chunk
  (the JAX shard_map body's ``lax.map``), with no communication until
  ``fit_batch`` gathers every image's state onto every rank at the end. As
  the JAX ``fit_batch`` is one dispatch a chunk, a chunk of the rank's whole
  block is, on the card wherever ``train.trainer.captures``, a replay of one
  ``ChunkGraph`` whose carry is the block's ``(ts, last render)`` pairs; the
  growth and the final fill follow it eagerly, image by image (as
  ``train.trainer.train_macro_chunk`` grows after its replays). On the CPU,
  and for tensors on the CPU under a gloo mesh, the same chunks run eagerly.
- **Tiles (one large image).** The Gaussian parameters are replicated; each
  rank projects them, bins and rasterizes only its own flat range of tile
  rows, and the tiles are all-gathered into the full image, so every rank
  computes the same loss. Backward: the gather hands each rank its slice of
  the image's cotangent, and the replicated parameters' gradients are summed
  over the ranks (the mesh-level counterpart of the reference backward's
  atomicAdd, backward.cu:1330-1344).

Deviations, on purpose:

- A JAX ``Mesh`` holds many devices in one process; the torch idiom is one
  process per device, so the port's ``Mesh`` is one axis of the ranks of a
  ``torch.distributed`` process group (``torchrun``, or ``multihost.initialize``),
  and each rank runs these functions on its own part. Without an initialised
  group it is a world of one, and nothing communicates. Meshes of more than
  one axis (the JAX docstring's 2D ``('data', 'tile')``) are not provided.
- A torch ``TrainState`` holds a ``torch.Generator``, which cannot be stacked,
  so a batch of states is a list, one per image, not a state with a leading
  batch axis. ``batch_train_chunk`` and ``batch_train_chunk_dp`` are one
  eager loop over the rank's images (a single chunk gains nothing from a
  graph's capture): the JAX package's vmapped chunk and shard_map
  chunk are two programs of one function (its tests hold them equal), and so
  ``fit_batch`` needs no fallback for a batch the mesh does not divide: the
  ranks take blocks that differ by one image.
- The collectives: an all-gather whose backward returns this rank's slice
  (``torch.distributed.nn``'s all_gather sums the gathered gradient over the
  ranks, which every rank's full-image loss would make ``world_size`` times
  too large), and an identity on the replicated parameters whose backward
  sums their gradients over the ranks. NCCL for tensors on the card, gloo for
  tensors on the CPU: the backend is the group's, and the state's device
  must be the one the group's backend serves.
- The local raster is the port's ``'xla'`` tiled raster over the shard's
  tile rows (``core/render_tiled.rasterize_tiles``: the kernels' fused
  multiply-add chain for sigma, tiles in batches that bound memory) with
  the JAX package's hand-written VJP as its backward, where the JAX function
  differentiates its blend with autodiff under the same gradient
  conventions (the JAX package holds the two equal); so a world of one
  renders and differentiates exactly as the unsharded ``'xla'`` path does.
- The render always counts the candidates its ``'hier'`` binner drops
  (``render_fn.super_overflow()``, summed over the ranks), and
  ``fit_image_tile_sharded`` warns when a fit dropped any. The JAX
  functions' ``check_overflow`` option (off by default: a psum and a print
  at every render) is not provided.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.binning import bin_gaussian_rows, bin_gaussian_rows_hier
from ..core.gaussian2d import tile_bounds_for
from ..core.precision import resolve_device
from ..core.render_tiled import _image_to_tiles, _tiles_to_image, rasterize_tiles
from ..models.gaussian_image import (GaussianConfig, GaussianParams, GaussianState, _clip01,
                                     colors_of, project)
from ..train.trainer import (ChunkRunner, TrainConfig, TrainState, _grow_ts, _train_chunk,
                             captures, fit_image, init_train_state)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One named axis over the ranks of ``group`` (``None``: the default
    group, or a world of one where no group is initialised)."""

    axis_names: Tuple[str, ...] = ("data",)
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group) if dist.is_initialized() else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if dist.is_initialized() else 0

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return {self.axis_names[0]: self.size}


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data",), group=None) -> Mesh:
    """A one-axis mesh over the ranks of ``group`` (default: the initialised
    world, else a world of one). ``shape``, when given, must be
    ``(world size,)``."""
    if len(axis_names) != 1:
        raise ValueError(f"the port's meshes have one axis, not {axis_names}")
    mesh = Mesh(axis_names=tuple(axis_names), group=group)
    if shape is not None and tuple(shape) != (mesh.size,):
        raise ValueError(f"mesh shape {tuple(shape)} does not match the {mesh.size} ranks "
                         f"of the process group (one process per device)")
    return mesh


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no axis {axis!r}")


def _block(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of ``n`` items: equal blocks when the
    ranks divide ``n``, else the first ``n % size`` ranks take one more."""
    q, r = divmod(n, mesh.size)
    lo = mesh.rank * q + min(mesh.rank, r)
    return slice(lo, lo + q + (mesh.rank < r))


# --------------------------------------------------------------------------
# Data parallelism over images
# --------------------------------------------------------------------------

def init_batch_train_state(cfg: GaussianConfig, tcfg: TrainConfig, num_points: int,
                           batch: int, seed: int = 3047, device=None) -> List[TrainState]:
    """One fresh ``TrainState`` per image, image ``i`` seeded ``seed + i``."""
    return [init_train_state(cfg, tcfg, num_points, seed + i, device=device)
            for i in range(batch)]


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's contiguous block of a leading-batch list or tensor (the
    shard ``P(axis)`` places on it)."""
    _check_axis(mesh, axis)
    return batch[_block(len(batch), mesh)]


def _block_chunk(gts, cfg: GaussianConfig, tcfg: TrainConfig, n_steps: int, do_prune: bool):
    """``fn(carry) -> (carry, outs)``: one chunk up to its growth (the
    re-sort, ``n_steps`` steps, the prune) for every image of a block, one
    after another. The carry holds one ``(ts, last pre-update render)`` pair
    an image; ``outs`` are ``loss`` and ``psnr`` [B, n_steps] and
    ``n_pruned`` [B]."""

    def fn(carry):
        new, ms = [], []
        for (ts, _), gt in zip(carry, gts, strict=True):
            ts, m, img = _train_chunk(ts, gt, cfg, tcfg, n_steps, do_prune)
            new.append((ts, img))
            ms.append(m)
        return tuple(new), tuple(torch.stack([m[k] for m in ms])
                                 for k in ("loss", "psnr", "n_pruned"))

    return fn


def _grow_block(carry, gts, cfg: GaussianConfig, tcfg: TrainConfig, do_grow: bool,
                final_fill: bool, grow_draws=None):
    """Each image's growth on its last render, eagerly and image by image,
    with its own generator or ``grow_draws[i]``: (states, ``n_added`` [B])."""
    tss, n_added = [], []
    for i, ((ts, img), gt) in enumerate(zip(carry, gts, strict=True)):
        n = torch.zeros((), dtype=torch.int32, device=img.device)
        if do_grow:
            ts, n = _grow_ts(ts, gt, cfg, tcfg, img, final_fill,
                             grow_draws[i] if grow_draws is not None else None)
        tss.append(ts)
        n_added.append(n)
    return tss, torch.stack(n_added)


def _block_carry(tss, cfg: GaussianConfig):
    return tuple((ts, torch.zeros((cfg.H, cfg.W, 3), device=ts.gaussians.active.device))
                 for ts in tss)


def batch_train_chunk(tss: Sequence[TrainState], gts, cfg: GaussianConfig, tcfg: TrainConfig,
                      n_steps: int, do_prune: bool, do_grow: bool, final_fill: bool = False,
                      grow_draws: Optional[Sequence[torch.Tensor]] = None):
    """``train_chunk`` over each (state, image) pair, eagerly: every image's
    steps and prune, then every image's growth. ``grow_draws``: one growth's
    draws per image. Returns (states, metrics stacked over the images:
    ``loss`` and ``psnr`` [B, n_steps], ``n_pruned`` and ``n_added`` [B])."""
    if not tss:
        return [], {}
    carry, (loss, psnr, n_pruned) = _block_chunk(gts, cfg, tcfg, n_steps, do_prune)(
        _block_carry(tss, cfg))
    tss, n_added = _grow_block(carry, gts, cfg, tcfg, do_grow, final_fill, grow_draws)
    return tss, {"loss": loss, "psnr": psnr, "n_pruned": n_pruned, "n_added": n_added}


def batch_train_chunk_dp(tss: Sequence[TrainState], gts, cfg: GaussianConfig,
                         tcfg: TrainConfig, n_steps: int, do_prune: bool, do_grow: bool,
                         final_fill: bool, mesh: Mesh, axis: str = "data",
                         grow_draws: Optional[Sequence[torch.Tensor]] = None):
    """The data-parallel chunk: each rank passes its block (``shard_batch``)
    and runs ``batch_train_chunk`` on it, with no communication."""
    _check_axis(mesh, axis)
    return batch_train_chunk(tss, gts, cfg, tcfg, n_steps, do_prune, do_grow, final_fill,
                             grow_draws)


def _chunk_schedule(tcfg: TrainConfig):
    """(iteration at the chunk's end, do_grow, final_fill) of each chunk of
    ``prune_iter`` steps, as ``fit_image`` and the JAX ``fit_batch`` run them."""
    chunk = tcfg.prune_iter
    for ci in range(tcfg.iterations // chunk):
        it_end = (ci + 1) * chunk
        do_grow = (tcfg.adaptive_add and it_end % tcfg.grow_iter == 0
                   and it_end < tcfg.iterations)
        yield it_end, do_grow, it_end == tcfg.iterations - tcfg.grow_iter


def _fit_local(tss, gts, cfg, tcfg, progress, grow_draws):
    """The chunk schedule over this rank's states and images: each chunk of
    the whole block is one ``ChunkRunner`` call, on the card (where
    ``captures``) a replay of one ``ChunkGraph`` over the block, the JAX
    package's one dispatch per chunk; the growths follow it eagerly."""
    if not tss:                     # a rank with no image of the batch
        for it_end, _, _ in _chunk_schedule(tcfg):
            if progress is not None:
                progress(it_end, {})
        return list(tss)
    draws = [iter(d) for d in grow_draws] if grow_draws is not None else None
    graph = captures(cfg, tss[0].gaussians.active.device)
    runner = ChunkRunner(_block_chunk([gt.clone() for gt in gts] if graph else gts, cfg, tcfg,
                                      tcfg.prune_iter, tcfg.prune), graph)
    carry = _block_carry(tss, cfg)
    for it_end, do_grow, final_fill in _chunk_schedule(tcfg):
        dr = [next(d) for d in draws] if (do_grow and draws is not None) else None
        carry, (loss, psnr, n_pruned) = runner.run(carry, 1)
        tss, n_added = _grow_block(carry, gts, cfg, tcfg, do_grow, final_fill, dr)
        carry = tuple((ts, img) for ts, (_, img) in zip(tss, carry))
        if progress is not None:
            progress(it_end, {"loss": loss[0], "psnr": psnr[0], "n_pruned": n_pruned[0],
                              "n_added": n_added})
    return tss


def _map_tensors(obj, f):
    if isinstance(obj, torch.Tensor):
        return f(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(x, f) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(x, f) for x in obj)
    return obj


def _gather_states(local: List[TrainState], mesh: Mesh, device) -> List[TrainState]:
    """Every rank's states, in rank order, on every rank: this rank's own
    objects and copies of the others' on ``device``. A generator crosses as
    its state, onto a device of the type it was made on."""
    if mesh.size == 1:
        return list(local)
    mine = [(_map_tensors(ts._replace(generator=None), lambda t: t.cpu()),
             None if ts.generator is None else (ts.generator.device.type,
                                                ts.generator.get_state()))
            for ts in local]
    parts: list = [None] * mesh.size
    dist.all_gather_object(parts, mine, group=mesh.group)
    dev = torch.device(device)
    out = []
    for r, part in enumerate(parts):
        if r == mesh.rank:
            out.extend(local)
            continue
        for ts, gen_state in part:
            gen = None
            if gen_state is not None and gen_state[0] == dev.type:
                gen = torch.Generator(device=dev)
                gen.set_state(gen_state[1])
            out.append(_map_tensors(ts, lambda t: t.to(dev))._replace(generator=gen))
    return out


def fit_batch(images, cfg: GaussianConfig, tcfg: TrainConfig, num_points: int,
              mesh: Optional[Mesh] = None, seed: int = 3047, progress=None,
              axis: str = "data", device=None, states: Optional[Sequence[TrainState]] = None,
              grow_draws=None) -> List[TrainState]:
    """Fit a batch of same-shaped images [B, H, W, 3], one Gaussian set each,
    with the reference's chunk schedule (a prune every ``prune_iter``, the
    growth, the final fill); returns every image's final ``TrainState``, in
    batch order, on every rank. Replaces the reference's sequential dataset
    loop (train.py:294-308).

    With ``mesh`` each rank fits its block of the batch (every rank passes
    the whole batch); without one this process fits them all. Image ``i``
    starts from ``init_train_state`` seeded ``seed + i`` on ``device`` (the
    card unless ``device='cpu'``), or from ``states[i]``; ``grow_draws[i]``
    (one [M, 3] tensor per growth) replaces image ``i``'s growth draws, so
    that a fit can start from the JAX package's states and draws."""
    dev = states[0].gaussians.active.device if states is not None else resolve_device(device)
    idx = shard_batch(range(len(images)), mesh, axis) if mesh is not None else range(len(images))
    gts = [torch.as_tensor(np.asarray(images[i]) if not isinstance(images[i], torch.Tensor)
                           else images[i], dtype=torch.float32).to(dev) for i in idx]
    tss = ([states[i] for i in idx] if states is not None else
           [init_train_state(cfg, tcfg, num_points, seed + i, device=dev) for i in idx])
    draws = [grow_draws[i] for i in idx] if grow_draws is not None else None
    local = _fit_local(tss, gts, cfg, tcfg, progress, draws)
    return _gather_states(local, mesh, dev) if mesh is not None else local


def replica_spread(tensors: Sequence[torch.Tensor], mesh: Mesh) -> float:
    """Largest spread (max - min over the ranks) of the float64 sums of
    ``tensors``: 0 when every rank holds the same values, as the replicated
    parameters of a tile-sharded fit must."""
    sums = torch.stack([t.detach().double().sum() for t in tensors])
    if not dist.is_initialized():
        return 0.0
    hi, lo = sums.clone(), sums.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    return float((hi - lo).max())


# --------------------------------------------------------------------------
# Tile-grid sharding for one large image
# --------------------------------------------------------------------------

def _raster_tiles_local(xys, conics, colors, opacity, ids, mask, tile_start: int,
                        cfg: GaussianConfig) -> torch.Tensor:
    """Rasterize the flat tile rows ``[tile_start, tile_start + len(ids))`` ->
    [Tl, P, 3], unclamped, with the gradient conventions of
    ``rasterize_tiles``."""
    tile_idx = tile_start + torch.arange(ids.shape[0], device=xys.device)
    tb_x, _ = tile_bounds_for(cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    return rasterize_tiles(xys, conics, colors, opacity, ids, mask, tile_idx, tb_x,
                           cfg.block_h, cfg.block_w)


def image_to_tile_rows(gt: torch.Tensor, cfg: GaussianConfig) -> torch.Tensor:
    """[H, W, 3] -> [T, P, 3] in the binning's y-major tile order."""
    tb_x, tb_y = tile_bounds_for(cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    return _image_to_tiles(gt, tb_x, tb_y, cfg.block_h, cfg.block_w)


class _GatherTiles(torch.autograd.Function):
    """All-gather of each rank's tiles along dim 0; backward: this rank's
    slice of the gathered cotangent."""

    @staticmethod
    def forward(ctx, tiles, mesh):
        ctx.mesh, ctx.n = mesh, tiles.shape[0]
        parts = [torch.empty_like(tiles) for _ in range(mesh.size)]
        dist.all_gather(parts, tiles.contiguous(), group=mesh.group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.rank * ctx.n
        return g[lo:lo + ctx.n], None


class _Replicated(torch.autograd.Function):
    """Identity on replicated parameters; backward: their gradients summed
    over the ranks (each rank's covers its own tiles)."""

    @staticmethod
    def forward(ctx, mesh, *params):
        ctx.mesh = mesh
        return tuple(p.clone() for p in params)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.mesh.group)
        return (None, *(x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]),
                                                       grads)))


def make_tile_sharded_render(mesh: Mesh, cfg: GaussianConfig, axis: str = "tile",
                             super_cap: int = 0):
    """``render_fn(state, cfg) -> [H, W, 3]`` with the tile grid sharded over
    the ranks of ``mesh``: every rank projects (replicated), bins only its
    own ``ceil(T / ranks)`` tile rows (``bin_gaussian_rows``, or
    ``bin_gaussian_rows_hier`` when ``cfg.bin_method`` is ``'hier'``, or
    ``'auto'`` past 32M membership entries a rank), rasterizes them and
    all-gathers the tiles. The image is cropped from the tiles before any
    loss sees it, so any H and W match the unsharded render. Plug it into
    ``train_step`` / ``train_chunk`` / ``fit_image`` as ``render_fn``; every
    rank then runs the same steps and must be given the same state.

    ``super_cap``: the hier binner's band budget (0: ``max(4 cap, 512)``).
    A band with more candidates drops the rest, and the render then differs
    from exact binning: ``render_fn.super_overflow()`` returns the
    candidates dropped over every render so far, summed over the ranks (a
    collective: every rank calls it)."""
    _check_axis(mesh, axis)
    tb_x, tb_y = tile_bounds_for(cfg.H, cfg.W, cfg.block_h, cfg.block_w)
    T = tb_x * tb_y
    n_local = -(-T // mesh.size)
    start = mesh.rank * n_local
    use_hier = (cfg.bin_method == "hier"
                or (cfg.bin_method == "auto" and n_local * cfg.max_num_points > 32_000_000))
    # the Pallas binner (kernel E) has no row-range form: flat top_k instead
    bin_method = "top_k" if cfg.bin_method in ("pallas", "hier", "auto") else cfg.bin_method
    shared = dist.is_initialized()          # a group of one runs its collectives too
    dropped: list = [0]                     # this rank's overflow, summed on the device

    def render_fn(state: GaussianState, _cfg: GaussianConfig) -> torch.Tensor:
        params = GaussianParams(*_Replicated.apply(mesh, *state.params)) if shared else state.params
        proj = project(params, state.active, state.bound, cfg)
        if use_hier:
            bins = bin_gaussian_rows_hier(proj, cfg.H, cfg.W, start, n_local, cap=cfg.tile_cap,
                                          block_h=cfg.block_h, block_w=cfg.block_w,
                                          super_cap=super_cap)
            dropped[0] = dropped[0] + bins.super_overflow.to(torch.int64)
        else:
            bins = bin_gaussian_rows(proj, cfg.H, cfg.W, start, n_local, cap=cfg.tile_cap,
                                     block_h=cfg.block_h, block_w=cfg.block_w, method=bin_method)
        colors = colors_of(params, cfg)
        opacity = torch.ones((cfg.max_num_points,), dtype=proj.xys.dtype, device=proj.xys.device)
        tiles = _raster_tiles_local(proj.xys, proj.conics, colors, opacity, bins.ids, bins.mask,
                                    start, cfg)
        if shared:
            tiles = _GatherTiles.apply(tiles, mesh)
        img = _tiles_to_image(tiles[:T], cfg.H, cfg.W, tb_x, tb_y, cfg.block_h, cfg.block_w)
        return _clip01(img)

    def super_overflow() -> int:
        # every rank renders in lockstep, so all hold a tensor or none does
        if not isinstance(dropped[0], torch.Tensor):
            return 0
        total = dropped[0].clone()
        if shared:
            dist.all_reduce(total, group=mesh.group)
        return int(total)

    render_fn.super_overflow = super_overflow
    return render_fn


def fit_image_tile_sharded(gt, cfg: GaussianConfig, tcfg: TrainConfig, num_points: int,
                           mesh: Optional[Mesh] = None, axis: str = "tile", super_cap: int = 0,
                           **kwargs):
    """``train.fit_image`` with the render sharded over the ranks of ``mesh``
    (default: the initialised world, else a world of one): the scale-out path
    for 2K-and-larger images. Every rank calls it with the same arguments;
    the whole trainer (losses, growth, pruning, the best snapshot,
    checkpoints) runs unchanged on top, in lockstep.

    At 2K and above ``'auto'`` bins with ``'hier'``, whose default band
    budget is too small there (it dropped 3994 candidates at the default on
    a 2040x1344, 20,000-Gaussian state, none at 4096): pass ``super_cap``
    4096 or more. A fit that dropped any candidate warns at its end, on
    every rank, with the count summed over the ranks."""
    if mesh is None:
        mesh = make_mesh(axis_names=(axis,))
    render_fn = make_tile_sharded_render(mesh, cfg, axis, super_cap=super_cap)
    res = fit_image(gt, cfg, tcfg, num_points, render_fn=render_fn, **kwargs)
    n = render_fn.super_overflow()
    if n:
        warnings.warn(f"the 'hier' binner dropped {n} candidates over the fit, summed over the "
                      f"ranks: the sharded render diverged from exact binning; raise super_cap "
                      f"(now {super_cap or max(4 * cfg.tile_cap, 512)})", stacklevel=2)
    return res
