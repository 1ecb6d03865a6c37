"""Multi-process runtime: process-group start-up and the cross-process
batched fit.

Port of ``gaussianimage_plus_tpu/parallel/multihost.py``: ``initialize``
(``:29-39``), ``global_mesh`` (``:42-43``), ``shard_global_batch``
(``:46-50``) and ``fit_global_batch`` (``:53-95``). Every rank of a
``torchrun`` launch (one process per device, on one host or many) calls::

    from gaussianimage_plus_tpu_torch.parallel import multihost
    multihost.initialize()                  # init_process_group from torchrun's variables
    tss = multihost.fit_global_batch(my_images, cfg, tcfg, num_points)

Deviation: JAX assembles one global array from each process's local images
(``make_array_from_process_local_data``); here each rank keeps its own block
and the blocks are the global batch in rank order. ``fit_global_batch``
returns every image's state on every rank, as ``sharded.fit_batch`` does.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.precision import resolve_device
from ..models.gaussian_image import GaussianConfig
from ..train.trainer import TrainConfig, init_train_state
from .sharded import Mesh, _fit_local, _gather_states, make_mesh


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """``init_process_group`` with ``torchrun``'s environment as defaults
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``,
    or ``coordinator_address`` as ``host:port``); a no-op when a group is
    already initialised or the run is a single process. The backend follows
    ``device`` (the card unless ``device='cpu'``): NCCL on the card, with
    ``LOCAL_RANK``'s card made current, gloo on the CPU."""
    if dist.is_initialized():
        return
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    kw = {"timeout": timeout} if timeout is not None else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank, **kw)


def global_mesh(axis: str = "data") -> Mesh:
    """The mesh over every rank of the initialised world (one when none is)."""
    return make_mesh(axis_names=(axis,))


def shard_global_batch(local_images, mesh: Mesh, axis: str = "data", device=None) -> torch.Tensor:
    """This rank's images [n, H, W, 3] as a tensor on ``device``: its block of
    the global batch, which has ``n`` images on every rank (checked)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no axis {axis!r}")
    dev = resolve_device(device)
    images = torch.as_tensor(np.asarray(local_images) if not isinstance(local_images, torch.Tensor)
                             else local_images, dtype=torch.float32).to(dev)
    if mesh.size > 1:
        counts = [torch.zeros((1,), dtype=torch.int64, device=dev) for _ in range(mesh.size)]
        dist.all_gather(counts, torch.tensor([images.shape[0]], device=dev), group=mesh.group)
        sizes = [int(c) for c in counts]
        if len(set(sizes)) != 1:
            raise ValueError(f"every rank must pass the same number of images; got {sizes}")
    return images


def fit_global_batch(local_images, cfg: GaussianConfig, tcfg: TrainConfig, num_points: int,
                     seed: int = 3047, progress=None, axis: str = "data", device=None):
    """``sharded.fit_batch`` with each rank passing only its own images: the
    global batch is the ranks' blocks in rank order, image ``i`` of it seeded
    ``seed + i``. Returns every image's ``TrainState`` on every rank."""
    mesh = global_mesh(axis)
    images = shard_global_batch(local_images, mesh, axis, device)
    dev = images.device
    first = mesh.rank * images.shape[0]
    tss = [init_train_state(cfg, tcfg, num_points, seed + first + i, device=dev)
           for i in range(images.shape[0])]
    local = _fit_local(tss, list(images), cfg, tcfg, progress, None)
    return _gather_states(local, mesh, dev)
