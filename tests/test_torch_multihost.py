"""The port's ``parallel/multihost.py`` (on the CPU, gloo).

- ``initialize`` is a no-op in a single process (no ``WORLD_SIZE``, or a
  world of one) and inside an initialised group (the ranks below call it);
- ``global_mesh`` and ``shard_global_batch`` in a world of one;
- ``fit_global_batch`` in one process ``torch.equal`` to ``fit_batch`` of the
  same images, with the progress callback at each chunk end;
- ``fit_global_batch`` at 2 spawned gloo ranks, each passing its own 2 of 4
  images, ``torch.equal`` on both ranks to ``fit_batch`` in one process;
- a rank passing another number of images than the others is refused.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.parallel import multihost, sharded
from gaussianimage_plus_tpu_torch.train import trainer as ttr

from test_torch_dist_workers import run_ranks
from test_torch_parallel import assert_train_states_equal

CFG = tgi.GaussianConfig(H=32, W=64, max_num_points=64, tile_cap=32)
TCFG = ttr.TrainConfig(iterations=100, grow_iter=50, prune_iter=50, lr=0.02)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(n=4, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 32, 64, 3)).astype(np.float32)


def test_initialize_is_a_no_op_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize(device="cpu")
    multihost.initialize(num_processes=1, device="cpu")
    assert not dist.is_initialized()


def test_global_mesh_and_shard_global_batch():
    mesh = multihost.global_mesh()
    assert mesh.axis_names == ("data",) and mesh.size == 1 and mesh.rank == 0
    local = images(3)
    out = multihost.shard_global_batch(local, mesh, device="cpu")
    assert out.dtype == torch.float32 and np.array_equal(out.numpy(), local)
    with pytest.raises(ValueError, match="no axis"):
        multihost.shard_global_batch(local, mesh, axis="tile", device="cpu")


@pytest.fixture(scope="module")
def reference():
    """Four images and ``fit_batch`` of them in one process."""
    imgs = images(seed=3)
    return imgs, sharded.fit_batch(imgs, CFG, TCFG, 40, seed=1, device="cpu")


def test_fit_global_batch_matches_fit_batch_single_process(reference):
    imgs, ref = reference
    seen = []
    got = multihost.fit_global_batch(imgs, CFG, TCFG, 40, seed=1, device="cpu",
                                     progress=lambda it, m: seen.append(it))
    assert seen == [50, 100] and len(got) == 4
    for a, b in zip(got, ref):
        assert_train_states_equal(a, b)
    assert all(float(ts.best_psnr) > 5 for ts in ref)


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    return run_ranks("calls", 2, tmp_path_factory.mktemp("ranks"),
                     [("fit_global_batch", (reference[0], CFG, TCFG, 40)),
                      ("shard_uneven", ())])


def test_fit_global_batch_two_ranks(reference, two_ranks):
    for (tss, seen), _ in two_ranks:
        assert seen == [50, 100] and len(tss) == 4
        for a, b in zip(tss, reference[1]):
            assert_train_states_equal(a, b)


def test_uneven_local_batches_are_refused(two_ranks):
    for _, refused in two_ranks:
        assert "same number of images" in refused
