"""Kernel F (``kernels/raster_list.chunk_lists``, ``csrc/chunk_lists.cu``) as
far as the CPU can check it, and the metric that says it engages.

- ``list_kernel.train`` (``portbench/metrics``) reads 100 from a steady
  chunk whose ``lists.kernel_tiles`` equals ``lists.tiles``, the share where
  fewer tiles went through the kernel, and None without the counter or
  without a steady segment's eager chunk.
- On the CPU ``chunk_lists`` is its plain version: the enumeration's ATen
  operations alone, lists equal to ``_lists_and_members``, no
  ``lists.kernel_tiles`` counted and no launch; it refuses what the kernel
  does not take.
- Kernel F's ``__global__`` names hold none of ``portbench/kernels.json``'s
  kernel names, which the benchmark matches by substring.
- Each kernel's C entry point takes what its wrapper's ctypes argtypes
  declare, in order: no compiler checks that off the card.

The card compares the kernel itself with the plain version
(``tests/test_torch_kernels_cuda.py``, ``-m cuda``).
"""

import ctypes
import json
import re
import types
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gaussianimage_plus_tpu_torch.kernels import (binning_tiles, raster_binned, raster_list,
                                                  wrappers)
from gaussianimage_plus_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "gaussianimage_plus_tpu_torch" / "csrc"


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


# ---- the metric -------------------------------------------------------------

def _reader():
    from portbench.cell import load_module

    return load_module(ROOT / "portbench" / "metrics" / "list_kernel.train.py",
                       "test_metric_list_kernel_train")


def _span(name, id, parent, start_s):
    return types.SimpleNamespace(name=name, id=id, parent=parent, root=parent or id,
                                 start_ns=round(start_s * 1e9), end_ns=round(start_s * 1e9) + 1)


SPANS = [_span("fit", 10, 0, 30.0), _span("fit.warm_chunk", 11, 10, 30.1),
         _span("fit.warm_chunk", 20, 0, 40.0), _span("fit.warm_chunk", 30, 0, 50.0)]
LISTS = {"lists.tiles": 1075200, "lists.overflow_tiles": 0, "lists.member_chunks": 2053632,
         "lists.visited_chunks": 2053632}


def _program(counts):
    """A stand-in for the port's ``utils.profiling`` holding these spans and
    device counters (by root)."""
    return types.SimpleNamespace(spans=lambda: list(SPANS), counters=lambda: {},
                                 dropped=lambda: 0,
                                 device_counters=lambda root=None: dict(counts.get(root, {})))


@pytest.mark.parametrize("counts, want", [
    ({30: {**LISTS, "lists.kernel_tiles": 1075200}}, 100.0),
    ({30: {**LISTS, "lists.kernel_tiles": 268800}, 20: {**LISTS, "lists.kernel_tiles": 0}}, 25.0),
    ({30: LISTS, 10: {**LISTS, "lists.kernel_tiles": 1075200}}, None),   # no kernel ran there
    ({10: {**LISTS, "lists.kernel_tiles": 1075200}}, None),              # the profiled job only
], ids=["every tile", "a quarter", "plain path", "no steady chunk counts"])
def test_list_kernel_reader(monkeypatch, counts, want):
    from gaussianimage_plus_tpu_torch import utils

    monkeypatch.setattr(utils, "profiling", _program(counts), raising=False)
    got = _reader().read({"steady": {"steps": 300}})
    assert got == (pytest.approx(want, rel=1e-12) if want is not None else None)
    assert _reader().read({"jobs": 5}) is None                          # no steady segment


# ---- the wrapper on the CPU -----------------------------------------------------

def _random_table(tb_x=8, tb_y=6, nch=12, kc=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    Np = nch * kc
    x0 = torch.rand((Np,), generator=g) * (tb_x + 4) - 2
    y0 = torch.rand((Np,), generator=g) * (tb_y + 4) - 2
    w = torch.rand((Np, 2), generator=g) * 4
    bbox = torch.stack([x0, x0 + w[:, 0], y0, y0 + w[:, 1]], -1).contiguous()
    table = torch.zeros((Np, raster_list.COLS))
    table[:, raster_list.COLS - 1] = (torch.rand((Np,), generator=g) > 0.1).float()
    return table, bbox, Np, kc, 16 * tb_y, 16 * tb_x


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("lmax", [1, 4, 16])
def test_cpu_takes_the_plain_enumeration(lmax):
    table, bbox, Np, kc, H, W = _random_table()
    with _Ops() as plain:
        want = raster_list._lists_and_members(
            raster_list._bbox_members(table, bbox, W // 16, (W // 16) * (H // 16)), Np, kc, lmax)
    before = [k.launches for k in wrappers()]
    with profiling.recording(), _Ops() as ops:
        got = raster_list.chunk_lists(table, bbox, Np, kc, lmax, H, W)
    assert ops.ops == plain.ops
    assert [k.launches for k in wrappers()] == before
    assert "lists.kernel_tiles" not in profiling.device_counters()
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(a, b)
    (lst, cnt, lo2, hi2), members = got
    assert lst.shape == ((W // 16) * (H // 16), lmax)
    if lmax == 1:
        assert bool((hi2 > lo2).any()) and bool((members > cnt).any())


def test_member_lists_counts_no_kernel_tiles_on_the_cpu():
    table, bbox, Np, kc, H, W = _random_table()
    with profiling.recording():
        raster_list.member_lists(table, bbox, Np - 1, Np, kc, H, W, lmax=4)
    got = profiling.device_counters()
    assert got["lists.tiles"] == (W // 16) * (H // 16) and "lists.kernel_tiles" not in got


@pytest.mark.parametrize("bad", ["kc", "Np", "rows", "lmax", "bbox", "dtype", "device"])
def test_chunk_lists_refuses_bad_inputs(bad):
    table, bbox, Np, kc, H, W = _random_table()
    args = dict(table=table, bbox=bbox, Np=Np, kc=kc, lmax=4, H=H, W=W)
    err = ValueError
    if bad == "kc":
        args["kc"] = 0
    elif bad == "Np":
        args["Np"] = Np + 1
    elif bad == "rows":
        args["Np"] = Np - kc
    elif bad == "lmax":
        args["lmax"] = -1
    elif bad == "bbox":
        args["bbox"] = bbox[:, :3]
    elif bad == "dtype":
        args["table"], err = table.double(), TypeError
    else:
        args["bbox"] = bbox.to("meta")
    with pytest.raises(err):
        raster_list.chunk_lists(**args)


# ---- the kernel's source ---------------------------------------------------------

def _globals(src: str) -> list:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", src)


def test_kernel_f_names_are_not_the_benchmarks_kernels():
    names = [n for k in json.loads((ROOT / "portbench" / "kernels.json").read_text()).values()
             for n in k["names"]]
    mine = _globals((CSRC / "chunk_lists.cu").read_text())
    assert mine == ["chunk_mark_kernel", "chunk_compact_kernel"]
    assert not [(m, n) for m in mine for n in names if n in m]
    # the names the benchmark matches are the other kernels'
    assert all(any(n in g for f in CSRC.glob("*.cu") if f.name != "chunk_lists.cu"
                   for g in _globals(f.read_text())) for n in names)


SETUPS = {
    "tile_table_forward": raster_binned._setup,
    "tile_table_backward": raster_binned._setup_bwd,
    "chunk_list_forward": raster_list._setup,
    "chunk_backward": raster_list._setup_bwd,
    "tile_bin": binning_tiles._setup,
    "chunk_lists": raster_list._setup_lists,
}


@pytest.mark.parametrize("name", list(SETUPS))
def test_entry_point_matches_its_argtypes(name):
    src = (CSRC / f"{name}.cu").read_text()
    params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert all("*" in p or p.split()[0] == "int" for p in params), params
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace()})
    SETUPS[name](lib)
    fn = getattr(lib, name)
    assert fn.restype is ctypes.c_int and fn.argtypes == want
    assert sorted(SETUPS) == sorted(f.stem for f in CSRC.glob("*.cu"))
