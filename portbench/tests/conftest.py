"""A small checkout of the benchmark for CPU tests: the benchmark's files, a
BENCHMARK.json with a ``tiny`` configuration (64x96, 200 rows, 300 steps,
targets from three random states) and a ``tiny-decode`` cell over two
committed streams. Runs go through ``run.run_cell`` on the CPU, which skips
only the runner's look for a card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def make_checkout(dst: Path) -> Path:
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    rng = np.random.default_rng(0)
    H, W, M = 64, 96, 200
    states = dst / "states"
    states.mkdir()
    for k in range(3):
        cov = rng.random((M, 3)) * [20, 2, 20] - [0, 1, 0]
        np.savez(states / f"s{k}.npz", xyz=(rng.random((M, 2)) * [W, H]).astype(np.float32),
                 cov2d=cov.astype(np.float32),
                 features=(rng.random((M, 3)) * 0.5).astype(np.float32),
                 active=np.arange(M) < 180, bound=np.zeros((M, 3), np.float32),
                 num_active=np.int32(180), H=H, W=W)
    conf = json.loads((ROOT / "portbench/configs/kodak-768x512-n5000.json").read_text())
    conf.update(name="tiny", H=H, W=W, max_num_points=M, num_points=100, iterations=300,
                prune_iter=100, grow_iter=200)
    conf["targets"] = {"glob": str(states / "s*.npz")}
    conf["streams"] = [{"glob": str(ROOT / "results/bitstreams_r3/kodim0[12].gipb")},
                       {"glob": str(ROOT / "results/bitstreams_vq_r5/kodim01.gipb")}]
    (dst / "portbench/configs/tiny.json").write_text(json.dumps(conf))
    traffic = json.loads((ROOT / "portbench/traffic/decode-closed.json").read_text())
    traffic.update(sample=2, profiled_requests=2)
    (dst / "portbench/traffic/decode-tiny.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"] += [
        {"name": "tiny-fit", "config": "tiny", "traffic": "fit-closed", "chips": 1,
         "why": "CPU tests"},
        {"name": "tiny-decode", "config": "tiny", "traffic": "decode-tiny", "chips": 1,
         "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        for real, tiny in (("kodak-fit", "tiny-fit"), ("kodak-decode", "tiny-decode")):
            if real in m.get("workloads", ()):
                m["workloads"].append(tiny)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst / "BENCHMARK.json"


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(bench: Path, workload: str, seed: int = 2 ** 31 + 12345, seconds: float = 0.5,
        trace: bool = False) -> dict:
    import time

    from portbench import run as runner
    from portbench.cell import load_cell

    cell = load_cell(workload, bench)
    return runner.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())


@pytest.fixture
def run_cell():
    return run
