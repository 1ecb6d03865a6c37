"""A cell as BENCHMARK.json names it, and what every kind of traffic shares.

Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by name:

- ``portbench/configs/<config>.json``: the configuration (named in
  BENCHMARK.json's ``configs``, ``file``);
- ``portbench/traffic/<traffic>.json``: the traffic mix, parameters only; its
  ``kind`` names the generator, ``portbench/kinds/<kind>.py``;
- ``portbench/metrics/<metric>.py``: one per-layer metric, ``read(trace)``.

Nothing here imports the program: the kinds do, at set-up.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    bench: dict
    root: Path

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metrics(self, section: str) -> List[dict]:
        """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
        this cell reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench_path: Optional[Path] = None) -> Cell:
    bench_path = Path(bench_path) if bench_path else ROOT / "BENCHMARK.json"
    root = bench_path.resolve().parent
    bench = json.loads(bench_path.read_text())
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(w["name"], w, config, traffic, bench, root)


def kind(cell: Cell):
    """The generator module of the cell's traffic kind."""
    return load_module(cell.root / "portbench" / "kinds" / f"{cell.traffic['kind']}.py",
                       f"portbench_kind_{cell.traffic['kind']}")


def metric_reader(cell: Cell, name: str):
    return load_module(cell.root / "portbench" / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


def fixture_files(cell: Cell, spec: dict) -> List[Path]:
    """The files of a fixture glob, in name order, checked against its
    ``sha256`` (of the names and bytes together) when it gives one, so that
    the yardstick's inputs cannot change under it."""
    pattern = Path(spec["glob"])
    base = pattern.parent if pattern.is_absolute() else cell.root / pattern.parent
    files = sorted(base.glob(pattern.name))
    if not files:
        raise FileNotFoundError(f"no fixture matches {pattern}")
    if "sha256" in spec:
        h = hashlib.sha256()
        for f in files:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        if h.hexdigest() != spec["sha256"]:
            raise ValueError(f"fixtures {pattern} changed (sha256 {h.hexdigest()})")
    return files


def split_fields(config: dict, cls) -> Dict[str, object]:
    """The configuration's keys that are fields of dataclass ``cls``."""
    import dataclasses

    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in config.items() if k in names}
