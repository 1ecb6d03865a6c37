"""The harness is driven by data: a configuration, a traffic mix, a traffic
kind and a per-layer metric are added as files and BENCHMARK.json entries,
with no edit to a file that is there; and BENCHMARK.json keeps the
contract's names, units and shapes."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

ECHO_KIND = '''
import time


class Traffic:
    def __init__(self, cell, seed, device):
        self.cell, self.seed = cell, seed

    def window(self, seconds, tracer=None):
        t0 = time.perf_counter()
        time.sleep(0.01)
        return {"train_ms_per_step": (time.perf_counter() - t0) * 1e3, "attempted": 1,
                "failed": 0}

    def check(self):
        return [("echo_gap", 0.0, self.cell.config["limits"]["loss_gap"])]
'''

METRIC = '''
def read(trace):
    return float(trace["jobs"])
'''


def test_new_files_resolve_without_edits(checkout, run_cell):
    root = checkout.parent
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    bench = json.loads(checkout.read_text())
    conf = json.loads((root / "portbench/configs/tiny.json").read_text())
    conf["name"] = "tiny2"
    (root / "portbench/configs/tiny2.json").write_text(json.dumps(conf))
    (root / "portbench/traffic/fit-tiny2.json").write_text(
        json.dumps({"kind": "fit", "jobs_drawn": 2, "steady_chunks": 1}))
    (root / "portbench/traffic/echo.json").write_text(json.dumps({"kind": "echo"}))
    (root / "portbench/kinds/echo.py").write_text(ECHO_KIND)
    (root / "portbench/metrics/jobs_seen.train.py").write_text(METRIC)
    bench["configs"].append({"name": "tiny2", "source": "https://example.org/tiny2",
                             "file": "portbench/configs/tiny2.json", "reduced": [],
                             "why": "added by a test"})
    bench["workloads"] += [{"name": "tiny2-fit", "config": "tiny2", "traffic": "fit-tiny2",
                            "chips": 1, "why": "added by a test"},
                           {"name": "tiny2-echo", "config": "tiny2", "traffic": "echo",
                            "chips": 1, "why": "added by a test"}]
    for m in bench["end_to_end"]:
        if m["name"] == "train_ms_per_step":
            m["workloads"] += ["tiny2-fit", "tiny2-echo"]
    bench["per_layer"].append({"name": "jobs_seen.train", "unit": "jobs", "better": "higher",
                               "source": "program_counter", "layer": "fused dispatch",
                               "moves": "train_ms_per_step", "workloads": ["tiny2-fit"]})
    new_bench = root / "BENCHMARK2.json"
    new_bench.write_text(json.dumps(bench))
    try:
        res = run_cell(new_bench, "tiny2-fit", trace=True)
        assert res["metrics"]["jobs_seen.train"]["value"] >= 1
        assert res["correct"] is True
        echo = run_cell(new_bench, "tiny2-echo")
        assert echo["correct"] is True and "train_ms_per_step" in echo["metrics"]
        assert list(echo["checks"]) == ["echo_gap"]
        for p, data in before.items():
            assert p.read_bytes() == data, f"{p} was edited"
    finally:
        for p in ("configs/tiny2.json", "traffic/fit-tiny2.json", "traffic/echo.json",
                  "kinds/echo.py", "metrics/jobs_seen.train.py"):
            (root / "portbench" / p).unlink()
        new_bench.unlink()


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1] == "portbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["file"] not in files
        files.add(c["file"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in conf["published"] and conf[k] != conf["published"][k]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in b["configs"]}
        assert NAME.match(w["traffic"])
        assert (ROOT / "portbench/traffic" / f"{w['traffic']}.json").is_file()
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= cells
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and (ROOT / "portbench/metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reported = [m for m in b["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024
