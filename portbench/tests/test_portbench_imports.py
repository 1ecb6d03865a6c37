"""The runner, every traffic kind and metric reader, and the reference load
neither JAX nor the JAX package; the reference loads nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "gaussianimage_plus_tpu"}

LOAD_ALL = """
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import portbench.run, portbench.control, portbench.readers
from portbench.cell import load_module
for f in sorted((root / "portbench/kinds").glob("*.py")):
    load_module(f, "kind_" + f.stem)
for f in sorted((root / "portbench/metrics").glob("*.py")):
    load_module(f, "metric_" + f.stem.replace(".", "_"))
"""

RUN_TINY = """
import torch, time
sys.path.insert(0, sys.argv[2])
import conftest
bench = conftest.make_checkout(Path(sys.argv[3]))
for w in ("tiny-fit", "tiny-decode"):
    conftest.run(bench, w, trace=w == "tiny-decode")
"""

TAIL = """
print(json.dumps(sorted({m.split(".")[0] for m in list(sys.modules)})))
"""


def _top_level(code: str, *args) -> set:
    out = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runner_kinds_and_metrics_load_no_jax():
    loaded = _top_level(LOAD_ALL + TAIL, str(ROOT))
    assert not loaded & FORBIDDEN
    assert "gaussianimage_plus_tpu_torch" not in loaded    # the kinds import the port at set-up


def test_runs_load_no_jax(tmp_path):
    loaded = _top_level(LOAD_ALL + RUN_TINY + TAIL, str(ROOT), str(Path(__file__).parent),
                        str(tmp_path))
    assert "gaussianimage_plus_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "portbench/reference").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"gaussianimage_plus_tpu_torch"}, \
                    f"{f.name} imports {n}"
    code = ("import json, sys; sys.path.insert(0, sys.argv[1])\n"
            "import portbench.reference.render, portbench.reference.train, "
            "portbench.reference.gipb, portbench.reference.counts\n" + TAIL)
    loaded = _top_level(code, str(ROOT))
    assert not loaded & (FORBIDDEN | {"gaussianimage_plus_tpu_torch"})
