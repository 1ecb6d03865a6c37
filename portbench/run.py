"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json ``workloads``) names a
configuration and a traffic mix; set-up makes every input from ``--seed``
and warms up the shapes the traffic uses; the window measures for
``--seconds``; then the plain reference checks what the window produced.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each compared number with
its limit; the same numbers end standard error.

It exits with an error, and prints no result, without as many CUDA cards as
the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gaussianimage_plus_tpu"})


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


T_START = time.perf_counter() - process_age()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def caches_in_checkout() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Set up, measure and check one run; returns the result line's object."""
    import torch

    from portbench import cell as CL
    from portbench import trace as T

    traffic = CL.kind(cell).Traffic(cell, seed, device)
    tracer = None
    if trace:
        tracer = T.Tracer(device)
        traffic.install(tracer)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    values = traffic.window(seconds, tracer)
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    values["setup_s"] = setup_s

    result = {"correct": None, "attempted": values["attempted"], "failed": values["failed"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    metrics = {}
    if tracer is None:
        for m in cell.metrics("end_to_end"):
            if m["name"] not in values:
                raise KeyError(f"the {cell.traffic['kind']} traffic does not measure {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        data = traffic.traced(tracer)
        tracer.restore()
        peaks = json.loads((ROOT / "portbench" / "peaks.json").read_text())
        data["peaks"] = peaks.get(dev["kind"])
        data["kernels"] = json.loads((ROOT / "portbench" / "kernels.json").read_text())
        for m in cell.metrics("per_layer"):
            v = CL.metric_reader(cell, m["name"]).read(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prof = traffic.device_window(tracer)
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown()
        del data, prof
    result["metrics"] = metrics
    result["device"] = dev
    checks = traffic.check()
    result["correct"] = all(v <= limit for _, v, limit in checks)
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    caches_in_checkout()
    import torch

    from portbench.cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
