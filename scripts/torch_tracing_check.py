"""What the port's spans and counters (``utils/profiling.py``) cost on the card,
and how their times agree with the profiler's.

    python scripts/torch_tracing_check.py --seeds 11 12 13 --seconds 51 \\
        --out logs/tracing_check.json

- ``calls``: ``--calls`` spans, and as many counts, with recording off and
  inside ``recording()``: microseconds a call on this host.
- ``clock``: ``--frames`` decodes of the committed LSQ streams under
  ``torch.profiler``: for each span, the larger gap between its stored start
  and end and its profiler range's (paired by name in order of start), as
  the share within 50 us, the median and the largest; and the device-side
  events that carry a span's name (the profiler mirrors user-scoped ranges
  on the device's timeline; the spans' function-scoped ones should not be).
- ``windows``: the benchmark's ``kodak-decode`` and ``kodak-fit`` cells
  (``portbench/``), each seed's inputs set up once, then the cell's window
  run with recording off and with ``recording()`` on, in turns (off first
  on even seeds, on first on odd ones): each window's ``decode_fps`` or
  ``train_ms_per_step``, the spans it recorded, and the plain reference's
  check of both windows.

Prints one JSON line, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gaussianimage_plus_tpu_torch.utils import profiling  # noqa: E402

CELLS = {"kodak-decode": "decode_fps", "kodak-fit": "train_ms_per_step"}


def _per_call_us(fn, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def _one_span():
    with profiling.span("x"):
        pass


def call_costs(calls: int) -> dict:
    """Microseconds a ``span`` and a ``count``, recording off and on."""
    profiling.reset()
    out = {"calls": calls, "span_off_us": _per_call_us(_one_span, calls),
           "count_off_us": _per_call_us(lambda: profiling.count("x"), calls)}
    if profiling.spans() or profiling.counters():
        raise RuntimeError("recording was on")
    with profiling.recording():
        out["span_on_us"] = _per_call_us(_one_span, calls)
        out["count_on_us"] = _per_call_us(lambda: profiling.count("x"), calls)
    profiling.reset()
    return out


def clock(frames: int, device) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream

    bufs = [p.read_bytes() for p in sorted((ROOT / "results/bitstreams_r4").glob("*.gipb"))]
    for b in bufs:
        decode_bitstream(b, device=device)
    torch.cuda.synchronize(device)
    profiling.reset()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for i in range(frames):
        decode_bitstream(bufs[i % len(bufs)], device=device)
        torch.cuda.synchronize(device)
    prof.stop()
    spans = profiling.spans()
    names = {s.name for s in spans}
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in names]
    gaps = []
    for name in names:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e.name() == name
                         and e.device_type() == DeviceType.CPU), key=lambda e: e.start_ns())
        if len(mine) != len(theirs):
            raise RuntimeError(f"{len(mine)} spans {name} but {len(theirs)} profiler ranges")
        gaps += [max(abs(s.start_ns - e.start_ns()),
                     abs(s.end_ns - e.start_ns() - e.duration_ns())) / 1e3
                 for s, e in zip(mine, theirs)]
    profiling.reset()
    return {"frames": frames, "spans": len(gaps),
            "within_50us": sum(g <= 50 for g in gaps) / len(gaps),
            "median_us": statistics.median(gaps), "max_us": max(gaps),
            "on_device_timeline": sum(e.device_type() != DeviceType.CPU for e in events)}


def windows(name: str, seeds, seconds: float, device) -> list:
    from portbench import cell as CL

    cell = CL.load_cell(name)
    metric = CELLS[name]
    rows = []
    for i, seed in enumerate(seeds):
        traffic = CL.kind(cell).Traffic(cell, seed, device)
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            profiling.reset()
            with profiling.recording() if on else contextlib.nullcontext():
                v = traffic.window(seconds)
            rows.append({"cell": name, "seed": seed, "recording": on, metric: v[metric],
                         "attempted": v["attempted"], "spans": len(profiling.spans()),
                         "dropped": profiling.dropped()})
        checks = traffic.check()
        for r in rows[-2:]:
            r["correct"] = all(v <= limit for _, v, limit in checks)
    profiling.reset()
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--calls", type=int, default=100_000)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--cells", nargs="*", default=list(CELLS), choices=list(CELLS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tracing_check: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"card": card.strip(), "torch": torch.__version__, "calls": call_costs(args.calls),
           "clock": clock(args.frames, dev),
           "windows": [r for c in args.cells for r in windows(c, args.seeds, args.seconds, dev)]}
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
