"""The exact, sync-free selections of ``core/binning.select_members`` timed on the card.

Every method selects each row's first ``cap`` members in index order, the
JAX ``_select_members`` result; the choice is only one of speed. This
script records the membership matrices that the port's binning builds at
three states, checks every candidate against the reference there (ids, mask
and count equal), and times each:

- the odd-grid fit state: ``results/repr_states_plain/kodim01.npz`` on the
  752x496 crop's grid (47x31 = 1457 tiles, 5000 rows, cap 256), the
  ``'pallas'`` + ``'top_k'`` route that ``'auto'`` takes there;
- the 2K ``'hier'`` binner on ``results/repr_states_2k/mosaic2k.npz``
  (2040x1344, 20,000 rows): level 1 (176 super-tiles, ``super_cap`` 1024)
  and level 2 (10,752 tiles against 1024 candidates, cap 256).

Candidates: ``torch.topk`` at ``k = min(cap, N)``; the cumsum + scatter
(``method='scatter'``); the rank search as ``torch.searchsorted`` on the
membership cumsum (``method='rank'``); the rank search as a Python loop of
binary-search steps. Each is captured 20 times in one CUDA graph and timed
over 5 replays (CUDA events, median, ms a call). Beside them: the occupancy
tier that the JAX function picks with ``lax.switch``, ``torch.topk`` at that
tier (timed the same way: what a device-side tier could reach), and the
tiered selection of earlier versions that read the tier on the host (50
calls back to back, eagerly, its sync included).

Needs one CUDA card. Run from the repository root::

    python3 scripts/torch_select_members.py

Prints one line a state and candidate and writes
``chiprun_out/torch_select_members.json``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from gaussianimage_plus_tpu_torch.core import binning  # noqa: E402
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy  # noqa: E402
from gaussianimage_plus_tpu_torch.models import gaussian_image as gi  # noqa: E402

CALLS, REPS = 20, 5
ODD_HW = (496, 752)


def topk_at(member, cap, k):
    """``torch.topk`` on the keys ``N - index`` at ``k`` (exact when every
    row's count fits ``k``; always at ``k = min(cap, N)``)."""
    N = member.shape[1]
    ar = torch.arange(N, dtype=torch.int32, device=member.device)
    key = torch.where(member, N - ar[None, :], torch.zeros((), dtype=torch.int32,
                                                           device=member.device))
    topv = torch.nn.functional.pad(torch.topk(key, k, dim=1).values, (0, cap - k))
    mask = topv > 0
    return torch.where(mask, N - topv, torch.zeros_like(topv)), mask


def tier_of(member, cap):
    """The JAX function's tier: the first of 64, 128, ``min(cap, N)`` that
    holds the fullest row."""
    k_eff = min(cap, member.shape[1])
    max_c = int(member.sum(dim=1).max())
    return next(t for t in (64, 128, k_eff) if t >= min(max_c, k_eff) and t <= k_eff)


def tiered_host(member, cap):
    """The tiered selection that reads its tier on the host."""
    return topk_at(member, cap, tier_of(member, cap))


def rank_loop(member, cap):
    """The rank search as a loop of ``log2 N`` binary-search steps."""
    T, N = member.shape
    dev = member.device
    count = torch.clamp(member.sum(dim=1, dtype=torch.int32), max=cap)
    rank = torch.cumsum(member, dim=1, dtype=torch.int32)
    k_eff = min(cap, N)
    targets = torch.arange(1, k_eff + 1, dtype=torch.int32, device=dev)[None, :]
    lo = torch.zeros((T, k_eff), dtype=torch.int64, device=dev)
    hi = torch.full((T, k_eff), N, dtype=torch.int64, device=dev)
    for _ in range(max(N, 2).bit_length()):
        mid = (lo + hi) >> 1
        go_right = torch.gather(rank, 1, torch.clamp(mid, max=N - 1)) < targets
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    mask = targets <= count[:, None]
    ids = torch.where(mask, torch.clamp(lo, max=N - 1), torch.zeros_like(lo))
    return (torch.nn.functional.pad(ids, (0, cap - k_eff)),
            torch.nn.functional.pad(mask, (0, cap - k_eff)))


def with_count(fn):
    def run(member, cap):
        count = torch.clamp(member.sum(dim=1, dtype=torch.int32), max=cap)
        ids, mask = fn(member, cap)
        return ids.to(torch.int32), mask, count
    return run


def method(name):
    def run(member, cap):
        b = binning.select_members(member, cap, name)
        return b.ids, b.mask, b.count
    return run


CANDIDATES = {
    "topk at min(cap, N)": with_count(lambda m, cap: topk_at(m, cap, min(cap, m.shape[1]))),
    "cumsum + scatter ('scatter')": method("scatter"),
    "cumsum + searchsorted ('rank', 'top_k')": method("rank"),
    "cumsum + binary-search loop": with_count(rank_loop),
}


def graph_ms(fn) -> float:
    """ms a call of ``fn``: ``CALLS`` calls captured in one CUDA graph, the
    median over ``REPS`` replays between CUDA events."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    cur.wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def eager_ms(fn, calls: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def record_members(state, cfg, method_name) -> list:
    """The (member, cap) inputs of every ``select_members`` call that
    ``bin_gaussians`` makes at ``state``."""
    seen = []
    orig = binning.select_members

    def recorder(member, cap, method="top_k"):
        seen.append((member.clone(), cap))
        return orig(member, cap, method)

    binning.select_members = recorder
    try:
        with torch.no_grad():
            proj = gi.project(state.params, state.active, state.bound, cfg)
            binning.bin_gaussians(proj, cfg.H, cfg.W, cap=cfg.tile_cap, method=method_name)
    finally:
        binning.select_members = orig
    return seen


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    d = dict(np.load(ROOT / "results" / "repr_states_plain" / "kodim01.npz"))
    cfg = dataclasses.replace(config_from_numpy(d), H=ODD_HW[0], W=ODD_HW[1])
    states = {"odd-grid fit state (top_k)": record_members(state_from_numpy(d, device=dev), cfg,
                                                           "top_k")}
    d2 = dict(np.load(ROOT / "results" / "repr_states_2k" / "mosaic2k.npz"))
    lv = record_members(state_from_numpy(d2, device=dev), config_from_numpy(d2), "hier")
    states["2K hier level 1"], states["2K hier level 2"] = [lv[0]], [lv[1]]
    out = {"card": cs.nvidia_smi_line(), "calls": CALLS, "reps": REPS, "states": {}}
    for tag, calls in states.items():
        (member, cap), = calls
        T, N = member.shape
        rows = member.sum(dim=1)
        tier = tier_of(member, cap)
        ref = with_count(tiered_host)(member, cap)
        info = dict(shape=[T, N], cap=cap, fullest_row=int(rows.max()),
                    mean_row=float(rows.float().mean()), tier=tier, ms={})
        for name, fn in CANDIDATES.items():
            got = fn(member, cap)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"{tag}: {name} differs from the reference selection")
            info["ms"][name] = graph_ms(lambda: fn(member, cap))
        info["ms"][f"topk at the tier {tier} (device work only)"] = graph_ms(
            lambda: topk_at(member, cap, tier))
        info["ms"]["tiered, tier read on the host (eager, 50 back to back)"] = eager_ms(
            lambda: tiered_host(member, cap))
        out["states"][tag] = info
        for name, ms in info["ms"].items():
            print(f"{tag} [{T}, {N}] cap {cap} (fullest row {info['fullest_row']}, tier {tier}): "
                  f"{name} {ms:.4f} ms", flush=True)
    print(out["card"])
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "torch_select_members.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
