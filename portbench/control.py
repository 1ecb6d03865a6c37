"""The control of ``correct``, and the faults it has to catch, read at a
cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <a,b,c> [--mode tf32|faults]

``tf32``: the configuration states float32 with TF32 off (the port's
precision rule), so the control is the plain reference with TF32 on (the
blend's product of gated weights and colours and, in training, its
gradients on the tensor cores), read by the cell's comparison against the
float32 reference on the same inputs:

- decode cells: ``rms_gap`` over the first ``sample`` requests of the seed;
- fit cells, over the first three jobs: ``loss_gap`` (steps 1-2) and
  ``loss3_gap`` (step 3) from the initial rows, and ``replay_loss_gap``
  (steps c + 1 to c + 4) from the carry the program's first chunk hands on
  (a fit of two chunks, the second a replay on the card).

``faults``: what each fault a cell can have does to the numbers that have
to fail it. For a fit: a step that returns its state unchanged and a loss
over half the pixels, on the reference put in the program's place at the
start (``loss_gap``, ``loss3_gap``) and planted in the program's replayed
chunks only (``replay_loss_gap``), a prune by the wrong rule
(``prune_miss``), and colours altered in the answer the program's first job
returns (``psnr_gap``). For a decode: an image with one
tile blanked and a stream with one row's position code moved by 100
(``rms_gap``). Neither mode runs in the benchmark's own runs.

``planted(fault)`` plants a fault in the program for as long as it is
entered; ``tests/test_portbench_faults.py`` drives whole runs with it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import cell as CL  # noqa: E402


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` in it:

    - ``unchanged_state``: every step returns its state unchanged but for
      the step count;
    - ``half_batch``: every step's loss is the mean over the image's top half;
    - ``replay_*``: the same from the second chunk of each fit on, which is
      what the graph captures and replays on the card;
    - ``raw_prune``: the prune that ends each chunk tests the raw covariance,
      without its bound, for positive definiteness;
    - ``altered_answer``: the returned state's colours + 0.05;
    - ``altered_image``: the decoded image's first 16x16 pixels blanked;
    - ``altered_token``: the first row's x position code moved by 100."""
    from gaussianimage_plus_tpu_torch.compress import bitstream
    from gaussianimage_plus_tpu_torch.train import trainer

    saved = []

    def put(owner, attr, new):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    on = {"now": not fault.startswith("replay_")}
    if fault.startswith("replay_"):
        runner = trainer._fit_runner

        def later(*a, **kw):
            r = runner(*a, **kw)
            inner, calls = r.fn, [0]

            def fn(carry):
                calls[0] += 1
                on["now"] = calls[0] > 1
                try:
                    return inner(carry)
                finally:
                    on["now"] = False

            r.fn = fn
            return r

        put(trainer, "_fit_runner", later)
    if fault.endswith("unchanged_state"):
        step = trainer.train_step

        def unchanged(ts, *a, **kw):
            new, out = step(ts, *a, **kw)
            return (ts._replace(step=new.step), out) if on["now"] else (new, out)

        put(trainer, "train_step", unchanged)
    elif fault.endswith("half_batch"):
        loss = trainer.loss_fn

        def half(pred, gt, *a):
            if on["now"]:
                return loss(pred[: pred.shape[0] // 2], gt[: gt.shape[0] // 2], *a)
            return loss(pred, gt, *a)

        put(trainer, "loss_fn", half)
    elif fault == "raw_prune":
        def raw(state, cfg):
            xx, xy, yy = state.params.cov2d.unbind(-1)
            active = state.active & (xx * yy - xy * xy > 0) & (xx > 0) & (yy > 0)
            n = active.sum(dtype=torch.int32)
            return state._replace(active=active, num_active=n), state.num_active - n

        put(trainer, "prune", raw)
    elif fault == "altered_answer":
        best = trainer.restore_best

        def altered(ts):
            s = best(ts)
            return s._replace(params=s.params._replace(features=s.params.features + 0.05))

        put(trainer, "restore_best", altered)
    elif fault == "altered_image":
        render = bitstream.decompress_wo_ec

        def blanked(*a, **kw):
            img = render(*a, **kw).clone()
            img[:16, :16] = 0.0
            return img

        put(bitstream, "decompress_wo_ec", blanked)
    elif fault == "altered_token":
        parse = bitstream.deserialize_bitstream

        def moved(*a, **kw):
            dec = parse(*a, **kw)
            codes = dec.enc.quant_means.clone()
            codes[0, 0] += 100.0
            return dec._replace(enc=dec.enc._replace(quant_means=codes))

        put(bitstream, "deserialize_bitstream", moved)
    else:
        raise ValueError(f"no fault {fault!r}")
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def first_replay(mod, inp, seed: int, j: int):
    """Job ``j`` cut to two chunks (the second a replay on the card): the
    carry its first chunk handed on and the losses of steps c + 1 to c + 4."""
    c = inp.tcfg.prune_iter
    with mod.carries() as got:
        res = mod.fit(inp, seed, j, dataclasses.replace(inp.tcfg, iterations=2 * c))
    return got[0] if got else None, res.history["loss"][c:c + 4].tolist()


def decode_reading(cell, seed: int, device) -> float:
    mod = CL.kind(cell)
    inp = mod.make_inputs(cell, seed)
    worst = 0.0
    for r in inp.requests[:int(cell.traffic["sample"])]:
        ref = mod.reference_image(inp.bufs[r], device)
        ctl, _ = mod.reference_image(inp.bufs[r], device, torch.float32, True)
        worst = max(worst, mod.rms(ctl.float(), ref))
    return worst


def fit_reading(cell, seed: int, device, jobs: int = 3) -> dict:
    from portbench.reference import train as RT

    mod = CL.kind(cell)
    inp = mod.make_inputs(cell, seed, device)
    t = inp.tcfg
    worst = {"loss_gap": 0.0, "loss3_gap": 0.0, "replay_loss_gap": 0.0}
    for j in range(jobs):
        gt = inp.targets[inp.order[j % len(inp.order)]]
        rows = inp.inits[j % len(inp.inits)]
        ctl = RT.follow(rows, gt, t.lr, 2, None, t.lr_step_size, t.lr_gamma, tf32=True)
        gaps = mod.start_gaps(rows, gt, t, ctl)
        carry, _ = first_replay(mod, inp, seed, j)
        ctl = RT.follow(carry.rows, gt, t.lr, 3, carry.adam, t.lr_step_size, t.lr_gamma,
                        tf32=True)
        later = mod.replay_gaps(carry, gt, t, ctl)
        print("control tf32: loss gaps by step " + " ".join(f"{g:.3e}" for g in gaps) +
              "; first replay " + " ".join(f"{g:.3e}" for g in later), file=sys.stderr)
        worst = {"loss_gap": max([worst["loss_gap"]] + gaps[:2]),
                 "loss3_gap": max(worst["loss3_gap"], gaps[2]),
                 "replay_loss_gap": max([worst["replay_loss_gap"]] + later)}
    return worst


def fit_faults(cell, seed: int, device) -> dict:
    from portbench.reference import render as R
    from portbench.reference import train as RT

    mod = CL.kind(cell)
    inp = mod.make_inputs(cell, seed, device)
    t = inp.tcfg
    gt = inp.targets[inp.order[0]]
    ref = RT.follow(inp.inits[0], gt, t.lr, 2, None, t.lr_step_size, t.lr_gamma)
    unchanged = mod.start_gaps(inp.inits[0], gt, t, [ref[0]] * 3)
    half = float(torch.mean(gt[: gt.shape[0] // 2].double() ** 2))   # colours start at zero
    out = {"loss_gap.unchanged_state": max(unchanged[:2]),
           "loss3_gap.unchanged_state": unchanged[2],
           "loss_gap.half_batch": abs(half - ref[0]) / ref[0]}
    for fault in ("replay_unchanged_state", "replay_half_batch"):
        with planted(fault):
            carry, losses = first_replay(mod, inp, seed, 0)
        out[f"replay_loss_gap.{fault}"] = max(mod.replay_gaps(carry, gt, t, losses))
    with planted("raw_prune"):
        carry, _ = first_replay(mod, inp, seed, 0)
    out["prune_miss.raw_prune"] = mod.prune_misses(inp.inits[0], carry)
    res = mod.fit(inp, seed, 0)
    s = res.state
    img = R.render_state(s.params.xyz, s.params.cov2d + s.bound, s.params.features + 0.05,
                         s.active, inp.cfg.H, inp.cfg.W)
    out["psnr_gap.altered_answer"] = abs(mod.claim(res) - RT.psnr(img, gt))
    return out


def decode_faults(cell, seed: int, device) -> dict:
    from portbench.reference import gipb

    mod = CL.kind(cell)
    inp = mod.make_inputs(cell, seed)
    blank = moved = 0.0
    for r in inp.requests[:int(cell.traffic["sample"])]:
        buf = inp.bufs[r]
        ref = mod.reference_image(buf, device)
        img = ref[0].clone()
        img[:16, :16] = 0.0
        blank = max(blank, mod.rms(img, ref))
        g = gipb.decode(buf)
        xy = g.xy.copy()
        step = (xy.max(axis=0) - xy.min(axis=0)) / 4095.0     # one code of the 12-bit grid
        xy[0, 0] += 100 * step[0]
        t = lambda a: torch.as_tensor(a).to(device)
        one = torch.ones(len(xy), dtype=torch.bool, device=device)
        moved_img = mod.R.render_state(t(xy), t(g.cov), t(g.colors), one, g.H, g.W, g.cap)
        moved = max(moved, mod.rms(moved_img, ref))
    return {"rms_gap.blanked_tile": blank, "rms_gap.moved_row": moved}


def reading(cell, seed: int, mode: str, device) -> dict:
    decode = cell.traffic["kind"] == "decode"
    if mode == "faults":
        return decode_faults(cell, seed, device) if decode else fit_faults(cell, seed, device)
    if decode:
        return {"rms_gap": decode_reading(cell, seed, device)}
    return fit_reading(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("tf32", "faults"), default="tf32")
    args = ap.parse_args(argv)
    cell = CL.load_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": cell.name, "seed": seed, "mode": args.mode,
                          **reading(cell, seed, args.mode, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
