"""The control of the coding cells' ``correct`` (traffic kind ``qat``), and
the faults it has to catch, read at a cell's own size.

    python3 portbench/control_qat.py --workload <cell> --seeds <a,b,c> [--mode tf32|faults]

Each reading runs jobs cut to two QAT chunks (the eager chunk, then on the
card a capture and one replay), through the public calls as the cell runs
them.

``tf32``: the configuration states float32 with TF32 off, so the control is
the plain reference with TF32 on (the blend's product of gated weights and
colours and its gradients on the tensor cores), read by the cell's
comparisons against the float32 reference from the same starts, over the
first three jobs: ``qat_loss_gap`` (the forwards of steps 1 and 2 from the
program's rows), ``qat_update_miss`` (the first update from the restored
rows), ``qat_replay_loss_gap`` (steps c + 1 and c + 2 from the carry the
program's eager chunk handed on) and ``stream_psnr_gap`` (the reference's
decode of the program's stream rendered so). ``qinit_gap`` and
``code_miss`` hold no product of matrices: TF32 cannot move them.

``faults``: each fault planted in the program, and the number it has to
fail, read on the first job: an unchanged QAT step everywhere
(``qat_update_miss``) and in the replays only (``qat_replay_loss_gap``),
the straight-through gradient dropped from the colour quantizer
(``qat_update_miss``), a loss over half the image (``qat_loss_gap``), one
code moved and one grid scale altered in the written stream
(``code_miss``), an initial grid altered (``qinit_gap``), and the
round-trip decode's image altered (``stream_psnr_gap``). Neither mode runs
in the benchmark's own runs.

``planted(fault)`` plants a fault in the program for as long as it is
entered; ``portbench/tests/test_portbench_qat.py`` drives whole CPU runs
with it. Enter it before a run's set-up, so that the run's ``taps`` see
what the fault does.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import cell as CL  # noqa: E402

FAULTS = {"unchanged_qat_step": "qat_update_miss",
          "no_ste_color": "qat_update_miss",
          "half_image_loss": "qat_loss_gap",
          "replay_unchanged_qat_step": "qat_replay_loss_gap",
          "moved_code": "code_miss",
          "altered_grid": "code_miss",
          "altered_qinit": "qinit_gap",
          "altered_stream_image": "stream_psnr_gap"}


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` in it:

    - ``unchanged_qat_step``: every QAT step returns its state, Adams and
      grids unchanged (its loss and the best snapshot as computed);
    - ``replay_unchanged_qat_step``: the same from the QAT runner's second
      chunk on, which is what the graph captures and replays on the card;
    - ``no_ste_color``: the colour quantizer rounds without the
      straight-through gradient (the colours take none);
    - ``half_image_loss``: every QAT step's loss is the mean over the
      image's top half;
    - ``moved_code``: the first kept row's x code moved by one in the
      written stream;
    - ``altered_grid``: the x grid's scale in the written stream's header
      times 1.001;
    - ``altered_qinit``: the x grid's scale that ``init_quantizers`` sets
      times 1.01;
    - ``altered_stream_image``: the round-trip decode's image two 8-bit
      levels brighter (+2/255) before ``stream_psnr`` is taken (a blanked
      16x16 tile moves the PSNR of an image whose corner is dark by under
      0.01 dB)."""
    from gaussianimage_plus_tpu_torch.compress import pipeline, quantizers
    from gaussianimage_plus_tpu_torch.compress import trainer as ctr

    saved = []

    def put(owner, attr, new):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    on = {"now": not fault.startswith("replay_")}
    if fault.startswith("replay_"):
        runner = ctr._qat_runner

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

        put(ctr, "_qat_runner", later)
    if fault.endswith("unchanged_qat_step"):
        chunk = pipeline.quant_train_chunk

        def unchanged(state, mos, bundle, gt, cfg, qcfg, model_lr, n_steps, best=None):
            if not on["now"]:
                return chunk(state, mos, bundle, gt, cfg, qcfg, model_lr, n_steps, best=best)
            losses, psnrs = [], []
            for _ in range(n_steps):
                *_, m = chunk(state, mos, bundle, gt, cfg, qcfg, model_lr, 1, best=best)
                best = m["best"]
                losses.append(m["loss"])
                psnrs.append(m["psnr"])
            return state, mos, bundle, {"loss": torch.cat(losses), "psnr": torch.cat(psnrs),
                                        "best": best}

        put(pipeline, "quant_train_chunk", unchanged)
    elif fault == "half_image_loss":
        loss = pipeline.loss_fn

        def half(pred, gt, *a):
            return loss(pred[: pred.shape[0] // 2], gt[: gt.shape[0] // 2], *a)

        put(pipeline, "loss_fn", half)
    elif fault == "no_ste_color":
        lsq = pipeline.uniform_forward

        def no_ste(params, x, bits, signed=False):
            if x.shape[-1] != 3:
                return lsq(params, x, bits, signed)
            lo, hi = quantizers.uniform_qrange(bits, signed)
            code = torch.round(quantizers.clip((x - params.beta) / params.scale, lo, hi))
            return code * params.scale + params.beta, code

        put(pipeline, "uniform_forward", no_ste)
    elif fault in ("moved_code", "altered_grid"):
        serialize = ctr.serialize_bitstream

        def altered(bundle, enc, cfg, qcfg):
            if fault == "moved_code":
                codes = enc.quant_means.clone()
                first = int(torch.argmax(enc.active.to(torch.int32)))
                codes[first, 0] += -1.0 if float(codes[first, 0]) > 0 else 1.0
                enc = enc._replace(quant_means=codes)
            else:
                bundle = bundle._replace(xy=bundle.xy._replace(scale=bundle.xy.scale * 1.001))
            return serialize(bundle, enc, cfg, qcfg)

        put(ctr, "serialize_bitstream", altered)
    elif fault == "altered_qinit":
        init = ctr.init_quantizers

        def altered_init(*a, **kw):
            b = init(*a, **kw)
            return b._replace(xy=b.xy._replace(scale=b.xy.scale * 1.01))

        put(ctr, "init_quantizers", altered_init)
    elif fault == "altered_stream_image":
        decode = ctr.decode_bitstream

        def brighter(*a, **kw):
            img, dec = decode(*a, **kw)
            return img + 2.0 / 255.0, dec

        put(ctr, "decode_bitstream", brighter)
    else:
        raise ValueError(f"no fault {fault!r}")
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def cut_job(mod, inp, seed: int, j: int, fault=None):
    """Job ``j`` cut to two QAT chunks, with ``fault`` planted; its ``Job``."""
    tcfg = dataclasses.replace(inp.tcfg, iterations=inp.warmup + 2 * inp.tcfg.prune_iter)
    with tempfile.TemporaryDirectory(prefix="portbench-qat-") as d, \
            planted(fault) if fault else contextlib.nullcontext(), mod.taps() as got:
        path = os.path.join(d, f"job{j}.gipb")
        res, stats = mod.run_job(inp, seed, j, path, tcfg)
        return mod.keep(inp, j, res, stats, path, got)


def tf32_reading(cell, seed: int, device, jobs: int = 3) -> dict:
    mod = CL.kind(cell)
    inp = mod.make_inputs(cell, seed, device)
    worst = {"qat_loss_gap": 0.0, "qat_update_miss": 0.0, "qat_replay_loss_gap": 0.0,
             "stream_psnr_gap": 0.0}
    for j in range(jobs):
        job = cut_job(mod, inp, seed, j)
        gt = inp.targets[job.target]
        start, miss = mod.first_steps(inp, job, gt, tf32=True)
        got = {"qat_loss_gap": start, "qat_update_miss": [miss],
               "qat_replay_loss_gap": mod.replay_gaps(inp, job, gt, tf32=True),
               "stream_psnr_gap": [mod.stream_gap(job, gt, tf32=True)]}
        print("control tf32: " + "; ".join(f"{k} " + " ".join(f"{g:.3e}" for g in v)
                                           for k, v in got.items()), file=sys.stderr)
        worst = {k: max([worst[k]] + got[k]) for k in worst}
    return worst


def fault_reading(cell, seed: int, device) -> dict:
    mod = CL.kind(cell)
    inp = mod.make_inputs(cell, seed, device)
    number = {"qat_loss_gap": lambda job, gt: max(mod.first_steps(inp, job, gt)[0]),
              "qat_update_miss": lambda job, gt: mod.first_steps(inp, job, gt)[1],
              "qat_replay_loss_gap": lambda job, gt: max(mod.replay_gaps(inp, job, gt)),
              "code_miss": lambda job, gt: mod.code_miss(inp, job),
              "qinit_gap": lambda job, gt: mod.qinit_gap(inp, job),
              "stream_psnr_gap": lambda job, gt: mod.stream_gap(job, gt)}
    out = {}
    for fault, name in FAULTS.items():
        job = cut_job(mod, inp, seed, 0, fault)
        out[f"{name}.{fault}"] = number[name](job, inp.targets[job.target])
    return out


def reading(cell, seed: int, mode: str, device) -> dict:
    return fault_reading(cell, seed, device) if mode == "faults" else \
        tf32_reading(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("tf32", "faults"), default="tf32")
    args = ap.parse_args(argv)
    cell = CL.load_cell(args.workload)
    if cell.traffic["kind"] != "qat":
        raise SystemExit(f"{cell.name} is not a coding cell; its control is control.py")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": cell.name, "seed": seed, "mode": args.mode,
                          **reading(cell, seed, args.mode, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
