"""The coding cells' traffic kind (``kinds/qat.py``) on the CPU, at a tiny
size: the ``tiny`` configuration of ``conftest.py`` (64x96, 200 rows) over
three states shaped like fitted ones (``fitted_states``; the fit cells' tiny
states pile dozens of wide Gaussians on a pixel and saturate it, which no
fitted state does) with a 100-step warmup and 200 QAT steps a job, so
that each job has an eager QAT chunk and a second chunk (a replay on the
card). A whole run reads ``correct`` true; each fault ``control_qat.py``
plants fails its own number, and only the replays' fault leaves the start
sound; the control's fault readings fail the limits too; a traced run gives
the metrics whose readers find something on the CPU; the readers of the
program's spans, by hand, and on a parent's program (no such spans)."""

from __future__ import annotations

import json
import types
from pathlib import Path

import numpy as np
import pytest

from portbench import control_qat
from portbench.cell import load_cell

CELL = "tiny-qat"


def fitted_states(dst: Path, H: int = 64, W: int = 96, M: int = 200, n: int = 190) -> None:
    """Three states shaped like fitted ones: Gaussians of 1-2.5 pixels
    (three layers a pixel, few saturated pixels), the floor of SLV, and, as
    the committed Kodak states have, a few rows of extreme colour (a
    twentieth in [-3, 4]: Kodak's span [-8, 16]) that set a coarse 6-bit
    colour grid, so that quantizing costs what it costs there (a loss of
    ~1e-3; with colours in [0, 0.7] alone it is ~5e-6, and the loss's
    relative gaps grow as much as it shrinks)."""
    rng = np.random.default_rng(5)
    dst.mkdir()
    for k in range(3):
        var = rng.uniform(0.5, 5.0, (M, 2))
        xy = rng.uniform(-0.6, 0.6, M) * np.sqrt(var[:, 0] * var[:, 1])
        colors = rng.uniform(-0.1, 0.7, (M, 3))
        extreme = rng.random(M) < 0.05
        colors[extreme] = rng.uniform(-3.0, 4.0, (int(extreme.sum()), 3))
        np.savez(dst / f"f{k}.npz", xyz=(rng.random((M, 2)) * [W, H]).astype(np.float32),
                 cov2d=np.stack([var[:, 0], xy, var[:, 1]], -1).astype(np.float32),
                 features=colors.astype(np.float32),
                 active=np.arange(M) < n, bound=np.tile(np.float32([[1.0, 0, 1.0]]), (M, 1)),
                 num_active=np.int32(n), H=H, W=W)


def add_qat_cell(bench: Path) -> Path:
    """The checkout of ``conftest.make_checkout`` with a ``tiny-qat`` cell
    over ``fitted_states``."""
    root = bench.parent
    fitted_states(root / "fitted")
    conf = json.loads((root / "portbench/configs/tiny.json").read_text())
    conf.update(name="tiny-qat", warmup_iter=100, qat_iter=200,
                targets={"glob": str(root / "fitted" / "f*.npz")})
    (root / "portbench/configs/tiny-qat.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "portbench/traffic/qat-closed.json").read_text())
    traffic.update(steady_chunks=1)
    (root / "portbench/traffic/qat-tiny.json").write_text(json.dumps(traffic))
    b = json.loads(bench.read_text())
    b["configs"].append({"name": "tiny-qat", "source": "https://example.org/tiny",
                         "file": "portbench/configs/tiny-qat.json", "reduced": [],
                         "why": "CPU tests"})
    b["workloads"].append({"name": CELL, "config": "tiny-qat", "traffic": "qat-tiny",
                           "chips": 1, "why": "CPU tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "kodak-qat" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    bench.write_text(json.dumps(b, indent=1))
    return bench


@pytest.fixture(scope="module")
def qat_checkout(tmp_path_factory) -> Path:
    import conftest

    return add_qat_cell(conftest.make_checkout(tmp_path_factory.mktemp("qat")))


def test_sound_run_is_correct(qat_checkout, run_cell):
    res = run_cell(qat_checkout, CELL)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"qinit_gap", "qat_loss_gap", "qat_update_miss",
                                  "qat_replay_loss_gap", "code_miss", "stream_psnr_gap"}
    assert res["metrics"]["train_ms_per_step"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(control_qat.FAULTS))
def test_faults_are_caught(qat_checkout, run_cell, fault):
    number = control_qat.FAULTS[fault]
    with control_qat.planted(fault):
        res = run_cell(qat_checkout, CELL)
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"], (fault, res["checks"])
    if fault.startswith("replay_"):     # the start, before any replay, reads sound
        start = res["checks"]["qat_loss_gap"]
        assert start["value"] <= start["limit"]


def test_fault_readings_fail_the_checks(qat_checkout):
    import torch

    cell = load_cell(CELL, qat_checkout)
    got = control_qat.reading(cell, 2 ** 31 + 7, "faults", torch.device("cpu"))
    assert set(got) == {f"{n}.{f}" for f, n in control_qat.FAULTS.items()}
    for key, value in got.items():
        assert value > cell.traffic["limits"][key.split(".")[0]], key


def test_traced_run_reads_the_programs_spans(qat_checkout, run_cell):
    """On the CPU the chunks run eagerly: nothing is captured or replayed, so
    the readers of the capture, the replays and the device's glue and share
    of the peak find nothing and leave their metrics out; the encoder's span
    is read over the window's jobs."""
    res = run_cell(qat_checkout, CELL, trace=True)
    assert res["correct"] is True, res["checks"]
    m = res["metrics"]
    assert m["encode_ms.qat"]["value"] > 0
    assert not {"qat_capture_ms.qat", "qat_replay_ms.qat", "quant_glue_ms.qat",
                "step_mfu.qat"} & set(m)
    assert res["device"]["window_s"] > 0


ROOT = Path(__file__).resolve().parents[2]


def reader(name):
    from portbench.cell import load_module

    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                       "test_metric_" + name.replace(".", "_"))


@pytest.fixture
def use(monkeypatch):
    from gaussianimage_plus_tpu_torch import utils

    return lambda mod: monkeypatch.setattr(utils, "profiling", mod, raising=False)


def _spans(with_qat=True):
    """Two coding jobs' spans and a steady segment's (a parent's program
    names its QAT runner's spans ``fit.*`` and records no ``qat`` or
    ``encode``)."""
    from test_portbench_program import S

    q = "qat" if with_qat else "fit"
    out = [S("fit.warm_chunk", 2, 1, 1, 10.1, 10.5), S("fit.capture", 3, 1, 1, 10.5, 11.5),
           S(f"{q}.warm_chunk", 4, 1, 1, 12.0, 12.3), S(f"{q}.capture", 5, 1, 1, 12.3, 13.5),
           S("fit.warm_chunk", 12, 11, 11, 30.1, 30.5), S("fit.capture", 13, 11, 11, 30.5, 31.5),
           S(f"{q}.warm_chunk", 14, 11, 11, 32.0, 32.2), S(f"{q}.capture", 15, 11, 11, 32.2, 33.0),
           S(f"{q}.warm_chunk", 30, 0, 30, 50.0, 50.1), S(f"{q}.capture", 31, 0, 31, 50.1, 50.6)]
    if with_qat:
        out += [S("qat", 1, 0, 1, 10.0, 20.0), S("encode.entropy", 7, 6, 6, 20.01, 20.02),
                S("encode", 6, 0, 6, 20.0, 20.04), S("qat", 11, 0, 11, 30.0, 40.0),
                S("encode", 16, 0, 16, 40.0, 40.02)]
    return out


def test_span_readers_by_hand(use):
    from test_portbench_program import program_with

    use(program_with(_spans()))
    window = {"qat_window": types.SimpleNamespace(lo=5.0, hi=39.0)}
    # the last qat root's QAT warm-up chunk and capture: 200 + 800 ms
    assert reader("qat_capture_ms.qat").read(window) == pytest.approx(1000.0, rel=1e-6)
    # the window holds the first job's encode only (40 ms); the profiled job's lies past it
    assert reader("encode_ms.qat").read(window) == pytest.approx(40.0, rel=1e-6)
    window["qat_window"].hi = 41.0
    assert reader("encode_ms.qat").read(window) == pytest.approx(30.0, rel=1e-6)


@pytest.mark.parametrize("name", ["qat_capture_ms.qat", "encode_ms.qat", "qat_replay_ms.qat",
                                  "quant_glue_ms.qat", "step_mfu.qat"])
def test_readers_return_none_without_what_they_read(use, name):
    from test_portbench_program import program_with

    trace = {"qat_window": types.SimpleNamespace(lo=5.0, hi=41.0), "peaks": None,
             "kernels": {}}
    use(program_with(_spans(with_qat=False)))      # a parent's program
    assert reader(name).read(trace) is None
    use(types.SimpleNamespace(trace=None))         # a profiling module with no spans
    assert reader(name).read(trace) is None
    assert reader(name).read({"peaks": None, "kernels": {}}) is None
