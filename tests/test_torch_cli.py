"""The port's CLIs, log writer and profiling helpers (on the CPU).

On two 32x48 PNGs with ``--device cpu`` (or the JAX scripts' ``--cpu``)
and tiny iteration counts:

- the fit CLI's log directory name, its files and its line formats (the
  arguments line, the per-image ``iter`` lines, the per-image line and the
  ``Average:`` line, numbers masked) against one run of the JAX
  ``scripts/train.py`` (``--cpu``, one image, 20 steps) in a subprocess;
  the arguments line has the JAX script's keys plus ``device``;
- the ``--model_name`` remap and its ``note:`` lines;
- ``--model_path`` with ``--iterations 0`` repeats the fit's PSNR;
- ``train_quantize`` with ``--model_path`` and ``--write_bitstream``: the
  stream decodes through ``decode.main`` and ``decode_bitstream`` to the
  logged stream PSNR (1e-4 dB; the PNG ``decode.main`` writes, 8-bit, within
  0.05 dB);
- ``eval_kodak`` over a ``fit_ckpt``: the PSNR that ``evaluate`` gives for
  ``restore_best`` of it at the same cap (1e-4 dB), and its ``--out`` JSON;
- ``LogWriter``; ``profiling.trace`` of a CPU decode: its Chrome trace holds
  the decode's spans and each kernel wrapper's launches (none on the CPU);
- with no card, a default-device run of each CLI raises and writes nothing.

The CLIs' numbers are not compared with the JAX CLIs': their random initial
draws differ (a JAX PRNG against a ``torch.Generator``). The functions under
them are held against JAX in the other ``test_torch_*`` files.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussianimage_plus_tpu_torch import decode
from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream
from gaussianimage_plus_tpu_torch.models import gaussian_image as tgi
from gaussianimage_plus_tpu_torch.scripts import eval_kodak, train, train_quantize
from gaussianimage_plus_tpu_torch.train import trainer as ttr
from gaussianimage_plus_tpu_torch.train.metrics import psnr as psnr_fn
from gaussianimage_plus_tpu_torch.utils import profiling
from gaussianimage_plus_tpu_torch.utils.checkpoint import load_checkpoint
from gaussianimage_plus_tpu_torch.utils.image_io import LogWriter, load_image, save_image

ROOT = Path(__file__).resolve().parent.parent
H, W, M = 32, 48, 100
FIT_ARGS = ["--num_images", "1", "--iterations", "20", "--prune_iter", "10", "--grow_iter", "10",
            "--num_points", "50", "--max_num_points", str(M), "--log_every", "10"]
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[+-]\d+)?")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: it is faster here,
    and test workers that each start a thread per core slow every OpenMP
    region of every worker (a 200-step fit: 1.3 s alone, minutes beside
    five others)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("kodak")
    yy, xx = np.mgrid[0:H, 0:W] / float(H)
    for i in (1, 2):
        img = np.stack([0.5 + 0.4 * np.sin(3 * xx + i), 0.5 + 0.4 * np.cos(2 * yy),
                        0.5 + 0.3 * np.sin(4 * xx * yy)], -1)
        save_image(img, d / f"kodim{i:02}.png")
    return d


@pytest.fixture(scope="module")
def fitted(data, tmp_path_factory):
    """One run of the port's fit CLI on both images."""
    out = tmp_path_factory.mktemp("fit")
    log_dir = train.main(["-d", str(data), *FIT_ARGS, "--num_images", "2", "--cpu",
                          "--save_imgs", "--log_dir", str(out)])
    return log_dir


def _mask(line: str) -> str:
    return NUMBER.sub("#", line)


def _lines(path) -> list:
    return Path(path).read_text().splitlines()


def test_fit_cli_formats_match_jax(data, tmp_path):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    args = ["-d", str(data), *FIT_ARGS, "--cpu"]
    subprocess.run([sys.executable, str(ROOT / "scripts" / "train.py"), *args, "--log_dir",
                    str(jax_out)], check=True, cwd=ROOT, capture_output=True, timeout=600,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"))
    port_dir = train.main([*args, "--log_dir", str(port_out)])
    jax_dir = next((jax_out / "kodak").iterdir())
    assert port_dir.relative_to(port_out) == jax_dir.relative_to(jax_out)
    assert port_dir.name == "GaussianImage_Covariance_I20_N50_SLV_R1.0_add_prune"
    assert sorted(p.name for p in (port_dir / "kodim01").iterdir()) == \
        sorted(p.name for p in (jax_dir / "kodim01").iterdir())   # gaussian_model, train.txt
    run_j, run_t = _lines(jax_dir / "train.txt"), _lines(port_dir / "train.txt")
    args_j, args_t = json.loads(run_j[0]), json.loads(run_t[0])
    assert args_t == dict(args_j, log_dir=str(port_out), device=None)
    assert [_mask(x) for x in run_t[1:]] == [_mask(x) for x in run_j[1:]]
    assert run_t[1].startswith("kodim01\t32x48\tPSNR\t") and run_t[2].startswith("Average: PSNR:")
    img_j, img_t = _lines(jax_dir / "kodim01" / "train.txt"), _lines(port_dir / "kodim01" / "train.txt")
    assert [_mask(x) for x in img_t] == [_mask(x) for x in img_j] == ["iter #: psnr # best # n #"] * 2


def test_fit_cli_outputs(data, fitted):
    lines = _lines(fitted / "train.txt")
    assert [x.split("\t")[0] for x in lines[1:3]] == ["kodim01", "kodim02"]
    state, extra = load_checkpoint(fitted / "kodim01" / "gaussian_model", device="cpu")
    assert isinstance(state, tgi.GaussianState) and set(extra) == {"psnr", "ms_ssim"}
    ev = ttr.evaluate(state, load_image(data / "kodim01.png"),
                      tgi.GaussianConfig(H=H, W=W, max_num_points=M), n_renders=1)
    assert f"{ev['psnr']:.4f}" == lines[1].split("\t")[3]
    assert load_image(fitted / "kodim01" / "render.png").shape == (H, W, 3)


def test_model_path_skips_the_fit(data, fitted, tmp_path):
    log_dir = train.main(["-d", str(data), *FIT_ARGS, "--num_images", "2", "--iterations", "0",
                          "--cpu", "--model_path", str(fitted), "--log_dir", str(tmp_path)])
    assert log_dir.name.startswith("GaussianImage_Covariance_I0_")
    first, again = _lines(fitted / "train.txt"), _lines(log_dir / "train.txt")
    for a, b in zip(first[1:3], again[1:3]):
        fa, fb = a.split("\t"), b.split("\t")
        assert fb[:4] == fa[:4] and fb[5] == fa[5]             # name, size, PSNR, MS-SSIM
        assert float(fb[7]) == 0.0                             # no training time
    assert not (log_dir / "kodim01" / "train.txt").exists() or \
        _lines(log_dir / "kodim01" / "train.txt") == []


def test_model_name_remap(data, tmp_path, capsys):
    log_dir = train.main(["-d", str(data), *FIT_ARGS, "--cpu", "--model_name",
                          "GaussianImage_Cholesky", "--lr", "0.01", "--prune", "true",
                          "--log_dir", str(tmp_path)])
    notes = [x for x in capsys.readouterr().out.splitlines() if x.startswith("note:")]
    assert notes == [
        "note: --lr=0.01 overrides the reference's GaussianImage_Cholesky bundle value 0.001",
        "note: --prune=True overrides the reference's GaussianImage_Cholesky bundle value False"]
    args = json.loads(_lines(log_dir / "train.txt")[0])
    assert (args["lr"], args["opt_type"], args["adaptive_add"], args["prune"]) == \
        (0.01, "adan", False, True)
    assert log_dir.name == "GaussianImage_Cholesky_I20_N50_SLV_R1.0_prune"
    assert np.isfinite(float(_lines(log_dir / "train.txt")[1].split("\t")[3]))


def test_train_quantize_writes_a_stream(data, fitted, tmp_path):
    log_dir, stats = train_quantize.main(
        ["-d", str(data), "--num_images", "1", "--iterations", "30", "--warmup_iter", "10",
         "--prune_iter", "10", "--num_points", "50", "--max_num_points", str(M), "--cpu",
         "--model_path", str(fitted), "--write_bitstream", "--log_dir", str(tmp_path),
         "--log_every", "10"])
    lines = _lines(log_dir / "train.txt")
    assert lines[1] == f"warm-start from {fitted / 'kodim01' / 'gaussian_model'}"
    line = next(x for x in lines if x.startswith("kodim01 Eval time:"))
    assert _mask(line) == ("kodim# Eval time:#s, FPS:# PSNR:#, MS_SSIM:#, bpp:# position_bpp:#, "
                           "cholesky_bpp:#, feature_dc_bpp:#")
    avg = dict(kv.split(":") for kv in lines[-1][len("Average: "):].split(", "))
    gipb = tmp_path / "kodim01.gipb"
    gt = torch.as_tensor(load_image(data / "kodim01.png"))
    img, _ = decode_bitstream(gipb.read_bytes(), device="cpu")
    assert abs(float(psnr_fn(img, gt)) - stats["kodim01"]["stream_psnr"]) <= 1e-6
    assert abs(stats["kodim01"]["stream_psnr"] - float(avg["stream_psnr"])) <= 5e-5
    out = tmp_path / "decoded.png"
    assert decode.main([str(gipb), "-o", str(out), "--device", "cpu"]) == 0
    png = torch.as_tensor(load_image(out))
    assert abs(float(psnr_fn(png, gt)) - float(avg["stream_psnr"])) <= 0.05


def test_eval_kodak_over_fit_ckpt(data, tmp_path, capsys):
    cfg = tgi.GaussianConfig(H=H, W=W, max_num_points=M)
    gt = load_image(data / "kodim01.png")
    ttr.fit_image(gt, cfg, ttr.TrainConfig(iterations=20, prune_iter=10, grow_iter=10), 50,
                  device="cpu", checkpoint_dir=str(tmp_path / "ck" / "kodim01"))
    out = tmp_path / "eval.json"
    rows = eval_kodak.main(["--dataset", str(data), "--ckpt_dir", str(tmp_path / "ck"),
                            "--max_num_points", str(M), "--out", str(out), "--cpu"])
    assert [r["image"] for r in rows] == ["kodim01"] and json.loads(out.read_text()) == rows
    printed = capsys.readouterr().out.splitlines()
    assert [_mask(x) for x in printed[-2:]] == ["kodim#: PSNR # MS-SSIM #",
                                                "AVERAGE over #: PSNR #, MS-SSIM #"]
    ts, _ = load_checkpoint(tmp_path / "ck" / "kodim01" / "fit_ckpt", device="cpu")
    ev = ttr.evaluate(ttr.restore_best(ts), gt, tgi.GaussianConfig(
        H=H, W=W, max_num_points=M, tile_cap=256, raster_backend="pallas"), n_renders=1)
    assert abs(rows[0]["psnr"] - ev["psnr"]) <= 1e-4 and rows[0]["tile_cap"] == 256


def test_log_writer(tmp_path, capsys):
    lw = LogWriter(tmp_path / "run")
    lw.write("first")
    lw.write("second")
    assert _lines(tmp_path / "run" / "train.txt") == ["first", "second"]
    assert capsys.readouterr().out == "first\nsecond\n"
    LogWriter(tmp_path / "run", train=False).write("x")
    assert _lines(tmp_path / "run" / "test.txt") == ["x"]


def test_profiling_helpers(tmp_path):
    gipb = ROOT / "results" / "bitstreams_r4" / "kodim01.gipb"
    with profiling.trace(str(tmp_path / "tr")) as path:
        decode_bitstream(gipb.read_bytes(), device="cpu")
    trace = json.loads(Path(path).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"decode", "decode.parse", "decode.entropy", "decode.dequantize", "decode.render",
            "render.bin"} <= names
    assert trace["launches"] == {"tile_table_forward": 0, "chunk_list_forward": 0,
                                 "chunk_backward": 0, "tile_table_backward": 0, "tile_bin": 0}


@pytest.mark.parametrize("cli", ["train", "train_quantize", "eval_kodak"])
def test_default_device_raises_without_a_card(data, tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = {"train": train, "train_quantize": train_quantize, "eval_kodak": eval_kodak}[cli]
    argv = (["--dataset", str(data), "--ckpt_dir", str(tmp_path)] if cli == "eval_kodak"
            else ["-d", str(data), "--num_images", "1", "--log_dir", str(tmp_path / "logs")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not (tmp_path / "logs").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(tmp_path / "missing")
