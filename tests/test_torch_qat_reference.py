"""The port's coding path against the benchmark's plain reference of QAT and
of the encoder (``portbench/reference/qat.py``, which imports nothing of the
port), and its ``.gipb`` bytes against the frozen parser
(``portbench/reference/gipb.py``).

On the CPU at 48x64 with 200 rows (190 active) shaped like a fitted state,
seeded, and a target that is the 8-bit render of the rows moved a little:

- ``init_quantizers``: every grid equal to the reference's init on the same
  rows, exactly (both take the active rows' min and max and one float32
  division);
- ``quant_train_chunk``: 3 steps, each from the port's carry (rows, the
  model's Adam, grids, the grids' Adams), against one reference step from
  the same carry: the step's loss within ``LOSS_RTOL`` relative, the
  updated rows and grids within a hundredth of their Adams' step (but for
  ``OFF_SHARE`` of the values). Not a free run: a code whose argument
  lies at a half-integer rounds either way once two float32 sums differ in
  the last bits, and free runs of the two then part (on these scenes by up
  to 1.7e-3 in the loss within 3 steps);
- ``compress_wo_ec``: the codes, the log grid and the rows kept equal the
  reference encoder's exactly (the same float32 operations, the log and exp
  rounded once from float64 on both sides);
- ``serialize_bitstream``: the frozen parser reads back the header, every
  grid value and every code the reference's encoding has (``code_misses``
  0), and the frozen decoder's render of the bytes is the port's decode of
  them within ``STREAM_DB``.

The card (``-m cuda``): the same comparisons at 768x512 with the 5000 rows of
kodim01's committed fitted state and its render as the target, each step a
replay of the graphed QAT runner (``quant_train_macro_chunk``, one step a
chunk: kernels B, C and F). This file imports no JAX, so the card cases run
with ``python -m pytest --noconftest tests/test_torch_qat_reference.py -m cuda``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gaussianimage_plus_tpu_torch.compress import bitstream as bs  # noqa: E402
from gaussianimage_plus_tpu_torch.compress import pipeline as pl  # noqa: E402
from gaussianimage_plus_tpu_torch.models import gaussian_image as gi  # noqa: E402
from gaussianimage_plus_tpu_torch.train import trainer as tr  # noqa: E402
from gaussianimage_plus_tpu_torch.train.metrics import psnr  # noqa: E402
from portbench.reference import qat as RQ  # noqa: E402
from portbench.reference import render as R  # noqa: E402

H, W, M, N = 48, 64, 200, 190
LR = 0.018
BITS = RQ.Bits(12, 10, 6)
KODIM01 = ROOT / "results/repr_states_plain/kodim01.npz"
# The step's loss: the port's render (the plain path on the CPU, kernels B and
# C on the card) and the reference's blend sum in other orders, which moves
# pixels in their last bits, most where rows of large opposite colours
# cancel; read at most 1.8e-6 on 8 CPU scenes.
LOSS_RTOL = 1e-5
# a hundredth of an Adam step: the updates differ by the bias corrections
# (float32 on the port, float64 in the reference: 2.6e-5 of a step) and by
# gradients summed in other orders; read at most 7.7e-4 of a step on the CPU
STEP_FRACTION = 0.01
# the share of values allowed past that: an Adam step follows its gradient's
# sign, so a value whose gradient lies within rounding of zero moves a whole
# step either way (none on the CPU scenes)
OFF_SHARE = 1e-3
# the stream's PSNR, the port's decode against the frozen decoder's: kernel A
# and the reference's blend sum in other orders, as above (read at most
# 4.7e-4 dB on 13 Kodak coding jobs on the card)
STREAM_DB = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed: int, dev="cpu"):
    """(state, target, config): Gaussians of 1-2.5 pixels, the target the 8-bit
    render of the rows moved by about a third of a pixel and their colours
    by 0.05, so that every grid and row takes a gradient."""
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 5.0, (M, 2))
    xy = rng.uniform(-0.6, 0.6, M) * np.sqrt(var[:, 0] * var[:, 1])
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)
    xyz, cov = t(rng.random((M, 2)) * [W, H]), t(np.stack([var[:, 0], xy, var[:, 1]], -1))
    feat, bound = t(rng.uniform(-0.1, 0.7, (M, 3))), t(np.tile([[1.0, 0.0, 1.0]], (M, 1)))
    active = torch.arange(M, device=dev) < N
    gt = R.to_8bit(R.render_state(xyz + t(rng.normal(0, 0.3, (M, 2))), cov + bound,
                                  feat + t(rng.normal(0, 0.05, (M, 3))), active, H, W))
    state = gi.GaussianState(gi.GaussianParams(xyz, cov, feat), active, bound,
                             torch.tensor(N, dtype=torch.int32, device=dev))
    return state, gt, gi.GaussianConfig(H=H, W=W, max_num_points=M)


def _rows(state):
    p = state.params
    return RQ.rows_of(p.xyz, p.cov2d, p.features, state.active, state.bound)


def _grids(b):
    return RQ.Grids(RQ.Grid(b.xy.scale, b.xy.beta), RQ.Grid(b.cov.cov.scale, b.cov.cov.beta),
                    RQ.Grid(b.color.scale, b.color.beta))


def _adam(o):
    return (o.count, o.mu, o.nu)


def _assert_steps(state, gt, cfg, qcfg, step_fn, steps=3):
    """``steps`` steps of ``step_fn(state, mos, bundle) -> (state, mos,
    bundle, loss)``, each against one reference step from the same carry."""
    bundle = pl.init_quantizers(state, cfg, qcfg)
    mos = tr.make_adam(LR).init(state.params)
    for k in range(steps):
        ref = RQ.follow(_rows(state), _grids(bundle), gt, BITS, LR, 1, _adam(mos),
                        tuple(_adam(o) for o in (bundle.xy_opt, bundle.cov_opt,
                                                 bundle.color_opt)))
        state, mos, bundle, loss = step_fn(state, mos, bundle)
        assert abs(float(loss) - ref.losses[0]) <= LOSS_RTOL * ref.losses[0], (k, loss, ref)
        off = total = 0
        for a, b in zip(state.params, ref.rows):
            off += int(((a - b).abs() > STEP_FRACTION * LR).sum())
            total += a.numel()
        for a, b in zip(_grids(bundle), ref.grids):
            for x, y in zip(a, b):
                off += int(((x - y).abs() > STEP_FRACTION * qcfg.quant_lr).sum())
                total += x.numel()
        assert off <= OFF_SHARE * total, (k, off, total)
    return state, bundle


def _assert_encoding(state, bundle, gt, cfg, qcfg):
    enc = pl.compress_wo_ec(bundle, state, cfg, qcfg)
    ref = RQ.encode(_rows(state), _grids(bundle), BITS)
    keep = enc.active.cpu().numpy()
    np.testing.assert_array_equal(keep, ref.keep)
    for got, want in ((enc.quant_means, ref.xy), (enc.quant_cov, ref.cov),
                      (enc.color_codes, ref.color)):
        np.testing.assert_array_equal(got.cpu().numpy()[keep].astype(np.int64), want)
    assert float(enc.log_state.beta) == ref.log_beta
    assert float(enc.log_state.scale) == ref.log_scale
    data = bs.serialize_bitstream(bundle, enc, cfg, qcfg)
    assert RQ.code_misses(data, _rows(state), _grids(bundle), BITS, cfg.H, cfg.W) == 0
    img, _ = bs.decode_bitstream(data, device=gt.device)
    assert abs(float(psnr(img, gt)) - RQ.stream_psnr(data, gt)) <= STREAM_DB


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_init_quantizers_matches_the_reference(seed):
    state, _, cfg = _scene(seed)
    got = _grids(pl.init_quantizers(state, cfg, pl.QuantConfig()))
    want = RQ.init_grids(_rows(state), BITS)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert RQ.grid_gap(got, want) == 0.0


def _eager_step(gt, cfg, qcfg):
    def step(state, mos, bundle):
        state, mos, bundle, m = pl.quant_train_chunk(state, mos, bundle, gt, cfg, qcfg, LR, 1)
        return state, mos, bundle, m["loss"][0]

    return step


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_train_chunk_steps_match_the_reference(seed):
    state, gt, cfg = _scene(seed)
    qcfg = pl.QuantConfig()
    _assert_steps(state, gt, cfg, qcfg, _eager_step(gt, cfg, qcfg))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codes_and_bytes_match_the_reference(seed):
    state, gt, cfg = _scene(seed)
    qcfg = pl.QuantConfig()
    state, bundle = _assert_steps(state, gt, cfg, qcfg, _eager_step(gt, cfg, qcfg), steps=1)
    _assert_encoding(state, bundle, gt, cfg, qcfg)


def test_a_moved_code_and_an_altered_grid_are_misses():
    """``code_misses`` counts what it is meant to: one moved code is one
    miss, one altered grid value one more."""
    state, _, cfg = _scene(3)
    qcfg = pl.QuantConfig()
    bundle = pl.init_quantizers(state, cfg, qcfg)
    enc = pl.compress_wo_ec(bundle, state, cfg, qcfg)
    codes = enc.quant_means.clone()
    codes[0, 1] += 1.0 if float(codes[0, 1]) < 4095 else -1.0
    moved = bs.serialize_bitstream(bundle, enc._replace(quant_means=codes), cfg, qcfg)
    assert RQ.code_misses(moved, _rows(state), _grids(bundle), BITS, H, W) == 1
    wide = bundle._replace(color=bundle.color._replace(scale=bundle.color.scale * 1.001))
    both = bs.serialize_bitstream(wide, enc._replace(quant_means=codes), cfg, qcfg)
    assert RQ.code_misses(both, _rows(state), _grids(bundle), BITS, H, W) == 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kodim01(dev):
    s = np.load(KODIM01)
    t = lambda k: torch.as_tensor(s[k]).to(dev)
    state = gi.GaussianState(gi.GaussianParams(t("xyz").float(), t("cov2d").float(),
                                               t("features").float()),
                             t("active").bool(), t("bound").float(),
                             torch.tensor(int(s["active"].sum()), dtype=torch.int32, device=dev))
    cfg = gi.GaussianConfig(H=int(s["H"]), W=int(s["W"]), max_num_points=s["xyz"].shape[0])
    p = state.params
    gt = R.to_8bit(R.render_state(p.xyz, p.cov2d + state.bound, p.features, state.active,
                                  cfg.H, cfg.W))
    return state, gt, cfg


@pytest.mark.cuda
def test_graphed_qat_steps_and_stream_match_the_reference_on_the_card(card):
    state, gt, cfg = _kodim01(card)
    assert tr.captures(cfg, card) and gi.resolve_backend(cfg, card) == "list_t"
    qcfg = pl.QuantConfig()
    got = _grids(pl.init_quantizers(state, cfg, qcfg))
    assert RQ.grid_gap(got, RQ.init_grids(_rows(state), BITS)) == 0.0

    def graphed(s, mos, bundle):
        s, mos, bundle, m = pl.quant_train_macro_chunk(s, mos, bundle, gt, cfg, qcfg, LR, 1, 1)
        return s, mos, bundle, m["loss"][0]

    state, bundle = _assert_steps(state, gt, cfg, qcfg, graphed)
    _assert_encoding(state, bundle, gt, cfg, qcfg)
