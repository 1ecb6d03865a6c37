"""Port encoder (``compress/pipeline.py``) against the JAX package on all 48
committed fitted states (``results/repr_states_{cn,plain}/*.npz``).

``init_quantizers`` -> ``compress_wo_ec`` -> ``analysis_wo_ec`` ->
``serialize_bitstream`` in both packages from the same state:

- the active mask equals exactly;
- every float32 grid is within 1 ulp of JAX's: the log grid because the port
  takes the ``log`` in float64 rounded once where XLA takes it in float32 (an
  ulp apart at ~7% of the elements), a uniform grid where ``sigmoid`` or, at
  ``init_percentile < 100``, the percentile's interpolation rounds
  differently;
- the codes equal, except where JAX's code argument lies within a
  half-integer by less than what one ulp of the input, of the grid's beta and
  of its scale move it (~1e-4 at 10 bits): only there can those ulps round a
  code the other way (the uniform codes of equal grids are the same float32
  operations, so they equal exactly);
- the bpp accounting equals;
- the ``.gipb`` equals JAX's byte for byte; where a grid differs by its ulp,
  or a log code at a half-integer tie, it equals once JAX's grids and those
  codes are substituted (the test records which in ``substituted``).

Also ``init_percentile=99`` on four states and the VQ colour init with JAX's
first k-means centres (``init_indices``) on two: codebooks to rtol 1e-6 of
their largest entry (the centroid sums run in another order), indices equal.
"""

import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gaussianimage_plus_tpu.compress import bitstream as jbs
from gaussianimage_plus_tpu.compress import pipeline as jp
from gaussianimage_plus_tpu.models import gaussian_image as jgi

from gaussianimage_plus_tpu_torch.compress import bitstream as tbs
from gaussianimage_plus_tpu_torch.compress import pipeline as tp
from gaussianimage_plus_tpu_torch.interop import config_from_numpy, state_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 48 fitted 768x512 states (repr_states_2k holds the 2040x1344 one)
STATES = sorted(p for d in ("repr_states_cn", "repr_states_plain")
                for p in glob.glob(os.path.join(ROOT, "results", d, "*.npz")))
IDS = [f"{os.path.basename(os.path.dirname(p))[12:]}-{os.path.basename(p)[:-4]}" for p in STATES]
PARAMS = ("xyz", "cov2d", "features")


def _states(path):
    d = dict(np.load(path))
    ct = config_from_numpy(d)
    st = state_from_numpy(d, device="cpu")
    cj = jgi.GaussianConfig(H=ct.H, W=ct.W, max_num_points=ct.max_num_points,
                            color_norm=ct.color_norm, tile_cap=ct.tile_cap)
    sj = jgi.GaussianState(
        params=jgi.GaussianParams(**{k: jnp.asarray(getattr(st.params, k).numpy()) for k in PARAMS}),
        active=jnp.asarray(st.active.numpy()), bound=jnp.asarray(st.bound.numpy()),
        num_active=jnp.asarray(int(st.num_active), jnp.int32))
    return st, ct, sj, cj


def _ulps(a, b) -> int:
    a, b = np.atleast_1d(np.float32(a)), np.atleast_1d(np.float32(b))
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def _grids(bundle, enc):
    """Every float32 grid of an encoding, by name."""
    g = {"xy.scale": bundle.xy.scale, "xy.beta": bundle.xy.beta,
         "cov.scale": bundle.cov.cov.scale, "cov.beta": bundle.cov.cov.beta,
         "color.scale": bundle.color.scale, "color.beta": bundle.color.beta,
         "log.beta": enc.log_state.beta, "log.scale": enc.log_state.scale}
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in g.items()}


def _encode_both(path, **qkw):
    st, ct, sj, cj = _states(path)
    qj, qt = jp.QuantConfig(**qkw), tp.QuantConfig(**qkw)
    bj = jp.init_quantizers(sj, cj, qj)
    ej = jp.compress_wo_ec(bj, sj, cj, qj)
    bt = tp.init_quantizers(st, ct, qt)
    et = tp.compress_wo_ec(bt, st, ct, qt)
    return (st, ct, qt, bt, et), (sj, cj, qj, bj, ej)


def _tie_differences(code_t, code_j, x, beta, scale):
    """Where the port's codes differ from JAX's, asserting each lies at a
    half-integer tie of JAX's argument ``(x - beta) / scale``: within what
    one ulp of ``x``, of ``beta`` and of ``scale`` moves it."""
    arg = (x - beta) / scale
    tol = 2 * ((np.spacing(np.abs(x)) + np.spacing(np.abs(beta))) / scale
               + np.abs(arg) * np.spacing(scale) / scale)
    near_half = np.abs(arg - np.floor(arg) - 0.5) <= tol
    differ = code_t != code_j
    assert not (differ & ~near_half).any(), "a code differs away from a half-integer tie"
    return differ


def _check_encoding(t, j, record):
    st, ct, qt, bt, et = t
    sj, cj, qj, bj, ej = j
    np.testing.assert_array_equal(et.active.numpy(), np.asarray(ej.active))
    assert int(et.num_active) == int(ej.num_active)
    gt_, gj_ = _grids(bt, et), _grids(bj, ej)
    worst = {k: _ulps(gt_[k], gj_[k]) for k in gj_}
    assert max(worst.values()) <= 1, worst
    # JAX's code arguments from its own grids: the log codes take the log of
    # the effective variances (XLA's float32 log, an ulp from the port's)
    eff = np.asarray(jgi.effective_cov2d(sj.params, sj.bound, cj))
    codes = {"xy": (et.quant_means, ej.quant_means, np.asarray(sj.params.xyz), "xy"),
             "cov": (et.quant_cov[:, 1:2], ej.quant_cov[:, 1:2], eff[:, 1:2], "cov"),
             "log": (et.quant_cov[:, ::2], ej.quant_cov[:, ::2],
                     np.asarray(jnp.log(jnp.abs(jnp.asarray(eff[:, ::2])) + 1e-6)), "log")}
    if qt.color_quant == "vq":
        np.testing.assert_array_equal(et.color_codes.numpy(), np.asarray(ej.color_codes))
    else:
        codes["color"] = (et.color_codes, ej.color_codes,
                          np.asarray(jgi.colors_of(sj.params, cj)), "color")
    differ = {k: _tie_differences(a.numpy(), np.asarray(b), x, gj_[f"{g}.beta"], gj_[f"{g}.scale"])
              for k, (a, b, x, g) in codes.items()}
    assert tp.analysis_wo_ec(et, ct, qt, bt) == jp.analysis_wo_ec(ej, cj, qj, bj)

    data_j = jbs.serialize_bitstream(bj, ej, cj, qj)
    data_t = tbs.serialize_bitstream(bt, et, ct, qt)
    if data_t != data_j:
        # substitute JAX's grids, and its codes at the half-integer ties
        sub = lambda t_, j_: torch.as_tensor(np.where(t_.numpy() != np.asarray(j_), np.asarray(j_),
                                                      t_.numpy()))
        tens = lambda k: torch.as_tensor(np.array(gj_[k]))
        et2 = et._replace(quant_means=sub(et.quant_means, ej.quant_means),
                          quant_cov=sub(et.quant_cov, ej.quant_cov),
                          color_codes=sub(et.color_codes, ej.color_codes),
                          log_state=tp.LogQuantState(beta=tens("log.beta"), scale=tens("log.scale")))
        uni = lambda q: tp.UniformQuantParams(scale=tens(f"{q}.scale"), beta=tens(f"{q}.beta"))
        bt2 = bt._replace(xy=uni("xy"), cov=tp.HybridQuantParams(cov=uni("cov")), color=uni("color"))
        if qt.color_quant == "vq":
            bt2 = bt2._replace(color_vq=bj.color_vq)
        assert tbs.serialize_bitstream(bt2, et2, ct, qt) == data_j
        record("substituted", {"grids_off_by_an_ulp": [k for k, u in worst.items() if u],
                               "codes_at_ties": {k: int(v.sum()) for k, v in differ.items()
                                                 if v.any()}})
    else:
        record("substituted", "nothing: byte-identical")
    return data_t


@pytest.mark.parametrize("path", STATES, ids=IDS)
def test_encoder_matches_jax(path, record_property):
    t, j = _encode_both(path)
    data = _check_encoding(t, j, record_property)
    # the port's decoder reads its own stream back to the encoding's codes
    st, ct, qt, bt, et = t
    dec = tbs.deserialize_bitstream(data, device="cpu")
    act = et.active.numpy()
    n = int(act.sum())
    np.testing.assert_array_equal(dec.enc.quant_cov.numpy()[:n], et.quant_cov.numpy()[act])
    np.testing.assert_array_equal(dec.enc.color_codes.numpy()[:n], et.color_codes.numpy()[act])


@pytest.mark.parametrize("path", STATES[::12], ids=IDS[::12])
def test_encoder_percentile_init_matches_jax(path, record_property):
    _check_encoding(*_encode_both(path, init_percentile=99.0), record_property)


@pytest.mark.parametrize("path", [STATES[0], STATES[30]], ids=[IDS[0], IDS[30]])
def test_vq_init_with_jax_draws_matches_jax(path, record_property):
    st, ct, sj, cj = _states(path)
    qj, qt = jp.QuantConfig(color_quant="vq"), tp.QuantConfig(color_quant="vq")
    n = ct.max_num_points
    draws = [torch.as_tensor(np.array(jax.random.choice(
        jax.random.fold_in(jax.random.PRNGKey(0), i), n, (8,), replace=n < 8))) for i in range(2)]
    bj = jp.init_quantizers(sj, cj, qj)
    bt = tp.init_quantizers(st, ct, qt, vq_init_indices=draws)
    for lt, lj in zip(bt.color_vq.layers, bj.color_vq.layers):
        e = np.asarray(lj.embed)
        np.testing.assert_allclose(lt.embed.numpy(), e, rtol=0, atol=1e-6 * np.abs(e).max())
    ej = jp.compress_wo_ec(bj, sj, cj, qj)
    et = tp.compress_wo_ec(bt, st, ct, qt)
    assert et.color_codes.dtype == torch.int32 and et.color_codes.shape == (n, 2)
    _check_encoding((st, ct, qt, bt, et), (sj, cj, qj, bj, ej), record_property)
