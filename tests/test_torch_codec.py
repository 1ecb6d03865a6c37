"""Port codec (``compress/``) against the JAX package on every committed
``.gipb`` stream (``results/bitstreams*/``: lsq and VQ colour, format v1 and
v2): deserialized codes and grids equal; the port's serializer
reproduces each v2 stream byte for byte; dequantized attributes to rtol 1e-6
(``exp`` may differ by an ulp between the two libraries).
"""

import glob
import os

import numpy as np
import pytest
import torch

from gaussianimage_plus_tpu.compress.bitstream import deserialize_bitstream as jax_deserialize
from gaussianimage_plus_tpu.compress.pipeline import _decode_attributes as jax_decode_attributes

from gaussianimage_plus_tpu_torch.compress import bitstream as tbs
from gaussianimage_plus_tpu_torch.compress import entropy
from gaussianimage_plus_tpu_torch.compress.pipeline import _decode_attributes
from gaussianimage_plus_tpu_torch.interop import bundle_from_numpy, encoding_from_numpy
from gaussianimage_plus_tpu_torch.models.gaussian_image import GaussianConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = sorted(glob.glob(os.path.join(ROOT, "results", "bitstreams*", "*.gipb")))
IDS = [f"{os.path.basename(os.path.dirname(p))}-{os.path.basename(p)[:-5]}" for p in STREAMS]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tree_equal(a, b, what):
    """Equal leaves of two NamedTuple trees (port tensors vs JAX arrays)."""
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if hasattr(a, "_fields"):
        for f in a._fields:
            if f in ("cluster_size",):
                continue
            _assert_tree_equal(getattr(a, f), getattr(b, f), f"{what}.{f}")
        return
    if isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{what}[{i}]")
        return
    x, y = _np(a), _np(b)
    assert x.dtype == y.dtype, f"{what}: {x.dtype} vs {y.dtype}"
    np.testing.assert_array_equal(x, y, err_msg=what)


@pytest.mark.parametrize("path", STREAMS, ids=IDS)
def test_stream_round_trip(path):
    data = open(path, "rb").read()
    dj = jax_deserialize(data)
    dt = tbs.deserialize_bitstream(data, device="cpu")
    assert (dt.H, dt.W, dt.bpp, dt.qcfg.decode_cap) == (dj.H, dj.W, dj.bpp, dj.qcfg.decode_cap)
    for f in ("xy_bit", "cov_bit", "color_bit", "xy_quant", "color_quant"):
        assert getattr(dt.qcfg, f) == getattr(dj.qcfg, f), f
    _assert_tree_equal(dt.enc, dj.enc, "enc")
    for f in ("xy", "cov", "color", "color_vq"):
        _assert_tree_equal(getattr(dt.bundle, f), getattr(dj.bundle, f), f"bundle.{f}")
    np.testing.assert_array_equal(dt.bound.numpy(), np.asarray(dj.bound))

    if data[4] == tbs.VERSION:
        cfg = GaussianConfig(H=dt.H, W=dt.W, max_num_points=dt.enc.active.shape[0],
                             tile_cap=dt.qcfg.decode_cap)
        assert tbs.serialize_bitstream(dt.bundle, dt.enc, cfg, dt.qcfg) == data

    # dequantized attributes, from the port's own parse and from interop
    ref = [np.asarray(a) for a in jax_decode_attributes(dj.bundle, dj.enc, dj.qcfg)]
    for enc, bundle in ((dt.enc, dt.bundle),
                        (encoding_from_numpy(dj.enc, "cpu"), bundle_from_numpy(dj.bundle, "cpu"))):
        for name, a, b in zip(("means", "cov", "colors"),
                              _decode_attributes(bundle, enc, dt.qcfg), ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=0, err_msg=name)


def test_malformed_streams_raise():
    data = open(STREAMS[0], "rb").read()
    with pytest.raises(ValueError):
        tbs.deserialize_bitstream(b"NOPE" + data[4:], device="cpu")
    for cut in (20, 40, len(data) // 2, len(data) - 3):
        with pytest.raises(ValueError):
            tbs.deserialize_bitstream(data[:cut], device="cpu")


def test_rans_matches_jax_coder():
    from gaussianimage_plus_tpu.compress import entropy as jax_entropy

    rng = np.random.default_rng(0)
    vals = np.rint(rng.normal(3.0, 9.0, 4000)).astype(np.int64)
    for fn in ("compress_categorical", "compress_gaussian"):
        for x, y in zip(getattr(entropy, fn)(vals), getattr(jax_entropy, fn)(vals)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=fn)
    words, counts, unique = entropy.compress_categorical(vals)
    back = entropy.decompress_categorical(words, counts, unique, vals.size, vals.shape)
    np.testing.assert_array_equal(back, vals)


def test_quantizer_decoders_match_jax():
    from gaussianimage_plus_tpu.compress import quantizers as jq
    from gaussianimage_plus_tpu_torch.compress import quantizers as tq

    for bits, signed in ((6, False), (10, True), (12, False)):
        assert tq.uniform_qrange(bits, signed) == jq.uniform_qrange(bits, signed)
    rng = np.random.default_rng(5)
    code = np.rint(rng.uniform(0, 1023, (300, 3))).astype(np.float32)
    scale, beta = np.float32([0.02]), np.float32([-3.0])
    lscale, lbeta = np.float32(0.011), np.float32(-2.5)
    ref = jq.hybrid_decompress(
        jq.HybridQuantParams(cov=jq.UniformQuantParams(scale=scale, beta=beta)),
        jq.LogQuantState(beta=lbeta, scale=lscale), code)
    out = tq.hybrid_decompress(
        tq.HybridQuantParams(cov=tq.UniformQuantParams(scale=torch.as_tensor(scale),
                                                       beta=torch.as_tensor(beta))),
        tq.LogQuantState(beta=torch.as_tensor(lbeta), scale=torch.as_tensor(lscale)),
        torch.as_tensor(code))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=0)


def test_log_decompress_first_in_a_fresh_process_is_rounded_float64():
    """The log decoder is the first ``exp`` of fresh processes, as in a test
    worker's first stream: each result equals float64 ``exp`` rounded to
    float32 bit for bit (``utils/exp_drift.py`` reproduces the float32 drift
    this guards against)."""
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "gaussianimage_plus_tpu_torch.utils.exp_drift",
                          "--op", "log_decompress", "--runs", "3", "--jobs", "3"],
                         capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).stdout
    lines = [json.loads(s) for s in out.strip().splitlines()]
    assert [r["error"] for r in lines[:-1]] == [0.0, 0.0, 0.0]
    assert lines[-1]["drifted"] == 0
