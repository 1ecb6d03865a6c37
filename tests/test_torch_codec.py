"""Port codec (``compress/``) against the JAX package on every committed
``.gipb`` stream (``results/bitstreams*/``: lsq and VQ colour, format v1 and
v2): deserialized codes and grids equal; the port's serializer
reproduces each v2 stream byte for byte; dequantized attributes to rtol 1e-6
(``exp`` may differ by an ulp between the two libraries).
"""

import glob
import math
import os
import struct

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


def _coded_stream_ends(data, off):
    """Byte offsets past one coded stream's tag, header, tables and words (v2)."""
    tag, off = data[off], off + 1
    ends = [off]
    if tag == 0:
        _, n_unique, dtag = struct.unpack_from("<IIB", data, off)
        off += 9
        ends.append(off)
        off += n_unique * (np.dtype(tbs._DTYPE_TAGS[dtag]).itemsize + 4)
        (n_words,) = struct.unpack_from("<I", data, off)
        off += 4
    else:
        _, vmin, vmax, n_words = struct.unpack_from("<IiiI", data, off)
        off += 16
        ends.append(off)
        off += (vmax - vmin + 1) * 2
    ends.append(off)
    return ends + [off + n_words * 2]


def _field_ends(data):
    """Byte offsets past each field of a v2 ``.gipb`` stream (header, grids,
    codebooks, the xy block, each coded stream's parts), read with ``struct``
    alone, and the xy block's (start, end)."""
    (_, _, xy_mode, color_mode, xy_bit, _, _, _, _, n, _) = struct.unpack_from(tbs._HEADER, data, 4)
    off = 4 + struct.calcsize(tbs._HEADER)
    ends = [off]
    off += 16 if xy_mode == tbs._XY_MODES["lsq"] else 0
    ends += [off, off + 16]
    off += 16
    if color_mode == tbs._COLOR_MODES["vq"]:
        n_layers, K, D = struct.unpack_from("<HHH", data, off)
        off += 6
        ends.append(off)
        off += n_layers * K * D * 4
    else:
        off += 24
    ends.append(off)
    xy = (off, off + (n * 4 if xy_mode == tbs._XY_MODES["fp16"] else (2 * n * xy_bit + 7) // 8))
    ends.append(xy[1])
    cov = _coded_stream_ends(data, xy[1])
    return ends + cov + _coded_stream_ends(data, cov[-1]), xy


def test_malformed_streams_raise():
    """A wrong magic, a stream cut anywhere (inside the header, at each
    field's end, inside the bit-packed xy block and inside the last coded
    stream), a row count or xy bit width no stream can hold, and a coded
    stream of another length than its field's raise ``ValueError``."""
    data = open(STREAMS[0], "rb").read()
    with pytest.raises(ValueError):
        tbs.deserialize_bitstream(b"NOPE" + data[4:], device="cpu")
    for cut in (20, 40, len(data) // 2, len(data) - 3):
        with pytest.raises(ValueError):
            tbs.deserialize_bitstream(data[:cut], device="cpu")
    for name in ("bitstreams_r4/kodim01.gipb", "bitstreams_vq_r5/kodim01.gipb"):
        data = open(os.path.join(ROOT, "results", name), "rb").read()
        ends, (xy_start, xy_end) = _field_ends(data)
        assert ends[-1] == len(data) and ends == sorted(ends), (name, ends)
        for cut in sorted(set(ends[:-1]) | {(xy_start + xy_end) // 2}):
            with pytest.raises(ValueError):
                tbs.deserialize_bitstream(data[:cut], device="cpu")
        tbs.deserialize_bitstream(data, device="cpu")
        # header fields no parse takes: 2**30 rows and an xy bit width of 0
        # (no bytes for any row count), which would size the staging buffer
        # past any stream, and an xy bit width past what the window holds
        header = struct.unpack_from(tbs._HEADER, data, 4)
        for field, value, what in ((9, 1 << 30, "row count"), (4, 0, "xy bit width 0"),
                                   (4, 58, "xy bit width 58")):
            bad = header[:field] + (value,) + header[field + 1:]
            with pytest.raises(ValueError, match=what):
                tbs.deserialize_bitstream(data[:4] + struct.pack(tbs._HEADER, *bad)
                                          + data[4 + struct.calcsize(tbs._HEADER):], device="cpu")
    # a coded stream of another length than its field's
    vals = np.arange(30) % 7
    for tag, packed in ((b"\x00", tbs._pack_categorical(vals)), (b"\x01", tbs._pack_gaussian(vals))):
        buf = tag + packed
        tbs._unpack_stream(buf, 0, np.empty(30, np.float32), "covariance")
        with pytest.raises(ValueError, match="covariance stream length"):
            tbs._unpack_stream(buf, 0, np.empty(29, np.float32), "covariance")


@pytest.mark.parametrize("bits", list(range(1, 28)) + [33, 57])
def test_bit_unpack_round_trips(bits):
    """``_unpack_bits`` inverts ``_pack_bits`` at every width its 8-byte
    window holds, up to 57 bits. Code counts end on every bit
    offset of the last byte and at every code of a group of 8; a stream
    offset, set bits past the last code and the bytes after the block change
    nothing; a block cut short raises ``ValueError``."""
    rng = np.random.default_rng(bits)
    counts = list(range(1, 17)) + [1000 + k for k in range(8)]
    assert {c * bits % 8 for c in counts} == set(range(0, 8, math.gcd(bits, 8)))
    for count in counts:
        vals = rng.integers(0, 1 << bits, count, dtype=np.uint64)
        vals[0] = (1 << bits) - 1
        packed = bytearray(tbs._pack_bits(vals, bits))
        assert len(packed) == (count * bits + 7) // 8
        if count * bits % 8:
            packed[-1] |= 0xFF << (count * bits % 8) & 0xFF
        buf = b"\xAA" * 5 + bytes(packed) + b"\xFF" * 7
        out = np.zeros(count, np.uint64)
        assert tbs._unpack_bits(buf, 5, out, bits) == 5 + len(packed)
        np.testing.assert_array_equal(out, vals, err_msg=f"{bits} bits, {count} codes")
        with pytest.raises(ValueError):
            tbs._unpack_bits(bytes(packed[:-1]), 0, out, bits)


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
