"""A frozen plain decoder of ``.gipb`` streams (format versions 1 and 2).

Written from the format: header, quantizer grids, bit-packed xy codes, then
the covariance and colour streams, each rANS-coded under a categorical or a
global-Gaussian model behind a one-byte tag. The rANS decoder is 32-bit
state streaming rANS with 16-bit words and probabilities normalized to
2^16 (the counts' deterministic normalization: floor shares, each nonzero
count at least 1, the drift on the largest share, scanned from the last
nonzero symbol and taken over only by a strictly larger one). Dequantizing
follows the codec: uniform ``code * scale + beta`` in float32, variances
``exp(code * scale + beta)`` with the argument in float32 and the ``exp`` in
float64 rounded once, VQ colours the sum of the layers' codebook rows.

Numpy and the standard library only; malformed input raises ``ValueError``.
"""

from __future__ import annotations

import struct
from math import erf, sqrt
from typing import NamedTuple

import numpy as np

MAGIC = b"GIPB"
_HEADER = "<BBBBBBBxIIII"
_DTYPES = {0: np.uint8, 1: np.uint16, 2: np.uint32, 3: np.int8, 4: np.int16, 5: np.int32}
PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 16


class Gaussians(NamedTuple):
    """Decoded rows in float32 numpy: means [n, 2] in pixels, effective
    covariances [n, 3], colours [n, 3]; the image size and tile cap."""

    xy: np.ndarray
    cov: np.ndarray
    colors: np.ndarray
    H: int
    W: int
    cap: int


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"malformed stream: {what}")


def normalize(counts: np.ndarray):
    counts = [int(c) for c in counts]
    total = sum(counts)
    _need(total > 0, "empty counts")
    freq = [0] * len(counts)
    assigned = 0
    for i, c in enumerate(counts):
        if c:
            f = max(c * PROB_SCALE // total, 1)
            freq[i] = f
            assigned += f
    drift = PROB_SCALE - assigned
    if drift:
        # the last nonzero symbol, unless an earlier one is strictly larger
        big = max(i for i, c in enumerate(counts) if c)
        for i, f in enumerate(freq):
            if f > freq[big]:
                big = i
        _need(freq[big] + drift >= 1, "degenerate counts")
        freq[big] += drift
    cum = np.concatenate([[0], np.cumsum(freq)]).astype(np.int64)
    return np.asarray(freq, np.int64), cum


def rans_decode(words: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    freq, cum = normalize(counts)
    lut = np.repeat(np.arange(len(freq)), freq)
    w = words.astype(np.int64).tolist()
    _need(len(w) >= 2, "rANS stream too short")
    state = (w[0] << 16) | w[1]
    pos = 2
    out = np.empty(n, np.int64)
    f, c, lt = freq.tolist(), cum.tolist(), lut.tolist()
    mask = PROB_SCALE - 1
    for j in range(n):
        slot = state & mask
        s = lt[slot]
        out[j] = s
        state = f[s] * (state >> PROB_BITS) + slot - c[s]
        while state < RANS_L and pos < len(w):
            state = ((state << 16) | w[pos]) & 0xFFFFFFFF
            pos += 1
    return out


def gaussian_counts(mean: float, std: float, vmin: int, vmax: int) -> np.ndarray:
    def cdf(x):
        return 0.5 * (1.0 + erf((x - mean) / (std * sqrt(2.0))))

    pmf = np.array([max(cdf(s + 0.5) - cdf(s - 0.5), 1e-12) for s in range(vmin, vmax + 1)])
    return np.maximum((pmf / pmf.sum() * (1 << 16)).astype(np.uint32), 1)


class _Reader:
    def __init__(self, buf: bytes, off: int):
        self.buf, self.off = buf, off

    def take(self, fmt: str):
        size = struct.calcsize(fmt)
        _need(self.off + size <= len(self.buf), "truncated")
        v = struct.unpack_from(fmt, self.buf, self.off)
        self.off += size
        return v

    def array(self, dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype)
        _need(self.off + count * dt.itemsize <= len(self.buf), "truncated")
        a = np.frombuffer(self.buf, dt, count, self.off).copy()
        self.off += count * dt.itemsize
        return a


def _stream(r: _Reader, version: int) -> np.ndarray:
    (tag,) = r.take("<B")
    if tag == 0:
        n, n_unique, dtag = r.take("<IIB")
        _need(dtag in _DTYPES and 0 < n_unique <= n, "categorical header")
        unique = r.array(_DTYPES[dtag], n_unique).astype(np.int64)
        counts = r.array(np.uint32, n_unique)
        (n_words,) = r.take("<I")
        words = r.array(np.uint16, n_words)
        _need(int(counts.sum()) == n, "categorical counts")
        return unique[rans_decode(words, counts, n)]
    _need(tag == 1, f"stream tag {tag}")
    if version == 1:
        n, mean, std, vmin, vmax, n_words = r.take("<IffiiI")
        counts = gaussian_counts(mean, std, vmin, vmax)
    else:
        n, vmin, vmax, n_words = r.take("<IiiI")
        counts = r.array(np.uint16, vmax - vmin + 1).astype(np.uint32)
    words = r.array(np.uint16, n_words)
    return rans_decode(words, counts, n) + vmin


def _bits(r: _Reader, count: int, bits: int) -> np.ndarray:
    raw = r.array(np.uint8, (count * bits + 7) // 8)
    flat = np.unpackbits(raw, bitorder="little")[:count * bits].reshape(count, bits)
    return (flat.astype(np.int64) << np.arange(bits)).sum(axis=1)


def decode(buf: bytes) -> Gaussians:
    _need(buf[:4] == MAGIC, "magic")
    r = _Reader(buf, 4)
    (version, _param, xy_mode, color_mode, xy_bit, _cov_bit, _color_bit,
     H, W, n, cap) = r.take(_HEADER)
    _need(version in (1, 2) and xy_mode in (0, 1) and color_mode in (0, 1), "header")
    f32 = lambda k: r.array(np.float32, k)
    if xy_mode == 0:
        xy_scale, xy_beta = f32(2), f32(2)
    log_beta, log_scale = f32(1)[0], f32(1)[0]
    mid_scale, mid_beta = f32(1), f32(1)
    if color_mode == 1:
        layers, K, D = r.take("<HHH")
        books = [f32(K * D).reshape(K, D) for _ in range(layers)]
    else:
        col_scale, col_beta = f32(3), f32(3)
    if xy_mode == 1:
        xy = r.array(np.float16, n * 2).astype(np.float32).reshape(n, 2)
    else:
        xy = _bits(r, n * 2, xy_bit).astype(np.float32).reshape(n, 2) * xy_scale + xy_beta
    cov_codes = _stream(r, version).astype(np.float32).reshape(n, 3)
    col = _stream(r, version)
    var = np.exp((cov_codes[:, ::2] * log_scale + log_beta).astype(np.float64)).astype(np.float32)
    mid = cov_codes[:, 1:2] * mid_scale + mid_beta
    cov = np.concatenate([var[:, :1], mid, var[:, 1:]], axis=1)
    if color_mode == 1:
        idx = col.reshape(n, len(books))
        colors = books[0][idx[:, 0]]
        for i in range(1, len(books)):
            colors = colors + books[i][idx[:, i]]
    else:
        colors = col.astype(np.float32).reshape(n, 3) * col_scale + col_beta
    return Gaussians(xy=xy.astype(np.float32), cov=cov.astype(np.float32),
                     colors=colors.astype(np.float32), H=H, W=W, cap=cap if cap else 256)
