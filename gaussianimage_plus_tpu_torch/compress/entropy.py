"""Entropy coding: native rANS streams (host side, numpy).

Port of ``gaussianimage_plus_tpu/compress/entropy.py``. The coder is the
port's own copy of the JAX package's ``native/rans.cpp``
(``gaussianimage_plus_tpu_torch/native/rans.cpp``), built with ``g++`` at
first use into ``build/torch_native/`` at the repository root (git ignores
it), named by a hash of the source; the JAX package's ``native/`` directory
is never touched. Two models, as in the reference (utils.py:61-110):
categorical over the symbol histogram with dtype-minimized unique values, and
the global quantized Gaussian over an integer support.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from math import erf, sqrt
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils.profiling import span

_SRC = Path(__file__).resolve().parent.parent / "native" / "rans.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_native"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_lib_cache: list = []
_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    with _lock:
        if _lib_cache:
            return _lib_cache[0]
        h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
        so = _BUILD_DIR / f"librans_{h}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.rans_encode.restype = ctypes.c_long
        lib.rans_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_long]
        lib.rans_decode.restype = ctypes.c_int
        lib.rans_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
        _lib_cache.append(lib)
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _minimized_dtype(vmin: int, vmax: int):
    """Smallest integer dtype holding [vmin, vmax] (reference judege_type,
    utils.py:46-60, with its vmax == 256 -> uint8 off-by-one fixed)."""
    if vmin >= 0:
        if vmax <= 255:
            return np.uint8
        if vmax <= 65535:
            return np.uint16
        return np.uint32
    if vmax < 128 and vmin >= -128:
        return np.int8
    if vmax < 32768 and vmin >= -32768:
        return np.int16
    return np.int32


def encode_rans(messages: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Encode an index stream against a histogram -> u16 stream words."""
    msgs = np.ascontiguousarray(messages, dtype=np.int32)
    cts = np.ascontiguousarray(counts, dtype=np.uint32)
    cap = 2 * msgs.size + 16
    out = np.empty(cap, dtype=np.uint16)
    with span("encode.entropy"):
        n = _lib().rans_encode(_ptr(msgs, ctypes.c_int32), msgs.size,
                               _ptr(cts, ctypes.c_uint32), cts.size,
                               _ptr(out, ctypes.c_uint16), cap)
    if n < 0:
        raise ValueError("rans_encode failed (capacity or bad symbol)")
    return out[:n].copy()


def decode_rans(words: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    ws = np.ascontiguousarray(words, dtype=np.uint16)
    cts = np.ascontiguousarray(counts, dtype=np.uint32)
    out = np.empty(n, dtype=np.int32)
    with span("decode.entropy"):
        rc = _lib().rans_decode(_ptr(ws, ctypes.c_uint16), ws.size,
                                _ptr(cts, ctypes.c_uint32), cts.size,
                                _ptr(out, ctypes.c_int32), n)
    if rc != 0:
        raise ValueError("rans_decode failed")
    return out


def compress_categorical(matrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(compressed_words, histogram, unique_values) — utils.py:61-77."""
    flat = np.asarray(matrix).reshape(-1)
    unique, inverse, counts = np.unique(flat, return_inverse=True, return_counts=True)
    unique = unique.astype(_minimized_dtype(int(unique.min()), int(unique.max())))
    words = encode_rans(inverse.astype(np.int32), counts.astype(np.uint32))
    return words, counts.astype(np.int64), unique


def decompress_categorical(words, counts, unique, length, shape) -> np.ndarray:
    """utils.py:79-89."""
    idx = decode_rans(np.asarray(words), np.asarray(counts), int(length))
    return np.asarray(unique)[idx].reshape(shape)


def categorical_bits(matrix) -> int:
    """Size in bits of the categorical stream with its histogram and unique
    table (the reference's get_np_size accounting, quantize.py:300-304)."""
    words, counts, unique = compress_categorical(matrix)
    return int(words.size * words.itemsize * 8 + counts.size * counts.itemsize * 8
               + unique.size * unique.itemsize * 8)


def gaussian_counts(mean: float, std: float, vmin: int, vmax: int) -> np.ndarray:
    """Discretized-Gaussian histogram over the integer support [vmin, vmax]
    (utils.py:94-110), deterministic in its four scalars."""
    support = np.arange(vmin, vmax + 1)

    def cdf(x):
        return 0.5 * (1.0 + erf((x - mean) / (std * sqrt(2.0))))

    pmf = np.array([max(cdf(s + 0.5) - cdf(s - 0.5), 1e-12) for s in support])
    return np.maximum((pmf / pmf.sum() * (1 << 16)).astype(np.uint32), 1)


def compress_gaussian(matrix):
    """(words, mean_f32, std_f32, vmin, vmax) under the global-Gaussian
    model; mean/std are rounded to f32 before the table is built."""
    flat = np.asarray(matrix, dtype=np.float64).reshape(-1)
    mean = float(np.float32(flat.mean()))
    std = float(np.float32(np.clip(flat.std(ddof=1) if flat.size > 1 else 1.0, 1e-5, 1e10)))
    vmin = int(np.floor(flat.min()))
    vmax = int(np.ceil(flat.max()))
    if vmin == vmax:
        vmax = vmin + 1
    counts = gaussian_counts(mean, std, vmin, vmax)
    symbols = (np.rint(flat).astype(np.int64) - vmin).astype(np.int32)
    return encode_rans(symbols, counts), mean, std, vmin, vmax


def decompress_gaussian(words, mean: float, std: float, vmin: int, vmax: int,
                        n: int) -> np.ndarray:
    counts = gaussian_counts(mean, std, vmin, vmax)
    return decode_rans(words, counts, n).astype(np.int64) + vmin


def gaussian_global_bits(matrix) -> int:
    """Size in bits of the stream under the global quantized-Gaussian model
    (the reference uses only this size, for ``bpp_wc``; train_quantize.py:250-252)."""
    words, *_ = compress_gaussian(matrix)
    return int(words.size * 16)
