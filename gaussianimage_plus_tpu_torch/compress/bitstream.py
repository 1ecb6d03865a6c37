"""Self-contained ``.gipb`` bitstream: bytes <-> codes + side tables -> image.

Port of ``gaussianimage_plus_tpu/compress/bitstream.py`` (``serialize_bitstream``,
``deserialize_bitstream`` for format versions 1 and 2, ``decode_bitstream``).
The byte layout is the JAX package's, so the two packages read each other's
streams and the port's serializer reproduces a v2 stream byte for byte:

  header:  magic 'GIPB', version, param/mode tags, bit widths, H, W,
           n_active, decode_cap
  grids:   xy affine grid (lsq mode), log-variance grid, covariance affine
           grid, colour affine grid or residual-VQ codebooks
  streams: xy (raw fp16 in fp16 mode, fixed-width bit-packed otherwise),
           then covariance and colour, each rANS-coded under the smaller of
           a categorical model and a global-Gaussian model (1-byte tag)

Parsing is host-side numpy; the decoded tensors are placed on the requested
device. Malformed input raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import struct as _struct
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.precision import resolve_device
from .entropy import (compress_categorical, compress_gaussian, decode_rans,
                      decompress_gaussian, gaussian_counts)
from ..models.gaussian_image import GaussianConfig
from ..utils.profiling import count, span
from .pipeline import Encoding, QuantConfig, QuantizerBundle, decompress_wo_ec
from .quantizers import HybridQuantParams, LogQuantState, UniformQuantParams
from .residual_vq import ResidualVQState, VQCodebook

MAGIC = b"GIPB"
VERSION = 2
_HEADER = "<BBBBBBBxIIII"
_XY_MODES = {"lsq": 0, "fp16": 1}
_COLOR_MODES = {"lsq": 0, "vq": 1}
_DTYPE_TAGS = {0: np.uint8, 1: np.uint16, 2: np.uint32,
               3: np.int8, 4: np.int16, 5: np.int32}
_TAG_OF = {np.dtype(v): k for k, v in _DTYPE_TAGS.items()}
# the largest stream is n rows x 3 columns; a bigger length field is corruption
_MAX_SYMS = 1 << 28


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"malformed bitstream: {what}")


def _pack_categorical(values: np.ndarray) -> bytes:
    flat = np.asarray(values).astype(np.int64).reshape(-1)
    words, counts, unique = compress_categorical(flat)
    return b"".join([_struct.pack("<IIB", flat.size, unique.size, _TAG_OF[unique.dtype]),
                     unique.tobytes(), counts.astype(np.uint32).tobytes(),
                     _struct.pack("<I", words.size), words.tobytes()])


def _pack_gaussian(values: np.ndarray) -> bytes:
    """v2 global-Gaussian stream: ships the u16 counts table, since a
    decoder's libm ``erf`` may round differently."""
    flat = np.asarray(values).astype(np.int64).reshape(-1)
    words, mean, std, vmin, vmax = compress_gaussian(flat)
    counts = gaussian_counts(mean, std, vmin, vmax)
    if int(counts.max()) > 0xFFFF:
        raise ValueError(f"gaussian counts overflow u16 (max {int(counts.max())}); "
                         f"support [{vmin}, {vmax}] degenerate")
    return b"".join([_struct.pack("<IiiI", flat.size, vmin, vmax, words.size),
                     counts.astype(np.uint16).tobytes(), words.tobytes()])


def _pack_stream(values: np.ndarray) -> bytes:
    cat, gau = _pack_categorical(values), _pack_gaussian(values)
    return (b"\x00" + cat) if len(cat) <= len(gau) else (b"\x01" + gau)


def _unpack_stream(buf: bytes, off: int, version: int = VERSION,
                   max_syms: int = _MAX_SYMS) -> Tuple[np.ndarray, int]:
    _check(off < len(buf), "truncated before stream tag")
    tag = buf[off]
    off += 1
    if tag == 0:
        _check(off + 9 <= len(buf), "truncated categorical header")
        n_sym, n_unique, dtag = _struct.unpack_from("<IIB", buf, off)
        off += 9
        _check(0 < n_sym <= max_syms, f"categorical n_sym {n_sym}")
        _check(dtag in _DTYPE_TAGS, f"unknown dtype tag {dtag}")
        dt = np.dtype(_DTYPE_TAGS[dtag])
        _check(0 < n_unique <= min(n_sym, 1 << 24), f"categorical n_unique {n_unique}")
        _check(off + n_unique * (dt.itemsize + 4) + 4 <= len(buf),
               "truncated categorical tables")
        unique = np.frombuffer(buf, dt, n_unique, off).copy()
        off += n_unique * dt.itemsize
        counts = np.frombuffer(buf, np.uint32, n_unique, off).copy()
        off += n_unique * 4
        (n_words,) = _struct.unpack_from("<I", buf, off)
        off += 4
        _check(off + n_words * 2 <= len(buf), "truncated categorical words")
        _check(int(counts.sum()) > 0 and int(counts.min()) > 0,
               "categorical counts table has zero entries")
        _check(int(counts.sum()) == n_sym, "categorical counts do not sum to n_sym")
        words = np.frombuffer(buf, np.uint16, n_words, off).copy()
        off += n_words * 2
        idx = decode_rans(words, counts, n_sym)
        _check(bool((idx >= 0).all() and (idx < n_unique).all()),
               "categorical indices out of range")
        return unique.astype(np.int64)[idx], off
    _check(tag == 1, f"unknown stream tag {tag}")
    if version == 1:
        hdr = _struct.calcsize("<IffiiI")
        _check(off + hdr <= len(buf), "truncated gaussian(v1) header")
        n_sym, mean, std, vmin, vmax, n_words = _struct.unpack_from("<IffiiI", buf, off)
        off += hdr
        _check(0 < n_sym <= max_syms, f"gaussian n_sym {n_sym}")
        _check(vmax >= vmin and vmax - vmin < (1 << 20), f"gaussian support [{vmin}, {vmax}]")
        _check(np.isfinite(mean) and np.isfinite(std) and std > 0,
               "gaussian (mean, std) invalid")
        _check(off + n_words * 2 <= len(buf), "truncated gaussian(v1) words")
        words = np.frombuffer(buf, np.uint16, n_words, off).copy()
        off += n_words * 2
        return decompress_gaussian(words, mean, std, vmin, vmax, n_sym), off
    hdr = _struct.calcsize("<IiiI")
    _check(off + hdr <= len(buf), "truncated gaussian header")
    n_sym, vmin, vmax, n_words = _struct.unpack_from("<IiiI", buf, off)
    off += hdr
    _check(0 < n_sym <= max_syms, f"gaussian n_sym {n_sym}")
    _check(vmax >= vmin and vmax - vmin < (1 << 20), f"gaussian support [{vmin}, {vmax}]")
    support = vmax - vmin + 1
    _check(off + support * 2 + n_words * 2 <= len(buf), "truncated gaussian tables/words")
    counts = np.frombuffer(buf, np.uint16, support, off).astype(np.uint32)
    off += support * 2
    _check(int(counts.sum()) > 0, "gaussian counts table all zero")
    words = np.frombuffer(buf, np.uint16, n_words, off).copy()
    off += n_words * 2
    sym = decode_rans(words, counts, n_sym)
    _check(bool((counts[sym] > 0).all()), "decoded symbols fall on zero-count slots")
    return sym.astype(np.int64) + vmin, off


def _f32s(*arrays) -> bytes:
    return b"".join(np.asarray(a, dtype=np.float32).tobytes() for a in arrays)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pack_bits(vals: np.ndarray, bits: int) -> bytes:
    """Fixed-width little-endian bit-pack of non-negative integers."""
    v = np.asarray(vals).astype(np.uint64).reshape(-1)
    out = np.zeros((v.size * bits + 7) // 8, dtype=np.uint8)
    bitpos = np.arange(v.size, dtype=np.uint64) * bits
    for b in range(bits):
        byte = ((bitpos + b) >> 3).astype(np.int64)
        off = (bitpos + b) & 7
        np.add.at(out, byte, (((v >> b) & 1) << off).astype(np.uint8))
    return out.tobytes()


def _unpack_bits(buf: bytes, off: int, count: int, bits: int):
    nbytes = (count * bits + 7) // 8
    _check(off + nbytes <= len(buf), "truncated bit-packed xy codes")
    arr = np.frombuffer(buf, np.uint8, nbytes, off)
    bitpos = np.arange(count, dtype=np.uint64) * bits
    v = np.zeros(count, dtype=np.uint64)
    for b in range(bits):
        byte = ((bitpos + b) >> 3).astype(np.int64)
        o = (bitpos + b) & 7
        v |= ((arr[byte] >> o) & 1).astype(np.uint64) << b
    return v, off + nbytes


class DecodedBitstream(NamedTuple):
    enc: Encoding
    bundle: QuantizerBundle
    qcfg: QuantConfig
    H: int
    W: int
    bound: torch.Tensor   # zeros — the covariance codes already carry the bound
    bpp: float


def serialize_bitstream(bundle: QuantizerBundle, enc: Encoding, cfg,
                        qcfg: QuantConfig) -> bytes:
    """Encoding -> one self-contained byte string (active rows only)."""
    active = _np(enc.active).astype(bool)
    n = int(active.sum())
    out = [MAGIC, _struct.pack(
        _HEADER, VERSION, 0, _XY_MODES[qcfg.xy_quant], _COLOR_MODES[qcfg.color_quant],
        qcfg.xy_bit, qcfg.cov_bit, qcfg.color_bit, cfg.H, cfg.W, n,
        qcfg.decode_cap if qcfg.decode_cap > 0 else cfg.tile_cap)]
    if qcfg.xy_quant != "fp16":
        out.append(_f32s(_np(bundle.xy.scale), _np(bundle.xy.beta)))
    out.append(_f32s(_np(enc.log_state.beta), _np(enc.log_state.scale),
                     _np(bundle.cov.cov.scale), _np(bundle.cov.cov.beta)))
    if qcfg.color_quant == "vq":
        layers = bundle.color_vq.layers
        K, D = layers[0].embed.shape
        out.append(_struct.pack("<HHH", len(layers), K, D))
        out.append(_f32s(*[_np(cb.embed) for cb in layers]))
    else:
        out.append(_f32s(_np(bundle.color.scale), _np(bundle.color.beta)))
    if qcfg.xy_quant == "fp16":
        out.append(_np(enc.quant_means)[active].astype(np.float16).tobytes())
    else:
        out.append(_pack_bits(_np(enc.quant_means)[active], qcfg.xy_bit))
    out.append(_pack_stream(_np(enc.quant_cov)[active]))
    out.append(_pack_stream(_np(enc.color_codes)[active]))
    return b"".join(out)


def deserialize_bitstream(data: bytes, device=None) -> DecodedBitstream:
    """Bytes -> (Encoding, grids, qcfg, H, W, bound, actual bpp) with the
    tensors on ``device`` (default: the card)."""
    with span("decode.parse"):
        dev = resolve_device(device)
        if data[:4] != MAGIC:
            raise ValueError("not a GIPB bitstream")
        _check(len(data) >= 4 + _struct.calcsize(_HEADER), "truncated header")
        (version, _param, xy_mode, color_mode, xy_bit, cov_bit, color_bit,
         H, W, n, decode_cap) = _struct.unpack_from(_HEADER, data, 4)
        if version not in (1, VERSION):
            raise ValueError(f"unsupported bitstream version {version}")
        _check(xy_mode in _XY_MODES.values() and color_mode in _COLOR_MODES.values(),
               "unknown quantizer mode")
        off = 4 + _struct.calcsize(_HEADER)

        def tensor(a):
            count("decode.uploads")
            return torch.as_tensor(a).to(dev)

        def f32(size):
            nonlocal off
            _check(off + size * 4 <= len(data), "truncated grids")
            a = np.frombuffer(data, np.float32, size, off).copy()
            off += size * 4
            return tensor(a)

        xy_quant = {v: k for k, v in _XY_MODES.items()}[xy_mode]
        color_quant = {v: k for k, v in _COLOR_MODES.items()}[color_mode]
        if xy_quant != "fp16":
            xy_params = UniformQuantParams(scale=f32(2), beta=f32(2))
        else:
            xy_params = UniformQuantParams(scale=tensor(np.ones(2, np.float32)),
                                           beta=tensor(np.zeros(2, np.float32)))
        log_state = LogQuantState(beta=f32(1)[0], scale=f32(1)[0])
        cov_params = HybridQuantParams(cov=UniformQuantParams(scale=f32(1), beta=f32(1)))
        color_vq = None
        if color_quant == "vq":
            _check(off + 6 <= len(data), "truncated codebook header")
            n_layers, K, D = _struct.unpack_from("<HHH", data, off)
            off += 6
            layers = []
            for _ in range(n_layers):
                embed = f32(K * D).reshape(K, D)
                layers.append(VQCodebook(embed=embed, cluster_size=embed.new_zeros((K,)),
                                         embed_avg=embed))
            color_vq = ResidualVQState(layers=tuple(layers))
            color_params = UniformQuantParams(scale=tensor(np.ones(3, np.float32)),
                                              beta=tensor(np.zeros(3, np.float32)))
            n_color_cols = n_layers
        else:
            color_params = UniformQuantParams(scale=f32(3), beta=f32(3))
            n_color_cols = 3

        if xy_quant == "fp16":
            _check(off + n * 4 <= len(data), "truncated fp16 xy")
            xy_codes = np.frombuffer(data, np.float16, n * 2, off).astype(np.float32).reshape(n, 2)
            off += n * 2 * 2
        else:
            flat, off = _unpack_bits(data, off, n * 2, xy_bit)
            xy_codes = flat.astype(np.float32).reshape(n, 2)
        cov_flat, off = _unpack_stream(data, off, version)
        _check(cov_flat.size == n * 3, "covariance stream length")
        cov_codes = cov_flat.astype(np.float32).reshape(n, 3)
        col_flat, off = _unpack_stream(data, off, version)
        _check(col_flat.size == n * n_color_cols, "colour stream length")
        color_codes = col_flat.reshape(n, n_color_cols)
        color_codes = (color_codes.astype(np.int32) if color_quant == "vq"
                       else color_codes.astype(np.float32))

        M = max(8, -(-n // 8) * 8)   # pad with invalid rows, as the JAX decoder does

        def pad(a):
            return tensor(np.concatenate([a, np.zeros((M - n,) + a.shape[1:], a.dtype)], axis=0))

        enc = Encoding(means=pad(xy_codes), quant_means=pad(xy_codes),
                       quant_cov=pad(cov_codes), color_codes=pad(color_codes),
                       log_state=log_state, active=tensor(np.arange(M) < n),
                       num_active=tensor(np.asarray(n, np.int32)))
        bundle = QuantizerBundle(xy=xy_params, cov=cov_params, color=color_params,
                                 color_vq=color_vq)
        qcfg = QuantConfig(xy_bit=xy_bit, cov_bit=cov_bit, color_bit=color_bit,
                           xy_quant=xy_quant, color_quant=color_quant, decode_cap=decode_cap)
        bound = torch.zeros((M, 3), dtype=torch.float32, device=dev)
        return DecodedBitstream(enc=enc, bundle=bundle, qcfg=qcfg, H=H, W=W,
                                bound=bound, bpp=len(data) * 8.0 / (H * W))


def decode_bitstream(data: bytes, cfg=None, backend=None, device=None):
    """Bytes -> (rendered [H, W, 3] image in [0, 1], DecodedBitstream).

    ``cfg`` overrides the render config (H, W and the row count always come
    from the stream); ``backend`` forwards to ``decompress_wo_ec``
    (``'binned'`` default, or ``'list'``/``'list_t'``); ``device`` defaults
    to the card."""
    with span("decode"):
        dec = deserialize_bitstream(data, device=device)
        M = dec.enc.active.shape[0]
        if cfg is None:
            cfg = GaussianConfig(H=dec.H, W=dec.W, max_num_points=M,
                                 tile_cap=dec.qcfg.decode_cap or 256)
        else:
            cfg = dataclasses.replace(cfg, H=dec.H, W=dec.W, max_num_points=M)
        img = decompress_wo_ec(dec.bundle, dec.enc, dec.bound, cfg, dec.qcfg, backend=backend)
        return img, dec
