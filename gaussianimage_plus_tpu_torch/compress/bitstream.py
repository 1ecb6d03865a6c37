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

Parsing is host-side numpy in one pass: the header fixes the layout of every
decoded field (``_Layout``), each field is written in its decode layout
(rows padded with zeros) into one staging buffer, and that buffer is placed
on the requested device once: on the card one non-blocking copy from a pinned
host buffer, on the CPU no copy. Every tensor of the result is a view of that
one allocation. Malformed input raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import math
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


def _unpack_stream(buf: bytes, off: int, out: np.ndarray, what: str,
                   version: int = VERSION) -> int:
    """Decode one coded stream of ``out.size`` symbols into the flat ``out``
    (float32 or int32), cast as the int64 values would be; -> the offset
    past the stream."""
    _check(off < len(buf), "truncated before stream tag")
    tag = buf[off]
    off += 1
    if tag == 0:
        _check(off + 9 <= len(buf), "truncated categorical header")
        n_sym, n_unique, dtag = _struct.unpack_from("<IIB", buf, off)
        off += 9
        _check(0 < n_sym <= _MAX_SYMS, f"categorical n_sym {n_sym}")
        _check(n_sym == out.size, f"{what} stream length")
        _check(dtag in _DTYPE_TAGS, f"unknown dtype tag {dtag}")
        dt = np.dtype(_DTYPE_TAGS[dtag])
        _check(0 < n_unique <= min(n_sym, 1 << 24), f"categorical n_unique {n_unique}")
        _check(off + n_unique * (dt.itemsize + 4) + 4 <= len(buf),
               "truncated categorical tables")
        unique = np.frombuffer(buf, dt, n_unique, off)
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
        _check(int(idx.min()) >= 0 and int(idx.max()) < n_unique,
               "categorical indices out of range")
        np.take(unique.astype(np.int64).astype(out.dtype), idx, out=out)
        return off
    _check(tag == 1, f"unknown stream tag {tag}")
    if version == 1:
        hdr = _struct.calcsize("<IffiiI")
        _check(off + hdr <= len(buf), "truncated gaussian(v1) header")
        n_sym, mean, std, vmin, vmax, n_words = _struct.unpack_from("<IffiiI", buf, off)
        off += hdr
        _check(0 < n_sym <= _MAX_SYMS, f"gaussian n_sym {n_sym}")
        _check(n_sym == out.size, f"{what} stream length")
        _check(vmax >= vmin and vmax - vmin < (1 << 20), f"gaussian support [{vmin}, {vmax}]")
        _check(np.isfinite(mean) and np.isfinite(std) and std > 0,
               "gaussian (mean, std) invalid")
        _check(off + n_words * 2 <= len(buf), "truncated gaussian(v1) words")
        words = np.frombuffer(buf, np.uint16, n_words, off).copy()
        off += n_words * 2
        out[:] = decompress_gaussian(words, mean, std, vmin, vmax, n_sym)
        return off
    hdr = _struct.calcsize("<IiiI")
    _check(off + hdr <= len(buf), "truncated gaussian header")
    n_sym, vmin, vmax, n_words = _struct.unpack_from("<IiiI", buf, off)
    off += hdr
    _check(0 < n_sym <= _MAX_SYMS, f"gaussian n_sym {n_sym}")
    _check(n_sym == out.size, f"{what} stream length")
    _check(vmax >= vmin and vmax - vmin < (1 << 20), f"gaussian support [{vmin}, {vmax}]")
    support = vmax - vmin + 1
    _check(off + support * 2 + n_words * 2 <= len(buf), "truncated gaussian tables/words")
    counts = np.frombuffer(buf, np.uint16, support, off).astype(np.uint32)
    off += support * 2
    _check(int(counts.sum()) > 0, "gaussian counts table all zero")
    words = np.frombuffer(buf, np.uint16, n_words, off).copy()
    off += n_words * 2
    sym = decode_rans(words, counts, n_sym)
    # the coder decodes only symbols of the table, so a table with no zero
    # count needs no look-up
    _check(int(counts.min()) > 0 or bool((counts[sym] > 0).all()),
           "decoded symbols fall on zero-count slots")
    # vmin + sym lies in [vmin, vmax], so int32 holds the sum exactly
    np.add(sym, vmin, out=out, dtype=np.int32, casting="unsafe")
    return off


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


# the widest code an 8-byte window holds at any bit offset (7 + 57 = 64)
_MAX_XY_BITS = 57


def _unpack_bits(buf: bytes, off: int, out: np.ndarray, bits: int) -> int:
    """Fixed-width little-endian bit-unpack of ``out.size`` codes of at most
    ``_MAX_XY_BITS`` bits into ``out``; -> the offset past them. A code is
    read from the 8-byte window at its first byte, shifted and masked: codes
    come in groups of 8 that span ``bits`` bytes, so code ``k`` of each
    group sits at the same byte and bit of its group."""
    count = out.size
    nbytes = (count * bits + 7) // 8
    _check(off + nbytes <= len(buf), "truncated bit-packed xy codes")
    groups = -(-count // 8)
    padded = np.zeros(groups * bits + 7, np.uint8)
    padded[:nbytes] = np.frombuffer(buf, np.uint8, nbytes, off)
    # windows[g, j]: the 8 bytes at byte j of group g, little-endian
    windows = np.ndarray((groups, bits), "<u8", padded, strides=(bits, 1))
    first = np.arange(8) * bits
    v = windows[:, first >> 3]
    v >>= (first & 7).astype(np.uint64)
    v &= np.uint64((1 << bits) - 1)
    out[:] = v.reshape(-1)[:count]
    return off + nbytes


class _Layout:
    """Each decoded field's place in one staging buffer: (byte offset, byte
    end, numpy dtype, shape), every field 16-byte aligned."""

    _TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
              np.dtype(np.bool_): torch.bool}

    def __init__(self):
        self.fields = {}
        self.nbytes = 0

    def add(self, name: str, dtype, shape: tuple) -> None:
        dt = np.dtype(dtype)
        end = self.nbytes + dt.itemsize * math.prod(shape)
        self.fields[name] = (self.nbytes, end, dt, shape)
        self.nbytes = -(-end // 16) * 16

    def host(self, buf: np.ndarray, name: str) -> np.ndarray:
        a, b, dt, shape = self.fields[name]
        return buf[a:b].view(dt).reshape(shape)

    def device(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        a, b, dt, shape = self.fields[name]
        return buf[a:b].view(self._TORCH[dt]).view(shape)


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
    tensors on ``device`` (default: the card), all views of one staged
    buffer placed there by one copy."""
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
        xy_quant = {v: k for k, v in _XY_MODES.items()}[xy_mode]
        color_quant = {v: k for k, v in _COLOR_MODES.items()}[color_mode]
        _check(xy_quant == "fp16" or xy_bit > 0, "xy bit width 0")
        _check(xy_quant == "fp16" or xy_bit <= _MAX_XY_BITS, f"xy bit width {xy_bit}")

        # where the grids lie in the stream, and the layout they fix
        off = 4 + _struct.calcsize(_HEADER)
        xy_grid = off if xy_quant != "fp16" else None
        log_grid = off = off + (16 if xy_grid is not None else 0)
        off += 16
        _check(off <= len(data), "truncated grids")
        if color_quant == "vq":
            _check(off + 6 <= len(data), "truncated codebook header")
            n_layers, K, D = _struct.unpack_from("<HHH", data, off)
            off += 6
            n_color_cols, n_grid = n_layers, n_layers * K * D
        else:
            n_color_cols, n_grid = 3, 6
        color_grid = off
        off += n_grid * 4
        _check(off <= len(data), "truncated grids")
        _check(n * max(3, n_color_cols) <= _MAX_SYMS, f"row count {n}")
        xy_bytes = n * 4 if xy_quant == "fp16" else (n * 2 * xy_bit + 7) // 8
        _check(off + xy_bytes <= len(data), "truncated xy codes")
        M = max(8, -(-n // 8) * 8)   # pad with invalid rows, as the JAX decoder does
        lay = _Layout()
        lay.add("grids", np.float32, (14,))
        if color_quant == "vq":
            lay.add("books", np.float32, (n_layers, K, D))
        lay.add("xy", np.float32, (M, 2))
        lay.add("cov", np.float32, (M, 3))
        lay.add("color", np.int32 if color_quant == "vq" else np.float32, (M, n_color_cols))
        lay.add("active", np.bool_, (M,))
        lay.add("num_active", np.int32, ())

        # on the card a pinned host buffer from the caching host allocator,
        # which keeps a block from reuse until the copy out of it has run
        host = torch.empty(lay.nbytes, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        buf = host.numpy()

        # grids: xy scale, beta | log beta, scale | cov scale, beta | colour scale, beta
        grids = lay.host(buf, "grids")
        if xy_grid is not None:
            grids[0:4] = np.frombuffer(data, np.float32, 4, xy_grid)
        else:
            grids[0:4] = (1, 1, 0, 0)
        grids[4:8] = np.frombuffer(data, np.float32, 4, log_grid)
        if color_quant == "vq":
            lay.host(buf, "books").reshape(-1)[:] = np.frombuffer(
                data, np.float32, n_grid, color_grid)
            grids[8:14] = (1, 1, 1, 0, 0, 0)
        else:
            grids[8:14] = np.frombuffer(data, np.float32, 6, color_grid)

        # the rows: the first n written, the rest zero
        xy = lay.host(buf, "xy")
        if xy_quant == "fp16":
            xy[:n] = np.frombuffer(data, np.float16, n * 2, off).reshape(n, 2)
            off += xy_bytes
        else:
            off = _unpack_bits(data, off, xy[:n].reshape(-1), xy_bit)
        cov, color = lay.host(buf, "cov"), lay.host(buf, "color")
        off = _unpack_stream(data, off, cov[:n].reshape(-1), "covariance", version)
        off = _unpack_stream(data, off, color[:n].reshape(-1), "colour", version)
        for rows in (xy, cov, color):
            rows[n:] = 0
        active = lay.host(buf, "active")
        active[:n], active[n:] = True, False
        lay.host(buf, "num_active")[...] = n

        if dev.type == "cuda":
            count("decode.uploads")
            staged = torch.empty(lay.nbytes, dtype=torch.uint8, device=dev)
            staged.copy_(host, non_blocking=True)
        else:
            staged = host.to(dev)

        grids = lay.device(staged, "grids")
        color_vq = None
        if color_quant == "vq":
            books = lay.device(staged, "books")
            color_vq = ResidualVQState(layers=tuple(
                VQCodebook(embed=e, cluster_size=e.new_zeros((K,)), embed_avg=e) for e in books))
        xy = lay.device(staged, "xy")   # read-only: the xy codes serve as both fields
        enc = Encoding(means=xy, quant_means=xy, quant_cov=lay.device(staged, "cov"),
                       color_codes=lay.device(staged, "color"),
                       log_state=LogQuantState(beta=grids[4], scale=grids[5]),
                       active=lay.device(staged, "active"),
                       num_active=lay.device(staged, "num_active"))
        bundle = QuantizerBundle(
            xy=UniformQuantParams(scale=grids[0:2], beta=grids[2:4]),
            cov=HybridQuantParams(cov=UniformQuantParams(scale=grids[6:7], beta=grids[7:8])),
            color=UniformQuantParams(scale=grids[8:11], beta=grids[11:14]),
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
