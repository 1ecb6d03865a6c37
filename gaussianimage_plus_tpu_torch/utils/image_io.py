"""8-bit PNG read/write with ``zlib`` + ``struct`` (no PIL dependency), and
the training log writer.

Counterpart of ``gaussianimage_plus_tpu/utils/image_io.py`` (``load_image``,
``save_image``, ``LogWriter``; reference utils.py:11-42). Images are [H, W, 3] float32 in
[0, 1]. The writer emits 8-bit RGB; the reader takes non-interlaced 8-bit
grey, grey+alpha, RGB or RGBA with any of the five PNG row filters.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples per pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_image(arr, path) -> None:
    """[H, W, 3] float in [0, 1] (numpy or CPU-convertible tensor) -> PNG."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {arr.shape}")
    u8 = np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)
    H, W, _ = u8.shape
    raw = np.concatenate([np.zeros((H, 1), np.uint8), u8.reshape(H, W * 3)], axis=1)
    png = (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def _unfilter(data: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    rows = data.reshape(H, stride + 1)
    out = np.zeros((H, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.int32)
    for y in range(H):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, dtype=np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                elif ftype == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def load_image(path) -> np.ndarray:
    """8-bit PNG -> [H, W, 3] float32 in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    off, idat, hdr = 8, [], None
    while off + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, off)
        tag = data[off + 4:off + 8]
        body = data[off + 8:off + 8 + length]
        off += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) PNG is supported")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != H * (W * ch + 1):
        raise ValueError(f"{path}: image data has the wrong size")
    px = _unfilter(raw, H, W * ch, ch).reshape(H, W, ch).astype(np.float32) / 255.0
    if ch <= 2:
        px = np.repeat(px[:, :, :1], 3, axis=2)
    return px[:, :, :3]


class LogWriter:
    """print, and append to ``<file_path>/train.txt`` (``test.txt`` with
    ``train=False``), as the reference's utils.py:32-42."""

    def __init__(self, file_path, train: bool = True):
        os.makedirs(file_path, exist_ok=True)
        self.file_path = os.path.join(file_path, "train.txt" if train else "test.txt")

    def write(self, text: str) -> None:
        print(text, flush=True)
        with open(self.file_path, "a") as f:
            f.write(text + "\n")
