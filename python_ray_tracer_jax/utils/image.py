"""Image quantization and PNG I/O.

Quantization matches the reference writer exactly
(the reference's ``ray_tracer/infrastructure/numpy/base.py:143-151``):
clip to [0, 1], scale by 255, truncate to uint8 (``astype`` truncates —
no rounding), per channel.

PNG is read and written with the standard library (``zlib``, ``struct``):
8-bit greyscale, grey+alpha, RGB and RGBA, non-interlaced, all five row
filters.  Images are written as RGB with no row filter.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit samples only).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def to_uint8(image: np.ndarray | object) -> np.ndarray:
    """(H, W, 3) float image -> uint8, reference-exact truncation."""
    arr = np.asarray(image, dtype=np.float64)
    return (255.0 * np.clip(arr, 0.0, 1.0)).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(pixels: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) uint8 array."""
    h, w, c = pixels.shape
    if c != 3 or pixels.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 3) uint8, got {pixels.shape} {pixels.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; returns (h, stride) uint8."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        kind = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1)
        pos += stride + 1
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: running sum along the row, per byte of a pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64) % 256).astype(np.uint8)
            cur = cur.reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte depends on the one before
            cur_b = bytearray(stride)
            up = prior.tobytes()
            filt = line.tobytes()
            for i in range(stride):
                left = cur_b[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_b[i] = (filt[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"bad PNG row filter {kind}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB from PNG bytes (alpha dropped, grey broadcast)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(_SIGNATURE)
    idat = []
    header = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, interlace {interlace}")
    ch = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ch in (1, 2):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def save_png(image: np.ndarray | object, path: str | Path) -> None:
    """Quantize a float (H, W, 3) image (:func:`to_uint8`) and write it."""
    Path(path).write_bytes(encode_png(to_uint8(image)))


def load_png(path: str | Path) -> np.ndarray:
    """uint8 (H, W, 3) array from disk."""
    return decode_png(Path(path).read_bytes())
