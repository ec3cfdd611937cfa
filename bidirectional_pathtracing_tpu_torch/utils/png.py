"""Minimal dependency-free PNG writer/reader (replaces vendored lodepng).

Reference: src/util/lodepng.{h,cpp} is a 8.5k-LoC vendored codec; we only
need 8-bit RGBA encode (save_image, raytraced_renderer.cpp:690-728) and
decode for golden-image tests.

A copy of bidirectional_pathtracing_tpu/utils/png.py (:18-107), kept
jax-free: the port writes the same bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgba: np.ndarray) -> None:
    """rgba: uint8 [H,W,4] (or [H,W,3], alpha forced to 255)."""
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    h, w = rgba.shape[:2]
    if rgba.shape[2] == 3:
        rgba = np.concatenate(
            [rgba, np.full((h, w, 1), 255, np.uint8)], axis=2)
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Decode 8-bit RGB/RGBA/gray PNG to uint8 [H,W,C].  Supports the
    filter types lodepng emits; used for golden-image comparisons."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = color = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
            if bitdepth != 8 or interlace != 0:
                raise ValueError("unsupported PNG format")
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = line
            for i in range(channels, stride):
                cur[i] = (cur[i] + cur[i - channels]) & 0xFF
        elif ft == 2:
            cur = (line + prev) & 0xFF
        elif ft == 3:
            cur = line
            for i in range(stride):
                left = cur[i - channels] if i >= channels else 0
                cur[i] = (cur[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:
            cur = line
            for i in range(stride):
                a = int(cur[i - channels]) if i >= channels else 0
                b = int(prev[i])
                c = int(prev[i - channels]) if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ft}")
        out[y] = cur
        prev = cur
    img = out.reshape(h, w, channels)
    if color == 3:
        img = palette[img[..., 0]]
    return img
