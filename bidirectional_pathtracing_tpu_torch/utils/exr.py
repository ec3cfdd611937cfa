"""Minimal OpenEXR scanline reader/writer (replaces vendored tinyexr).

Supports what the reference uses for `-e` environment maps
(main.cpp:40-77): single-part scanline images, RGB(A) channels, HALF or
FLOAT pixels, NONE or ZIP/ZIPS compression, increasing-Y line order.
Returns [H,W,3] float32 with channels in R,G,B order (the reference reads
tinyexr's alphabetical B,G,R planes and swaps, main.cpp:63-72).

A copy of bidirectional_pathtracing_tpu/utils/exr.py (:23-189), kept
jax-free: write_exr writes the JAX package's bytes.  read_exr differs in
one place, the zip undelta (_unpredict), which is the format's here and
wrong there.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _parse_header(data):
    pos = 8
    attrs = {}
    while True:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = data.index(b"\0", pos)
        pos = end + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        attrs[name] = data[pos:pos + size]
        pos += size
    return attrs, pos


def _unpredict(raw: bytes) -> np.ndarray:
    """EXR zip post-processing: undelta then de-interleave.

    The undelta is t[i] = t[i-1] + d[i] - 128 (OpenEXR's zip predictor),
    so t[i] = sum(d[:i+1]) - 128 i.  The JAX package's copy adds 128 (i+1)
    back to its cumsum(d - 128), which leaves sum(d[:i+1]): it misreads
    every block that zlib shrank, its own files' included; files whose
    blocks stay raw (and uncompressed files) read the same in both."""
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    arr = (np.cumsum(arr) - 128 * np.arange(len(arr))) % 256
    out = np.zeros(len(arr), np.uint8)
    half = (len(arr) + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:half + len(arr) // 2]
    return out


def _predict(data: np.ndarray) -> bytes:
    """Inverse of _unpredict for writing."""
    n = len(data)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = data[0::2]
    inter[half:] = data[1::2]
    d = inter.astype(np.int64)
    d[1:] = (d[1:] - d[:-1] + 128) % 256
    return d.astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not an EXR file (possibly a git-lfs stub)")
    version = data[4]
    if data[5] & 0x1A:
        raise ValueError("tiled/deep/multipart EXR not supported")
    attrs, pos = _parse_header(data)

    comp = attrs["compression"][0]
    if comp not in _LINES_PER_BLOCK:
        raise ValueError(f"unsupported EXR compression {comp}")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    chans = []
    ch = attrs["channels"]
    p = 0
    while ch[p] != 0:
        e = ch.index(b"\0", p)
        name = ch[p:e].decode()
        p = e + 1
        ptype, _, xs, ys = struct.unpack_from("<IIii", ch, p)
        p += 16
        if (xs, ys) != (1, 1):
            raise ValueError("subsampled channels not supported")
        chans.append((name, ptype))
    # EXR stores channels alphabetically within a scanline

    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = -(-h // lpb)
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    planes = {name: np.zeros((h, w), np.float32) for name, _ in chans}
    bytes_per = {name: (2 if t == _PT_HALF else 4) for name, t in chans}
    line_bytes = sum(bytes_per[n] * w for n, _ in chans)

    for off in offsets:
        (y,) = struct.unpack_from("<i", data, off)
        (size,) = struct.unpack_from("<I", data, off + 4)
        blob = data[off + 8:off + 8 + size]
        rows = min(lpb, y1 - y + 1)
        expect = line_bytes * rows
        if comp in (_COMP_ZIP, _COMP_ZIPS) and size < expect:
            raw = _unpredict(zlib.decompress(blob)).tobytes()
        else:
            raw = blob
        rp = 0
        for r in range(rows):
            yy = y - y0 + r
            for name, t in chans:
                nb = bytes_per[name] * w
                buf = raw[rp:rp + nb]
                rp += nb
                if t == _PT_HALF:
                    planes[name][yy] = np.frombuffer(buf, np.float16)
                else:
                    planes[name][yy] = np.frombuffer(buf, np.float32)

    out = np.zeros((h, w, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in planes:
            out[..., i] = planes[c]
        elif "Y" in planes:
            out[..., i] = planes["Y"]
    return out


def write_exr(path: str, img: np.ndarray, compression: int = _COMP_ZIP):
    """Write [H,W,3] float32 as scanline RGB FLOAT."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]

    def attr(name, typ, payload):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<I", len(payload)) + payload)

    chan = b""
    for c in sorted("BGR"):
        chan += c.encode() + b"\0" + struct.pack("<IIii", _PT_FLOAT, 0, 1, 1)
    chan += b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (_MAGIC + struct.pack("<I", 2)
              + attr("channels", "chlist", chan)
              + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = -(-h // lpb)
    blocks = []
    for b in range(n_blocks):
        y = b * lpb
        rows = min(lpb, h - y)
        raw = b""
        for r in range(rows):
            for i, c in enumerate(sorted("BGR")):
                src = {"R": 0, "G": 1, "B": 2}[c]
                raw += img[y + r, :, src].tobytes()
        if compression in (_COMP_ZIP, _COMP_ZIPS):
            comp_blob = zlib.compress(
                _predict(np.frombuffer(raw, np.uint8)), 6)
            if len(comp_blob) >= len(raw):
                comp_blob = raw
        else:
            comp_blob = raw
        blocks.append((y, comp_blob))

    table_pos = len(header)
    data_pos = table_pos + 8 * n_blocks
    offsets = []
    body = b""
    for y, blob in blocks:
        offsets.append(data_pos + len(body))
        body += struct.pack("<iI", y, len(blob)) + blob
    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        f.write(body)
