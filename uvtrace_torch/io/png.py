"""Dependency-free PNG reader/writer (8-bit), zlib + struct only.

Numpy copy of uvtrace/io/png.py, kept equal to it by tests/test_torch_io_viz.py.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def png_bytes(image: np.ndarray) -> bytes:
    """Encode uint8 [H,W,3] (or [H,W] grayscale) as PNG bytes."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    assert image.ndim == 3 and image.shape[2] == 3, image.shape
    image = image.astype(np.uint8)
    h, w = image.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    raw = b"".join(b"\x00" + image[row].tobytes() for row in range(h))
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    return payload


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write uint8 [H,W,3] (or [H,W] grayscale) to a PNG file."""
    Path(path).write_bytes(png_bytes(image))


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG (gray/RGB/RGBA, the formats
    tinygltf's stb_image feeds the reference's texture path, mesh.cpp:166-199)
    to uint8 [H,W,3]."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            if bit_depth != 8 or interlace != 0:
                raise ValueError(f"unsupported PNG (depth={bit_depth}, interlace={interlace})")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for row in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        cur = np.zeros(stride, np.int32)
        if filt == 0:
            cur = line
        elif filt == 2:  # up
            cur = (line + prev) & 0xFF
        else:  # sub(1) / average(3) / paeth(4) need left-to-right recurrence
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                c = prev[i - channels] if i >= channels else 0
                if filt == 1:
                    pred = a
                elif filt == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        out[row] = cur
        prev = cur
    img = out.reshape(h, w, channels)
    if channels == 1:
        img = np.repeat(img, 3, axis=2)
    elif channels == 2:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    elif channels == 4:
        img = img[:, :, :3]
    return img


def read_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
