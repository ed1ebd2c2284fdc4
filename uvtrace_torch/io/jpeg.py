"""Dependency-free baseline JPEG decoder (pure numpy).

Numpy copy of uvtrace/io/jpeg.py, kept equal to it by tests/test_torch_io_viz.py.

The reference decodes the LiDAR room-scan photo texture with stb_image via
tinygltf (mesh.cpp:166-199); phone scans ship JPEG almost exclusively, so the
'photo scan' view mode needs JPEG parity. This module implements the
ITU-T T.81 baseline sequential process:

- marker parse (SOI/APPn/DQT/SOF0/SOF1/DHT/SOS/DRI/EOI),
- Huffman entropy decode with byte-stuffing and restart markers,
- dequantization + zigzag, vectorized 8x8 IDCT (one einsum over all blocks),
- chroma upsampling (4:4:4 / 4:2:2 / 4:2:0 and any h/v factor pair),
- YCbCr -> RGB.

Entropy decoding is a per-symbol Python loop — fine for typical texture
sizes in tests; `decode_jpeg` uses Pillow, where it is installed, as a
fast path for large or progressive images when available, falling back to
this decoder. Returns uint8[H, W, 3] like io/png.decode_png.
"""

from __future__ import annotations

import struct

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# orthonormal 8-point DCT-III basis for the 2-D inverse transform
_A = np.zeros((8, 8), np.float32)
for _k in range(8):
    for _n in range(8):
        c = np.sqrt(0.125) if _k == 0 else 0.5
        _A[_k, _n] = c * np.cos((2 * _n + 1) * _k * np.pi / 16.0)


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment, handling 0xFF00
    byte stuffing; stops (returns zero bits) at any non-RST marker."""

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        d = self.data
        while self.nbits <= 24:
            if self.pos >= len(d):
                b = 0  # past end: zero-pad (T.81 allows; EOB ends blocks)
            else:
                b = d[self.pos]
                if b == 0xFF:
                    nxt = d[self.pos + 1] if self.pos + 1 < len(d) else 0xD9
                    if nxt == 0x00:
                        self.pos += 2  # stuffed data byte 0xFF
                    else:
                        b = 0  # marker (RSTn/EOI) ahead: zero-pad, don't consume
                else:
                    self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFF
            self.nbits += 8

    def receive(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        return v

    def align_restart(self):
        """Byte-align and consume one RSTn marker."""
        self.acc = 0
        self.nbits = 0
        d = self.data
        # scan forward to the next 0xFF D0-D7
        while self.pos + 1 < len(d):
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1


def _build_huffman(bits: list[int], vals: bytes):
    """{length: {code: symbol}} lookup from the DHT code-length counts."""
    lut = {}
    code = 0
    k = 0
    for length in range(1, 17):
        n = bits[length - 1]
        if n:
            lut[length] = {}
            for _ in range(n):
                lut[length][code] = vals[k]
                code += 1
                k += 1
        code <<= 1
    return lut


def _decode_huff(br: _BitReader, lut) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.receive(1)
        tbl = lut.get(length)
        if tbl is not None:
            sym = tbl.get(code)
            if sym is not None:
                return sym
    raise ValueError("invalid Huffman code")


def _extend(v: int, n: int) -> int:
    """T.81 F.2.2.1 sign extension of an n-bit magnitude."""
    if n == 0:
        return 0
    return v if v >= (1 << (n - 1)) else v - (1 << n) + 1


def decode_jpeg_baseline(data: bytes) -> np.ndarray:
    """Decode a baseline (SOF0/SOF1) JPEG to uint8[H, W, 3]."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG (no SOI)")
    pos = 2
    qt = {}
    huff_dc, huff_ac = {}, {}
    frame = None
    restart_interval = 0
    scan = None
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack_from(">H", data, pos)
        body = data[pos + 2 : pos + seglen]
        if marker == 0xDB:  # DQT
            b = 0
            while b < len(body):
                prec, tid = body[b] >> 4, body[b] & 15
                b += 1
                if prec:
                    qt[tid] = np.frombuffer(body, ">u2", 64, b).astype(np.int32)
                    b += 128
                else:
                    qt[tid] = np.frombuffer(body, np.uint8, 64, b).astype(np.int32)
                    b += 64
        elif marker in (0xC0, 0xC1):  # SOF0/1 baseline
            _prec, h, w, ncomp = struct.unpack_from(">BHHB", body, 0)
            comps = []
            for ci in range(ncomp):
                cid, hv, tq = struct.unpack_from("BBB", body, 6 + 3 * ci)
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            frame = dict(h=h, w=w, comps=comps)
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise NotImplementedError(f"non-baseline JPEG (SOF marker 0x{marker:02X})")
        elif marker == 0xC4:  # DHT
            b = 0
            while b < len(body):
                tc, th = body[b] >> 4, body[b] & 15
                bits = list(body[b + 1 : b + 17])
                nv = sum(bits)
                vals = body[b + 17 : b + 17 + nv]
                (huff_ac if tc else huff_dc)[th] = _build_huffman(bits, vals)
                b += 17 + nv
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack_from(">H", body, 0)
        elif marker == 0xDA:  # SOS
            ns = body[0]
            sel = []
            for si in range(ns):
                cs, tds = struct.unpack_from("BB", body, 1 + 2 * si)
                sel.append((cs, tds >> 4, tds & 15))
            scan = sel
            pos += seglen
            break  # entropy-coded data follows
        pos += seglen
    if frame is None or scan is None:
        raise ValueError("JPEG missing SOF/SOS")

    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mcux = -(-frame["w"] // (8 * hmax))
    mcuy = -(-frame["h"] // (8 * vmax))
    by_id = {c["id"]: c for c in comps}
    order = []
    for cs, td, ta in scan:
        c = by_id[cs]
        order.append((c, huff_dc[td], huff_ac[ta], qt[c["tq"]]))

    # per-component coefficient planes in block units
    blocks = {
        c["id"]: np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int32) for c in comps
    }
    br = _BitReader(data, pos)
    pred = {c["id"]: 0 for c in comps}
    mcu_count = 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and mcu_count and mcu_count % restart_interval == 0:
                br.align_restart()
                pred = {c["id"]: 0 for c in comps}
            for c, dc_lut, ac_lut, q in order:
                for vy in range(c["v"]):
                    for vx in range(c["h"]):
                        coef = np.zeros(64, np.int32)
                        s = _decode_huff(br, dc_lut)
                        diff = _extend(br.receive(s), s)
                        pred[c["id"]] += diff
                        coef[0] = pred[c["id"]]
                        k = 1
                        while k < 64:
                            rs = _decode_huff(br, ac_lut)
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r == 15:
                                    k += 16
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                break
                            coef[k] = _extend(br.receive(s), s)
                            k += 1
                        blocks[c["id"]][my * c["v"] + vy, mx * c["h"] + vx] = coef * q
            mcu_count += 1

    planes = []
    for c in comps:
        bl = blocks[c["id"]]
        nby, nbx = bl.shape[:2]
        zz = np.zeros_like(bl)
        zz[:, :, _ZIGZAG] = bl  # de-zigzag
        x = zz.reshape(nby * nbx, 8, 8).astype(np.float32)
        # 2-D inverse DCT over every block at once: A^T X A
        sp = np.einsum("ki,nkl,lj->nij", _A, x, _A, optimize=True)
        sp = np.clip(np.round(sp + 128.0), 0, 255).astype(np.uint8)
        plane = sp.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
        # upsample to full resolution
        plane = np.repeat(np.repeat(plane, vmax // c["v"], 0), hmax // c["h"], 1)
        planes.append(plane[: frame["h"], : frame["w"]])

    if len(planes) == 1:
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    y = planes[0].astype(np.float32)
    cb = planes[1].astype(np.float32) - 128.0
    cr = planes[2].astype(np.float32) - 128.0
    rgb = np.stack(
        [y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], axis=2
    )
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """Decode a JPEG to uint8[H, W, 3]: Pillow fast path when importable
    (handles progressive too), else the in-tree baseline decoder."""
    try:
        import io

        from PIL import Image

        img = Image.open(io.BytesIO(data)).convert("RGB")
        return np.asarray(img, np.uint8)
    except ImportError:
        return decode_jpeg_baseline(data)
