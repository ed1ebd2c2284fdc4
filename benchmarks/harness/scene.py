"""The benchmark's own readers of its inputs: a binary glTF's first
primitive as a triangle soup, the floor height the upstream tracer detects
(mesh.cpp:100-136), and a route XML of the upstream schema
(raytracer.cpp:233-300). Both sides of a comparison get these arrays.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from xml.etree import ElementTree

import numpy as np

_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def _accessor(doc: dict, blob: bytes, index: int) -> np.ndarray:
    acc = doc["accessors"][index]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype, width = np.dtype(_DTYPES[acc["componentType"]]), _WIDTH[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or dtype.itemsize * width
    raw = np.frombuffer(blob, np.uint8)
    rows = np.lib.stride_tricks.as_strided(raw[offset:], shape=(acc["count"], dtype.itemsize * width),
                                           strides=(stride, 1))
    return rows.copy().view(dtype).reshape(acc["count"], width)


def load_triangles(path) -> np.ndarray:
    """f32[T, 3, 3] of the first primitive of the first mesh."""
    data = Path(path).read_bytes()
    magic, version, _ = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67 or version != 2:
        raise ValueError(f"{path}: not a glTF 2.0 binary")
    doc, blob, offset = None, b"", 12
    while offset + 8 <= len(data):
        length, kind = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8:offset + 8 + length]
        offset += 8 + length
        if kind == 0x4E4F534A:
            doc = json.loads(chunk)
        elif kind == 0x004E4942:
            blob = chunk
    prim = doc["meshes"][0]["primitives"][0]
    pos = _accessor(doc, blob, prim["attributes"]["POSITION"]).astype(np.float32)
    if "indices" in prim:
        idx = _accessor(doc, blob, prim["indices"]).reshape(-1).astype(np.int64)
    else:
        idx = np.arange(pos.shape[0])
    idx = idx[: idx.shape[0] // 3 * 3]
    return np.ascontiguousarray(pos[idx].reshape(-1, 3, 3))


def floor_height(tris: np.ndarray, bins: int = 48) -> float:
    """The centre of the fullest of 48 bins of vertex heights over [min y,
    0], vertices on a bin edge or above 0 not counted."""
    ys = tris.reshape(-1, 3)[:, 1].astype(np.float32)
    lo = min(np.float32(0.0), ys.min()) if ys.size else np.float32(0.0)
    span = np.float32(0.0) - lo
    if span <= 0:
        return 0.0
    edges = np.arange(bins + 1, dtype=np.float64) * (float(span) / bins) + float(lo)
    hist = [np.count_nonzero((ys > edges[j]) & (ys < edges[j + 1])) for j in range(bins)]
    return float((int(np.argmax(hist)) + 0.5) * (float(span) / bins) + float(lo))


def load_route(path) -> dict:
    """{"waypoints": [(x, z, seconds)], and the file's parameters}."""
    root = ElementTree.parse(str(path)).getroot()
    tags = dict(photon_count=("aantal_fotonen", int), iterations=("aantal_iteraties", int),
                light_intensity=("lamp_sterkte", float), min_dosage=("minimale_dosis", float),
                min_power=("minimale_bestralingssterkte", float), light_length=("lamp_lengte", float),
                light_height=("lamp_hoogte", float))
    out = {k: kind(root.find(tag).text) for k, (tag, kind) in tags.items() if root.find(tag) is not None}
    waypoints, inner = [], root.find("route")
    while inner is not None and inner.find(f"lamp_positie_{len(waypoints)}") is not None:
        e = inner.find(f"lamp_positie_{len(waypoints)}")
        waypoints.append((float(e.get("positie_x", 0.0)), float(e.get("positie_y", 0.0)),
                          float(e.get("duration", 1.0))))
    out["waypoints"] = waypoints
    return out


def areas(tris: np.ndarray) -> np.ndarray:
    """f32[T] |(v0 - v1) x (v0 - v2)| / 2."""
    c = np.cross(tris[:, 0] - tris[:, 1], tris[:, 0] - tris[:, 2])
    return (0.5 * np.linalg.norm(c, axis=1)).astype(np.float32)
