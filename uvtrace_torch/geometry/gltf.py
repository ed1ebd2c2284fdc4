"""Minimal dependency-free binary glTF (.glb) loader (numpy copy of
uvtrace/geometry/gltf.py).

Covers what the reference loads with tinygltf (mesh.cpp:5-98): the first
primitive of the first mesh — POSITION, TEXCOORD_0 and the index accessor
(u8/u16/u32), expanded to a flat per-triangle array. Written from the glTF 2.0
spec; no third-party glTF library is available in this environment.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from uvtrace_torch.geometry.mesh import TriangleMesh, detect_floor_height

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _parse_glb(data: bytes) -> tuple[dict, bytes]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC:
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json, bin_chunk = None, b""
    while offset + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + clen]
        offset += clen
        if ctype == _CHUNK_JSON:
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif ctype == _CHUNK_BIN:
            bin_chunk = chunk
    if gltf_json is None:
        raise ValueError("GLB has no JSON chunk")
    return gltf_json, bin_chunk


def _read_accessor(gltf: dict, bin_chunk: bytes, accessor_index: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_index]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    byte_offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize
    stride = view.get("byteStride") or itemsize * ncomp
    if stride == itemsize * ncomp:
        arr = np.frombuffer(bin_chunk, dtype=dtype, count=count * ncomp, offset=byte_offset)
        return arr.reshape(count, ncomp)
    # strided (interleaved) layout
    raw = np.frombuffer(bin_chunk, dtype=np.uint8)
    out = np.empty((count, ncomp), dtype=dtype)
    for i in range(ncomp):
        start = byte_offset + i * itemsize
        col = np.lib.stride_tricks.as_strided(
            raw[start:], shape=(count, itemsize), strides=(stride, 1)
        )
        out[:, i] = col.copy().view(dtype)[:, 0]
    return out


def load_glb(path: str | Path, primitive: int = 0, mesh_index: int = 0) -> TriangleMesh:
    """Load a .glb scene to a flat triangle soup.

    Mirrors the reference's expansion of indexed geometry into per-triangle
    vertex triples (mesh.cpp:53-87) and its floor-height auto-detection
    (mesh.cpp:100-136).
    """
    path = Path(path)
    gltf, bin_chunk = _parse_glb(path.read_bytes())
    prim = gltf["meshes"][mesh_index]["primitives"][primitive]
    positions = _read_accessor(gltf, bin_chunk, prim["attributes"]["POSITION"]).astype(np.float32)
    uvs_per_vertex = None
    if "TEXCOORD_0" in prim["attributes"]:
        uvs_per_vertex = _read_accessor(gltf, bin_chunk, prim["attributes"]["TEXCOORD_0"]).astype(
            np.float32
        )
    if "indices" in prim:
        indices = _read_accessor(gltf, bin_chunk, prim["indices"]).reshape(-1).astype(np.int64)
    else:
        indices = np.arange(len(positions), dtype=np.int64)
    indices = indices[: (len(indices) // 3) * 3]
    tris = positions[indices].reshape(-1, 3, 3)
    uvs = uvs_per_vertex[indices].reshape(-1, 3, 2) if uvs_per_vertex is not None else None
    return TriangleMesh(
        tris=tris,
        uvs=uvs,
        floor_height=detect_floor_height(tris),
        name=path.stem,
        texture=_load_base_color_texture(gltf, bin_chunk, prim),
    )


def _load_base_color_texture(gltf: dict, bin_chunk: bytes, prim: dict):
    """Base-color texture of the primitive's material (the room scan photo
    the reference shows in 'texture' view mode, mesh.cpp:166-199).
    PNG and JPEG both decode in-tree (io/png.py, io/jpeg.py) — phone LiDAR
    scans ship JPEG textures almost exclusively, matching the reference's
    stb_image coverage."""
    try:
        mat = gltf["materials"][prim["material"]]
        tex_info = mat["pbrMetallicRoughness"]["baseColorTexture"]
        image = gltf["images"][gltf["textures"][tex_info["index"]]["source"]]
        if "bufferView" not in image:
            return None
        view = gltf["bufferViews"][image["bufferView"]]
        start = view.get("byteOffset", 0)
        raw = bin_chunk[start : start + view["byteLength"]]
        if image.get("mimeType") == "image/png" or raw[:8] == b"\x89PNG\r\n\x1a\n":
            from uvtrace_torch.io.png import decode_png

            return decode_png(raw)
        if image.get("mimeType") == "image/jpeg" or raw[:2] == b"\xff\xd8":
            from uvtrace_torch.io.jpeg import decode_jpeg

            return decode_jpeg(raw)
        return None  # unknown format: texture view falls back to white
    except (KeyError, IndexError, TypeError):
        return None
