"""Binary glTF (.glb) export.

Numpy copy of uvtrace/io/gltf_export.py, kept equal to it by tests/test_torch_io_viz.py.

Writes a scene with per-vertex COLOR_0 (e.g. the dose heatmap) and optional
TEXCOORD_0 + PNG base-color texture — so dose results can be inspected
interactively in ANY glTF viewer, replacing the reference's in-app OpenGL
heatmap (myapp.cpp:180-205) in a portable way. Also used by tests to
synthesize textured scenes for the loader.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942


def _pad(b: bytes, align: int = 4, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((-len(b)) % align)


def export_glb(
    path: str | Path,
    tris: np.ndarray,
    colors: np.ndarray | None = None,
    uvs: np.ndarray | None = None,
    texture_png: bytes | None = None,
    name: str = "uvtrace",
) -> None:
    """Write float32[T,3,3] triangles (flat, unindexed) with optional
    per-triangle RGB `colors` [T,3] (expanded per-vertex) or per-corner
    [T,3,3]; optional uvs [T,3,2] and a base-color texture (`texture_png`
    accepts PNG or JPEG bytes; the mime type is sniffed)."""
    tris = np.ascontiguousarray(tris, np.float32)
    t = tris.shape[0]
    positions = tris.reshape(-1, 3)

    buffers = []
    buffer_views = []
    accessors = []
    attributes = {}

    def add_view(data: bytes, target=None):
        offset = sum(len(b) for b in buffers)
        buffers.append(_pad(data))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(view, comp_type, count, type_str, minmax=None):
        acc = {
            "bufferView": view,
            "componentType": comp_type,
            "count": count,
            "type": type_str,
        }
        if minmax:
            acc["min"], acc["max"] = minmax
        accessors.append(acc)
        return len(accessors) - 1

    pv = add_view(positions.tobytes(), target=34962)
    attributes["POSITION"] = add_accessor(
        pv, 5126, len(positions), "VEC3",
        ([float(x) for x in positions.min(0)], [float(x) for x in positions.max(0)]),
    )
    if colors is not None:
        colors = np.asarray(colors, np.float32)
        if colors.ndim == 2:  # per-triangle -> per-corner (dosageToColor
            # writes the same RGB to all 3 corners, cl/shade.cl:61-70)
            colors = np.repeat(colors[:, None, :], 3, axis=1)
        cv = add_view(np.ascontiguousarray(colors.reshape(-1, 3)).tobytes(), target=34962)
        attributes["COLOR_0"] = add_accessor(cv, 5126, 3 * t, "VEC3")
    if uvs is not None:
        uv = np.ascontiguousarray(np.asarray(uvs, np.float32).reshape(-1, 2))
        uvv = add_view(uv.tobytes(), target=34962)
        attributes["TEXCOORD_0"] = add_accessor(uvv, 5126, 3 * t, "VEC2")

    gltf = {
        "asset": {"version": "2.0", "generator": "uvtrace"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": name}],
        "meshes": [{"primitives": [{"attributes": attributes, "mode": 4}]}],
    }
    if texture_png is not None:
        iv = add_view(texture_png)
        mime = "image/jpeg" if texture_png[:2] == b"\xff\xd8" else "image/png"
        gltf["images"] = [{"bufferView": iv, "mimeType": mime}]
        gltf["samplers"] = [{}]
        gltf["textures"] = [{"source": 0, "sampler": 0}]
        gltf["materials"] = [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}
        ]
        gltf["meshes"][0]["primitives"][0]["material"] = 0

    bin_chunk = b"".join(buffers)
    gltf["buffers"] = [{"byteLength": len(bin_chunk)}]
    gltf["bufferViews"] = buffer_views
    gltf["accessors"] = accessors

    json_bytes = _pad(json.dumps(gltf, separators=(",", ":")).encode(), fill=b" ")
    bin_bytes = _pad(bin_chunk)
    total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
    out = (
        struct.pack("<III", 0x46546C67, 2, total)
        + struct.pack("<II", len(json_bytes), _CHUNK_JSON)
        + json_bytes
        + struct.pack("<II", len(bin_bytes), _CHUNK_BIN)
        + bin_bytes
    )
    Path(path).write_bytes(out)
