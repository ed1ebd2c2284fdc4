"""Procedural scene generators for tests and benchmarks.

Numpy copy of uvtrace/geometry/procedural.py, kept equal to it by tests/test_torch_host.py.

The reference ships hospital-room scans (rooms/*.glb); the large ones
(C046_1*.glb, 46,252 triangles — Report §2.1) are not available in this
environment, so benchmarks use procedurally generated rooms of matching
triangle counts.
"""

from __future__ import annotations

import numpy as np

from uvtrace_torch.geometry.mesh import TriangleMesh, detect_floor_height


def _quad(a, b, c, d) -> np.ndarray:
    """Two CCW triangles for quad corners a-b-c-d."""
    return np.array([[a, b, c], [a, c, d]], dtype=np.float32)


def make_box_room(
    size=(6.0, 3.0, 8.0),
    floor_y: float = -1.0,
    subdivisions: int = 1,
    clutter: int = 0,
    seed: int = 0,
) -> TriangleMesh:
    """An axis-aligned room (floor, ceiling, 4 walls), optionally subdivided
    into a grid of quads per face, with optional random box "furniture".

    ``subdivisions=48, clutter=24`` yields ~46k triangles — the scale of the
    reference's C046_1 hospital room (Report §2.1).
    """
    sx, sy, sz = size
    x0, x1 = -sx / 2, sx / 2
    y0, y1 = floor_y, floor_y + sy
    z0, z1 = -sz / 2, sz / 2
    n = max(1, subdivisions)
    tris = []

    def face(origin, du, dv):
        origin, du, dv = map(np.asarray, (origin, du, dv))
        for i in range(n):
            for j in range(n):
                a = origin + du * (i / n) + dv * (j / n)
                b = origin + du * ((i + 1) / n) + dv * (j / n)
                c = origin + du * ((i + 1) / n) + dv * ((j + 1) / n)
                d = origin + du * (i / n) + dv * ((j + 1) / n)
                tris.append(_quad(a, b, c, d))

    face((x0, y0, z0), (sx, 0, 0), (0, 0, sz))  # floor
    face((x0, y1, z0), (0, 0, sz), (sx, 0, 0))  # ceiling
    face((x0, y0, z0), (0, sy, 0), (sx, 0, 0))  # wall z0
    face((x0, y0, z1), (sx, 0, 0), (0, sy, 0))  # wall z1
    face((x0, y0, z0), (0, 0, sz), (0, sy, 0))  # wall x0
    face((x1, y0, z0), (0, sy, 0), (0, 0, sz))  # wall x1

    rng = np.random.default_rng(seed)
    for _ in range(clutter):
        cx = rng.uniform(x0 + 0.5, x1 - 0.5)
        cz = rng.uniform(z0 + 0.5, z1 - 0.5)
        w, h, d = rng.uniform(0.2, 1.0, size=3)
        bx0, bx1 = cx - w / 2, cx + w / 2
        bz0, bz1 = cz - d / 2, cz + d / 2
        by0, by1 = y0, y0 + h
        corners = lambda x, y, z: (x, y, z)
        # 6 faces of the box (2 tris each)
        tris.append(_quad((bx0, by1, bz0), (bx1, by1, bz0), (bx1, by1, bz1), (bx0, by1, bz1)))
        tris.append(_quad((bx0, by0, bz0), (bx0, by1, bz0), (bx0, by1, bz1), (bx0, by0, bz1)))
        tris.append(_quad((bx1, by0, bz0), (bx1, by0, bz1), (bx1, by1, bz1), (bx1, by1, bz0)))
        tris.append(_quad((bx0, by0, bz0), (bx1, by0, bz0), (bx1, by1, bz0), (bx0, by1, bz0)))
        tris.append(_quad((bx0, by0, bz1), (bx0, by1, bz1), (bx1, by1, bz1), (bx1, by0, bz1)))

    all_tris = np.concatenate(tris, axis=0).astype(np.float32)
    return TriangleMesh(
        tris=all_tris,
        floor_height=detect_floor_height(all_tris),
        name=f"box_room_n{n}_c{clutter}",
    )


def make_single_square(
    center=(0.0, 0.0, 0.0), half_width: float = 0.1, axis: str = "z"
) -> TriangleMesh:
    """A 2-triangle square facing the given axis — the calibration target
    geometry (raytracer.cpp:156-170 builds a 0.2x0.2 m square)."""
    cx, cy, cz = center
    w = half_width
    if axis == "z":
        v = np.array(
            [
                [[cx + w, cy + w, cz], [cx - w, cy + w, cz], [cx + w, cy - w, cz]],
                [[cx - w, cy - w, cz], [cx - w, cy + w, cz], [cx + w, cy - w, cz]],
            ],
            dtype=np.float32,
        )
    elif axis == "y":
        v = np.array(
            [
                [[cx + w, cy, cz + w], [cx - w, cy, cz + w], [cx + w, cy, cz - w]],
                [[cx - w, cy, cz - w], [cx - w, cy, cz + w], [cx + w, cy, cz - w]],
            ],
            dtype=np.float32,
        )
    else:
        raise ValueError(axis)
    return TriangleMesh(tris=v, name="calibration_square")
