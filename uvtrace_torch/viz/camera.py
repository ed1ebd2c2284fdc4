"""Camera with reference-compatible XML persistence.

Numpy copy of uvtrace/viz/camera.py, kept equal to it by tests/test_torch_io_viz.py.

The reference camera (camera.cpp) is a glm 4x4 view matrix with WASD/arrow
controls, persisted to camera.xml as the 16 matrix entries + FOV
(camera.cpp:45-99, default FOV 40°, myapp.cpp:26). This module keeps the same
on-disk schema so camera.xml files interoperate, and offers a look-at
constructor for the headless renderer.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from xml.etree import ElementTree as ET

import numpy as np


@dataclasses.dataclass
class Camera:
    view: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4, dtype=np.float32))
    fov_deg: float = 40.0  # myapp.cpp:26

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_deg: float = 40.0) -> "Camera":
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        f = target - eye
        f = f / np.linalg.norm(f)
        s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        view = np.eye(4, dtype=np.float32)
        view[0, :3] = s
        view[1, :3] = u
        view[2, :3] = -f
        view[0, 3] = -np.dot(s, eye)
        view[1, 3] = -np.dot(u, eye)
        view[2, 3] = np.dot(f, eye)  # row 2 is -f, so the translation is +f.eye
        return Camera(view=view, fov_deg=fov_deg)

    # ------------------------------------------------------------- xml io

    def save_xml(self, path: str | Path):
        root = ET.Element("camera")
        ve = ET.SubElement(root, "view")
        # glm is column-major: view[col][row]; serialize like the reference
        for col in range(4):
            for row in range(4):
                ve.set(f"m{col}{row}", f"{self.view[row, col]:.9g}")
        fov = ET.SubElement(root, "FOV")
        fov.text = f"{self.fov_deg:.9g}"
        ET.ElementTree(root).write(str(path), encoding="unicode")

    @staticmethod
    def load_xml(path: str | Path) -> "Camera":
        root = ET.parse(str(path)).getroot()
        cam = Camera()
        ve = root.find("view")
        if ve is not None:
            for col in range(4):
                for row in range(4):
                    v = ve.get(f"m{col}{row}")
                    if v is not None:
                        cam.view[row, col] = float(v)
        fov = root.find("FOV")
        if fov is not None and fov.text:
            cam.fov_deg = float(fov.text)
        return cam
