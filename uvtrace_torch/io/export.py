"""Dose-map exports: npy arrays, heatmap legend, rendered PNG views
(uvtrace/io/export.py). Dose maps may be tensors on any device or numpy
arrays; the colouring runs in ops/shade.py and the rendering in
viz/rasterizer.py on the dose's device (numpy: the card, unless `device`
says otherwise)."""

from __future__ import annotations

import numpy as np
import torch

from uvtrace_torch.io.png import write_png
from uvtrace_torch.ops.shade import dosage_to_color, greyscale_to_heatmap


def _numpy(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def export_dose_npy(path, dose) -> None:
    np.save(str(path), _numpy(dose))


def export_heatmap_png(path, mesh_tris, dose, min_value, threshold_view=False,
                       camera=None, width=960, height=720, gamma=False,
                       route=None, selected=-1, floor_height=0.0,
                       light_height=0.8, light_length=1.0, device=None) -> None:
    """Render the per-triangle heatmap to a PNG (the reference's GL view,
    myapp.cpp:180-205, headless). `route` draws lamp-rod markers on top
    (myapp.cpp:140-153); `gamma` sqrt-encodes (opt-in: the reference's blit
    ships with gamma commented out, template.cpp:159)."""
    from uvtrace_torch.viz.rasterizer import default_camera, draw_route_markers, render_device, render_heatmap

    dev = render_device(device, dose)
    if camera is None:
        camera = default_camera(mesh_tris)
    colors = dosage_to_color(torch.as_tensor(dose, dtype=torch.float32, device=dev), min_value, threshold_view)
    img = render_heatmap(mesh_tris, colors, camera=camera, width=width, height=height, gamma=gamma)
    if route:
        img = draw_route_markers(img, camera, route, floor_height, light_height, light_length, selected)
    write_png(path, img)


def export_legend_png(path, min_value, width=256, height=32) -> None:
    """The heatmap legend strip (UI legend, userinterface.cpp:366-402):
    gradient from 0 to 2*min_value."""
    ramp = np.linspace(0.0, 1.0, width, dtype=np.float32)
    colors = greyscale_to_heatmap(torch.from_numpy(ramp)).numpy()
    img = np.clip(np.broadcast_to(colors[None, :, :], (height, width, 3)), 0, 1)
    write_png(path, (img * 255).astype(np.uint8))


def export_grid_png(path, grid, min_value, threshold_view=False, route=None,
                    aabb=None, selected=-1, gamma=False) -> None:
    """Top-down dose-grid image (Simulator.dose_grid) with the reference's
    5-stop heatmap gradient (cl/shade.cl:43-71); optional waypoint crosses."""
    grid = _numpy(grid).astype(np.float32)
    colors = dosage_to_color(torch.from_numpy(grid.ravel()), min_value,
                             threshold_view).numpy().reshape(grid.shape[0], grid.shape[1], 3)
    colors = np.clip(colors, 0, 1)
    if gamma:
        colors = np.sqrt(colors)
    img = (colors * 255).astype(np.uint8)
    if route is not None and aabb is not None:
        from uvtrace_torch.viz.rasterizer import draw_route_markers_grid

        img = draw_route_markers_grid(img, aabb, route, selected)
    write_png(path, img)
