"""Headless software rasterizer (uvtrace/viz/rasterizer.py): the reference's
OpenGL heatmap view (myapp.cpp:180-205 + shaders/shader3D.*) as a z-buffered
edge-function rasterizer in PyTorch that renders per-triangle flat colours,
or per-pixel texture coordinates, to an image.

The JAX version walks 256-triangle chunks and tests every triangle against
every pixel, keeping a running depth minimum: a pixel shows the first
triangle, in index order, of least depth among those that cover it. Here
each triangle is tested only against the pixels of its screen bounding box
(with a pixel of margin): the (triangle, pixel) pairs are enumerated in
groups of about PAIRS_PER_GROUP, each covered pair is keyed by (depth bits,
triangle index) and one scatter-min per group keeps each pixel's least key.
Depths of covered pairs are positive, so their f32 bits order like the
values; the key's low word breaks depth ties towards the lower index, as the
JAX version's strict running test does. The same edge functions, depth test
and degenerate-triangle rule give the same images but for rounding at edges
and depth ties.
"""

from __future__ import annotations

import numpy as np
import torch

from uvtrace_torch.viz.camera import Camera

PAIRS_PER_GROUP = 1 << 21  # (triangle, pixel) candidates per group: about 250 MB of temporaries
_NO_HIT = torch.iinfo(torch.int64).max


def render_device(device, like=None) -> torch.device:
    """The render's device: `device` if given, else that of `like` when it is
    a tensor, else the card."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return torch.device("cuda")


def _project(tris: torch.Tensor, view: torch.Tensor, fov_deg: float, width: int, height: int):
    """World f32[T,3,3] -> screen xy f32[T,3,2] and view-space depth f32[T,3]."""
    t_count = tris.shape[0]
    v = tris.reshape(-1, 3)
    vh = torch.cat([v, torch.ones((v.shape[0], 1), dtype=v.dtype, device=v.device)], dim=1)
    cam = (view @ vh.T).T  # [N,4], view space (-z forward)
    z = -cam[:, 2]
    f = 1.0 / np.tan(np.radians(np.float32(fov_deg)) / np.float32(2.0))
    aspect = width / height
    eps = 1e-6
    x_ndc = (cam[:, 0] * float(f) / aspect) / torch.clamp_min(z, eps)
    y_ndc = (cam[:, 1] * float(f)) / torch.clamp_min(z, eps)
    sx = (x_ndc * 0.5 + 0.5) * width
    sy = (1.0 - (y_ndc * 0.5 + 0.5)) * height
    xy = torch.stack([sx, sy], dim=1).reshape(t_count, 3, 2)
    return xy, z.reshape(t_count, 3)


def _edges(xy: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor):
    """(e_ab, e_bc, e_ca, area, inside) of triangles xy [..., 3, 2] at pixel
    centres (gx, gy), with the JAX version's edge functions and sign rule."""
    a, b, c = xy[..., 0, :], xy[..., 1, :], xy[..., 2, :]

    def edge(p, q):
        return (q[..., 0] - p[..., 0]) * (gy - p[..., 1]) - (q[..., 1] - p[..., 1]) * (gx - p[..., 0])

    e_ab, e_bc, e_ca = edge(a, b), edge(b, c), edge(c, a)
    area = (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])
    inside = torch.where(area >= 0, (e_ab >= 0) & (e_bc >= 0) & (e_ca >= 0),
                         (e_ab <= 0) & (e_bc <= 0) & (e_ca <= 0))
    return e_ab, e_bc, e_ca, area, inside


def _perspective(xy, depth, gx, gy):
    """(la, lb, lc, z_px) of pixels inside triangles: barycentric weights from
    the edge functions and the perspective-correct depth."""
    e_ab, e_bc, e_ca, area, _ = _edges(xy, gx, gy)
    inv_area = 1.0 / torch.where(area.abs() < 1e-12, torch.ones_like(area), area)
    la, lb, lc = e_bc * inv_area, e_ca * inv_area, e_ab * inv_area
    inv_z = la / depth[..., 0] + lb / depth[..., 1] + lc / depth[..., 2]
    return la, lb, lc, 1.0 / torch.clamp_min(inv_z, 1e-12)


def _visible(xy: torch.Tensor, depth: torch.Tensor, width: int, height: int, per_pixel_depth: bool):
    """i64[H*W] the visible triangle of every pixel, -1 where none covers it.
    per_pixel_depth: the depth test compares the perspective-correct depth
    at the pixel (the textured view), else the triangle's mean depth."""
    dev = xy.device
    t_count = xy.shape[0]
    best = torch.full((width * height,), _NO_HIT, dtype=torch.int64, device=dev)
    if t_count == 0:
        return torch.full_like(best, -1)
    a, b, c = xy[:, 0], xy[:, 1], xy[:, 2]
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    # dropped: triangles crossing the camera plane, degenerate or non-finite ones
    keep = ~(depth <= 1e-4).any(1) & (area.abs() > 1e-12) & torch.isfinite(xy).all(2).all(1)
    lo = torch.floor(xy.amin(1)) - 1
    hi = torch.ceil(xy.amax(1)) + 1
    x0 = lo[:, 0].clamp(0, width).long()
    y0 = lo[:, 1].clamp(0, height).long()
    bw = torch.where(keep, hi[:, 0].clamp(0, width).long() - x0, 0).clamp_min(0)
    bh = torch.where(keep, hi[:, 1].clamp(0, height).long() - y0, 0).clamp_min(0)
    pairs = bw * bh
    zmean = depth.mean(1)
    # group boundaries on the host: one copy of the per-triangle pair counts
    ends = np.cumsum(pairs.cpu().numpy())
    starts = np.concatenate([[0], ends[:-1]])
    cuts = np.flatnonzero(np.diff(starts // PAIRS_PER_GROUP, append=np.inf)) + 1
    first = 0
    for last in cuts:
        last = int(min(last, t_count))
        total = int(ends[last - 1] - starts[first])
        if total == 0:
            first = last
            continue
        ids = torch.arange(first, last, device=dev)
        cnt = pairs[first:last]
        tri = torch.repeat_interleave(ids, cnt, output_size=total)
        offs = torch.arange(total, device=dev) - (torch.cumsum(cnt, 0) - cnt)[tri - first]
        px = x0[tri] + offs % bw[tri]
        py = y0[tri] + offs // bw[tri]
        gx = px.to(torch.float32) + 0.5
        gy = py.to(torch.float32) + 0.5
        txy = xy[tri]
        inside = _edges(txy, gx, gy)[4]
        z = _perspective(txy, depth[tri], gx, gy)[3] if per_pixel_depth else zmean[tri]
        covered = inside & (z < float("inf"))
        key = (z.view(torch.int32).long() << 32) | tri
        best.scatter_reduce_(0, (py * width + px)[covered], key[covered], "amin")
        first = last
    return torch.where(best == _NO_HIT, -1, best & 0xFFFFFFFF)


def render_textured(mesh, camera: Camera | None = None, width: int = 640, height: int = 480,
                    gamma: bool = False, device=None) -> np.ndarray:
    """Render the scene with its scan texture, per pixel (the reference's
    'photo scan' view: simpleshader + mesh texture, myapp.cpp:186-194), with
    perspective-correct UVs and nearest sampling with wrap-around. Falls
    back to per-triangle average colours when the mesh has no texture or no
    UVs. device: the rasterizer's (None: the card). Returns uint8[H,W,3]."""
    if mesh.texture is None or mesh.uvs is None:
        return render_heatmap(mesh.tris, mesh.flat_texture_colors(), camera=camera, width=width,
                              height=height, gamma=gamma, device=device)
    dev = render_device(device)
    if camera is None:
        camera = default_camera(mesh.tris)
    tris = torch.as_tensor(np.asarray(mesh.tris, np.float32), device=dev)
    view = torch.as_tensor(np.asarray(camera.view, np.float32), device=dev)
    xy, depth = _project(tris, view, camera.fov_deg, width, height)
    tri = _visible(xy, depth, width, height, per_pixel_depth=True)
    hit = tri >= 0
    pix = torch.nonzero(hit).squeeze(1)
    win = tri[pix]
    gx = (pix % width).to(torch.float32) + 0.5
    gy = (pix // width).to(torch.float32) + 0.5
    la, lb, lc, z_px = _perspective(xy[win], depth[win], gx, gy)
    uv = torch.as_tensor(np.asarray(mesh.uvs, np.float32), device=dev)[win]
    za, zb, zc = depth[win, 0], depth[win, 1], depth[win, 2]
    uvbuf = torch.zeros((width * height, 2), dtype=torch.float32, device=dev)
    for j in range(2):
        uvbuf[pix, j] = (la * uv[:, 0, j] / za + lb * uv[:, 1, j] / zb + lc * uv[:, 2, j] / zc) * z_px
    uvbuf = uvbuf.reshape(height, width, 2).cpu().numpy()
    hitbuf = hit.reshape(height, width).cpu().numpy()
    tex = np.asarray(mesh.texture)
    h, w = tex.shape[:2]
    # GL_REPEAT + nearest sampling (mesh.cpp:166-199): floor(u * w), so the
    # baked atlas's gutters are never sampled at block edges
    tx = np.clip(np.floor((uvbuf[..., 0] % 1.0) * w).astype(np.int64), 0, w - 1)
    ty = np.clip(np.floor((uvbuf[..., 1] % 1.0) * h).astype(np.int64), 0, h - 1)
    img = np.where(hitbuf[..., None], tex[ty, tx].astype(np.float32) / 255.0, 0.0)
    img = np.clip(img, 0.0, 1.0)
    if gamma:
        img = np.sqrt(img)
    return (img * 255.0).astype(np.uint8)


def default_camera(mesh_tris) -> Camera:
    """Look-at from above the scene diagonal (used when no camera.xml)."""
    v = np.asarray(mesh_tris, np.float32).reshape(-1, 3)
    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2
    size = float(np.linalg.norm(hi - lo))
    eye = center + np.array([0.45, 0.75, 0.45]) * size
    return Camera.look_at(eye, center)


def render_heatmap(mesh_tris, colors, camera: Camera | None = None, width: int = 640, height: int = 480,
                   gamma: bool = False, device=None) -> np.ndarray:
    """Render per-triangle RGB colours (f32[T,3], numpy or a tensor) to a
    uint8 image [H,W,3]. camera: defaults to a look-at from above the scene
    diagonal. gamma: sqrt-encode the output (the reference's display path is
    linear: template/template.cpp:159 ships with the sqrt commented out).
    device: the rasterizer's (None: that of `colors` when it is a tensor,
    else the card)."""
    dev = render_device(device, colors)
    if camera is None:
        camera = default_camera(mesh_tris)
    tris = torch.as_tensor(np.asarray(mesh_tris, np.float32), device=dev)
    view = torch.as_tensor(np.asarray(camera.view, np.float32), device=dev)
    xy, depth = _project(tris, view, camera.fov_deg, width, height)
    tri = _visible(xy, depth, width, height, per_pixel_depth=False)
    colors = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    img = torch.where((tri >= 0)[:, None], colors[tri.clamp_min(0)], 0.0).reshape(height, width, 3)
    img = img.clamp(0.0, 1.0)
    if gamma:
        img = img.sqrt()
    return (img * 255.0).cpu().numpy().astype(np.uint8)


def project_points(points, camera: Camera, width: int, height: int):
    """World points [N,3] -> (screen xy [N,2], view depth [N]) — the same
    transform Draw3DLine applies (myapp.cpp:43-51)."""
    v = np.asarray(points, np.float64).reshape(-1, 3)
    vh = np.concatenate([v, np.ones((len(v), 1))], axis=1)
    cam = (np.asarray(camera.view, np.float64) @ vh.T).T
    z = -cam[:, 2]
    f = 1.0 / np.tan(np.radians(camera.fov_deg) / 2.0)
    aspect = width / height
    zs = np.maximum(z, 1e-6)
    sx = (cam[:, 0] * f / aspect / zs * 0.5 + 0.5) * width
    sy = (1.0 - (cam[:, 1] * f / zs * 0.5 + 0.5)) * height
    return np.stack([sx, sy], axis=1), z


def _paint_line(img, p0, p1, color, thickness=3):
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1])) * 2) + 2
    xs = np.linspace(p0[0], p1[0], n)
    ys = np.linspace(p0[1], p1[1], n)
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xi = np.clip(np.round(xs + dx).astype(int), 0, w - 1)
            yi = np.clip(np.round(ys + dy).astype(int), 0, h - 1)
            keep = (xs + dx >= 0) & (xs + dx < w) & (ys + dy >= 0) & (ys + dy < h)
            img[yi[keep], xi[keep]] = color


def draw_route_markers(img: np.ndarray, camera: Camera, route, floor_height: float, light_height: float,
                       light_length: float, selected: int = -1) -> np.ndarray:
    """Draw every waypoint's lamp rod as a 3-px projected line — white, the
    selected lamp (255,100,100) — the reference's marker overlay
    (myapp.cpp:140-153: Draw3DLine from the rod base to base+lightLength).
    Mutates and returns the uint8 [H,W,3] image."""
    h, w = img.shape[:2]
    for i, wp in enumerate(route):
        base = np.array([wp.x, floor_height + light_height, wp.y])
        top = base + np.array([0.0, light_length, 0.0])
        (p0, p1), z = project_points(np.stack([base, top]), camera, w, h)
        if z.min() <= 1e-4:
            continue  # behind the camera
        color = (255, 100, 100) if i == selected else (255, 255, 255)
        _paint_line(img, p0, p1, np.array(color, np.uint8))
    return img


def draw_route_markers_grid(img: np.ndarray, aabb, route, selected: int = -1, cross: int = 4) -> np.ndarray:
    """Waypoint crosses on a top-down dose-grid image (Simulator.dose_grid
    pixel mapping: x -> column over aabb x-range, z -> row over z-range)."""
    lo, hi = np.asarray(aabb[0]), np.asarray(aabb[1])
    h, w = img.shape[:2]
    for i, wp in enumerate(route):
        cx = (wp.x - lo[0]) / max(hi[0] - lo[0], 1e-9) * (w - 1)
        cy = (wp.y - lo[2]) / max(hi[2] - lo[2], 1e-9) * (h - 1)
        color = np.array((255, 100, 100) if i == selected else (255, 255, 255), np.uint8)
        _paint_line(img, (cx - cross, cy), (cx + cross, cy), color, thickness=1)
        _paint_line(img, (cx, cy - cross), (cx, cy + cross), color, thickness=1)
    return img
