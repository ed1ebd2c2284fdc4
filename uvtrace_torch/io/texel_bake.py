"""Bake the per-texel dose map into a texture atlas image + UVs (the port of
uvtrace/io/texel_bake.py: the packing and the block fill are the same host
loops; the colours come from ops/shade.py on the dose's device).

The reference renders everything it accumulates — its dose -> color ->
screen path is end-to-end at per-triangle resolution (cl/shade.cl:61-70,
myapp.cpp:180-205). uvtrace accumulates SUB-triangle dose (ops/texel.py);
this module closes the same loop at texel resolution: every triangle's
k x k barycentric cell grid becomes a block of a packed texture image
(heatmap-colored), with per-corner UVs mapping the triangle onto its block.

The baked (image, uvs) pair feeds BOTH display paths:
  - viz.rasterizer.render_textured -> a per-pixel texel-resolution PNG;
  - io.gltf_export.export_glb(uvs=..., texture_png=...) -> a .glb any
    glTF viewer shows with sub-triangle dose detail.

Block layout: triangle t owns a k_t x k_t pixel block; pixel (ix, iy) of
the block shows cell base_t + iy*k_t + ix. Pixels above the anti-diagonal
(ix + iy >= k) lie OUTSIDE the uv triangle and are filled with the folded
cell's color (ops/texel.texel_ids folds (u,v) with u+v>1 the same way), so
linear filtering at the diagonal edge stays consistent.
"""

from __future__ import annotations

import numpy as np
import torch


def bake_texel_atlas(
    atlas,
    texel_dose,
    min_value: float,
    threshold_view: bool = False,
    max_dim: int = 8192,
):
    """Pack heatmap-colored texel blocks into one image.

    atlas: ops.texel.TexelAtlas; texel_dose: float[n_slots] (physical units,
    same as dosage_map), a tensor or numpy. Returns (image uint8[H,W,3],
    uvs float32[T,3,2]).

    Blocks are shelf-packed in descending-k order with a 1-pixel gutter.
    If the packing exceeds max_dim x max_dim, every block is downsampled by
    the smallest power-of-two stride that fits (nearest-cell sampling).
    """
    from uvtrace_torch.ops.shade import dosage_to_color

    k = atlas.k.cpu().numpy().astype(np.int64)
    base = atlas.base.cpu().numpy().astype(np.int64)
    t_count = k.shape[0]
    colors = dosage_to_color(torch.as_tensor(texel_dose, dtype=torch.float32), min_value, threshold_view)
    colors8 = (colors * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()

    stride = 1
    while True:
        k_eff = np.maximum(1, -(-k // stride))
        # shelf packing estimate: blocks of (k_eff+1)^2 incl. gutter
        total = int(((k_eff + 1) ** 2).sum())
        width = 1 << max(4, int(np.ceil(np.sqrt(total))) - 1).bit_length()
        width = min(width, max_dim)
        # exact shelf pack (descending k): compute rows
        order = np.argsort(-k_eff, kind="stable")
        x = np.zeros(t_count, np.int64)
        y = np.zeros(t_count, np.int64)
        cx = 0
        cy = 0
        row_h = 0
        for t in order:
            b = int(k_eff[t]) + 1  # block + gutter
            if cx + b > width:
                cy += row_h
                cx = 0
                row_h = 0
            x[t], y[t] = cx, cy
            cx += b
            row_h = max(row_h, b)
        height = cy + row_h
        if height <= max_dim:
            break
        stride *= 2

    img = np.zeros((height, width, 3), np.uint8)
    uvs = np.zeros((t_count, 3, 2), np.float32)
    for t in range(t_count):
        ke = int(k_eff[t])
        kt = int(k[t])
        iy, ix = np.mgrid[0:ke, 0:ke]
        # cell indices at the original resolution (nearest when downsampled)
        cix = np.minimum(ix * stride, kt - 1)
        ciy = np.minimum(iy * stride, kt - 1)
        # fold the out-of-triangle upper half onto its paired cell
        over = cix + ciy >= kt
        fix = np.where(over, kt - 1 - cix, cix)
        fiy = np.where(over, kt - 1 - ciy, ciy)
        block = colors8[base[t] + fiy * kt + fix]
        img[y[t] : y[t] + ke, x[t] : x[t] + ke] = block
        # uv corners: v0 -> block origin, v1 -> +u edge, v2 -> +v edge
        uvs[t, 0] = (x[t], y[t])
        uvs[t, 1] = (x[t] + ke, y[t])
        uvs[t, 2] = (x[t], y[t] + ke)
    uvs[:, :, 0] /= width
    uvs[:, :, 1] /= height
    return img, uvs


def export_texel_heatmap_png(
    path, mesh_tris, atlas, texel_dose, min_value, threshold_view=False,
    camera=None, width: int = 960, height: int = 720, gamma: bool = False, device=None,
) -> None:
    """Camera-view heatmap PNG at TEXEL resolution: bake the atlas, then
    rasterize with per-pixel UV sampling (viz.rasterizer.render_textured) on
    `device` (None: that of texel_dose when it is a tensor, else the card)."""
    from uvtrace_torch.geometry.mesh import TriangleMesh
    from uvtrace_torch.io.png import write_png
    from uvtrace_torch.viz.rasterizer import render_device, render_textured

    image, uvs = bake_texel_atlas(atlas, texel_dose, min_value, threshold_view)
    mesh = TriangleMesh(tris=np.asarray(mesh_tris), uvs=uvs, texture=image)
    img = render_textured(mesh, camera=camera, width=width, height=height, gamma=gamma,
                          device=render_device(device, texel_dose))
    write_png(path, img)


def export_texel_glb(
    path, mesh_tris, atlas, texel_dose, min_value, threshold_view=False
) -> None:
    """Dose-textured .glb: sub-triangle dose visible in any glTF viewer."""
    from uvtrace_torch.io.gltf_export import export_glb
    from uvtrace_torch.io.png import png_bytes

    image, uvs = bake_texel_atlas(atlas, texel_dose, min_value, threshold_view)
    export_glb(path, np.asarray(mesh_tris), uvs=uvs, texture_png=png_bytes(image))
