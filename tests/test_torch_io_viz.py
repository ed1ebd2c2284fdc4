"""The port's output modules against the JAX package's on the same inputs:
PNG, JPEG, glTF export and texture loading, i18n, camera XML, the
rasterizer, the texel atlas bake, checkpoints (across the two packages),
the exports and the timing helpers. All on the CPU."""

import dataclasses
import io
import json

import jax  # noqa: F401  (conftest pins the JAX side to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace import i18n as jax_i18n
from uvtrace.geometry.gltf import load_glb as jax_load_glb
from uvtrace.geometry.mesh import TriangleMesh as JaxTriangleMesh
from uvtrace.geometry.procedural import make_box_room, make_single_square
from uvtrace.io import checkpoint as jax_checkpoint
from uvtrace.io import export as jax_export
from uvtrace.io import gltf_export as jax_gltf_export
from uvtrace.io import jpeg as jax_jpeg
from uvtrace.io import png as jax_png
from uvtrace.io import texel_bake as jax_bake
from uvtrace.io.routexml import LightPos as JaxLightPos
from uvtrace.ops import texel as jax_texel
from uvtrace.sim import SimParams as JaxSimParams
from uvtrace.sim import Simulator as JaxSimulator
from uvtrace.viz import camera as jax_camera
from uvtrace.viz import rasterizer as jax_raster
from uvtrace_torch import i18n
from uvtrace_torch.geometry.gltf import load_glb
from uvtrace_torch.geometry.mesh import TriangleMesh
from uvtrace_torch.io import checkpoint, export, gltf_export, jpeg, png, texel_bake
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.ops import texel
from uvtrace_torch.sim import SimParams, Simulator, ViewMode
from uvtrace_torch.utils.timing import ProgressReporter, Timer, device_trace
from uvtrace_torch.viz import camera, rasterizer

PIXEL_SHARE = 0.005  # rasterized pixels that may differ from JAX's (edges, depth ties)
CAMERAS = [None, ((1.0, 2.5, 3.5), (0.0, 0.0, 0.0)), ((0.2, 0.3, 0.1), (2.0, 0.0, 1.0))]


@pytest.fixture(scope="module")
def room():
    return make_box_room(subdivisions=4, clutter=3, seed=1)


def _images(seed):
    g = np.random.default_rng(seed)
    return [g.integers(0, 256, (16, 24, 3)).astype(np.uint8), g.integers(0, 256, (5, 7)).astype(np.uint8)]


# ------------------------------------------------------------- codecs, glTF


@pytest.mark.parametrize("seed", [0, 1])
def test_png_bytes_equal_and_roundtrip(tmp_path, seed):
    for img in _images(seed):
        data = png.png_bytes(img)
        assert data == jax_png.png_bytes(img)
        png.write_png(tmp_path / "a.png", img)
        back = png.read_png(tmp_path / "a.png")
        np.testing.assert_array_equal(back, np.stack([img] * 3, -1) if img.ndim == 2 else img)
        np.testing.assert_array_equal(png.decode_png(data), jax_png.decode_png(data))
    with pytest.raises(ValueError, match="PNG"):
        png.decode_png(b"not a png at all")


def _jpeg_bytes(img, **kw):
    pil = pytest.importorskip("PIL.Image")
    buf = io.BytesIO()
    pil.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_decoder_equal(subsampling):
    """The baseline decoder gives JAX's decoder's pixels (4:4:4, 4:2:2,
    4:2:0), and progressive JPEGs are refused by both."""
    x = np.linspace(0, 4 * np.pi, 40)
    gx, gy = np.meshgrid(x, x)
    base = (127 + 60 * np.sin(gx) + 50 * np.cos(gy))[..., None]
    rgb = np.clip(np.concatenate([base, base * 0.8 + 30, 255 - base * 0.5], axis=2), 0, 255).astype(np.uint8)
    data = _jpeg_bytes(rgb, quality=88, subsampling=subsampling)
    got = jpeg.decode_jpeg_baseline(data)
    np.testing.assert_array_equal(got, jax_jpeg.decode_jpeg_baseline(data))
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), jax_jpeg.decode_jpeg(data))
    assert got.shape == rgb.shape and np.abs(got.astype(int) - rgb).mean() < 8
    prog = _jpeg_bytes(rgb, quality=80, progressive=True)
    for decode in (jpeg.decode_jpeg_baseline, jax_jpeg.decode_jpeg_baseline):
        with pytest.raises(NotImplementedError):
            decode(prog)


@pytest.mark.parametrize("texture", ["none", "png", "jpeg"])
def test_glb_export_bytes_and_texture_load_equal(tmp_path, room, texture):
    """export_glb writes JAX's bytes (colours, uvs, a texture); load_glb
    decodes the base-colour texture as JAX's loader does, and
    flat_texture_colors agrees."""
    g = np.random.default_rng(4)
    t = room.triangle_count
    colors = g.uniform(0, 1, (t, 3)).astype(np.float32)
    uvs = g.uniform(0, 1, (t, 3, 2)).astype(np.float32)
    tex = g.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    kw = {}
    if texture == "png":
        kw = dict(uvs=uvs, texture_png=png.png_bytes(tex))
    elif texture == "jpeg":
        kw = dict(uvs=uvs, texture_png=_jpeg_bytes(np.repeat(np.repeat(tex, 4, 0), 4, 1), quality=95, subsampling=0))
    gltf_export.export_glb(tmp_path / "p.glb", room.tris, colors=colors, **kw)
    jax_gltf_export.export_glb(tmp_path / "j.glb", room.tris, colors=colors, **kw)
    assert (tmp_path / "p.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    got, want = load_glb(tmp_path / "p.glb"), jax_load_glb(tmp_path / "p.glb")
    np.testing.assert_array_equal(got.tris, want.tris)
    if texture == "none":
        assert got.texture is None and want.texture is None
    else:
        np.testing.assert_array_equal(got.texture, want.texture)
        np.testing.assert_array_equal(got.uvs, want.uvs)
        if texture == "png":
            np.testing.assert_array_equal(got.texture, tex)
    np.testing.assert_array_equal(got.flat_texture_colors(), want.flat_texture_colors())


def test_i18n_and_camera_equal(tmp_path):
    assert i18n._STRINGS == jax_i18n._STRINGS
    try:
        i18n.set_language("nl")
        assert i18n.tr("progress") == "Voortgang" and "dosis" in i18n.tr("dose_max")
    finally:
        i18n.set_language("en")
    with pytest.raises(ValueError):
        i18n.set_language("de")
    cam = camera.Camera.look_at((1.0, 2.0, 3.0), (0.0, 0.5, 0.0), fov_deg=35.0)
    ref = jax_camera.Camera.look_at((1.0, 2.0, 3.0), (0.0, 0.5, 0.0), fov_deg=35.0)
    np.testing.assert_array_equal(cam.view, ref.view)
    cam.save_xml(tmp_path / "p.xml")
    ref.save_xml(tmp_path / "j.xml")
    assert (tmp_path / "p.xml").read_text() == (tmp_path / "j.xml").read_text()
    back = camera.Camera.load_xml(tmp_path / "j.xml")
    np.testing.assert_array_equal(back.view, jax_camera.Camera.load_xml(tmp_path / "p.xml").view)
    assert back.fov_deg == 35.0


# --------------------------------------------------------------- rendering


def _camera(spec, tris):
    if spec is None:
        return rasterizer.default_camera(tris), jax_raster.default_camera(tris)
    return camera.Camera.look_at(*spec), jax_camera.Camera.look_at(*spec)


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_render_heatmap_matches_jax(room, cam):
    """Per-triangle colours rasterized at 64x48 (and the gamma view):
    at most PIXEL_SHARE of the pixels differ from JAX's (rounding of the edge
    functions and depth ties); the third camera sits inside the room."""
    colors = np.random.default_rng(cam).uniform(0, 1, (room.triangle_count, 3)).astype(np.float32)
    pcam, jcam = _camera(CAMERAS[cam], room.tris)
    for gamma in (False, True):
        got = rasterizer.render_heatmap(room.tris, colors, camera=pcam, width=64, height=48, gamma=gamma,
                                        device="cpu")
        want = jax_raster.render_heatmap(room.tris, colors, camera=jcam, width=64, height=48, gamma=gamma)
        assert got.dtype == np.uint8 and got.shape == want.shape == (48, 64, 3)
        assert (got != want).any(-1).mean() <= PIXEL_SHARE
        assert (got > 0).any(-1).mean() > 0.2
    ones = torch.from_numpy(colors)  # a tensor's device is the render's
    np.testing.assert_array_equal(rasterizer.render_heatmap(room.tris, ones, camera=pcam, width=64, height=48),
                                  rasterizer.render_heatmap(room.tris, colors, camera=pcam, width=64, height=48,
                                                            device="cpu"))


def test_render_heatmap_depth_order_and_group_split(room, monkeypatch):
    """The nearer of two overlapping triangles wins; a pair budget smaller
    than one triangle's box gives the same image (groups of one)."""
    tris = np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]], [[-0.5, -0.5, 1], [0.5, -0.5, 1], [0, 0.5, 1]]],
                    np.float32)
    colors = np.array([[0, 0, 1], [1, 0, 0]], np.float32)
    cam = camera.Camera.look_at((0, 0, 4.0), (0, 0, 0))
    img = rasterizer.render_heatmap(tris, colors, camera=cam, width=64, height=64, device="cpu")
    assert img[32, 32, 0] > 200 and img[32, 32, 2] < 60
    colors = np.random.default_rng(0).uniform(0, 1, (room.triangle_count, 3)).astype(np.float32)
    want = rasterizer.render_heatmap(room.tris, colors, width=64, height=48, device="cpu")
    monkeypatch.setattr(rasterizer, "PAIRS_PER_GROUP", 97)
    np.testing.assert_array_equal(rasterizer.render_heatmap(room.tris, colors, width=64, height=48, device="cpu"),
                                  want)


def _checker_mesh(mesh_cls):
    tris = np.array([[[-1, 0, -1], [1, 0, -1], [1, 0, 1]], [[-1, 0, -1], [1, 0, 1], [-1, 0, 1]]], np.float32)
    uvs = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]], np.float32)
    checker = np.indices((8, 8)).sum(axis=0) % 2
    tex = (np.stack([np.repeat(np.repeat(checker, 16, 0), 16, 1)] * 3, axis=-1) * 255).astype(np.uint8)
    return mesh_cls(tris=tris, uvs=uvs, texture=tex)


def test_render_textured_matches_jax():
    """Per-pixel perspective-correct UVs: a checkerboard shows several
    alternations in one row, at most PIXEL_SHARE of the pixels differ from
    JAX's; the untextured fallback renders the flat colours."""
    spec = ((0.0, 3.0, 0.01), (0.0, 0.0, 0.0))
    got = rasterizer.render_textured(_checker_mesh(TriangleMesh), camera=camera.Camera.look_at(*spec), width=64,
                                     height=64, device="cpu")
    want = jax_raster.render_textured(_checker_mesh(JaxTriangleMesh), camera=jax_camera.Camera.look_at(*spec),
                                      width=64, height=64)
    assert (got != want).any(-1).mean() <= PIXEL_SHARE
    assert int((np.abs(np.diff(got[32, :, 0].astype(int))) > 128).sum()) >= 6
    plain = TriangleMesh(tris=_checker_mesh(TriangleMesh).tris)
    flat = rasterizer.render_textured(plain, camera=camera.Camera.look_at(*spec), width=32, height=32, device="cpu")
    assert flat.max() == 255


def test_route_markers_equal(room):
    route = [LightPos(0.0, 0.0, 60.0), LightPos(1.0, 0.5, 30.0)]
    jroute = [JaxLightPos(0.0, 0.0, 60.0), JaxLightPos(1.0, 0.5, 30.0)]
    pcam, jcam = _camera(None, room.tris)
    base = np.zeros((48, 64, 3), np.uint8)
    got = rasterizer.draw_route_markers(base.copy(), pcam, route, room.floor_height, 0.8, 1.0, selected=1)
    want = jax_raster.draw_route_markers(base.copy(), jcam, jroute, room.floor_height, 0.8, 1.0, selected=1)
    np.testing.assert_array_equal(got, want)
    assert ((got == (255, 100, 100)).all(-1)).any()
    np.testing.assert_array_equal(rasterizer.draw_route_markers_grid(base.copy(), room.aabb, route, 0),
                                  jax_raster.draw_route_markers_grid(base.copy(), room.aabb, jroute, 0))


def test_exports_match_jax(tmp_path, room):
    """The legend and the dose-grid PNG (with markers, gamma, threshold) are
    JAX's bytes; the heatmap PNG differs in at most PIXEL_SHARE of its pixels
    and draws the markers."""
    route = [LightPos(0.0, 0.0, 60.0), LightPos(1.0, 0.5, 30.0)]
    jroute = [JaxLightPos(0.0, 0.0, 60.0), JaxLightPos(1.0, 0.5, 30.0)]
    export.export_legend_png(tmp_path / "p.png", 100.0)
    jax_export.export_legend_png(tmp_path / "j.png", 100.0)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    grid = np.tile(np.linspace(0, 200, 32, dtype=np.float32), (24, 1))
    for kw in (dict(), dict(threshold_view=True, gamma=True, selected=0)):
        export.export_grid_png(tmp_path / "pg.png", grid, 100.0, route=route, aabb=room.aabb, **kw)
        jax_export.export_grid_png(tmp_path / "jg.png", grid, 100.0, route=jroute, aabb=room.aabb, **kw)
        assert (tmp_path / "pg.png").read_bytes() == (tmp_path / "jg.png").read_bytes()
    dose = np.linspace(0.0, 300.0, room.triangle_count).astype(np.float32)
    marker = dict(floor_height=room.floor_height, selected=1, width=64, height=48)
    export.export_heatmap_png(tmp_path / "ph.png", room.tris, torch.from_numpy(dose), 100.0, route=route, **marker)
    jax_export.export_heatmap_png(tmp_path / "jh.png", room.tris, jnp.asarray(dose), 100.0, route=jroute, **marker)
    got, want = png.read_png(tmp_path / "ph.png"), png.read_png(tmp_path / "jh.png")
    assert (got != want).any(-1).mean() <= PIXEL_SHARE and ((got == (255, 100, 100)).all(-1)).any()
    export.export_dose_npy(tmp_path / "d.npy", torch.from_numpy(dose))
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), dose)


# ------------------------------------------------------------- texel bake


@pytest.fixture(scope="module")
def gradient():
    """A 4 x 4 m floor of two triangles under one lamp (tests/test_texel_bake.py),
    its atlas at 8 texels per m and a texel dose from both packages' atlases."""
    floor = make_single_square(center=(0.0, 0.0, 0.0), half_width=2.0, axis="y")
    jatlas = jax_texel.build_atlas(floor.areas, density=8.0)
    patlas = texel.build_atlas(floor.areas, density=8.0)
    g = np.random.default_rng(5)
    slot_xy = g.uniform(0, 1, patlas.n_slots)
    dose = (100.0 * np.exp(-3 * slot_xy) + g.uniform(0, 5, patlas.n_slots)).astype(np.float32)
    return floor, jatlas, patlas, dose


@pytest.mark.parametrize("max_dim,threshold", [(8192, False), (16, True)])
def test_bake_texel_atlas_equal(gradient, max_dim, threshold):
    """The same image and uvs, also when the packing is downsampled."""
    floor, jatlas, patlas, dose = gradient
    got = texel_bake.bake_texel_atlas(patlas, torch.from_numpy(dose), 40.0, threshold, max_dim=max_dim)
    want = jax_bake.bake_texel_atlas(jatlas, dose, 40.0, threshold, max_dim=max_dim)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(got[0].reshape(-1, 3), axis=0)) > 8


def test_texel_heatmap_png_and_glb_match_jax(tmp_path, gradient):
    floor, jatlas, patlas, dose = gradient
    spec = ((0.0, 5.0, 0.01), (0.0, 0.0, 0.0))
    texel_bake.export_texel_heatmap_png(tmp_path / "p.png", floor.tris, patlas, torch.from_numpy(dose), 40.0,
                                        camera=camera.Camera.look_at(*spec), width=64, height=64)
    jax_bake.export_texel_heatmap_png(tmp_path / "j.png", floor.tris, jatlas, dose, 40.0,
                                      camera=jax_camera.Camera.look_at(*spec), width=64, height=64)
    got, want = png.read_png(tmp_path / "p.png"), png.read_png(tmp_path / "j.png")
    assert (got != want).any(-1).mean() <= PIXEL_SHARE and len(np.unique(got.reshape(-1, 3), axis=0)) > 8
    texel_bake.export_texel_glb(tmp_path / "p.glb", floor.tris, patlas, dose, 40.0)
    jax_bake.export_texel_glb(tmp_path / "j.glb", floor.tris, jatlas, dose, 40.0)
    assert (tmp_path / "p.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()
    back = load_glb(tmp_path / "p.glb")
    assert back.texture is not None and back.uvs is not None


# ------------------------------------------------------------ checkpoints


def _sims(room, texel_density=0.0, **kw):
    p = dict(photon_count=1 << 12, max_iterations=2, seed=9, texel_density=texel_density, **kw)
    js = JaxSimulator(room, JaxSimParams(**p, traversal="mxu", precision="highest"),
                      route=[JaxLightPos(0.1, 0.2, 30.0)], ray_chunk=1024)
    ps = Simulator(room, SimParams(**p, traversal="mxu"), route=[LightPos(0.1, 0.2, 30.0)], ray_chunk=1024,
                   device="cpu")
    return js, ps


def _assert_state_equal(ps, js):
    for name in ("photon_map", "max_photon_map", "reflectance") + (
            ("photon_map_tex", "max_photon_map_tex") if ps.atlas is not None else ()):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name))[: ps._n_texels or None]
                                      if "tex" in name else np.asarray(getattr(js, name)), err_msg=name)
    np.testing.assert_array_equal(ps.key, np.asarray(js.key).astype(np.uint32))
    assert (ps.photon_map_size, ps.curr_iterations, ps._launch_n, ps.finished, ps.global_seed) == (
        js.photon_map_size, js.curr_iterations, js._launch_n, js.finished, int(js.global_seed))
    assert dataclasses.asdict(ps.params) == dataclasses.asdict(js.params)
    assert [(w.x, w.y, w.duration) for w in ps.route] == [(w.x, w.y, w.duration) for w in js.route]


@pytest.mark.parametrize("texel_density", [0.0, 8.0])
def test_checkpoints_cross_load(tmp_path, room, texel_density):
    """A checkpoint saved by JAX loads in the port and the reverse, with
    equal maps, counters, key, parameters, route, reflectance and texel
    state; the same fields; and a resumed port run continues as the port
    run that never stopped."""
    js, ps = _sims(room, texel_density, max_bounces=1, reflectance=0.3)
    rho = np.linspace(0.1, 0.8, room.triangle_count).astype(np.float32)
    js.set_reflectance(rho)
    js.run_iteration()
    jax_checkpoint.save_checkpoint(tmp_path / "j.npz", js)
    assert checkpoint.peek_params(tmp_path / "j.npz") == SimParams(**dataclasses.asdict(js.params))
    checkpoint.load_checkpoint(tmp_path / "j.npz", ps)
    _assert_state_equal(ps, js)
    checkpoint.save_checkpoint(tmp_path / "p.npz", ps)
    with np.load(tmp_path / "p.npz") as pz, np.load(tmp_path / "j.npz") as jz:
        assert sorted(pz.files) == sorted(jz.files)
        for f in jz.files:
            assert pz[f].dtype == jz[f].dtype, f
            np.testing.assert_array_equal(pz[f], jz[f], err_msg=f)
    js2, _ = _sims(room, texel_density)
    jax_checkpoint.load_checkpoint(tmp_path / "p.npz", js2)
    _assert_state_equal(ps, js2)
    _, again = _sims(room, texel_density)
    checkpoint.load_checkpoint(tmp_path / "p.npz", again)
    _, straight = _sims(room, texel_density, max_bounces=1, reflectance=0.3)
    straight.set_reflectance(rho)
    straight.run_iteration()
    checkpoint.save_checkpoint(tmp_path / "s.npz", straight)
    checkpoint.load_checkpoint(tmp_path / "s.npz", again)
    straight.run_iteration()
    again.run_iteration()
    assert torch.equal(again.photon_map, straight.photon_map)
    if texel_density:
        assert torch.equal(again.photon_map_tex, straight.photon_map_tex)


def test_checkpoint_mismatches_raise_as_in_jax(tmp_path, room):
    """The texel-presence, texel-density and scene mismatches are refused
    with JAX's errors, whichever package saved the checkpoint."""
    plain = Simulator(room, SimParams(photon_count=1 << 10, max_iterations=1), device="cpu")
    tex8 = Simulator(room, SimParams(photon_count=1 << 10, max_iterations=1, texel_density=8.0), device="cpu")
    tex4 = Simulator(room, SimParams(photon_count=1 << 10, max_iterations=1, texel_density=4.0), device="cpu")
    checkpoint.save_checkpoint(tmp_path / "plain.npz", plain)
    checkpoint.save_checkpoint(tmp_path / "tex8.npz", tex8)
    jplain = JaxSimulator(room, JaxSimParams(photon_count=1 << 10, max_iterations=1))
    jax_checkpoint.save_checkpoint(tmp_path / "jplain.npz", jplain)
    for src, dst, match in (("plain", tex8, "texel"), ("jplain", tex8, "texel"), ("tex8", plain, "texel"),
                            ("tex8", tex4, "texel_density")):
        with pytest.raises(ValueError, match=match):
            checkpoint.load_checkpoint(tmp_path / f"{src}.npz", dst)
    with pytest.raises(ValueError, match="texel"):
        jax_checkpoint.load_checkpoint(tmp_path / "plain.npz",
                                       JaxSimulator(room, JaxSimParams(photon_count=1 << 10, texel_density=8.0)))
    other = Simulator(make_box_room(subdivisions=2), SimParams(), device="cpu")
    with pytest.raises(ValueError, match="triangle"):
        checkpoint.load_checkpoint(tmp_path / "plain.npz", other)


def test_checkpoint_without_launch_n_recovers_it(tmp_path, room):
    """A checkpoint written before the launch_n field: MAX_POWER's launch
    size is recovered from the totals, as JAX recovers it."""
    js, ps = _sims(room)
    js.run_iteration()
    jax_checkpoint.save_checkpoint(tmp_path / "j.npz", js)
    with np.load(tmp_path / "j.npz") as z:
        fields = {f: z[f] for f in z.files if f != "launch_n"}
    np.savez(tmp_path / "old.npz", **fields)
    jax_old = JaxSimulator(room, JaxSimParams())
    jax_checkpoint.load_checkpoint(tmp_path / "old.npz", jax_old)
    checkpoint.load_checkpoint(tmp_path / "old.npz", ps)
    assert ps._launch_n == jax_old._launch_n == 1 << 12


# ---------------------------------------------------------------- timing


def test_timer_progress_and_device_trace(tmp_path):
    t = Timer(device="cpu")
    assert t.elapsed() >= 0
    lines = []
    rep = ProgressReporter(10, log=lines.append, device="cpu")
    rep.update(1, 1000)
    assert lines[0].startswith("Progress: 10% photon count: 1000 delta time: ") and "Mrays/s" in lines[0]
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
