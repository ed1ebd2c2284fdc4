"""Command line of the port (uvtrace/cli.py without optimize-route,
dose-image and bench):

  python -m uvtrace_torch info      <scene.glb> [--texel-density PER_M]
  python -m uvtrace_torch compute   <scene.glb> [--route route.xml] [...]
  python -m uvtrace_torch calibrate <scene.glb> --measure-power 2909 [...]
  python -m uvtrace_torch render    <scene.glb> --checkpoint state.npz [...]

`compute` writes the files of uvtrace/cli.py:202-357 into --output:
dose_mJ_cm2.npy and irradiance_uW_cm2.npy; dose.png, irradiance.png and
legend.png (unless --no-render); with --texel-density dose_texels.npy,
irradiance_texels.npy, texel_atlas.npz and dose_texels.png (and
dose_texels.glb with --export-glb); dose.glb with --export-glb;
checkpoint.npz with --checkpoint; route_used.xml; dose_grid.npy and
dose_grid.png with --dose-grid. It prints one JSON summary line. `calibrate`
fits the lamp power to a UV-meter reading (Report §2.2) and prints
{"calibrated_power_W": ...}. `render` draws a checkpointed dose map to a PNG.
Every command runs on the card unless it is given --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

NOT_PORTED = {
    "shards": ("--shards", "ROADMAP A13"),
    "texel_shards": ("--texel-shards", "ROADMAP A13"),
}
PARAM_FIELDS = ("photon_count", "max_iterations", "light_intensity", "light_length", "light_height",
                "min_dosage", "min_power", "sampler", "traversal", "max_bounces", "reflectance", "seed",
                "precision", "texel_density", "texel_max_slots")


class CLIError(Exception):
    """One actionable line for the user, exit code 2."""


@contextlib.contextmanager
def _translated(what: str, path):
    """Loader failures (missing file, bad magic, malformed XML, corrupt npz)
    as a CLIError naming the file and the problem (uvtrace/cli.py:32-48)."""
    try:
        yield
    except CLIError:
        raise
    except FileNotFoundError:
        raise CLIError(f"{what} not found: {path}") from None
    except IsADirectoryError:
        raise CLIError(f"{what} is a directory, expected a file: {path}") from None
    except PermissionError:
        raise CLIError(f"{what} not readable (permission denied): {path}") from None
    except Exception as e:  # ValueError (bad GLB), ET.ParseError, zipfile errors
        raise CLIError(f"cannot read {what} '{path}': {str(e).strip() or type(e).__name__}") from None


def _load_mesh(path: str):
    from uvtrace_torch.geometry.gltf import load_glb

    with _translated("scene", path):
        return load_glb(path)


def _apply_param_flags(params, args):
    return dataclasses.replace(params, **{k: getattr(args, k) for k in PARAM_FIELDS
                                          if getattr(args, k, None) is not None})


def _check_device(device: str):
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise CLIError("no CUDA device; pass --device cpu to run the plain PyTorch version "
                       "(keep --photon-count small)")


def cmd_info(args):
    import numpy as np

    mesh = _load_mesh(args.scene)
    lo, hi = mesh.aabb
    print(f"scene: {mesh.name}")
    print(f"triangles: {mesh.triangle_count}")
    print(f"floor height: {mesh.floor_height:.4f} m")
    print(f"aabb: {lo.round(3).tolist()} .. {hi.round(3).tolist()}")
    print(f"surface area: {mesh.areas.sum():.2f} m^2")
    if args.texel_max_slots and not args.texel_density:
        raise CLIError("--texel-max-slots requires --texel-density")
    if args.texel_density:
        from uvtrace_torch.ops.texel import build_atlas

        kw = {"max_slots": args.texel_max_slots} if args.texel_max_slots else {}
        atlas = build_atlas(mesh.areas, density=args.texel_density, **kw)
        k = atlas.k.numpy()
        print(f"texel atlas @ {args.texel_density}/m: {atlas.n_slots} slots "
              f"(k min {k.min()} / median {int(np.median(k))} / max {k.max()}; "
              f"{atlas.n_slots * 4 / 1e6:.1f} MB per accumulator)")
    return 0


def _build_sim(args):
    """The Simulator of a compute or calibrate command line."""
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.sim import SimParams, Simulator

    for field, (flag, item) in NOT_PORTED.items():
        if getattr(args, field, None) not in (None, 0, 1):
            raise CLIError(f"{flag} is not ported yet ({item}); run it with `python -m uvtrace`")
    mesh = _load_mesh(args.scene)
    params, route = SimParams(), None
    if args.route:
        with _translated("route XML", args.route):
            r = load_route_xml(args.route)
        params, route = r.apply_to(params), r.waypoints or None
    params = _apply_param_flags(params, args)
    _check_device(args.device)
    try:
        return mesh, Simulator(mesh, params, route=route, device=args.device)
    except ValueError as e:  # a bad flag combination (e.g. a texel budget below the triangle count)
        raise CLIError(str(e)) from None


def cmd_compute(args):
    import numpy as np

    from uvtrace_torch.i18n import tr
    from uvtrace_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from uvtrace_torch.io.export import export_dose_npy, export_grid_png, export_heatmap_png, export_legend_png
    from uvtrace_torch.sim import ViewMode
    from uvtrace_torch.utils.timing import ProgressReporter

    mesh, sim = _build_sim(args)
    if args.resume:
        # cross-process "Resume computation" (userinterface.cpp:339-344):
        # restore accumulators, key and iteration counter, then the flags
        # override the checkpointed parameters (e.g. --iterations extends)
        with _translated("checkpoint", args.resume):
            load_checkpoint(args.resume, sim)
        sim.params = _apply_param_flags(sim.params, args)
        sim.finished = sim.curr_iterations >= sim.params.max_iterations
    reporter = ProgressReporter(sim.params.max_iterations, device=sim.device)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    marker_kw = dict(route=None if args.no_markers else sim.route, floor_height=mesh.floor_height,
                     light_height=sim.params.light_height, light_length=sim.params.light_length,
                     gamma=args.gamma)

    def run():
        while not sim.finished:
            sim.run_iteration()
            reporter.update(sim.curr_iterations, sim.photon_map_size)
            if args.watch:  # the live heatmap, redrawn per iteration (myapp.cpp:156-177)
                export_heatmap_png(out / "dose_live.png", mesh.tris, sim.dosage_map(ViewMode.DOSAGE),
                                   sim.params.min_dosage, args.threshold_view, **marker_kw)

    t0 = time.perf_counter()
    if args.profile:
        from uvtrace_torch.utils.timing import device_trace

        with device_trace(args.profile):
            run()
    else:
        run()
    dose = sim.dosage_map(ViewMode.DOSAGE)
    irr = sim.dosage_map(ViewMode.MAX_POWER)
    d = dose.cpu().numpy()
    seconds = time.perf_counter() - t0  # ends in the dose map's copy to the host
    export_dose_npy(out / "dose_mJ_cm2.npy", d)
    export_dose_npy(out / "irradiance_uW_cm2.npy", irr)
    tex_stats = {}
    if sim.atlas is not None:
        # the texel dose maps and the atlas layout (slot -> triangle,
        # barycentric cell) are deliverables
        tex_dose = sim.dosage_map_texels(ViewMode.DOSAGE)
        t = tex_dose.cpu().numpy()
        export_dose_npy(out / "dose_texels.npy", t)
        export_dose_npy(out / "irradiance_texels.npy", sim.dosage_map_texels(ViewMode.MAX_POWER))
        np.savez_compressed(out / "texel_atlas.npz", base=sim.atlas.base.cpu().numpy(),
                            k=sim.atlas.k.cpu().numpy(), cell_area=sim.atlas.cell_area.cpu().numpy())
        tex_stats = {
            "texels": sim.atlas.n_slots,
            "tex_dose_max": float(t.max()),
            "tex_dose_mean": float(t.mean()),
            "tex_dose_min": float(t.min()),
            "tex_coverage_above_min": float((t >= sim.params.min_dosage).mean()),
        }
        if not args.no_render or args.export_glb:
            # one bake of the atlas texture feeds the texel render and the .glb
            from uvtrace_torch.io.texel_bake import bake_texel_atlas

            image, uvs = bake_texel_atlas(sim.atlas, tex_dose, sim.params.min_dosage, args.threshold_view)
        if not args.no_render:
            from uvtrace_torch.geometry.mesh import TriangleMesh
            from uvtrace_torch.io.png import write_png
            from uvtrace_torch.viz.rasterizer import render_textured

            baked = TriangleMesh(tris=mesh.tris, uvs=uvs, texture=image)
            write_png(out / "dose_texels.png",
                      render_textured(baked, width=960, height=720, gamma=args.gamma, device=sim.device))
        if args.export_glb:
            from uvtrace_torch.io.gltf_export import export_glb
            from uvtrace_torch.io.png import png_bytes

            export_glb(out / "dose_texels.glb", mesh.tris, uvs=uvs, texture_png=png_bytes(image))
    if not args.no_render:
        export_heatmap_png(out / "dose.png", mesh.tris, dose, sim.params.min_dosage, args.threshold_view,
                           **marker_kw)
        export_heatmap_png(out / "irradiance.png", mesh.tris, irr, sim.params.min_power, args.threshold_view,
                           **marker_kw)
        export_legend_png(out / "legend.png", sim.params.min_dosage)
    if args.export_glb:
        sim.export_glb(out / "dose.glb", ViewMode.DOSAGE, args.threshold_view)
    if args.checkpoint:
        save_checkpoint(out / "checkpoint.npz", sim)
    sim.save_route(out / "route_used.xml")  # what was computed (myapp.cpp:298, raytracer.cpp:126)
    if args.dose_grid:
        grid = sim.dose_grid(res=args.dose_grid)
        np.save(out / "dose_grid.npy", grid)
        export_grid_png(out / "dose_grid.png", grid, sim.params.min_dosage, args.threshold_view,
                        gamma=args.gamma, route=None if args.no_markers else sim.route, aabb=mesh.aabb)
    print(f"{tr('computing')}: {tr('done')}")
    print(json.dumps({
        "photons": sim.photon_map_size,
        "dose_max": float(d.max()),
        "dose_mean": float(d.mean()),
        "dose_min": float(d.min()),
        "coverage_above_min": float((d >= sim.params.min_dosage).mean()),
        **tex_stats,
        "bounces": sim.params.max_bounces,
        "sampler": sim.params.sampler,
        "traversal": sim.params.traversal,
        "seconds": seconds,
        "device": str(sim.device),
        "output": str(out),
    }))
    return 0


def cmd_calibrate(args):
    _, sim = _build_sim(args)
    power = sim.calibrate_power(args.measure_power, args.measure_height, args.measure_dist)
    print(json.dumps({"calibrated_power_W": power, "device": str(sim.device)}))
    return 0


def cmd_render(args):
    from uvtrace_torch.io.checkpoint import load_checkpoint, peek_params
    from uvtrace_torch.io.export import export_heatmap_png
    from uvtrace_torch.sim import Simulator, ViewMode
    from uvtrace_torch.viz.camera import Camera

    mesh = _load_mesh(args.scene)
    # the run's parameters (texel_density in particular: the atlas must exist
    # at construction for the texel state to restore)
    with _translated("checkpoint", args.checkpoint):
        params = peek_params(args.checkpoint)
    _check_device(args.device)
    sim = Simulator(mesh, params, device=args.device)
    with _translated("checkpoint", args.checkpoint):
        load_checkpoint(args.checkpoint, sim)
    camera = None
    if args.camera:
        with _translated("camera XML", args.camera):
            camera = Camera.load_xml(args.camera)
    if args.view == "texture":
        # the photo-scan view (myapp.cpp:186-194): per-pixel UV sampling of the scan texture
        from uvtrace_torch.io.png import write_png
        from uvtrace_torch.viz.rasterizer import render_textured

        write_png(args.output, render_textured(mesh, camera=camera, device=sim.device))
        print(json.dumps({"output": args.output}))
        return 0
    view = ViewMode.MAX_POWER if args.view == "maxpower" else ViewMode.DOSAGE
    scale = sim.params.min_power if view == ViewMode.MAX_POWER else sim.params.min_dosage
    if sim.atlas is not None:  # texel runs render at texel resolution
        from uvtrace_torch.io.texel_bake import export_texel_heatmap_png

        export_texel_heatmap_png(args.output, mesh.tris, sim.atlas, sim.dosage_map_texels(view), scale,
                                 args.threshold_view, camera=camera)
    else:
        export_heatmap_png(args.output, mesh.tris, sim.dosage_map(view), scale, args.threshold_view,
                           camera=camera)
    print(json.dumps({"output": args.output}))
    return 0


def _add_device_flag(p):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default) runs the kernels; cpu runs their plain PyTorch versions")


def _add_sim_flags(p):
    """The scene and the SimParams flags of uvtrace/cli.py:85-118."""
    p.add_argument("scene")
    p.add_argument("--route", type=str, help="route XML (reference schema)")
    p.add_argument("--photon-count", dest="photon_count", type=int)
    p.add_argument("--iterations", dest="max_iterations", type=int)
    p.add_argument("--power", dest="light_intensity", type=float, help="lamp power (W)")
    p.add_argument("--lamp-length", dest="light_length", type=float, help="rod length (m)")
    p.add_argument("--lamp-height", dest="light_height", type=float, help="rod base above the floor (m)")
    p.add_argument("--min-dosage", dest="min_dosage", type=float, help="minimum dose (mJ/cm^2)")
    p.add_argument("--min-power", dest="min_power", type=float, help="minimum irradiance (µW/cm^2)")
    p.add_argument("--seed", type=int)
    _add_device_flag(p)
    p.add_argument("--sampler", choices=["native", "stratified", "reference"],
                   help="photon sampler: stratified (default) packets, threefry iid (native), or the "
                        "reference's xorshift32 streams (reference)")
    p.add_argument("--traversal", choices=["auto", "mxu-fused", "mxu", "pallas"],
                   help="auto, mxu-fused: stratified direct lighting without texels through the fused "
                        "kernel, the rest through the split kernel; mxu: everything through the split "
                        "kernel; pallas: everything through the gen-1 packet DFS")
    p.add_argument("--precision", choices=["highest", "high", "fast"],
                   help="accepted for uvtrace's command line; the port computes in f32 for every tier")
    p.add_argument("--bounces", dest="max_bounces", type=int,
                   help="diffuse bounces with Russian roulette (BASELINE config 2: 4)")
    p.add_argument("--reflectance", type=float, help="uniform UV reflectance, the survival probability")
    p.add_argument("--texel-density", dest="texel_density", type=float, metavar="PER_M",
                   help="texels per metre for sub-triangle dose maps (0 = per-triangle only)")
    p.add_argument("--texel-max-slots", dest="texel_max_slots", type=int, metavar="N",
                   help="texel atlas budget (default 2^22)")
    p.add_argument("--shards", type=int, default=0, metavar="N", help="not ported yet (ROADMAP A13)")
    p.add_argument("--texel-shards", dest="texel_shards", type=int, default=1, metavar="M",
                   help="not ported yet (ROADMAP A13)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="uvtrace_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--lang", choices=["en", "nl"], default="en",
                   help="output language (the reference UI is bilingual EN/NL)")
    sub = p.add_subparsers(dest="command", required=True)
    pi = sub.add_parser("info", help="scene statistics")
    pi.add_argument("scene")
    pi.add_argument("--texel-density", dest="texel_density", type=float, metavar="PER_M",
                    help="also report the texel atlas this density would allocate")
    pi.add_argument("--texel-max-slots", dest="texel_max_slots", type=int, metavar="N")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("compute", help="compute the dosage map")
    _add_sim_flags(pc)
    pc.add_argument("--output", default="out")
    pc.add_argument("--threshold-view", action="store_true")
    pc.add_argument("--no-render", action="store_true")
    pc.add_argument("--export-glb", action="store_true", help="write a dose-coloured .glb for external viewers")
    pc.add_argument("--checkpoint", action="store_true")
    pc.add_argument("--resume", metavar="CKPT", help="resume accumulation from a checkpoint.npz")
    pc.add_argument("--profile", metavar="DIR", help="write a torch.profiler trace (DIR/trace.json)")
    pc.add_argument("--dose-grid", dest="dose_grid", type=int, default=0, metavar="RES",
                    help="also write the RES x RES top-down dose grid, dose_grid.npy and .png")
    pc.add_argument("--watch", action="store_true",
                    help="re-export the heatmap after every iteration (dose_live.png)")
    pc.add_argument("--no-markers", action="store_true", help="hide the route waypoint markers")
    pc.add_argument("--gamma", action="store_true", help="sqrt gamma-encode PNG output")
    pc.set_defaults(fn=cmd_compute)

    pk = sub.add_parser("calibrate", help="calibrate the lamp power against a UV-meter reading")
    _add_sim_flags(pk)
    pk.add_argument("--measure-power", dest="measure_power", type=float, required=True, help="µW/cm^2")
    pk.add_argument("--measure-height", dest="measure_height", type=float, default=0.8, help="m")
    pk.add_argument("--measure-dist", dest="measure_dist", type=float, default=1.0, help="m")
    pk.set_defaults(fn=cmd_calibrate)

    pr = sub.add_parser("render", help="render a checkpointed dose map to PNG")
    pr.add_argument("scene")
    pr.add_argument("--checkpoint", required=True)
    pr.add_argument("--camera", help="camera.xml (reference schema)")
    pr.add_argument("--view", choices=["dosage", "maxpower", "texture"], default="dosage")
    pr.add_argument("--threshold-view", action="store_true")
    pr.add_argument("--output", default="render.png")
    _add_device_flag(pr)
    pr.set_defaults(fn=cmd_render)

    args = p.parse_args(argv)
    from uvtrace_torch.i18n import set_language, tr

    set_language(args.lang)
    try:
        return args.fn(args)
    except CLIError as e:
        print(f"uvtrace_torch: {tr('error')}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
