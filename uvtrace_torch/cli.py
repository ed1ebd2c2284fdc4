"""Command line of the port (uvtrace/cli.py):

  python -m uvtrace_torch info           <scene.glb> [--texel-density PER_M]
  python -m uvtrace_torch compute        <scene.glb> [--route route.xml] [...]
  python -m uvtrace_torch calibrate      <scene.glb> --measure-power 2909 [...]
  python -m uvtrace_torch optimize-route <scene.glb> --route route.xml [...]
  python -m uvtrace_torch dose-image     <scene.glb> --route route.xml [...]
  python -m uvtrace_torch render         <scene.glb> --checkpoint state.npz [...]
  python -m uvtrace_torch bench          [--bounce | --scaling] [--platform cpu] [...]

`compute` writes the files of uvtrace/cli.py:202-357 into --output:
dose_mJ_cm2.npy and irradiance_uW_cm2.npy; dose.png, irradiance.png and
legend.png (unless --no-render); with --texel-density dose_texels.npy,
irradiance_texels.npy, texel_atlas.npz and dose_texels.png (and
dose_texels.glb with --export-glb); dose.glb with --export-glb;
checkpoint.npz with --checkpoint; route_used.xml; dose_grid.npy and
dose_grid.png with --dose-grid. It prints one JSON summary line. `calibrate`
fits the lamp power to a UV-meter reading (Report §2.2) and prints
{"calibrated_power_W": ...}. `optimize-route` runs gradient descent on the
route's waypoints (and dwell times) to raise the soft minimum dose and writes
the optimized route XML; `dose-image` writes the differentiable res x res
dose image (dose_image.npy and .png) and the gradient of its worst lit pixel
with respect to every waypoint and dwell time (gradients.npz). `render`
draws a checkpointed dose map to a PNG. `bench` forwards to
uvtrace_torch/bench.py (the counterpart of the root's bench.py): one JSON
line of rays/s on testroomopt (UVTRACE_BENCH_BACKEND picks the backend,
UVTRACE_BENCH_ITERS its iterations), the config-2 row with --bounce, one row
per device count with --scaling. Every command runs on the card unless it
is given --device cpu (bench: --platform cpu).

`compute`, `calibrate`, `optimize-route` and `dose-image` run on several
ranks under torchrun with --shards (-1: every rank) and, for compute's texel
maps, --texel-shards:

  python -m torch.distributed.run --nproc-per-node 4 -m uvtrace_torch compute \
      scene.glb --texel-density 2048 --shards -1 --texel-shards 4

Each rank runs on cuda:LOCAL_RANK over NCCL, or on the CPU over gloo with
--device cpu. The results are bit-identical to one device; rank 0 alone
writes the files and prints the JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

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


def _device_mesh(args, texel_axis: bool = True):
    """(device mesh or None, torch device string) of --shards and
    --texel-shards (uvtrace/cli.py:120-166). --shards N shards every launch
    over the N ranks that torchrun started (-1: all of them; without
    torchrun's environment, one rank on a 1 x 1 mesh); --texel-shards M
    also shards the texel maps over a rays x texels mesh (texel_axis=False:
    a 1-D ray mesh, for the shadow rays of the differentiable commands).
    Each rank runs on cuda:LOCAL_RANK (NCCL), or on the CPU (gloo) with
    --device cpu."""
    shards = getattr(args, "shards", 0) or 0
    tex = getattr(args, "texel_shards", 1) or 1
    world = int(os.environ.get("WORLD_SIZE", 1))
    launch = "python -m torch.distributed.run --nproc-per-node N -m uvtrace_torch ... --shards -1"
    if not shards and tex == 1:
        if world > 1:
            raise CLIError(f"{world} ranks were launched without --shards: pass --shards -1 so that they "
                           "share the work")
        _check_device(args.device)
        return None, args.device
    if tex < 1:
        raise CLIError(f"--texel-shards must be >= 1, got {tex}")
    if tex > 1 and not texel_axis:
        raise CLIError("--texel-shards shards texel dose maps, which only compute makes")
    if shards > 0 and shards != world:
        raise CLIError(f"--shards {shards} needs {shards} ranks but {world} were launched: start them with "
                       f"`{launch.replace('N', str(shards))}`")
    if world % tex:
        raise CLIError(f"--texel-shards {tex} does not divide the {world} launched ranks: start a multiple of "
                       f"{tex} with `{launch}`")
    _check_device(args.device)
    import torch

    from uvtrace_torch.parallel import initialize, make_2d_mesh, make_ray_mesh

    device = "cpu"
    if args.device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    initialize("nccl" if args.device == "cuda" else "gloo", world_size=None if "WORLD_SIZE" in os.environ else 1)
    return (make_2d_mesh(world // tex, tex) if texel_axis else make_ray_mesh()), device


def _writer() -> bool:
    """Whether this process writes the files: rank 0, or a run without ranks."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _build_sim(args):
    """The Simulator of a compute or calibrate command line."""
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.sim import SimParams, Simulator

    mesh = _load_mesh(args.scene)
    params, route = SimParams(), None
    if args.route:
        with _translated("route XML", args.route):
            r = load_route_xml(args.route)
        params, route = r.apply_to(params), r.waypoints or None
    params = _apply_param_flags(params, args)
    device_mesh, device = _device_mesh(args)
    try:
        return mesh, Simulator(mesh, params, route=route, device_mesh=device_mesh, device=device)
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
    writer = _writer()
    if args.resume:
        # cross-process "Resume computation" (userinterface.cpp:339-344):
        # restore accumulators, key and iteration counter, then the flags
        # override the checkpointed parameters (e.g. --iterations extends)
        with _translated("checkpoint", args.resume):
            load_checkpoint(args.resume, sim)
        sim.params = _apply_param_flags(sim.params, args)
        sim.finished = sim.curr_iterations >= sim.params.max_iterations
    reporter = ProgressReporter(sim.params.max_iterations, log=print if writer else (lambda _: None),
                                device=sim.device)
    out = Path(args.output)
    if writer:
        out.mkdir(parents=True, exist_ok=True)
    marker_kw = dict(route=None if args.no_markers else sim.route, floor_height=mesh.floor_height,
                     light_height=sim.params.light_height, light_length=sim.params.light_length,
                     gamma=args.gamma)

    def run():
        while not sim.finished:
            sim.run_iteration()
            reporter.update(sim.curr_iterations, sim.photon_map_size)
            if args.watch and writer:  # the live heatmap, redrawn per iteration (myapp.cpp:156-177)
                export_heatmap_png(out / "dose_live.png", mesh.tris, sim.dosage_map(ViewMode.DOSAGE),
                                   sim.params.min_dosage, args.threshold_view, **marker_kw)

    t0 = time.perf_counter()
    if args.profile and writer:
        from uvtrace_torch.utils.timing import device_trace

        with device_trace(args.profile):
            run()
    else:
        run()
    dose = sim.dosage_map(ViewMode.DOSAGE)
    irr = sim.dosage_map(ViewMode.MAX_POWER)
    d = dose.cpu().numpy()
    seconds = time.perf_counter() - t0  # ends in the dose map's copy to the host
    # the collectives of a sharded run, on every rank: the texel maps are
    # gathered, the checkpoint gathers them again, the probe grid is traced
    # in slices
    if sim.atlas is not None:
        tex_dose = sim.dosage_map_texels(ViewMode.DOSAGE)
        tex_irr = sim.dosage_map_texels(ViewMode.MAX_POWER)
    if args.checkpoint:
        save_checkpoint(out / "checkpoint.npz", sim)  # rank 0 writes
    grid = sim.dose_grid(res=args.dose_grid) if args.dose_grid else None
    if not writer:
        return 0
    export_dose_npy(out / "dose_mJ_cm2.npy", d)
    export_dose_npy(out / "irradiance_uW_cm2.npy", irr)
    tex_stats = {}
    if sim.atlas is not None:
        # the texel dose maps and the atlas layout (slot -> triangle,
        # barycentric cell) are deliverables
        t = tex_dose.cpu().numpy()
        export_dose_npy(out / "dose_texels.npy", t)
        export_dose_npy(out / "irradiance_texels.npy", tex_irr)
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
    sim.save_route(out / "route_used.xml")  # what was computed (myapp.cpp:298, raytracer.cpp:126)
    if grid is not None:
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
    if _writer():
        print(json.dumps({"calibrated_power_W": power, "device": str(sim.device)}))
    return 0


def _diff_setup(args, command: str):
    """(mesh, route, params, diff scene) of an optimize-route or dose-image
    command line."""
    from uvtrace_torch.diff import make_diff_scene
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.sim import SimParams

    if not args.route:
        raise CLIError(f"{command} needs --route (it differentiates with respect to its waypoints)")
    mesh = _load_mesh(args.scene)
    with _translated("route XML", args.route):
        r = load_route_xml(args.route)
    params = _apply_param_flags(r.apply_to(SimParams()), args)
    device_mesh, device = _device_mesh(args, texel_axis=False)
    return mesh, r, params, make_diff_scene(mesh, device_mesh=device_mesh, device=device)


def _bounce_kwargs(params, mesh, sources: int, what: str) -> dict:
    """The interreflection arguments of --reflectance/--bounces, with
    uvtrace's note when --bounces is missing."""
    import numpy as np

    if params.reflectance <= 0:
        return {}
    if params.max_bounces < 1:
        # a forward `compute --reflectance X` without --bounces traces no bounce
        # segment; the differentiable term then claims one bounce: say so
        print(f"uvtrace_torch: note: --reflectance without --bounces {what} to match a forward bounce run",
              file=sys.stderr)
    return dict(reflectance=params.reflectance, areas=np.asarray(mesh.areas), n_bounces=max(1, params.max_bounces),
                n_sources=sources)


def cmd_optimize_route(args):
    import numpy as np

    from uvtrace_torch.diff import optimize_route
    from uvtrace_torch.io.routexml import LightPos, Route, save_route_xml

    mesh, r, params, scene = _diff_setup(args, "optimize-route")
    wp = np.array([[w.x, w.y] for w in r.waypoints], np.float32)
    durs = np.array([w.duration for w in r.waypoints], np.float32)
    lo, hi = mesh.aabb
    bounds = None
    if not args.no_bounds:
        # waypoints stay inside the room's footprint, 0.1 m from its walls
        m = 0.1
        bounds = ((float(lo[0]) + m, float(lo[2]) + m), (float(hi[0]) - m, float(hi[2]) - m))
        wp0 = wp
        wp = np.clip(wp, np.float32(bounds[0]) + 1e-3, np.float32(bounds[1]) - 1e-3)
        moved = np.where(np.abs(wp - wp0).max(axis=1) > 1e-6)[0]
        if moved.size:  # a waypoint placed outside the scan on purpose is not moved silently
            print(f"uvtrace_torch: note: clipped waypoint(s) {', '.join(str(i) for i in moved)} into the scene "
                  "footprint (use --no-bounds to optimize outside the AABB)", file=sys.stderr)
    target_mask = None
    if args.exclude_ceiling:
        # the ceiling band (dose_grid's height band) would pin the softmin near 0;
        # a flat scene keeps the full mask
        margin = 0.05
        cy = np.asarray(mesh.tris)[:, :, 1].mean(axis=1)
        if float(hi[1] - lo[1]) <= 10 * margin:
            print("uvtrace_torch: note: --exclude-ceiling skipped (flat scene — no roof band to exclude)",
                  file=sys.stderr)
        else:
            target_mask = cy < float(hi[1]) - margin
            if not target_mask.any():
                raise CLIError("--exclude-ceiling would exclude every triangle — the scene appears to be a "
                               "single horizontal band")
            print(f"uvtrace_torch: note: excluding {int((~target_mask).sum())} ceiling-band triangles from the "
                  "objective", file=sys.stderr)
    bounce_kw = _bounce_kwargs(params, mesh, args.sources, "optimizes a 1-bounce objective; pass --bounces N (and use the same flags in `compute`)")
    t0 = time.perf_counter()
    res = optimize_route(
        scene, wp, durs, mesh.floor_height + params.light_height, params.light_length, params.light_intensity,
        steps=args.steps, learning_rate=args.lr, n_samples=args.samples, bounds=bounds,
        progress=(lambda i, loss: print(f"step {i}: loss {loss:.4f}", file=sys.stderr)) if _writer() else None,
        target_mask=target_mask, **bounce_kw)
    seconds = time.perf_counter() - t0  # ends in the final dose's copy to the host
    out_route = Route(
        waypoints=[LightPos(float(x), float(y), float(d)) for (x, y), d in zip(res.waypoints_xz, res.durations)],
        photon_count=params.photon_count, max_iterations=params.max_iterations,
        light_intensity=params.light_intensity, min_dosage=params.min_dosage, min_power=params.min_power,
        light_length=params.light_length, light_height=params.light_height)
    if not _writer():
        return 0
    save_route_xml(args.output, out_route)
    d = res.final_dose_masked
    print(json.dumps({
        "final_min_dose": res.final_min_dose,
        "final_p05_dose": float(np.percentile(d, 5)),
        "final_median_dose": float(np.median(d)),
        "coverage_above_min": float((d >= params.min_dosage).mean()),
        "seconds": seconds,
        "device": str(scene.v0.device),
        "output": args.output,
    }))
    return 0


def cmd_dose_image(args):
    """The differentiable dose image and the gradient of its worst lit pixel
    (a softmin over lit pixels) with respect to every waypoint position and
    dwell time: which way each lamp stop should move to lift the darkest
    spot."""
    import numpy as np
    import torch

    from uvtrace_torch.diff import dose_image, plan_dose_image
    from uvtrace_torch.diff.optimize import softmin
    from uvtrace_torch.io.export import export_grid_png
    from uvtrace_torch.ops import rng

    mesh, r, params, scene = _diff_setup(args, "dose-image")
    t0 = time.perf_counter()
    plan = plan_dose_image(scene, res=args.res)
    dev = scene.v0.device
    wp = torch.tensor([[w.x, w.y] for w in r.waypoints], dtype=torch.float32, device=dev, requires_grad=True)
    durs = torch.tensor([w.duration for w in r.waypoints], dtype=torch.float32, device=dev, requires_grad=True)
    key = rng.PRNGKey(params.seed)
    kw = dict(n_samples=args.samples, **_bounce_kwargs(params, mesh, args.sources, "renders a 1-bounce image; pass --bounces N"))
    img_t = dose_image(scene, plan, wp, durs, mesh.floor_height + params.light_height, params.light_length,
                       params.light_intensity, key, **kw)
    flat = img_t.reshape(-1)
    lit = plan.mask & (flat > 0)
    # misses park at a huge dose so their exp(-x / T) weight is exactly 0
    g_wp, g_durs = torch.autograd.grad(softmin(torch.where(lit, flat, 1e9), 5.0), (wp, durs))
    img = img_t.detach().cpu().numpy()
    g_wp, g_durs = g_wp.cpu().numpy(), g_durs.cpu().numpy()
    seconds = time.perf_counter() - t0
    if not _writer():
        return 0
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "dose_image.npy", img)
    export_grid_png(out / "dose_image.png", img, params.min_dosage, args.threshold_view, aabb=mesh.aabb,
                    route=r.waypoints)
    np.savez(out / "gradients.npz", d_worstdose_d_waypoints=g_wp, d_worstdose_d_durations=g_durs)
    print(json.dumps({
        "res": args.res,
        "dose_max": float(img.max()),
        "worst_lit_pixel": float(img[img > 0].min()) if (img > 0).any() else 0.0,
        "waypoint_grad_norms": [round(float(n), 6) for n in np.linalg.norm(g_wp, axis=1)],
        "seconds": seconds,
        "device": str(dev),
        "output": str(out),
    }))
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


def cmd_bench(args):
    from uvtrace_torch import bench

    if args.platform != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise CLIError("no CUDA device; pass --platform cpu to run the plain PyTorch versions")
    argv = []
    if args.scaling:
        argv.append("--scaling")
    if args.bounce:
        argv.append("--bounce")
    if args.devices is not None:
        argv += ["--devices", *map(str, args.devices)]
    if args.rays is not None:
        argv += ["--rays", str(args.rays)]
    argv += ["--iters", str(args.iters)]
    if args.platform:
        argv += ["--platform", args.platform]
    bench.run_cli(argv)
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
    p.add_argument("--traversal", choices=["auto", "clustered", "jax", "pallas", "mxu", "mxu-fused"],
                   help="auto, mxu-fused: stratified direct lighting without texels through the fused "
                        "kernel, the rest through the split kernel; mxu: everything through the split "
                        "kernel; pallas: everything through the gen-1 packet DFS; clustered: the dense "
                        "two-phase packet traversal in plain torch, its cluster budget audited and "
                        "escalated; jax: the per-ray walk of the fine BVH in plain torch")
    p.add_argument("--precision", choices=["highest", "high", "fast"],
                   help="accepted for uvtrace's command line; the port computes in f32 for every tier")
    p.add_argument("--bounces", dest="max_bounces", type=int,
                   help="diffuse bounces with Russian roulette (BASELINE config 2: 4)")
    p.add_argument("--reflectance", type=float, help="uniform UV reflectance, the survival probability")
    p.add_argument("--texel-density", dest="texel_density", type=float, metavar="PER_M",
                   help="texels per metre for sub-triangle dose maps (0 = per-triangle only)")
    p.add_argument("--texel-max-slots", dest="texel_max_slots", type=int, metavar="N",
                   help="texel atlas budget (default 2^22)")
    p.add_argument("--shards", type=int, default=0, metavar="N",
                   help="shard every launch over the N ranks torchrun started (0: one device, -1: every "
                        "rank); results are bit-identical to one device")
    p.add_argument("--texel-shards", dest="texel_shards", type=int, default=1, metavar="M",
                   help="also shard the texel dose maps over M of the ranks (a rays x texels mesh; needs "
                        "--texel-density; BASELINE config 5)")


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

    po = sub.add_parser("optimize-route", help="gradient-optimize route waypoints")
    _add_sim_flags(po)
    po.add_argument("--steps", type=int, default=100)
    po.add_argument("--lr", type=float, default=0.05)
    po.add_argument("--samples", type=int, default=4)
    po.add_argument("--sources", type=int, default=64, help="bounce-estimator source points (with --reflectance)")
    po.add_argument("--exclude-ceiling", action="store_true",
                    help="drop ceiling-band triangles from the min-dose objective")
    po.add_argument("--no-bounds", action="store_true",
                    help="allow waypoints outside the room footprint (default: inside the scene AABB)")
    po.add_argument("--output", default="route_optimized.xml")
    po.set_defaults(fn=cmd_optimize_route)

    pg = sub.add_parser("dose-image", help="differentiable dose image and its waypoint gradients")
    _add_sim_flags(pg)
    pg.add_argument("--res", type=int, default=128)
    pg.add_argument("--samples", type=int, default=8)
    pg.add_argument("--sources", type=int, default=64, help="bounce-estimator source points (with --reflectance)")
    pg.add_argument("--threshold-view", action="store_true")
    pg.add_argument("--output", default="out")
    pg.set_defaults(fn=cmd_dose_image)

    pr = sub.add_parser("render", help="render a checkpointed dose map to PNG")
    pr.add_argument("scene")
    pr.add_argument("--checkpoint", required=True)
    pr.add_argument("--camera", help="camera.xml (reference schema)")
    pr.add_argument("--view", choices=["dosage", "maxpower", "texture"], default="dosage")
    pr.add_argument("--threshold-view", action="store_true")
    pr.add_argument("--output", default="render.png")
    _add_device_flag(pr)
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser(
        "bench",
        help="throughput benchmark (one JSON line; --scaling: one JSON row "
             "per device count via the sharded Simulator)",
    )
    pb.add_argument("--scaling", action="store_true")
    pb.add_argument("--bounce", action="store_true",
                    help="4-bounce all-segment throughput (config 2)")
    pb.add_argument("--devices", type=int, nargs="*", default=None, metavar="N")
    pb.add_argument("--rays", type=int, default=None,
                    help="photons per device per iteration")
    pb.add_argument("--iters", type=int, default=3)
    pb.add_argument("--platform", choices=["cpu", "cuda"], default=None,
                    help="cuda (default): the kernels on the card; cpu: their plain versions")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from uvtrace_torch.i18n import set_language, tr

    set_language(args.lang)
    import torch.distributed as dist

    ours = not dist.is_initialized()  # --shards starts the process group; it ends with the command
    try:
        return args.fn(args)
    except CLIError as e:
        print(f"uvtrace_torch: {tr('error')}: {e}", file=sys.stderr)
        return 2
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
