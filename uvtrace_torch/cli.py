"""Command line of the port (subset of uvtrace/cli.py):

  python -m uvtrace_torch info      <scene.glb>
  python -m uvtrace_torch compute   <scene.glb> [--route route.xml] [...]
  python -m uvtrace_torch calibrate <scene.glb> --measure-power 2909 [...]

`compute` writes dose_mJ_cm2.npy and irradiance_uW_cm2.npy into --output,
as uvtrace/cli.py:254-257 does, and dose_grid.npy with --dose-grid; it
prints one JSON summary line. `calibrate` fits the lamp power to a UV-meter
reading (Report §2.2) and prints {"calibrated_power_W": ...}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

NOT_PORTED = {
    "texel_density": ("--texel-density", "ROADMAP A10"),
}


class CLIError(Exception):
    """One actionable line for the user, exit code 2."""


def _load_mesh(path: str):
    from uvtrace_torch.geometry.gltf import load_glb

    try:
        return load_glb(path)
    except FileNotFoundError:
        raise CLIError(f"scene not found: {path}") from None
    except (ValueError, KeyError, IndexError) as e:
        raise CLIError(f"cannot read scene '{path}': {e}") from None


def cmd_info(args):
    mesh = _load_mesh(args.scene)
    lo, hi = mesh.aabb
    print(f"scene: {mesh.name}")
    print(f"triangles: {mesh.triangle_count}")
    print(f"floor height: {mesh.floor_height:.4f} m")
    print(f"aabb: {lo.round(3).tolist()} .. {hi.round(3).tolist()}")
    print(f"surface area: {mesh.areas.sum():.2f} m^2")
    return 0


def _build_sim(args):
    """The Simulator of a compute or calibrate command line."""
    import dataclasses

    import torch

    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.sim import SimParams, Simulator

    for field, (flag, item) in NOT_PORTED.items():
        if getattr(args, field, None):
            raise CLIError(f"{flag} is not ported yet ({item}); run it with `python -m uvtrace`")
    mesh = _load_mesh(args.scene)
    params, route = SimParams(), None
    if args.route:
        try:
            r = load_route_xml(args.route)
        except FileNotFoundError:
            raise CLIError(f"route XML not found: {args.route}") from None
        except Exception as e:  # ET.ParseError, bad numbers
            raise CLIError(f"cannot read route XML '{args.route}': {e}") from None
        params, route = r.apply_to(params), r.waypoints or None
    override = {k: getattr(args, k) for k in ("photon_count", "max_iterations", "seed", "max_bounces",
                                              "reflectance", "traversal", "sampler")
                if getattr(args, k, None) is not None}
    params = dataclasses.replace(params, **override)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise CLIError("no CUDA device; pass --device cpu to run the plain PyTorch version "
                       "(keep --photon-count small)")
    return Simulator(mesh, params, route=route, device=args.device)


def cmd_compute(args):
    import numpy as np

    from uvtrace_torch.sim import ViewMode

    sim = _build_sim(args)
    t0 = time.perf_counter()
    sim.compute()
    dose = sim.dosage_map(ViewMode.DOSAGE).cpu().numpy()
    irr = sim.dosage_map(ViewMode.MAX_POWER).cpu().numpy()
    seconds = time.perf_counter() - t0
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "dose_mJ_cm2.npy", dose)
    np.save(out / "irradiance_uW_cm2.npy", irr)
    if args.dose_grid:
        np.save(out / "dose_grid.npy", sim.dose_grid(res=args.dose_grid))
    sim.save_route(out / "route_used.xml")
    print(json.dumps({
        "photons": sim.photon_map_size,
        "dose_max": float(dose.max()),
        "dose_mean": float(dose.mean()),
        "dose_min": float(dose.min()),
        "coverage_above_min": float((dose >= sim.params.min_dosage).mean()),
        "bounces": sim.params.max_bounces,
        "sampler": sim.params.sampler,
        "traversal": sim.params.traversal,
        "seconds": seconds,
        "device": str(sim.device),
        "output": str(out),
    }))
    return 0


def cmd_calibrate(args):
    sim = _build_sim(args)
    power = sim.calibrate_power(args.measure_power, args.measure_height, args.measure_dist)
    print(json.dumps({"calibrated_power_W": power, "device": str(sim.device)}))
    return 0


def _add_sim_flags(p):
    p.add_argument("scene")
    p.add_argument("--route", type=str, help="route XML (reference schema)")
    p.add_argument("--photon-count", dest="photon_count", type=int)
    p.add_argument("--iterations", dest="max_iterations", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default) runs the kernels; cpu runs their plain PyTorch versions")
    p.add_argument("--sampler", choices=["native", "stratified", "reference"],
                   help="photon sampler: stratified (default) packets, threefry iid (native), or the "
                        "reference's xorshift32 streams (reference)")
    p.add_argument("--traversal", choices=["auto", "mxu-fused", "mxu", "pallas"],
                   help="auto, mxu-fused: stratified direct lighting through the fused kernel, the rest "
                        "through the split kernel; mxu: everything through the split kernel; pallas: "
                        "everything through the gen-1 packet DFS")


def main(argv=None):
    p = argparse.ArgumentParser(prog="uvtrace_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    pi = sub.add_parser("info", help="scene statistics")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("compute", help="compute the dosage map")
    _add_sim_flags(pc)
    pc.add_argument("--output", default="out")
    pc.add_argument("--bounces", dest="max_bounces", type=int,
                    help="diffuse bounces with Russian roulette (BASELINE config 2: 4)")
    pc.add_argument("--reflectance", type=float, help="uniform UV reflectance, the survival probability")
    pc.add_argument("--dose-grid", dest="dose_grid", type=int, default=0, metavar="RES",
                    help="also write dose_grid.npy, the RES x RES top-down probe dose grid (the PNG "
                         "waits for the port of io/export, ROADMAP A11)")
    pc.add_argument("--texel-density", dest="texel_density", type=float, default=0.0,
                    help="not ported yet")
    pc.set_defaults(fn=cmd_compute)

    pk = sub.add_parser("calibrate", help="calibrate the lamp power against a UV-meter reading")
    _add_sim_flags(pk)
    pk.add_argument("--measure-power", dest="measure_power", type=float, required=True, help="µW/cm^2")
    pk.add_argument("--measure-height", dest="measure_height", type=float, default=0.8, help="m")
    pk.add_argument("--measure-dist", dest="measure_dist", type=float, default=1.0, help="m")
    pk.set_defaults(fn=cmd_calibrate)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except CLIError as e:
        print(f"uvtrace_torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
