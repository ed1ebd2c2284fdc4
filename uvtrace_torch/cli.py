"""Command line of the port (subset of uvtrace/cli.py):

  python -m uvtrace_torch info    <scene.glb>
  python -m uvtrace_torch compute <scene.glb> [--route route.xml] [...]

`compute` writes dose_mJ_cm2.npy and irradiance_uW_cm2.npy into --output,
as uvtrace/cli.py:254-257 does, and dose_grid.npy with --dose-grid; it
prints one JSON summary line.
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


def cmd_compute(args):
    import dataclasses

    import numpy as np
    import torch

    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.sim import SimParams, Simulator, ViewMode

    for field, (flag, item) in NOT_PORTED.items():
        if getattr(args, field):
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
                                              "reflectance", "traversal")
                if getattr(args, k) is not None}
    params = dataclasses.replace(params, **override)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise CLIError("no CUDA device; pass --device cpu to run the plain PyTorch version "
                       "(brute force, keep --photon-count small)")
    sim = Simulator(mesh, params, route=route, device=args.device)
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
        "seconds": seconds,
        "device": str(sim.device),
        "output": str(out),
    }))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="uvtrace_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    pi = sub.add_parser("info", help="scene statistics")
    pi.add_argument("scene")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("compute", help="compute the dosage map")
    pc.add_argument("scene")
    pc.add_argument("--route", type=str, help="route XML (reference schema)")
    pc.add_argument("--photon-count", dest="photon_count", type=int)
    pc.add_argument("--iterations", dest="max_iterations", type=int)
    pc.add_argument("--seed", type=int)
    pc.add_argument("--output", default="out")
    pc.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default) runs the kernels; cpu runs their plain PyTorch versions")
    pc.add_argument("--bounces", dest="max_bounces", type=int,
                    help="diffuse bounces with Russian roulette (BASELINE config 2: 4)")
    pc.add_argument("--reflectance", type=float, help="uniform UV reflectance, the survival probability")
    pc.add_argument("--traversal", choices=["auto", "mxu-fused", "mxu"],
                    help="direct lighting through the fused kernel (auto, mxu-fused) or the split kernel "
                         "(mxu); bounces always run the split kernel")
    pc.add_argument("--dose-grid", dest="dose_grid", type=int, default=0, metavar="RES",
                    help="also write dose_grid.npy, the RES x RES top-down probe dose grid (the PNG "
                         "waits for the port of io/export, ROADMAP A11)")
    pc.add_argument("--texel-density", dest="texel_density", type=float, default=0.0,
                    help="not ported yet")
    pc.set_defaults(fn=cmd_compute)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except CLIError as e:
        print(f"uvtrace_torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
