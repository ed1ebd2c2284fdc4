"""Simulation checkpoint / resume.

The reference's persistence is coarse (SURVEY.md §5): route XML auto-saved on
shutdown/recompute and an in-session pausable iteration loop — the dose maps
themselves never hit disk. Here the full simulation state checkpoints to one
.npz: dose accumulators, iteration counters, RNG state, parameters, and
route, so a run can resume across processes/hosts (the equivalent of
"Resume computation", userinterface.cpp:339-344).

The port of uvtrace/io/checkpoint.py: the same .npz fields, so a checkpoint
written by either package loads in the other (the key is the two uint32
words of the threefry key in both).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.sim.params import SimParams


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_checkpoint(path, sim) -> None:
    """Write the state of `sim`. On a device mesh every rank must call it: the
    texel maps are gathered from the ranks' slot ranges, and rank 0 alone
    writes the file."""
    params = dataclasses.asdict(sim.params)
    route = [(w.x, w.y, w.duration) for w in sim.route]
    tex = {}
    if getattr(sim, "atlas", None) is not None:
        # texel accumulators: only the real atlas slots are saved (the
        # shard-alignment padding belongs to the saving topology;
        # load_checkpoint re-pads for the resuming Simulator's)
        tex = dict(
            photon_map_tex=_host(sim.full_texel_map(sim.photon_map_tex)),
            max_photon_map_tex=_host(sim.full_texel_map(sim.max_photon_map_tex)),
        )
    if getattr(sim, "device_mesh", None) is not None and dist.get_rank() != 0:
        return
    np.savez_compressed(
        str(path),
        **tex,
        photon_map=_host(sim.photon_map),
        max_photon_map=_host(sim.max_photon_map),
        photon_map_size=np.int64(sim.photon_map_size),
        curr_iterations=np.int64(sim.curr_iterations),
        global_seed=np.uint32(sim.global_seed),
        key=np.asarray(sim.key, np.uint32),
        finished=np.bool_(sim.finished),
        params_json=json.dumps(params),
        route=np.asarray(route, np.float64),
        triangle_count=np.int64(sim.triangle_count),
        # per-triangle reflectance (bounce survival): a derived DEVICE array
        # (set_reflectance may have replaced the params scalar); restoring
        # params alone would leave a resumed bounce run tracing with the
        # constructing simulator's stale values — silent dose bias
        reflectance=_host(sim.reflectance),
        # per-lamp launch size actually used when max_photon_map was
        # accumulated — MAX_POWER normalizes by it (raytracer.cpp:96-105
        # normalizes by the photonsPerLight it launched with); without it a
        # cross-process `render --view maxpower` would overstate irradiance
        launch_n=np.int64(getattr(sim, "_launch_n", 0)),
    )


def peek_params(path) -> SimParams:
    """Read only the SimParams from a checkpoint — callers that construct
    the Simulator themselves (e.g. `uvtrace render`) need the run's params
    (notably texel_density: the atlas is built at construction, and
    load_checkpoint refuses a texel-presence mismatch)."""
    with np.load(str(path), allow_pickle=False) as data:
        return SimParams(**json.loads(str(data["params_json"])))


def load_checkpoint(path, sim) -> None:
    """Restore state into an existing Simulator built on the same scene, on
    its device; a rank on a 'texels' mesh axis keeps its own slot range of
    the texel maps (uvtrace/io/checkpoint.py:108-135)."""
    with np.load(str(path), allow_pickle=False) as data:
        _restore(data, sim)


def _restore(data, sim) -> None:
    to_dev = lambda a: torch.from_numpy(np.array(a, np.float32)).to(sim.device)  # noqa: E731
    t = int(data["triangle_count"])
    if t != sim.triangle_count:
        raise ValueError(
            f"checkpoint is for a {t}-triangle scene, simulator has {sim.triangle_count}"
        )
    sim.photon_map = to_dev(data["photon_map"])
    sim.max_photon_map = to_dev(data["max_photon_map"])
    has_tex_ckpt = "photon_map_tex" in data
    has_tex_sim = getattr(sim, "atlas", None) is not None
    if has_tex_ckpt != has_tex_sim:
        # resuming a texel run without its accumulators (or vice versa) would
        # silently zero the texel dose while keeping photon_map_size — i.e.
        # under-reported dose, the one unacceptable failure mode here
        raise ValueError(
            "checkpoint/simulator texel-density mismatch: checkpoint "
            f"{'has' if has_tex_ckpt else 'lacks'} texel accumulators but the "
            f"simulator {'has' if has_tex_sim else 'lacks'} a texel atlas — "
            "resume with the same --texel-density the run was computed with"
        )
    if has_tex_sim:
        # the atlas layout is a function of (texel_density, texel_max_slots):
        # restoring a density-8 slot array into a density-4 atlas would put
        # every count in the wrong (triangle, cell) — require equality BEFORE
        # looking at shapes (shapes can coincide across densities)
        ck_params = json.loads(str(data["params_json"]))
        for f in ("texel_density", "texel_max_slots"):
            if ck_params.get(f) != getattr(sim.params, f):
                raise ValueError(
                    f"checkpoint was computed with {f}="
                    f"{ck_params.get(f)} but the simulator has "
                    f"{getattr(sim.params, f)} — resume with the run's "
                    "original texel flags (atlas layouts differ)"
                )
        saved = np.asarray(data["photon_map_tex"])
        ns = sim.atlas.n_slots
        # older checkpoints carried the saving topology's shard padding;
        # >= n_slots is fine (pad slots never receive hits), < is corruption
        if saved.shape[0] < ns:
            raise ValueError(
                f"checkpoint texel map has {saved.shape[0]} slots, atlas "
                f"needs {ns} — corrupt or mismatched checkpoint"
            )
        # re-padded for THIS Simulator's texel shards, each rank its slice
        sim.photon_map_tex = sim.own_texels(saved)
        sim.max_photon_map_tex = sim.own_texels(data["max_photon_map_tex"])
    sim.photon_map_size = int(data["photon_map_size"])
    if "launch_n" in data and int(data["launch_n"]) > 0:
        sim._launch_n = int(data["launch_n"])
    elif int(data["photon_map_size"]) > 0:
        # pre-format checkpoint (no launch_n field): MAX_POWER normalization
        # falls back to photons_per_light, which UNDERSTATES the launch when
        # the stratified sampler rounded it up to whole chunks — i.e.
        # `render --view maxpower` from an old checkpoint overstates
        # irradiance by the rounding ratio. Recompute the actual per-launch
        # size from the totals instead (photon_map_size counts the rounded
        # launches: iterations x route length of them).
        import warnings

        launches = int(data["curr_iterations"]) * max(1, len(data["route"]))
        if launches > 0 and int(data["photon_map_size"]) % launches == 0:
            sim._launch_n = int(data["photon_map_size"]) // launches
        else:
            warnings.warn(
                "checkpoint predates the launch_n field and its totals do "
                "not divide evenly; MAX_POWER normalization falls back to "
                "photons_per_light and may overstate irradiance by the "
                "stratified rounding ratio",
                RuntimeWarning,
                stacklevel=2,
            )
    sim.curr_iterations = int(data["curr_iterations"])
    sim.global_seed = int(data["global_seed"])
    sim.key = np.asarray(data["key"], np.uint32).reshape(2).copy()
    sim.finished = bool(data["finished"])
    params = json.loads(str(data["params_json"]))
    sim.params = SimParams(**params)
    sim.route = [LightPos(x, y, d) for x, y, d in data["route"]]
    if "reflectance" in data:
        sim.set_reflectance(np.asarray(data["reflectance"]))
    else:  # pre-format checkpoint: rebuild from the restored params scalar
        sim.set_reflectance(sim.params.reflectance)
