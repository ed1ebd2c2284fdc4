"""The texel dose map, driven as `compute --texel-density D --texel-max-slots
S --dose-grid R` drives it: whole runs back to back, one client, a closed
loop. A run is `reset()`, the traffic's iterations (`run_iteration()`, each
until its launches are done on the device, as compute's progress line
waits), the texel dose and irradiance maps (`dosage_map_texels(DOSAGE)`
and `(MAX_POWER)`) and the texel `dose_grid(R)` on the host.

The window stops at its end inside a run. Its record keeps the iterations
of the whole runs that ended in it and the end of the last one, so that
`photons_per_s` reads whole runs, each with its maps and grid; `attempted`
counts every iteration begun. The first run is always whole: the check
reads it. Every run traces the same photons (reset() restarts the key).

Correct (reference/texel.py), on the first run:
  texel_gap   L1 gap, relative to the reference's, between the program's
              texel counts added by one iteration (drawn from the seed among
              the run's; `photon_map_tex` before and after it, copied on the
              device) and the reference's texel histogram of that
              iteration's rays, traced again from the seed;
  tri_gap     the same, each summed over its triangle's slots, against the
              reference's triangle hits;
  photons_gap the photons of every counted iteration against the
              reference's launch size (exact);
  grid_gap    the share of a band of `grid_rows` rows of the grid (drawn
              from the seed) whose value differs from the reference's, by
              more than 1e-5 of it: the reference traces the band's probes
              and values each by its own atlas and unit rule on the
              program's texel counts at the run's end.
`control(run)` reads the same numbers with the reference in the program's
place, one precision below the configuration's, and with faults planted in
it (tests/test_harness_texel.py; on the card `python3
benchmarks/tests/control_texel.py --seed N ...`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.harness import scene as scene_io
from benchmarks.reference import dose as ref_dose
from benchmarks.reference import texel as ref_texel
from benchmarks.reference.tracer import scene_of
from benchmarks.rooflines.texel import k6_bytes

DIFFERS = 1e-5  # a probe's value differs from the reference's beyond f32 rounding of the unit rule
LOWER = torch.bfloat16


def _lamps(run):
    return [tuple(w) for w in run.traffic["lamps"]]


def setup(run):
    from uvtrace_torch.geometry.mesh import TriangleMesh
    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.sim import SimParams, Simulator

    c, t = run.config, run.traffic
    tris = scene_io.load_triangles(run.data(c["scene"]))
    floor = scene_io.floor_height(tris)
    params = SimParams(
        photon_count=int(t["photon_count"]), max_iterations=int(t["iterations"]), seed=run.seed,
        light_intensity=float(c["light_intensity"]), light_length=float(c["light_length"]),
        light_height=float(c["light_height"]), traversal=c["traversal"], sampler=c["sampler"],
        texel_density=float(c["texel_density"]), texel_max_slots=int(c["texel_max_slots"]))
    mesh = TriangleMesh(tris=tris, floor_height=floor, name="scene")
    t0 = time.perf_counter()
    sim = Simulator(mesh, params, route=[LightPos(x, z, s) for x, z, s in _lamps(run)], device=run.device)
    _sync(run)
    run.scene_build_s = time.perf_counter() - t0
    state = {"sim": sim}
    for _ in range(int(run.cell["warmup_runs"])):  # builds and loads the kernels; every shape of a run
        _one_run(run, state)
    _sync(run)
    return state


def _sync(run):
    if run.device == "cuda":
        torch.cuda.synchronize()


def _sample(run):
    """(the sampled iteration, the grid band's first row) of the seed."""
    rng = np.random.default_rng(run.seed)
    sample = int(rng.integers(int(run.traffic["iterations"])))
    return sample, int(rng.integers(int(run.traffic["dose_grid"]) - int(run.cell["grid_rows"]) + 1))


def _one_run(run, state, sample=None, deadline=None):
    """(items, the run's end or None where the deadline cut it, what the
    check keeps): one run; with `sample`, the texel counts before and after
    that iteration and at the end, and the grid."""
    from uvtrace_torch.sim import ViewMode

    sim = state["sim"]
    sim.reset()
    items, kept = [], {}
    for i in range(int(run.traffic["iterations"])):
        before = sim.photon_map_size
        if i == sample:
            kept["before"] = sim.photon_map_tex.clone()
        t0 = time.perf_counter()
        sim.run_iteration()
        _sync(run)
        t1 = time.perf_counter()
        items.append((t0, t1, sim.photon_map_size - before))
        if i == sample:
            kept["after"] = sim.photon_map_tex.clone()
        if deadline is not None and t1 >= deadline:
            return items, None, kept
    sim.dosage_map_texels(ViewMode.DOSAGE)
    sim.dosage_map_texels(ViewMode.MAX_POWER)
    grid = sim.dose_grid(res=int(run.traffic["dose_grid"]))
    _sync(run)
    end = time.perf_counter()
    if sample is not None:
        kept.update(final=sim.photon_map_tex.clone(), grid=grid)
    return items, end, kept


def _runs(run, state, deadline=None):
    """Whole runs back to back until `deadline` (None: one run); the record."""
    sample, row0 = _sample(run)
    start = time.perf_counter()
    counted, attempted, kept = [], 0, None
    while True:
        items, end, got = _one_run(run, state, None if counted else sample, deadline if counted else None)
        kept = kept or got
        attempted += len(items)
        if end is not None and (not counted or end <= deadline):
            counted.append((items, end))
        if deadline is None or end is None or end >= deadline:
            break
    return {"unit": "photons", "start": start, "end": counted[-1][1],
            "items": [item for items, _ in counted for item in items], "attempted": attempted,
            "runs": len(counted), "sample": sample, "row0": row0, **kept}


def window(run, state):
    return _runs(run, state, time.perf_counter() + run.seconds)


def traced(run, state):
    return _runs(run, state)


def release(run, state):
    state.clear()


class Reference:
    """The reference's side of a run's comparison: its atlas, the sampled
    iteration traced again, the grid band's probes."""

    def __init__(self, run, sample: int, row0: int, dtype=torch.float32, variants=None, work_every: int = 0):
        c, t = run.config, run.traffic
        tris = scene_io.load_triangles(run.data(c["scene"]))
        self.scene = scene_of(tris, run.device)
        self.atlas = ref_texel.atlas(tris, scene_io.areas(tris), float(c["texel_density"]),
                                     int(c["texel_max_slots"]), run.device)
        lamps = _lamps(run)
        self.per_lamp = ref_dose.launch_size(int(t["photon_count"]), len(lamps))[0]
        self.scale = float(c["light_intensity"]) * 0.1
        self.hists, self.tri_hits, self.k6, self.b2 = ref_texel.iteration_texels(
            self.scene, self.atlas, lamps, scene_io.floor_height(tris), float(c["light_height"]),
            float(c["light_length"]), int(t["photon_count"]), run.seed, sample, run.device, dtype=dtype,
            variants=variants, sample_every=work_every)
        orig, dirs, tp, tri, self.band_work = ref_texel.probe_band(
            self.scene, tris, int(t["dose_grid"]), row0, int(run.cell["grid_rows"]), run.device, dtype=dtype,
            sample_every=work_every)
        self.band = (orig, dirs, tp, tri)
        self.tris = tris

    def band_slots(self, dtype=torch.float32, **fault):
        return ref_texel.cells(self.atlas, *self.band, dtype=dtype, **fault)

    def values(self, slots, counts, photons_per_lamp):
        return ref_texel.texel_values(self.atlas, slots, counts, self.scale, photons_per_lamp)


def readings(ref: Reference, inc, counts, band, photons_per_lamp: int) -> dict:
    """{texel_gap, tri_gap, grid_gap} of a program's (or a control's) texel
    counts added by the sampled iteration (f64[n_slots]), its texel counts
    at the run's end, its grid band (f64) and photons a lamp by then."""
    at = ref.atlas
    hist = ref.hists["sound"]
    texel_gap = float((inc - hist).abs().sum() / hist.abs().sum().clamp_min(1e-30))
    per_tri = torch.bincount(ref_texel.slot_triangles(at), weights=inc, minlength=at.k.shape[0])
    tri_gap = float((per_tri - ref.tri_hits).abs().sum() / ref.tri_hits.abs().sum().clamp_min(1e-30))
    want = ref.values(ref.band_slots(), counts, photons_per_lamp)
    differs = (band - want).abs() > DIFFERS * want.abs()
    return {"texel_gap": texel_gap, "tri_gap": tri_gap, "grid_gap": float(differs.double().mean())}


def check(run, record):
    every = int(run.cell["work_sample_every"]) if run.trace else 0
    ref = Reference(run, record["sample"], record["row0"], work_every=every)
    dev = run.device
    to = lambda a: torch.as_tensor(a).to(dev, torch.float64)  # noqa: E731  (kept on the device until now)
    inc = to(record["after"]) - to(record["before"])
    rows = int(run.cell["grid_rows"])
    band = to(record["grid"][record["row0"]:record["row0"] + rows].reshape(-1))
    iterations = int(run.traffic["iterations"])
    out = readings(ref, inc[:ref.atlas.n_slots], to(record["final"])[:ref.atlas.n_slots], band,
                   ref.per_lamp * iterations)
    expected = ref.per_lamp * len(_lamps(run))
    got = sum(n for _, _, n in record["items"])
    out["photons_gap"] = abs(got - expected * len(record["items"])) / (expected * len(record["items"]))
    if every:  # the sampled iteration's work, times the slice's iterations; the band's, times the grid's rows
        res = int(run.traffic["dose_grid"])
        grids = record["runs"] * res / rows
        segments, tests = ref.b2
        run.work = {"segments": segments * len(record["items"]) + ref.band_work[0] * grids,
                    "tests": tests * len(record["items"]) + ref.band_work[1] * grids,
                    "scene_bytes": ref.tris.nbytes, "k6_bytes": k6_bytes(**ref.k6) * len(record["items"])}
    limits = run.cell["limits"]
    return [(name, float(out[name]), limits[name]) for name in ("texel_gap", "tri_gap", "photons_gap", "grid_gap")]


FAULTS = {"no_fold": {"fold": False}, "mirrored": {"mirror": True}, "off_by_one": {"shift": 1}}


def control(run) -> dict:
    """The readings of `check`'s numbers with the reference in the
    program's place, on the first run's sampled iteration and grid band:
    at LOWER ("lower"), with the upper half left unfolded ("no_fold": no
    hit inside its triangle has u + v > 1, so only rounding at the far edge
    can show it), every hit's cell mirrored across the grid ("mirrored":
    the fold applied to every hit), every slot moved on by one
    ("off_by_one"), and the grid read at its triangles' dose
    ("triangle_grid"). A control's grid values its own slots on its own
    texel counts of the one iteration."""
    sample, row0 = _sample(run)
    ref = Reference(run, sample, row0, variants={"sound": {}, **FAULTS})
    low = Reference(run, sample, row0, dtype=LOWER)
    n = ref.per_lamp

    def read(counts, slots):
        return readings(ref, counts, counts, ref.values(slots, counts, n), n)

    lower = low.hists["sound"]
    out = {"lower": readings(ref, lower, lower, low.values(low.band_slots(dtype=LOWER), lower, n), n)}
    for name, fault in FAULTS.items():
        out[name] = read(ref.hists[name], ref.band_slots(**fault))
    sound = ref.hists["sound"]
    tri_band = ref_texel.triangle_values(ref.atlas, ref.band[3], sound, ref.scale, n)
    out["triangle_grid"] = readings(ref, sound, sound, tri_band, n)
    return out
