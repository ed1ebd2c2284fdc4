"""Simulation driver: the port of uvtrace/sim/simulator.py (reference
`RayTracer`, raytracer.cpp/raytracer.h) for direct lighting with the three
samplers, diffuse bounces, texel-resolution dose maps, the top-down probe
dose grid, per-triangle colours, the dose-coloured .glb and power
calibration.

It owns the scene and the dose state on one torch device, runs a launch for
every route waypoint and iteration, converts counts to physical units, casts
the probe grid, calibrates the lamp power and persists routes. Member names, rounding and state fields
follow the JAX Simulator, so that a JAX run's state can be continued here
(`from_jax_state`). The iteration loop stays in Python for pausability
(myapp.cpp:156-175, "Resume computation" userinterface.cpp:339-344).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from uvtrace_torch.geometry.mesh import TriangleMesh
from uvtrace_torch.geometry.procedural import make_single_square
from uvtrace_torch.io.routexml import LightPos, Route
from uvtrace_torch.ops import accumulate as acc_ops
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import shade as shade_ops
from uvtrace_torch.ops import texel as texel_ops
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays
from uvtrace_torch.ops.traverse_mxu import build_mxu_scene, fused_trace_counts, traverse_mxu_counts, traverse_mxu_slots
from uvtrace_torch.ops.traverse_pallas import build_pallas_scene, traverse_pallas
from uvtrace_torch.sim.launch import BOUNCE_PACKET, launch_counts
from uvtrace_torch.sim.params import SimParams, ViewMode


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class Simulator:
    """Scene + dose state on one device, driving the launches.

    device: "cuda" runs the CUDA kernels and raises when no card is present;
    "cpu" runs their plain PyTorch versions (for tests and small runs).
    params.traversal: "auto" and "mxu-fused" trace stratified direct
    lighting with the fused kernel (B1), "mxu" with the split kernel (B2);
    both run bounces, the iid samplers, masked chunk tails and the probe
    grid through B2 in padded-slot space. "pallas" traces everything through
    the gen-1 packet DFS (B3) in triangle-id space. An atlas
    (params.texel_density > 0) turns the fused mode off: texel launches run
    B2 in counts mode, or B3. The port computes in f32 for every
    `params.precision`.

    cluster_size: triangles per cluster (None: 128, uvtrace's default; B3
    takes 128 only). max_leaf_size is accepted for the JAX signature and
    ignored: it sizes the leaves of the fine BVH of JAX's "jax" traversal,
    which the port's kernels do not walk. bvh, max_clusters and device_mesh
    (the "jax" and "clustered" traversals, multiple devices) raise
    NotImplementedError naming their ROADMAP item."""

    def __init__(
        self,
        mesh: TriangleMesh,
        params: SimParams = SimParams(),
        route: Optional[list[LightPos]] = None,
        bvh=None,
        ray_chunk: int = 1 << 20,
        max_leaf_size: Optional[int] = 8,
        cluster_size: Optional[int] = None,
        max_clusters: Optional[int] = None,
        device_mesh=None,
        device="cuda",
    ):
        for name, value, item in (("bvh", bvh, "A4"), ("max_clusters", max_clusters, "A4"),
                                  ("device_mesh", device_mesh, "A13")):
            if value is not None:
                raise NotImplementedError(f"{name}= is not ported yet (ROADMAP {item})")
        if params.traversal not in ("auto", "mxu-fused", "mxu", "pallas"):
            raise NotImplementedError(
                f"traversal={params.traversal!r} is not ported; the port runs the fused, split and "
                "gen-1 DFS kernels ('auto', 'mxu-fused', 'mxu', 'pallas'; 'clustered' and 'jax': "
                "ROADMAP A4)")
        if params.accumulate_method not in ("sort", "segment"):
            # both run the one index_add_ histogram of ops/accumulate.py
            raise NotImplementedError(
                f"accumulate_method={params.accumulate_method!r} is not ported; the port's one "
                "histogram gives the counts of 'sort' and 'segment' (MXU 'onehot': ROADMAP A5)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device; pass device='cpu' "
                               "to run the plain PyTorch version")
        self.mesh = mesh
        self.params = params
        self.route: list[LightPos] = route if route is not None else [LightPos(0.0, 0.0, 1.0)]
        self.areas = torch.from_numpy(mesh.areas).to(self.device)
        # 128-triangle clusters by default, as uvtrace for every mode
        clusters = build_clusters(mesh.tris, cluster_size=128 if cluster_size is None else cluster_size)
        normals = torch.from_numpy(mesh.normals).to(self.device)
        if params.traversal == "pallas":
            # hits are triangle ids: no slot map, geometry in triangle space
            self.scene = build_pallas_scene(clusters, device=self.device)
            self._slot_map = self._safe_sm = None
            self._trace = dict(extend_fn=traverse_pallas)
            self._normals_launch = normals
        else:
            self.scene = build_mxu_scene(clusters, device=self.device)
            self._slot_map = self.scene.tri_idx_flat
            self._trace = dict(
                extend_fn=traverse_mxu_slots, extend_counts_fn=traverse_mxu_counts,
                extend_bounce_fn=functools.partial(traverse_mxu_slots, packet=BOUNCE_PACKET),
                fused_counts_fn=None if params.traversal == "mxu" else fused_trace_counts)
            # launch contract (uvtrace/sim/launch.py:79-83): per-hit geometry is
            # gathered to padded-slot space once, through max(slot_map, 0)
            self._safe_sm = self._slot_map.clamp_min(0).long()
            self._normals_launch = normals[self._safe_sm]
        # the kernels consume whole 1024-ray packets
        self.ray_chunk = max(1024, int(ray_chunk))
        self.set_reflectance(params.reflectance)
        self.atlas = self._atlas_launch = None
        self._n_texels = 0
        if params.texel_density > 0:
            self.atlas = texel_ops.build_atlas(mesh.areas, density=params.texel_density,
                                               max_slots=params.texel_max_slots, device=self.device)
            self._n_texels = self.atlas.n_slots
            tris = torch.from_numpy(mesh.tris).to(self.device)
            self._tri_v0, self._tri_e1, self._tri_e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
            self._atlas_launch = self.atlas
            if self._safe_sm is not None:  # the launch contract's slot space
                sm = self._safe_sm
                self._tri_v0, self._tri_e1, self._tri_e2 = self._tri_v0[sm], self._tri_e1[sm], self._tri_e2[sm]
                self._atlas_launch = self.atlas._replace(base=self.atlas.base[sm], k=self.atlas.k[sm])
        self.reset()

    # ------------------------------------------------------------ route edit

    def add_lamp(self, x: float = 0.0, y: float = 0.0, duration: float = 1.0):
        """RayTracer::AddLamp (raytracer.cpp:3-10): append a waypoint."""
        self.route.append(LightPos(x, y, duration))

    def move_lamp(self, index: int, x: float, y: float):
        """UserInterface::MoveLightPos (userinterface.cpp:410-431)."""
        self.route[index] = LightPos(x, y, self.route[index].duration)

    def delete_lamp(self, index: int):
        """Waypoint deletion (userinterface.cpp:152-191)."""
        del self.route[index]

    def set_reflectance(self, reflectance):
        """Per-triangle UV reflectance (the RR survival probability of
        bounce mode): a scalar or f32[T]."""
        rho = torch.as_tensor(np.asarray(reflectance, np.float32), device=self.device)
        self.reflectance = torch.broadcast_to(rho, (self.triangle_count,)).contiguous()

    def _reflectance_launch(self) -> torch.Tensor:
        """Reflectance in the launch's hit-id space, per launch: set_reflectance
        may change it between iterations."""
        return self.reflectance if self._safe_sm is None else self.reflectance[self._safe_sm]

    # ---------------------------------------------------------------- state

    @property
    def triangle_count(self) -> int:
        return self.mesh.triangle_count

    def reset(self):
        """ResetDosageMap (raytracer.cpp:122-131): zero the accumulators,
        restart the iteration counter and the key."""
        t = self.triangle_count
        self.photon_map = torch.zeros(t, dtype=torch.float32, device=self.device)
        self.max_photon_map = torch.zeros(t, dtype=torch.float32, device=self.device)
        if self.atlas is not None:
            self.photon_map_tex = torch.zeros(self._n_texels, dtype=torch.float32, device=self.device)
            self.max_photon_map_tex = torch.zeros_like(self.photon_map_tex)
        self.photon_map_size = 0
        self._launch_n = 0  # per-lamp launch size of the last launch (MAX_POWER divides by it)
        self.curr_iterations = 0
        self.global_seed = 0  # the reference sampler's uint32 cross-launch SEED
        self.key = rng.PRNGKey(self.params.seed)  # uint32[2] key words
        self.finished = False

    @property
    def photons_per_light(self) -> int:
        return self.params.photons_per_light(len(self.route))

    # ------------------------------------------------------------- pipeline

    def _single_light(self, lamp: LightPos, n: int):
        """ComputeSingleLightDosageMap (raytracer.cpp:75-88). The reference
        sampler draws from the global seed and advances it after the launch;
        the others split the session key (uvtrace/sim/simulator.py:356-391)."""
        lamp_xyz = np.array(
            [lamp.x, self.mesh.floor_height + self.params.light_height, lamp.y], np.float32
        )
        sampler = self.params.sampler
        if sampler == "reference":
            new_key, rng_in = self.key, self.global_seed
        else:
            new_key, rng_in = rng.split(self.key)
        chunk = max(1024, min(self.ray_chunk, _next_pow2(n)))
        if sampler == "stratified":
            # stratified cells tile whole chunks: trace whole chunks and
            # normalise by the true count (photon_map_size); the iid samplers
            # mask the last chunk's tail instead
            n = -(-n // chunk) * chunk
        bounces = self.params.max_bounces
        tex = {}
        if self.atlas is not None:
            tex = dict(atlas=self._atlas_launch, n_texels=self._n_texels, tri_v0=self._tri_v0,
                       tri_e1=self._tri_e1, tri_e2=self._tri_e2)
        counts, tex_counts, _ = launch_counts(
            self.scene, rng_in, lamp_xyz.tolist(), np.float32(self.params.light_length),
            t_count=self.triangle_count, n=n, chunk=chunk, sampler=sampler, max_bounces=bounces,
            normals=self._normals_launch if bounces else None,
            reflectance=self._reflectance_launch() if bounces else None,
            slot_map=self._slot_map, **tex, **self._trace,
        )
        self.key = new_key
        self._launch_n = n
        self.photon_map, self.max_photon_map = acc_ops.accumulate_dose(
            self.photon_map, self.max_photon_map, counts, lamp.duration
        )
        if self.atlas is not None:
            self.photon_map_tex, self.max_photon_map_tex = acc_ops.accumulate_dose(
                self.photon_map_tex, self.max_photon_map_tex, tex_counts, lamp.duration)
        if sampler == "reference":
            self.global_seed = rng.advance_global_seed(lamp_xyz.tolist(), rng_in)
        self.photon_map_size += n
        return counts

    def run_iteration(self):
        """One iteration over all route waypoints (raytracer.cpp:66-72)."""
        n = self.photons_per_light
        for lamp in self.route:
            self._single_light(lamp, n)
        self.curr_iterations += 1
        if self.curr_iterations >= self.params.max_iterations:
            self.finished = True

    def compute(self, progress_callback=None):
        """Run to max_iterations; returns the DOSAGE map."""
        while not self.finished:
            self.run_iteration()
            if progress_callback:
                progress_callback(self.curr_iterations / self.params.max_iterations)
        return self.dosage_map(ViewMode.DOSAGE)

    def resume(self, extra_iterations: Optional[int] = None):
        """'Resume computation' (userinterface.cpp:339-344): continue
        accumulating on top of the existing maps."""
        if extra_iterations is not None:
            self.params = dataclasses.replace(
                self.params, max_iterations=self.params.max_iterations + extra_iterations
            )
        self.finished = False
        self.compute()

    # ----------------------------------------------------------------- shade

    def _view_scale(self, view: ViewMode):
        """(photons per lamp, scaled power) of a view (raytracer.cpp:93-120):
        DOSAGE divides the cumulative map by the photons per lamp so far,
        MAX_POWER the peak map by the last launch's size."""
        if view == ViewMode.MAX_POWER:
            return self._launch_n or self.photons_per_light, self.params.light_intensity * 100.0
        return max(1, self.photon_map_size // max(1, len(self.route))), self.params.light_intensity * 0.1

    def dosage_map(self, view: ViewMode = ViewMode.DOSAGE) -> torch.Tensor:
        """Physical units per RayTracer::Shade (raytracer.cpp:93-120):
        DOSAGE: cumulative dose in mJ/cm^2; MAX_POWER: peak irradiance in
        µW/cm^2."""
        src = self.max_photon_map if view == ViewMode.MAX_POWER else self.photon_map
        return shade_ops.compute_dosage(src, self.areas, *self._view_scale(view))

    def dosage_map_texels(self, view: ViewMode = ViewMode.DOSAGE) -> torch.Tensor:
        """f32[n_slots] per-texel dose map (needs params.texel_density > 0) in
        the units of dosage_map, with the atlas's exact cell areas."""
        if self.atlas is None:
            raise ValueError("dosage_map_texels needs params.texel_density > 0")
        src = self.max_photon_map_tex if view == ViewMode.MAX_POWER else self.photon_map_tex
        return texel_ops.texel_dose(self.atlas, src[: self.atlas.n_slots], *self._view_scale(view))

    def dose_grid(self, res: int = 256, view: ViewMode = ViewMode.DOSAGE, texels: Optional[bool] = None,
                  skip_ceiling: bool = True, ceiling_margin: float = 0.05) -> np.ndarray:
        """Top-down dose image (BASELINE config 1's 256^2 dose map,
        uvtrace/sim/simulator.py:578-672): a res x res grid of downward probes
        over the scene footprint, each reporting the dose of the first surface
        it hits, with the ceiling-band re-cast of ops/probes.py. Probes run
        through the session's trace function (B2, or B3 for
        traversal="pallas") in 1024-ray packets (the batch is padded with
        parked rays). With texels (None: when an atlas exists) a probe reports
        the dose of its texel, from the barycentrics of its hit (re-cast t
        from the original origin); otherwise its triangle's. Returns
        f32[res, res] in the units of dosage_map(view)."""
        if texels is None:
            texels = self.atlas is not None
        if texels and self.atlas is None:
            raise ValueError("dose_grid(texels=True) needs params.texel_density > 0")
        verts = self.mesh.tris.reshape(-1, 3)
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        n = res * res
        orig, direction = probe_rays(lo, hi, res, pad=(-n) % 1024, device=self.device)
        extend = self._trace["extend_fn"]
        t_hit, hit = first_hits_skip_ceiling(
            lambda o, d: extend(self.scene, o, d)[:2], orig, direction, float(lo[1]), float(hi[1]),
            skip_ceiling=skip_ceiling, ceiling_margin=ceiling_margin)
        t_hit, tri = t_hit[:n], hit[:n]
        if self._slot_map is not None:
            tri = torch.where(tri >= 0, self._slot_map[tri.clamp_min(0).long()], -1)
        safe = tri.clamp_min(0).long()
        if texels:
            tris = torch.from_numpy(self.mesh.tris).to(self.device)
            v0 = tris[safe, 0]
            u, v = texel_ops.barycentrics(orig[:n], direction[:n], t_hit, v0, tris[safe, 1] - v0,
                                          tris[safe, 2] - v0)
            slots = texel_ops.texel_ids(self.atlas, tri, u, v)
            img = torch.where(slots >= 0, self.dosage_map_texels(view)[slots.clamp_min(0).long()], 0.0)
        else:
            img = torch.where(tri >= 0, self.dosage_map(view)[safe], 0.0)
        return img.cpu().numpy().astype(np.float32).reshape(res, res)

    # ------------------------------------------------------------ calibrate

    def _make_calibration_sim(self, measure_height: float, measure_dist: float, budget: int) -> "Simulator":
        """The synthetic calibration setup of the reference (raytracer.cpp:
        156-190, uvtrace/sim/simulator.py:743-780): a 0.2 x 0.2 m square of two
        triangles at the measured height and distance, the lamp at the origin
        of the real room's floor height, this session's params and device."""
        square = make_single_square(center=(0.0, self.mesh.floor_height + measure_height, measure_dist),
                                    half_width=0.1, axis="z")
        cal = Simulator(square, dataclasses.replace(self.params, photon_count=budget, texel_density=0.0),
                        route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=self.ray_chunk, device=self.device)
        cal.mesh.floor_height = self.mesh.floor_height
        return cal

    def calibrate_power(self, measure_power: float, measure_height: float, measure_dist: float, *,
                        rel_stderr: float = 0.005) -> float:
        """Linear power calibration against a UV-meter reading (raytracer.cpp:
        151-227, Report §2.2; uvtrace/sim/simulator.py:782-840): trace photons
        at power 1 into the calibration square in launches of up to 2^20,
        stopping once the relative standard error of the per-launch mean
        doses is below `rel_stderr` (at least 4 launches, at most the
        session's photon budget), then set light_intensity to
        0.01 * measured / simulated mean and return it (W)."""
        budget = min(self.params.photon_count, 1 << 20)
        cal = self._make_calibration_sim(measure_height, measure_dist, budget)
        max_launches = max(1, self.params.max_iterations * max(1, self.params.photon_count // budget))
        means: list[float] = []
        prev = np.zeros((2,), np.float32)
        areas = cal.areas.cpu()
        for _ in range(max_launches):
            cal._single_light(cal.route[0], budget)
            cur = cal.photon_map.cpu().numpy()  # one read per launch, as the reference's clFinish
            dose_i = shade_ops.compute_dosage(torch.from_numpy(cur - prev), areas, cal._launch_n or budget, 1.0)
            means.append(float(dose_i.mean()))
            prev = cur
            if len(means) >= 4:
                m = float(np.mean(means))
                se = float(np.std(means, ddof=1)) / len(means) ** 0.5
                if m > 0 and se / m < rel_stderr:
                    break
        calibrated = 0.01 * measure_power / float(np.mean(means))
        self.params = dataclasses.replace(self.params, light_intensity=calibrated)
        return calibrated

    def colors(self, view: ViewMode = ViewMode.DOSAGE, threshold_view: bool = False) -> torch.Tensor:
        """f32[T, 3] per-triangle RGB of a view (cl/shade.cl:43-71): the
        heatmap of the dose or irradiance around its minimum, or the scan
        texture's colour at each triangle's UV centroid (TEXTURE)."""
        if view == ViewMode.TEXTURE:
            return torch.from_numpy(self.mesh.flat_texture_colors()).to(self.device)
        scale = self.params.min_power if view == ViewMode.MAX_POWER else self.params.min_dosage
        return shade_ops.dosage_to_color(self.dosage_map(view), scale, threshold_view)

    def export_glb(self, path, view: ViewMode = ViewMode.DOSAGE, threshold_view: bool = False):
        """Write a dose-coloured .glb viewable in any glTF viewer."""
        from uvtrace_torch.io.gltf_export import export_glb

        export_glb(path, self.mesh.tris, colors=self.colors(view, threshold_view).cpu().numpy(),
                   uvs=self.mesh.uvs)

    # ----------------------------------------------------------------- io

    def save_route(self, path):
        from uvtrace_torch.io.routexml import save_route_xml

        save_route_xml(
            path,
            Route(
                waypoints=list(self.route),
                photon_count=self.params.photon_count,
                max_iterations=self.params.max_iterations,
                light_intensity=self.params.light_intensity,
                min_dosage=self.params.min_dosage,
                min_power=self.params.min_power,
                light_length=self.params.light_length,
                light_height=self.params.light_height,
            ),
        )

    def load_route(self, path):
        from uvtrace_torch.io.routexml import load_route_xml

        r = load_route_xml(path)
        self.params = r.apply_to(self.params)
        if r.waypoints:
            self.route = r.waypoints


def from_jax_state(sim: Simulator, np_state: dict) -> Simulator:
    """Continue a JAX Simulator's run on `sim` (same mesh, params and route).

    np_state holds the JAX state as numpy values: photon_map, max_photon_map
    (f32[T]), photon_map_size, _launch_n, curr_iterations (ints), key (the
    two uint32 words of `jax.random.key_data(jax_sim.key)`), global_seed
    (the reference sampler's uint32 SEED; 0 when absent) and, for a texel
    run, photon_map_tex and max_photon_map_tex (f32[n_slots])."""
    as_map = lambda a: torch.from_numpy(np.array(a, np.float32)).to(sim.device)  # noqa: E731
    sim.photon_map = as_map(np_state["photon_map"])
    sim.max_photon_map = as_map(np_state["max_photon_map"])
    for name in ("photon_map_tex", "max_photon_map_tex"):
        if name in np_state:
            setattr(sim, name, as_map(np_state[name]))
    sim.photon_map_size = int(np_state["photon_map_size"])
    sim._launch_n = int(np_state["_launch_n"])
    sim.curr_iterations = int(np_state["curr_iterations"])
    sim.key = np.asarray(np_state["key"], np.uint32).reshape(2).copy()
    sim.global_seed = int(np_state.get("global_seed", 0)) & 0xFFFFFFFF
    sim.finished = sim.curr_iterations >= sim.params.max_iterations
    return sim
