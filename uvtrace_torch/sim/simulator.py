"""Simulation driver: the port of uvtrace/sim/simulator.py (reference
`RayTracer`, raytracer.cpp/raytracer.h) for direct lighting with the three
samplers, diffuse bounces, texel-resolution dose maps, the top-down probe
dose grid, per-triangle colours, the dose-coloured .glb and power
calibration.

It owns the scene and the dose state on one torch device, runs a launch for
every route waypoint and iteration, converts counts to physical units, casts
the probe grid, calibrates the lamp power and persists routes. With a
torch.distributed DeviceMesh, every rank runs a Simulator on its own device
and the launches, the probe grid and the calibration are sharded over the
ranks (uvtrace_torch/parallel/sharded.py). Member names, rounding and state fields
follow the JAX Simulator, so that a JAX run's state can be continued here
(`from_jax_state`). The iteration loop stays in Python for pausability
(myapp.cpp:156-175, "Resume computation" userinterface.cpp:339-344).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from uvtrace_torch.bvh import native
from uvtrace_torch.bvh.builder import build_bvh
from uvtrace_torch.device import resolve
from uvtrace_torch.geometry.mesh import TriangleMesh
from uvtrace_torch.geometry.procedural import make_single_square
from uvtrace_torch.io.routexml import LightPos, Route
from uvtrace_torch.ops import accumulate as acc_ops
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import shade as shade_ops
from uvtrace_torch.ops import texel as texel_ops
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.probes import first_hits_skip_ceiling, probe_rays
from uvtrace_torch.ops.traverse import scene_arrays, traverse
from uvtrace_torch.ops.traverse_clustered import cluster_arrays, traverse_clustered
from uvtrace_torch.ops.traverse_mxu import build_mxu_scene, fused_trace_counts, traverse_mxu_counts, traverse_mxu_slots
from uvtrace_torch.ops.traverse_pallas import build_pallas_scene, traverse_pallas
from uvtrace_torch.parallel.sharded import RAY_AXIS, TEXEL_AXIS, Collectives, mesh_index, mesh_shape, sharded_launch_fn
from uvtrace_torch.sim.launch import BOUNCE_PACKET, launch_counts
from uvtrace_torch.sim.params import SimParams, ViewMode


TRAVERSALS = ("auto", "mxu-fused", "mxu", "pallas", "clustered", "jax")


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
    B2 in counts mode, or B3. "clustered" (ops/traverse_clustered.py) and
    "jax" (the fine-BVH walk, ops/traverse.py) are JAX's plain-array
    traversals in plain torch, in triangle-id space, on any device; `auto`
    stays the fused kernel on every device (JAX picks "clustered" off the
    TPU). The port computes in f32 for every `params.precision`;
    self.backend names the traversal that runs ("mxu-fused" for "auto").

    cluster_size: triangles per cluster (None: 128, uvtrace's default; B3
    takes 128 only), built by the native builder (bvh/native.py) when it
    compiles here, as uvtrace does, else by the numpy one. bvh: a FlatBVH
    (or any object with its fields, JAX's included) for the "jax"
    traversal, which it selects; without one that traversal builds its fine
    BVH with leaves of at most max_leaf_size triangles (native builder, else
    bvh/builder.py). max_clusters: the clustered traversal's first budget of
    clusters per packet (None: 32 for stratified direct launches of at least
    2^16 photons, whose packets are coherent, else 512; at most the cluster
    count). A launch or probe batch whose packets entered more clusters than
    the budget is redone with the budget x 4 after a RuntimeWarning
    (`_escalate_cluster_budget`), the same photons again, until nothing is
    dropped.

    device_mesh: a torch.distributed DeviceMesh, 1-D ('rays',) or 2-D
    ('rays', 'texels') (uvtrace_torch.parallel), over which every rank runs
    this constructor and every method below with the same arguments, each on
    its own `device`. Every launch then runs the same chunked pipeline on
    every rank over its own GLOBAL chunk range, and all_reduces the counts:
    the results are bit-identical to one device and to any other
    factorization of the mesh. A 'texels' axis (needs params.texel_density >
    0) shards the texel dose map: each rank keeps only its n_texels /
    texel_shards slots (BASELINE config 5). Host decisions (the calibration's
    stopping rule, the reference sampler's seed) read reduced values only, so
    every rank takes the same branch."""

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
        if params.traversal not in TRAVERSALS:
            raise ValueError(f"traversal must be one of {TRAVERSALS}, got {params.traversal!r}")
        if params.accumulate_method not in acc_ops.METHODS:
            raise ValueError(f"accumulate_method must be one of {acc_ops.METHODS}, got "
                             f"{params.accumulate_method!r}")
        self.device = resolve(device)
        self.device_mesh = device_mesh
        self._ray_shards = self._tex_shards = 1
        self._ray_index = self._tex_index = 0
        self.collectives = None
        if device_mesh is not None:
            self._ray_shards, self._tex_shards = mesh_shape(device_mesh)
            if self._tex_shards > 1 and params.texel_density <= 0:
                raise ValueError("a 'texels' mesh axis shards the texel dose map — set params.texel_density > 0 "
                                 "(ops/texel.py)")
            self._ray_index, self._tex_index = mesh_index(device_mesh)
            self.collectives = Collectives(device_mesh)
        self._n_dev = self._ray_shards * self._tex_shards
        self._flat_mesh = None
        self.mesh = mesh
        self.params = params
        self.route: list[LightPos] = route if route is not None else [LightPos(0.0, 0.0, 1.0)]
        self.areas = torch.from_numpy(mesh.areas).to(self.device)
        backend = "jax" if bvh is not None else params.traversal
        self.backend = "mxu-fused" if backend == "auto" else backend
        normals = torch.from_numpy(mesh.normals).to(self.device)
        # hits are triangle ids but for the split and fused kernels: no slot
        # map, geometry in triangle space
        self._slot_map = self._safe_sm = None
        self._normals_launch = normals
        if backend == "jax":
            if bvh is None:
                build_fine = native.build_bvh_native if native.available() else build_bvh
                bvh = build_fine(mesh.tris, max_leaf_size=max_leaf_size)
            self.bvh = bvh
            self.scene = scene_arrays(bvh, device=self.device)
            self._trace = dict(extend_fn=functools.partial(traverse, max_leaf=bvh.max_leaf_size))
        else:
            # 128-triangle clusters by default, as uvtrace for every mode, from
            # the native builder where it compiles (uvtrace/sim/simulator.py:117-150)
            build = native.build_clusters_native if native.available() else build_clusters
            self.clusters = build(mesh.tris, cluster_size=128 if cluster_size is None else cluster_size)
        if backend == "clustered":
            self.scene = cluster_arrays(self.clusters, device=self.device)
            self._l_count = self.clusters.n_clusters
            if max_clusters is None:
                # stratified direct packets are coherent; the iid samplers,
                # bounces and small launches (few strata, wide cones) cover
                # the room (uvtrace/sim/simulator.py:226-240)
                coherent = (params.sampler == "stratified" and params.max_bounces == 0
                            and params.photon_count >= (1 << 16))
                max_clusters = 32 if coherent else 512
            self._set_cluster_budget(min(max_clusters, self._l_count))
        elif backend == "pallas":
            self.scene = build_pallas_scene(self.clusters, device=self.device)
            self._trace = dict(extend_fn=traverse_pallas)
        elif backend != "jax":
            self.scene = build_mxu_scene(self.clusters, device=self.device)
            self._slot_map = self.scene.tri_idx_flat
            self._trace = dict(
                extend_fn=traverse_mxu_slots, extend_counts_fn=traverse_mxu_counts,
                extend_bounce_fn=functools.partial(traverse_mxu_slots, packet=BOUNCE_PACKET),
                fused_counts_fn=None if params.traversal == "mxu" else fused_trace_counts)
            # launch contract (uvtrace/sim/launch.py:79-83): per-hit geometry is
            # gathered to padded-slot space once, through max(slot_map, 0)
            self._safe_sm = self._slot_map.clamp_min(0).long()
            self._normals_launch = normals[self._safe_sm]
        # the kernels consume whole 1024-ray packets; the plain traversals
        # take any chunk (uvtrace/sim/simulator.py:341-344)
        self._min_chunk = 1 if backend in ("clustered", "jax") else 1024
        self.ray_chunk = max(self._min_chunk, int(ray_chunk))
        self.set_reflectance(params.reflectance)
        self.atlas = self._atlas_launch = None
        self._n_texels = 0
        if params.texel_density > 0:
            self.atlas = texel_ops.build_atlas(mesh.areas, density=params.texel_density,
                                               max_slots=params.texel_max_slots, device=self.device)
            # the histogram rounds up to the texel-shard count so that the
            # reduce_scatter tiles evenly; slots >= atlas.n_slots receive no
            # hits and are cut off in dosage_map_texels
            self._n_texels = -(-self.atlas.n_slots // self._tex_shards) * self._tex_shards
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
            # on a 'texels' axis each rank keeps only its own slot range
            self.photon_map_tex = torch.zeros(self._n_texels // self._tex_shards, dtype=torch.float32,
                                              device=self.device)
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
        chunk = max(self._min_chunk, min(self.ray_chunk, _next_pow2(n)))
        if self.device_mesh is not None:
            # every rank scans whole chunks: n rounds up to devices x chunk
            step = self._n_dev * chunk
            n = -(-n // step) * step
        elif sampler == "stratified":
            # stratified cells tile whole chunks: trace whole chunks and
            # normalise by the true count (photon_map_size); the iid samplers
            # mask the last chunk's tail instead
            n = -(-n // chunk) * chunk
        bounces = self.params.max_bounces
        aux = dict(normals=self._normals_launch if bounces else None,
                   reflectance=self._reflectance_launch() if bounces else None, slot_map=self._slot_map)
        if self.atlas is not None:
            aux.update(atlas=self._atlas_launch, tri_v0=self._tri_v0, tri_e1=self._tri_e1, tri_e2=self._tri_e2)
        args = (self.scene, rng_in, lamp_xyz.tolist(), np.float32(self.params.light_length))
        counts, tex_counts = self._launch_audited(args, aux, n, chunk)
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

    def _launch_once(self, args, aux: dict, n: int, chunk: int):
        """(counts, tex_counts, overflow) of one launch, on this device or
        sharded over the mesh (launch_counts on this rank's global chunks,
        the counts and the overflow all_reduced; uvtrace/sim/simulator.py:
        470-510)."""
        static = dict(chunk=chunk, sampler=self.params.sampler, max_bounces=self.params.max_bounces,
                      n_texels=self._n_texels, method=self.params.accumulate_method, **self._trace)
        if self.device_mesh is None:
            return launch_counts(*args, t_count=self.triangle_count, n=n, **static, **aux)
        launch = sharded_launch_fn(self.device_mesh, t_count=self.triangle_count, n_total=n,
                                   collectives=self.collectives, **static)
        return launch(*args, aux)

    def _launch_audited(self, args, aux: dict, n: int, chunk: int):
        """One launch, audited for the clustered traversal's budget
        (uvtrace/sim/simulator.py:421-437): the overflow is read (one wait
        for the device a launch) and, while clusters were dropped, the
        budget grows and the launch is redone from the same key, so the same
        photons, none dropped. A lost hit under-counts dose, the one error a
        disinfection simulator must not make. Every rank of a mesh reads the
        same all_reduced overflow and takes the same branch."""
        while True:
            counts, tex_counts, overflow = self._launch_once(args, aux, n, chunk)
            if self.backend != "clustered":
                return counts, tex_counts
            dropped = int(overflow)
            if dropped == 0:
                return counts, tex_counts
            self._escalate_cluster_budget(dropped)

    def _set_cluster_budget(self, budget: int):
        self._max_clusters = budget
        self._trace = dict(extend_fn=functools.partial(traverse_clustered, max_clusters=budget,
                                                       return_overflow=True))

    def _escalate_cluster_budget(self, dropped: int):
        """Grow the clustered traversal's budget x 4, up to the cluster count,
        after `dropped` clusters were dropped (uvtrace/sim/simulator.py:
        439-466); RuntimeError if the full budget dropped any."""
        if self._max_clusters >= self._l_count:
            raise RuntimeError(
                "clustered traversal dropped candidate clusters even at the maximum budget — this should be "
                "impossible; please report (or use traversal='mxu'/'jax').")
        new_budget = min(self._l_count, self._max_clusters * 4)
        warnings.warn(
            f"per-packet cluster budget {self._max_clusters} dropped {dropped} candidate cluster(s); retrying "
            f"with budget {new_budget}. Incoherent rays (iid samplers, small launches, bounces, probe slabs) need "
            "large budgets — traversal='mxu' is budget-free and faster on TPU.",
            RuntimeWarning, stacklevel=3)
        self._set_cluster_budget(new_budget)

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
        the units of dosage_map, with the atlas's exact cell areas. On a
        'texels' mesh axis it all_gathers the ranks' slot ranges, so every
        rank must call it."""
        if self.atlas is None:
            raise ValueError("dosage_map_texels needs params.texel_density > 0")
        src = self.max_photon_map_tex if view == ViewMode.MAX_POWER else self.photon_map_tex
        return texel_ops.texel_dose(self.atlas, self.full_texel_map(src), *self._view_scale(view))

    def full_texel_map(self, src: torch.Tensor) -> torch.Tensor:
        """The whole f32[n_slots] map of which this rank keeps `src` (its
        slot range on a 'texels' axis, gathered from every rank: a
        collective), without the shard-alignment padding."""
        if self._tex_shards > 1:
            src = self.collectives.all_gather(src, TEXEL_AXIS)
        return src[: self.atlas.n_slots]

    def own_texels(self, full) -> torch.Tensor:
        """This rank's part of a whole texel map (numpy, the real atlas
        slots): padded for this Simulator's texel shards, sliced to its slot
        range and put on its device (checkpoints, `from_jax_state`)."""
        full = np.asarray(full, np.float32)[: self.atlas.n_slots]
        full = np.concatenate([full, np.zeros(self._n_texels - full.shape[0], np.float32)])
        k = self._n_texels // self._tex_shards
        return torch.from_numpy(full[self._tex_index * k:(self._tex_index + 1) * k].copy()).to(self.device)

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
        f32[res, res] in the units of dosage_map(view).

        On a device mesh the probes are padded to 1024 x ray shards, each
        ray rank traces its slice and the (t, hit) slices are all_gathered
        over 'rays' (uvtrace/sim/simulator.py:620-650, 674-719): every rank
        must call it, and every rank gets the whole image."""
        if texels is None:
            texels = self.atlas is not None
        if texels and self.atlas is None:
            raise ValueError("dose_grid(texels=True) needs params.texel_density > 0")
        verts = self.mesh.tris.reshape(-1, 3)
        lo, hi = verts.min(axis=0), verts.max(axis=0)
        n = res * res
        orig, direction = probe_rays(lo, hi, res, pad=(-n) % (1024 * self._ray_shards), device=self.device)
        t_hit, hit = first_hits_skip_ceiling(self._extend_probes, orig, direction, float(lo[1]), float(hi[1]),
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

    def _extend_probes(self, orig: torch.Tensor, direction: torch.Tensor):
        """(t, hit) of a probe batch through the session's trace function,
        sharded over the mesh's ray axis when there is one: this rank traces
        its slice, and the slices are all_gathered. A probe packet is a slab
        of the whole room: the clustered traversal's budget is audited as a
        launch's is, the overflow all_reduced over the mesh
        (uvtrace/sim/simulator.py:674-719)."""
        if self.device_mesh is not None:
            k = orig.shape[0] // self._ray_shards
            part = slice(self._ray_index * k, (self._ray_index + 1) * k)
        while True:
            if self.device_mesh is None:
                res = self._trace["extend_fn"](self.scene, orig, direction)
                dropped = int(res[2]) if self.backend == "clustered" else 0
            else:
                res = self._trace["extend_fn"](self.scene, orig[part], direction[part])
                dropped = 0
                if self.backend == "clustered":
                    dropped = int(self.collectives.all_reduce(res[2].reshape(1), self.device_mesh.mesh_dim_names))
            if dropped == 0:
                break
            self._escalate_cluster_budget(dropped)
        if self.device_mesh is None:
            return res[0], res[1]
        return self.collectives.all_gather(res[0], RAY_AXIS), self.collectives.all_gather(res[1], RAY_AXIS)

    # ------------------------------------------------------------ calibrate

    def _make_calibration_sim(self, measure_height: float, measure_dist: float, budget: int) -> "Simulator":
        """The synthetic calibration setup of the reference (raytracer.cpp:
        156-190, uvtrace/sim/simulator.py:743-780): a 0.2 x 0.2 m square of two
        triangles at the measured height and distance, the lamp at the origin
        of the real room's floor height, this session's params and device.
        A 2-D (rays x texels) session mesh flattens to a 1-D ray mesh of
        every rank (the square needs no atlas), so every rank traces
        (uvtrace/sim/simulator.py:760-774)."""
        square = make_single_square(center=(0.0, self.mesh.floor_height + measure_height, measure_dist),
                                    half_width=0.1, axis="z")
        cal_mesh = self.device_mesh
        if cal_mesh is not None and self._tex_shards > 1:
            if self._flat_mesh is None:  # a new mesh creates process groups: once per session
                self._flat_mesh = DeviceMesh(cal_mesh.device_type, cal_mesh.mesh.flatten(),
                                             mesh_dim_names=(RAY_AXIS,))
            cal_mesh = self._flat_mesh
        cal = Simulator(square, dataclasses.replace(self.params, photon_count=budget, texel_density=0.0),
                        route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=self.ray_chunk, device_mesh=cal_mesh,
                        device=self.device)
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
        0.01 * measured / simulated mean and return it (W). A sharded
        session calibrates over every rank; the per-launch means come from
        the all_reduced map, so every rank stops after the same launch."""
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
    run, photon_map_tex and max_photon_map_tex (f32[n_slots], of which a
    rank on a 'texels' mesh axis keeps its own slot range)."""
    as_map = lambda a: torch.from_numpy(np.array(a, np.float32)).to(sim.device)  # noqa: E731
    sim.photon_map = as_map(np_state["photon_map"])
    sim.max_photon_map = as_map(np_state["max_photon_map"])
    for name in ("photon_map_tex", "max_photon_map_tex"):
        if name in np_state:
            setattr(sim, name, sim.own_texels(np_state[name]))
    sim.photon_map_size = int(np_state["photon_map_size"])
    sim._launch_n = int(np_state["_launch_n"])
    sim.curr_iterations = int(np_state["curr_iterations"])
    sim.key = np.asarray(np_state["key"], np.uint32).reshape(2).copy()
    sim.global_seed = int(np_state.get("global_seed", 0)) & 0xFFFFFFFF
    sim.finished = sim.curr_iterations >= sim.params.max_iterations
    return sim
