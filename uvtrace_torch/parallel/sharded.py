"""Multi-device launches over a torch.distributed DeviceMesh: the port of
uvtrace/parallel/sharded.py, one sharded pipeline shared with the Simulator.

- the photon batch is embarrassingly parallel: the `rays` axis shards it;
- the scene (clusters and their tiles, a few MB) is built on every rank;
- every rank runs the SAME chunked launch (`launch_counts`,
  uvtrace_torch/sim/launch.py) over its own range of GLOBAL chunk indices,
  so the photon population, and with it every count, is bit-identical to a
  one-device run of the whole launch, whatever the mesh's factorization;
- per-triangle count partials are summed with one all_reduce, the collective
  that replaces the reference's atomic_inc contention (cl/extend.cl:95-98);
- a `texels` axis shards large texel dose maps (BASELINE config 5): every
  rank still traces its own photons, and its full-size texel partial is
  reduce_scattered over `texels`, so each rank keeps only its slot range,
  then all_reduced over `rays`.

Every collective goes through `Collectives`. NCCL takes CUDA tensors as they
are; a gloo group (CPU ranks, or ranks that share one card, which NCCL
refuses) takes host tensors, so a CUDA tensor is copied to the host, reduced
there and copied back, and the bytes and seconds of that staging are
counted. Integer sums are exact, so staging changes no result.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from uvtrace_torch.parallel.multihost import RAY_AXIS, TEXEL_AXIS


def make_ray_mesh(n_devices: Optional[int] = None, device_type: Optional[str] = None) -> DeviceMesh:
    """A 1-D mesh over the `rays` axis of every rank (n_devices, when given,
    must be the world size). device_type as in multihost.make_2d_mesh."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a {n_devices}-rank ray mesh needs {n_devices} ranks, the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(RAY_AXIS,))


def mesh_shape(mesh: DeviceMesh) -> tuple[int, int]:
    """(ray_shards, texel_shards) of a 1-D or 2-D product mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    if names not in ((RAY_AXIS,), (RAY_AXIS, TEXEL_AXIS)):
        raise ValueError(
            f"expected a ('{RAY_AXIS}',) or ('{RAY_AXIS}', '{TEXEL_AXIS}') device mesh, got axis names "
            f"{names}: build one with uvtrace_torch.parallel.make_ray_mesh or make_2d_mesh")
    return mesh.size(0), mesh.size(1) if len(names) == 2 else 1


def mesh_index(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's (ray index, texel index) on the mesh."""
    _, tex_shards = mesh_shape(mesh)
    return mesh.get_local_rank(RAY_AXIS), mesh.get_local_rank(TEXEL_AXIS) if tex_shards > 1 else 0


class Collectives:
    """The collectives of one mesh, by axis name, and the cost of staging.

    staged_bytes counts the bytes copied between the card and the host for
    gloo groups (both ways), staged_seconds the host time of those calls
    (copies and collective, ending in the copy back); calls counts every
    collective. On an NCCL mesh or with CPU tensors nothing is staged."""

    def __init__(self, mesh: DeviceMesh):
        mesh_shape(mesh)
        self.mesh = mesh
        self.staged_bytes = 0
        self.staged_seconds = 0.0
        self.calls = 0

    def _run(self, axis: str, op, x: torch.Tensor) -> torch.Tensor:
        """op(group, tensor) -> result on this axis's group, staged through
        the host when the group is gloo and x lies on a card."""
        group = self.mesh.get_group(axis)
        self.calls += 1
        if x.device.type == "cpu" or dist.get_backend(group) != "gloo":
            return op(group, x)
        t0 = time.perf_counter()
        host = x.cpu()
        out = op(group, host).to(x.device)
        self.staged_bytes += host.nbytes + out.nbytes
        self.staged_seconds += time.perf_counter() - t0
        return out

    def all_reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of x over the ranks of every axis in `axes` (x itself is
        overwritten)."""

        def op(group, t):
            dist.all_reduce(t, group=group)
            return t

        for axis in axes:
            x = self._run(axis, op, x)
        return x

    def reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """This rank's slice of the sum over `axis` of a 1-D x, whose length
        the axis size divides."""

        # reduce_scatter_single is the newer name (reduce_scatter_tensor is
        # deprecated from torch 2.13 on), the same call
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

        def op(group, t):
            out = t.new_empty(t.numel() // dist.get_world_size(group))
            scatter(out, t.contiguous(), group=group)
            return out

        return self._run(axis, op, x)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ranks' x along `axis`, concatenated on dim 0 in rank order."""

        def op(group, t):
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts)

        return self._run(axis, op, x)


def sharded_launch_fn(
    mesh: DeviceMesh,
    *,
    t_count: int,
    n_total: int,
    chunk: int,
    sampler: str,
    extend_fn,
    max_bounces: int = 0,
    n_texels: int = 0,
    extend_counts_fn=None,
    fused_counts_fn=None,
    extend_bounce_fn=None,
    collectives: Optional[Collectives] = None,
    method: str = "segment",
):
    """The multi-device launch of `n_total` photons, run by every rank.

    Returns fn(scene, rng_in, lamp_xyz, light_length, aux) -> (counts
    i32[t_count], tex_counts, overflow), where `aux` holds the per-launch
    tensors launch_counts takes (normals, reflectance, atlas, tri_v0/e1/e2,
    slot_map). The rank with linear index d = rays_index * texel_shards +
    texels_index scans global chunks [d*k, (d+1)*k): the keys and photon ids
    fold the GLOBAL chunk index, so results are bit-identical to one device
    AND invariant to the factorization (4x1 == 2x2 == 1x4).

    Outputs: counts summed over every axis; tex_counts summed over every
    axis on a 1-D mesh (i32[n_texels]) and, on a 2-D mesh, this rank's
    slice i32[n_texels / texel_shards] of that sum (reduce_scatter over
    `texels`, then all_reduce over `rays`); the overflow (the clusters a
    budgeted trace function dropped) summed over every axis, so that every
    rank sees the same total and escalates, and redoes the launch, with the
    others (a rank deciding alone would leave the rest waiting in a
    collective). collectives: the `Collectives` to run them through (a new
    one when None); method: the histogram of ops/accumulate.hit_counts."""
    from uvtrace_torch.sim.launch import launch_counts  # the Simulator imports this module

    ray_shards, tex_shards = mesh_shape(mesh)
    n_dev = ray_shards * tex_shards
    if n_total % (n_dev * chunk) != 0:
        raise ValueError(
            f"n_total={n_total} must be a multiple of n_devices*chunk = {n_dev}*{chunk} so every device "
            "scans whole chunks (the Simulator rounds launches up to this automatically)")
    chunks_per_dev = n_total // n_dev // chunk
    if tex_shards > 1 and (not n_texels or n_texels % tex_shards != 0):
        raise ValueError(
            f"a {tex_shards}-way 'texels' axis needs n_texels > 0 and divisible by it (got n_texels="
            f"{n_texels}); enable params.texel_density — the Simulator pads the slot count")
    comm = collectives or Collectives(mesh)
    ray_idx, tex_idx = mesh_index(mesh)
    offset = (ray_idx * tex_shards + tex_idx) * chunks_per_dev
    axes = mesh.mesh_dim_names
    static = dict(t_count=t_count, n=n_total // n_dev, chunk=chunk, sampler=sampler, extend_fn=extend_fn,
                  max_bounces=max_bounces, n_texels=n_texels, extend_counts_fn=extend_counts_fn,
                  fused_counts_fn=fused_counts_fn, extend_bounce_fn=extend_bounce_fn, method=method)

    def fn(scene, rng_in, lamp_xyz, light_length, aux):
        counts, tex, ov = launch_counts(scene, rng_in, lamp_xyz, light_length, chunk_offset=offset, **static, **aux)
        counts = comm.all_reduce(counts, axes)
        if tex_shards > 1:
            tex = comm.all_reduce(comm.reduce_scatter(tex, TEXEL_AXIS), (RAY_AXIS,))
        elif aux.get("atlas") is not None:
            tex = comm.all_reduce(tex, axes)
        return counts, tex, comm.all_reduce(ov.reshape(1), axes)[0]

    return fn
