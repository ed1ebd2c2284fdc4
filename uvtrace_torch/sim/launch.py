"""One lamp launch: the chunk loop of uvtrace/sim/launch.py, in fused and
split modes, with the diffuse bounce loop.

Chunk i draws its rays from the key fold_in(rng_in, i) (uvtrace/sim/launch.py:
119-133). Fused mode (direct lighting) generates, traces and histograms a
chunk in one `fused_trace_counts` call. Split mode generates the chunk with
`generate_stratified`, traces it with `traverse_mxu_counts` (1024-ray
packets, histogram in the kernel) and then runs the bounce segments
(:175-218): per bounce b, `bounce_rays` with the key fold_in(fold_in(rng_in,
7919 + b), i), `coherence_sort`, the split kernel in slots mode at 4096-ray
packets and `hit_counts` of the alive hits. Counts stay in padded-slot space
until one remap per launch. Every key is derived on the host before its
launch and nothing in the loop reads the device, so the launches queue
without a synchronisation.
"""

from __future__ import annotations

import functools

import torch

from uvtrace_torch.ops import accumulate as acc_ops
from uvtrace_torch.ops import rng
from uvtrace_torch.ops.bounce import bounce_rays, coherence_sort
from uvtrace_torch.ops.generate import generate_stratified
from uvtrace_torch.ops.traverse_mxu import MxuScene, fused_trace_counts, traverse_mxu_counts, traverse_mxu_slots

BOUNCE_PACKET = 4096  # incoherent bounce rays: the TPU's measured optimum (PERF.md appendix, round 4)


def launch_counts(
    scene: MxuScene,
    rng_in,
    lamp_xyz,
    light_length,
    *,
    t_count: int,
    n: int,
    chunk: int,
    sampler: str = "stratified",
    max_bounces: int = 0,
    texel_density: float = 0.0,
    device_mesh=None,
    normals=None,
    reflectance=None,
    fused_counts_fn=fused_trace_counts,
    extend_counts_fn=traverse_mxu_counts,
    extend_bounce_fn=functools.partial(traverse_mxu_slots, packet=BOUNCE_PACKET),
) -> torch.Tensor:
    """int32[t_count] hit counts of one lamp launch of n photons.

    rng_in: the launch key's two uint32 words. lamp_xyz: host floats.
    normals f32[L*C, 3] and reflectance f32[L*C] are the triangles' unit
    normals and survival probabilities gathered to slot space (needed when
    max_bounces > 0). The trace functions are parameters, as in JAX: the
    fused kernel runs direct lighting unless `fused_counts_fn` is None, which
    selects split mode; bounces always run split. Modes not ported raise
    NotImplementedError naming their ROADMAP item."""
    if sampler != "stratified":
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported yet (ROADMAP A3: generate_native / "
            "generate_reference, traced by the split kernel)")
    if texel_density > 0:
        raise NotImplementedError("texel dose maps are not ported yet (ROADMAP A10)")
    if device_mesh is not None:
        raise NotImplementedError("multi-device launches are not ported yet (ROADMAP A13)")
    if n % chunk:
        raise NotImplementedError(
            f"n={n} is not a whole number of chunks of {chunk}: a masked tail comes with the "
            "iid samplers (ROADMAP A3)")
    if max_bounces > 0 and (normals is None or reflectance is None):
        raise ValueError("max_bounces > 0 needs normals and reflectance in slot space")
    dev = scene.feat.device
    n_slots = scene.tri_idx_flat.shape[0]
    counts = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    for i in range(n // chunk):
        key = rng.fold_in(rng_in, i)
        if fused_counts_fn is not None and max_bounces == 0:
            counts += fused_counts_fn(scene, key, lamp_xyz, light_length, chunk)[2]
            continue
        rays = generate_stratified(key, chunk, lamp_xyz, light_length, packet=min(1024, chunk), device=dev)
        t_hit, hit, counts_chunk = extend_counts_fn(scene, rays.orig, rays.dir)
        counts += counts_chunk
        orig, direction = rays.orig, rays.dir
        alive = torch.ones(chunk, dtype=torch.bool, device=dev)
        for b in range(max_bounces):
            kb = rng.fold_in(rng.fold_in(rng_in, 7919 + b), i)
            orig, direction, alive = bounce_rays(kb, orig, direction, t_hit, hit, normals, reflectance, alive)
            orig, direction, alive = coherence_sort(orig, direction, alive)
            t_hit, hit_b = extend_bounce_fn(scene, orig, direction)[:2]
            hit = torch.where(alive, hit_b, -1)
            counts += acc_ops.hit_counts(hit, n_slots)
    return acc_ops.slots_to_tri(counts, scene.tri_idx_flat, t_count)
