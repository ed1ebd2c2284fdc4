"""One lamp launch: the chunk loop of uvtrace/sim/launch.py, with the diffuse
bounce loop and texel binning, in the hit-id space of the trace functions it
is given.

A launch of n photons runs ceil(n / chunk) chunks; local chunk i has the
global index g = chunk_offset + i and draws its rays with the sampler
(uvtrace/sim/launch.py:117-137):
  - "stratified": generate_stratified from the key fold_in(rng_in, g);
  - "native": generate_native from the key fold_in(rng_in, g);
  - "reference": generate_reference with photon ids from g * chunk and the
    uint32 global seed rng_in.
Lanes past n in the last chunk (local index) are masked: their hits are
dropped and they start no bounce (:164-167, :188). With a `slot_map` (the
split and fused kernels) hits are padded cluster slots: fused mode (direct
lighting, stratified, whole chunks, no atlas) generates, traces and
histograms a chunk in one `fused_counts_fn` call, counts mode histograms in
`extend_counts_fn`, bounce segments are coherence-sorted and traced by
`extend_bounce_fn`, and the slot bins are remapped to triangles once per
launch. Without a slot map (the gen-1 DFS) `extend_fn` returns triangle ids,
histograms run over triangles and bounce segments are traced unsorted by
`extend_fn` (:194-214). Per bounce b the key is fold_in(fold_in(base, 7919 +
b), g), base = rng_in, or fold_in(PRNGKey(0), int32(rng_in)) for the
reference sampler (:183-190). With an atlas every segment's masked hits are
binned into texels from the t its trace function returned (:107-115). A
trace function with a budget (the clustered traversal) returns the clusters
it dropped as a third output; they are summed over the primaries and the
bounce segments that `extend_fn` traces (:155-163, :211-214) and returned as
the launch's overflow, on the device.
Every key and seed is derived on the host before its launch and nothing in
the loop reads the device, so the launches queue without a synchronisation.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from uvtrace_torch.ops import accumulate as acc_ops
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import texel as texel_ops
from uvtrace_torch.ops.bounce import bounce_rays, coherence_sort
from uvtrace_torch.ops.generate import generate_native, generate_reference, generate_stratified

BOUNCE_PACKET = 4096  # incoherent bounce rays: the TPU's measured optimum (PERF.md appendix, round 4)
SAMPLERS = ("stratified", "native", "reference")


def launch_counts(
    scene,
    rng_in,
    lamp_xyz,
    light_length,
    *,
    t_count: int,
    n: int,
    chunk: int,
    extend_fn: Callable,
    sampler: str = "stratified",
    max_bounces: int = 0,
    normals=None,
    reflectance=None,
    atlas: Optional[texel_ops.TexelAtlas] = None,
    n_texels: int = 0,
    tri_v0: Optional[torch.Tensor] = None,
    tri_e1: Optional[torch.Tensor] = None,
    tri_e2: Optional[torch.Tensor] = None,
    slot_map: Optional[torch.Tensor] = None,
    fused_counts_fn: Optional[Callable] = None,
    extend_counts_fn: Optional[Callable] = None,
    extend_bounce_fn: Optional[Callable] = None,
    chunk_offset: int = 0,
    method: str = "segment",
):
    """(int32[t_count] hit counts, int32[n_texels] texel counts, int32
    overflow) of one lamp launch of n photons, as uvtrace/sim/launch.py:231
    returns them. The texel counts are int32[1] zeros without an atlas; the
    overflow is the sum of the third outputs of the trace function's calls
    through `extend_fn` (the clusters a budget dropped), 0 for the
    budget-free ones. method: the histogram of ops/accumulate.hit_counts.

    rng_in: the launch key's two uint32 words, or the uint32 global seed for
    sampler="reference". lamp_xyz: host floats. extend_fn(scene, orig, dir)
    -> (t, hit) traces rays in memory; hits are padded slots when slot_map
    (i32[L*C], slot -> triangle, -1 for padding) is given, triangle ids
    otherwise. normals f32[., 3], reflectance f32[.] (needed when
    max_bounces > 0), tri_v0/e1/e2 f32[., 3] and atlas.base/.k (needed with an
    atlas) are indexed by the same hit ids: with a slot_map they arrive
    expanded to slot space through max(slot_map, 0) (uvtrace/sim/launch.py:
    79-83). chunk_offset: the global index of this call's first chunk, for
    every key and photon id: a multi-device launch runs this function on
    every rank over its own chunks (uvtrace_torch/parallel/sharded.py)."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
    if max_bounces > 0 and (normals is None or reflectance is None):
        raise ValueError("max_bounces > 0 needs normals and reflectance in the hit-id space")
    if atlas is not None and (tri_v0 is None or tri_e1 is None or tri_e2 is None):
        raise ValueError("an atlas needs tri_v0, tri_e1 and tri_e2 in the hit-id space")
    dev = scene[0].device  # the scenes are NamedTuples of tensors on one device
    slot_space = slot_map is not None
    n_bins = slot_map.shape[0] if slot_space else t_count
    whole = n % chunk == 0
    # stratified direct lighting in whole chunks without texels: generate +
    # trace + histogram in one kernel
    fused_mode = (fused_counts_fn is not None and slot_space and whole and sampler == "stratified"
                  and max_bounces == 0 and atlas is None)
    counts_mode = extend_counts_fn is not None and slot_space and whole
    if sampler == "reference":
        base_key = rng.fold_in(rng.PRNGKey(0), int(rng_in))  # fold_in(PRNGKey(0), int32(seed))
    else:
        base_key = rng_in

    def texel_counts_of(orig, direction, t_hit, hit):
        safe = hit.clamp_min(0).long()
        u, v = texel_ops.barycentrics(orig, direction, t_hit, tri_v0[safe], tri_e1[safe], tri_e2[safe])
        return acc_ops.hit_counts(texel_ops.texel_ids(atlas, hit, u, v), n_texels, method)

    def extend(orig, direction):
        """(t, hit) of extend_fn; its overflow, if any, joins the launch's."""
        nonlocal overflow
        res = extend_fn(scene, orig, direction)
        if len(res) > 2:
            overflow = overflow + res[2]
        return res[0], res[1]

    counts = torch.zeros(n_bins, dtype=torch.int32, device=dev)
    tex_counts = torch.zeros(n_texels if atlas is not None else 1, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(max(1, -(-n // chunk))):
        g = chunk_offset + i  # the global chunk index: keys and photon ids
        if fused_mode:
            counts += fused_counts_fn(scene, rng.fold_in(rng_in, g), lamp_xyz, light_length, chunk)[2]
            continue
        if sampler == "reference":
            rays = generate_reference(chunk, lamp_xyz, light_length, int(rng_in), start=g * chunk, device=dev)
        elif sampler == "native":
            rays = generate_native(rng.fold_in(rng_in, g), chunk, lamp_xyz, light_length, device=dev)
        else:
            rays = generate_stratified(rng.fold_in(rng_in, g), chunk, lamp_xyz, light_length,
                                       packet=min(1024, chunk), device=dev)
        if counts_mode:
            t_hit, hit, c = extend_counts_fn(scene, rays.orig, rays.dir)
            counts += c
        else:
            t_hit, hit = extend(rays.orig, rays.dir)
        # the last chunk's lanes past n: hits dropped, no bounces (local index)
        valid = None if (i + 1) * chunk <= n else torch.arange(chunk, device=dev) < n - i * chunk
        if valid is not None:
            hit = torch.where(valid, hit, -1)
        if not counts_mode:
            counts += acc_ops.hit_counts(hit, n_bins, method)
        orig, direction = rays.orig, rays.dir
        if atlas is not None:
            tex_counts += texel_counts_of(orig, direction, t_hit, hit)
        alive = valid if valid is not None else torch.ones(chunk, dtype=torch.bool, device=dev)
        for b in range(max_bounces):
            kb = rng.fold_in(rng.fold_in(base_key, 7919 + b), g)
            orig, direction, alive = bounce_rays(kb, orig, direction, t_hit, hit, normals, reflectance, alive)
            if slot_space:  # re-pack scattered bounce rays into coherent packets
                orig, direction, alive = coherence_sort(orig, direction, alive)
            if extend_bounce_fn is not None:
                t_hit, hit_b = extend_bounce_fn(scene, orig, direction)[:2]
            else:
                t_hit, hit_b = extend(orig, direction)
            hit = torch.where(alive, hit_b, -1)
            counts += acc_ops.hit_counts(hit, n_bins, method)
            if atlas is not None:
                tex_counts += texel_counts_of(orig, direction, t_hit, hit)
    if slot_space:
        counts = acc_ops.slots_to_tri(counts, slot_map, t_count)
    return counts, tex_counts, overflow
