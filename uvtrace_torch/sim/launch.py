"""One lamp launch: the chunk loop of uvtrace/sim/launch.py in fused mode.

Each chunk of `chunk` rays is one `fused_trace_counts` call with the key
fold_in(rng_in, global chunk index) (uvtrace/sim/launch.py:119-125); the
per-slot counts add up on the device and map to triangles once at the end.
The chunk keys are derived on the host before the loop, and nothing inside
the loop reads the device, so the launches queue without a synchronisation.
"""

from __future__ import annotations

import torch

from uvtrace_torch.ops import accumulate as acc_ops
from uvtrace_torch.ops import rng
from uvtrace_torch.ops.traverse_mxu import MxuScene, fused_trace_counts


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
) -> torch.Tensor:
    """int32[t_count] hit counts of one lamp launch of n photons.

    rng_in: the launch key's two uint32 words. lamp_xyz: host floats.
    Only the fused direct-lighting mode is ported; every other mode raises
    NotImplementedError naming the ROADMAP item that ports it."""
    if sampler != "stratified":
        raise NotImplementedError(
            f"sampler={sampler!r} is not ported yet (ROADMAP A3: generate_native / "
            "generate_reference, traced by the split kernel B2)")
    if max_bounces > 0:
        raise NotImplementedError("bounces are not ported yet (ROADMAP A9, on kernel B2)")
    if texel_density > 0:
        raise NotImplementedError("texel dose maps are not ported yet (ROADMAP A10)")
    if device_mesh is not None:
        raise NotImplementedError("multi-device launches are not ported yet (ROADMAP A13)")
    if n % chunk:
        raise NotImplementedError(
            f"n={n} is not a whole number of chunks of {chunk}: a masked tail needs the "
            "split kernel (ROADMAP B2)")
    counts = torch.zeros(scene.tri_idx_flat.shape[0], dtype=torch.int32, device=scene.feat.device)
    for i in range(n // chunk):
        key = rng.fold_in(rng_in, i)
        counts += fused_trace_counts(scene, key, lamp_xyz, light_length, chunk)[2]
    return acc_ops.slots_to_tri(counts, scene.tri_idx_flat, t_count)
