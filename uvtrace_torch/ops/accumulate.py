"""Hit histograms, slot-to-triangle remap and dose accumulation
(uvtrace/ops/accumulate.py).

The trace kernels histogram hits per padded cluster slot; bounce segments
histogram their alive hits with `hit_counts`; `slots_to_tri` folds the slot
bins into triangle bins once per launch. JAX's "sort" and "segment" methods
are the one `index_add_` histogram here; "onehot" keeps JAX's f32 sums over
2048-ray tiles (`counts_onehot`).
"""

from __future__ import annotations

import torch


METHODS = ("sort", "segment", "onehot")


def counts_segment(hit_ids: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int32[num_bins] histogram of the non-negative ids; misses (< 0) go to
    an overflow bin that is dropped (uvtrace/ops/accumulate.py:42-47). JAX's
    "sort" and "segment" methods give these same counts. An index_add_, not a
    bincount: bincount sizes its output from the largest id, which on the
    card waits for the device."""
    ids = torch.where(hit_ids < 0, num_bins, hit_ids).long()
    out = torch.zeros(num_bins + 1, dtype=torch.int32, device=hit_ids.device)
    out.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    return out[:num_bins]


def counts_onehot(hit_ids: torch.Tensor, num_bins: int, tile: int = 2048) -> torch.Tensor:
    """int32[num_bins] histogram as JAX's one-hot matmul makes it
    (uvtrace/ops/accumulate.py:50-64): the ids in tiles of `tile` (the last
    padded with misses), each tile's one-hot column sums added to an f32
    total, tile after tile, then cast to int32. A tile's column sum is a
    count of at most `tile`, exact in f32 in any order, so it is taken as an
    f32 index_add_ of ones instead of a [tile, num_bins] one-hot; the running
    f32 total rounds as JAX's does. Equal to `counts_segment` until a bin
    passes 2^24 hits."""
    total = torch.zeros(num_bins, dtype=torch.float32, device=hit_ids.device)
    for start in range(0, hit_ids.shape[0], tile):
        ids = hit_ids[start:start + tile]
        ids = torch.where(ids < 0, num_bins, ids).long()
        sums = torch.zeros(num_bins + 1, dtype=torch.float32, device=hit_ids.device)
        total += sums.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float32))[:num_bins]
    return total.to(torch.int32)


def hit_counts(hit_ids: torch.Tensor, num_bins: int, method: str = "segment") -> torch.Tensor:
    """int32[num_bins] histogram of the non-negative ids by `method` (one of
    METHODS; "sort" and "segment" are one histogram)."""
    if method == "onehot":
        return counts_onehot(hit_ids, num_bins)
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    return counts_segment(hit_ids, num_bins)


def slots_to_tri(counts_slots: torch.Tensor, slot_map: torch.Tensor, t_count: int) -> torch.Tensor:
    """int32[t_count] triangle counts from int32[L*C] slot counts.

    slot_map[s] is the original triangle of slot s, -1 for cluster padding;
    padding slots go to an overflow bin T that is dropped."""
    seg = torch.where(slot_map < 0, torch.full_like(slot_map, t_count), slot_map)
    out = torch.zeros(t_count + 1, dtype=torch.int32, device=counts_slots.device)
    out.index_add_(0, seg.long(), counts_slots.to(torch.int32))
    return out[:t_count]


def accumulate_dose(photon_map, max_photon_map, counts, time_step):
    """One accumulate step (cl/accumulate.cl:4-14).

    photon_map += counts * time_step (duration-weighted cumulative);
    max_photon_map = max(max_photon_map, counts).
    Returns the new (photon_map, max_photon_map).
    """
    counts_f = counts.to(photon_map.dtype)
    # a Python scalar, not a new device tensor: copying a host value to the
    # card would wait for the launches queued before it
    return photon_map + counts_f * float(time_step), torch.maximum(max_photon_map, counts_f)
