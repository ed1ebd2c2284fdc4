"""Hit histograms, slot-to-triangle remap and dose accumulation
(uvtrace/ops/accumulate.py).

The trace kernels histogram hits per padded cluster slot; bounce segments
histogram their alive hits with `hit_counts`; `slots_to_tri` folds the slot
bins into triangle bins once per launch.
"""

from __future__ import annotations

import torch


def hit_counts(hit_ids: torch.Tensor, num_bins: int) -> torch.Tensor:
    """int32[num_bins] histogram of the non-negative ids; misses (< 0) go to
    an overflow bin that is dropped (uvtrace/ops/accumulate.py:42-47). JAX's
    "sort" and "segment" methods give these same counts. An index_add_, not a
    bincount: bincount sizes its output from the largest id, which on the
    card waits for the device."""
    ids = torch.where(hit_ids < 0, num_bins, hit_ids).long()
    out = torch.zeros(num_bins + 1, dtype=torch.int32, device=hit_ids.device)
    out.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    return out[:num_bins]


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
