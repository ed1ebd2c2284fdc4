"""Slot-to-triangle remap and dose accumulation (uvtrace/ops/accumulate.py).

The fused kernel histograms hits per padded cluster slot; `slots_to_tri`
folds the slot bins into triangle bins once per launch.
"""

from __future__ import annotations

import torch


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
