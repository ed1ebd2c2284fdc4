"""Hit histograms, slot-to-triangle remap and dose accumulation
(uvtrace/ops/accumulate.py).

The trace kernels histogram hits per padded cluster slot; bounce segments
and the iid paths add their hits into a launch's counts with
`hit_histogram`; `slots_to_tri` folds the slot bins into triangle bins once
per launch. JAX's "sort" and "segment" methods give the counts of one
histogram here: on a CUDA device the kernel K5 (csrc/launch_ops.cu), which
adds in place and replaces the XLA scatter of `counts_segment` (and the sort
of `counts_sort`); on the CPU `hit_histogram_reference`. "onehot" keeps
JAX's f32 sums over 2048-ray tiles (`counts_onehot`).
"""

from __future__ import annotations

import torch


METHODS = ("sort", "segment", "onehot")


def hit_histogram_reference(ids: torch.Tensor, counts: torch.Tensor, alive=None) -> torch.Tensor:
    """Plain PyTorch version of `hit_histogram`: one index_add_ of 0 or 1 a
    lane, the lanes that count adding 1 at their id and the others 0 at bin 0
    (no lane needs a bin past the counts, and nothing waits for the device)."""
    valid = (ids >= 0) & (ids < counts.shape[0])
    if alive is not None:
        valid &= alive
    return counts.index_add_(0, torch.where(valid, ids, 0).long(), valid.to(torch.int32))


def _hit_histogram_kernel(ids: torch.Tensor, counts: torch.Tensor, alive) -> torch.Tensor:
    """One launch of csrc/launch_ops.cu's hit_histogram_kernel (K5)."""
    from uvtrace_torch import _build

    dev, r = ids.device, ids.shape[0]
    _build.check_elements(r)
    _build.check_elements(counts.shape[0])
    _build.check_tensor("ids", ids, torch.int32, (r,), dev)
    _build.check_tensor("counts", counts, torch.int32, (counts.shape[0],), dev)
    if alive is not None:
        _build.check_tensor("alive", alive, torch.bool, (r,), dev)
    if r:
        _build.launch("hit_histogram_launch", dev, r, counts.shape[0], _build.ptr(ids), _build.ptr(alive),
                      _build.ptr(counts))
    return counts


def hit_histogram(ids: torch.Tensor, counts: torch.Tensor, alive=None) -> torch.Tensor:
    """Adds the histogram of `ids` into `counts` in place and returns it:
    counts[ids[i]] += 1 for every lane with 0 <= ids[i] < len(counts) (and
    alive[i]); a miss (< 0) adds nothing (uvtrace/ops/accumulate.py:31-47,
    whose "sort" and "segment" give these counts). ids: i32[R]; counts:
    i32[bins]; alive: optional bool[R]. On a CUDA device one launch of the
    kernel K5 (csrc/launch_ops.cu); on the CPU `hit_histogram_reference`.
    A launch that fails raises."""
    dev = ids.device
    if counts.device != dev or (alive is not None and alive.device != dev):
        raise ValueError(f"ids on {dev}, counts on {counts.device}"
                         + ("" if alive is None else f", alive on {alive.device}"))
    if dev.type == "cpu":
        return hit_histogram_reference(ids, counts, alive)
    if dev.type != "cuda":
        raise ValueError(f"hit_histogram runs on cpu or cuda tensors, not {dev}")
    return _hit_histogram_kernel(ids, counts, alive)


def counts_onehot(hit_ids: torch.Tensor, num_bins: int, tile: int = 2048) -> torch.Tensor:
    """int32[num_bins] histogram as JAX's one-hot matmul makes it
    (uvtrace/ops/accumulate.py:50-64): the ids in tiles of `tile` (the last
    padded with misses), each tile's one-hot column sums added to an f32
    total, tile after tile, then cast to int32. A tile's column sum is a
    count of at most `tile`, exact in f32 in any order, so it is taken as an
    f32 index_add_ of ones instead of a [tile, num_bins] one-hot; the running
    f32 total rounds as JAX's does. Equal to `hit_histogram` until a bin
    passes 2^24 hits."""
    total = torch.zeros(num_bins, dtype=torch.float32, device=hit_ids.device)
    for start in range(0, hit_ids.shape[0], tile):
        ids = hit_ids[start:start + tile]
        ids = torch.where(ids < 0, num_bins, ids).long()
        sums = torch.zeros(num_bins + 1, dtype=torch.float32, device=hit_ids.device)
        total += sums.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float32))[:num_bins]
    return total.to(torch.int32)


def add_hit_counts(counts: torch.Tensor, hit_ids: torch.Tensor, method: str = "segment", alive=None) -> torch.Tensor:
    """counts += the histogram of the non-negative ids (of the alive lanes)
    by `method` (one of METHODS; "sort" and "segment" are `hit_histogram`,
    in place); returns counts."""
    if method == "onehot":
        ids = hit_ids if alive is None else torch.where(alive, hit_ids, -1)
        counts += counts_onehot(ids, counts.shape[0])
        return counts
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    return hit_histogram(hit_ids, counts, alive)


def hit_counts(hit_ids: torch.Tensor, num_bins: int, method: str = "segment") -> torch.Tensor:
    """int32[num_bins] histogram of the non-negative ids by `method` (one of
    METHODS; "sort" and "segment" are one histogram)."""
    return add_hit_counts(torch.zeros(num_bins, dtype=torch.int32, device=hit_ids.device), hit_ids, method)


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
