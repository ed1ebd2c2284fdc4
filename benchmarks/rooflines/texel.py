"""The least work of the texel binning kernel K6 (csrc/launch_ops.cu
`texel_bin_kernel`), from the reference's histograms of the hits it bins.

A launch reads every lane's (t, id), each counted hit's ray (origin and
direction), once each distinct triangle it hits (v0, e1, e2 and the atlas's
base and k), and reads and writes once each texel it touches. Its
operations (the barycentrics, about 60 a hit) take a tenth of the bytes'
time at the peaks of rooflines/peaks.json: the bytes bound it. A texel or
triangle hit in several launches is counted in each, as each launch reads
it again.
"""

from __future__ import annotations

LANE_BYTES = 8  # t f32, id i32
RAY_BYTES = 24  # origin and direction, f32[3] each
TRIANGLE_BYTES = 44  # v0, e1, e2 f32[3] each, base and k i32
TEXEL_BYTES = 8  # an i32 count read and written
KERNELS = ("texel_bin_kernel",)


def k6_bytes(lanes: int, hits: int, triangles: int, texels: int) -> int:
    """Bytes K6's launches need: sums over the launches of their lanes,
    counted hits, distinct triangles hit and distinct texels touched."""
    return lanes * LANE_BYTES + hits * RAY_BYTES + triangles * TRIANGLE_BYTES + texels * TEXEL_BYTES


def roofline(run) -> float | None:
    """Percent of the card's bandwidth roofline that K6 reached over the
    traced slice, or None where there is nothing to read."""
    from benchmarks.harness.profile import device_time_s
    from benchmarks.rooflines.work import PEAKS

    peak = PEAKS.get(run.device_kind)
    n_bytes = run.work.get("k6_bytes")
    if peak is None or not n_bytes or run.profile is None:
        return None
    seconds = device_time_s(run.profile, KERNELS)
    return 100.0 * n_bytes / peak["bytes_per_s"] / seconds if seconds > 0 else None
