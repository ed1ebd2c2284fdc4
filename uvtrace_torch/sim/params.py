"""Simulation parameters.

Numpy copy of uvtrace/sim/params.py, kept equal to it by tests/test_torch_host.py.

Defaults mirror the reference's tunables (raytracer.h:28-37): 1 m lamp rod
0.8 m above the floor, 2^25 photons per iteration (2^26 hard cap in the
reference UI — here a soft advisory, the TPU build has no 2^27 color-buffer
corruption bug, Report §5.1), 10 iterations, 450 W lamp, 100 mJ/cm^2 minimum
dose, 1500 µW/cm^2 minimum irradiance.
"""

from __future__ import annotations

import dataclasses
import enum


class ViewMode(enum.Enum):
    """raytracer.h: enum ViewMode { dosage, maxpower, texture }."""

    DOSAGE = "dosage"
    MAX_POWER = "maxpower"
    TEXTURE = "texture"


@dataclasses.dataclass(frozen=True)
class SimParams:
    light_length: float = 1.0  # m, rod length
    light_height: float = 0.8  # m, rod base above the floor
    photon_count: int = 1 << 25  # photons per iteration (all lamps together)
    max_photon_count: int = 1 << 26  # advisory cap (reference UI clamp)
    max_iterations: int = 10
    light_intensity: float = 450.0  # W
    min_dosage: float = 100.0  # mJ/cm^2 (legend/threshold midpoint)
    min_power: float = 1500.0  # µW/cm^2

    # Framework knobs (no reference equivalent):
    # "stratified" | "native" | "reference". Stratified (equal-area sphere
    # cells per ray packet) is the default: unbiased, strictly lower variance
    # than iid, and packet-coherent — the iid samplers make every packet's
    # frustum cover the whole scene (~100x slower on the MXU kernel).
    # "native" = iid threefry (the reference's distribution); "reference" =
    # bit-exact WangHash/xorshift32 replay of cl/generate.cl.
    sampler: str = "stratified"
    accumulate_method: str = "segment"  # see ops/accumulate.py (segment ~10x
    #   faster than sort on TPU for 2^20 rays -> 45k bins, measured)
    traversal: str = "auto"  # "auto" | "clustered" | "jax" | "pallas" |
    #   "mxu" | "mxu-fused" ("mxu" + generate-in-kernel for the stratified
    #   direct-lighting path: rays never touch HBM; bounce/texel/iid modes
    #   fall back to the split mxu path automatically)
    precision: str = "high"  # mxu kernel matmul tier: "highest" (f32-exact,
    #   what the tests/goldens use) | "high" (bf16x3: 0.006% hit reassignment,
    #   ~8x below MC noise at default photon counts; 1.3x faster) | "fast"
    #   (single bf16 pass: preview quality)
    seed: int = 0
    # Multi-bounce diffuse interreflection (superset of the reference, which
    # is direct-lighting-only — Report §1.1; BASELINE config 2):
    max_bounces: int = 0  # 0 = reference behavior
    reflectance: float = 0.0  # uniform UV reflectance (RR survival prob)
    # Texel-resolution dose maps (superset: the reference is per-triangle;
    # BASELINE configs ask for fixed-resolution dose maps — ops/texel.py):
    texel_density: float = 0.0  # texels per meter; 0 = per-triangle only
    texel_max_slots: int = 1 << 22  # atlas budget

    def photons_per_light(self, num_lights: int) -> int:
        """Per-lamp launch size: floor division rounded down to even
        (raytracer.cpp:61-64)."""
        return (self.photon_count // max(1, num_lights)) & ~1
