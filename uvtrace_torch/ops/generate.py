"""Stratum grid of the packet-stratified sphere sampler.

The fused kernel generates its rays itself (ops/traverse_mxu.py); what the
host needs is the factorisation of the packet count into strata, which must
equal uvtrace/ops/generate.py:_stratum_grid so that packet g samples the same
cell on both packages.
"""

from __future__ import annotations

import math


def _stratum_grid(g: int, height_bands: int = 1) -> tuple[int, int, int]:
    """Factor g packets into (rod-height bands) x (cos-theta bands) x
    (azimuth sectors). Height bands shrink the packet frustum's origin spread;
    at least 64 direction cells are kept so that small launches do not get
    fat direction cones."""
    gh = height_bands
    while gh > 1 and (g % gh or g // gh < 64):
        gh //= 2
    rest = g // gh
    gy = max(1, int(math.sqrt(rest)))
    while rest % gy:
        gy -= 1
    return gh, gy, rest // gy
