"""Top-down probe layout and the ceiling-skip re-cast (uvtrace/ops/probes.py),
for Simulator.dose_grid.

Probes are the res x res cell centres over the scene's xz footprint, cast
straight down from 0.1 above the scene top. Möller–Trumbore accepts both
faces, so in a room with a roof the first hit is the ceiling; with
skip_ceiling, probes that hit within `ceiling_margin` of the scene top are
re-cast from just below their hit point. The classification is a pure height
band, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

PARK = 1e6  # coordinate of parked probes, far outside the scene


def probe_rays(lo, hi, res: int, pad: int = 0, device="cpu"):
    """(orig f32[res*res+pad, 3], dir f32[res*res+pad, 3]) of a res x res
    top-down grid; `pad` parked rays appended for packet alignment. lo, hi:
    the scene's f32 bounds; the f32 arithmetic is JAX's (numpy scalars in
    f32, torch tensors in f32)."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    n = res * res
    idx = torch.arange(res, dtype=torch.float32, device=device) + 0.5
    xs = float(lo[0]) + idx * float((hi[0] - lo[0]) / np.float32(res))
    zs = float(lo[2]) + idx * float((hi[2] - lo[2]) / np.float32(res))
    top = float(hi[1] + np.float32(0.1))
    orig = torch.stack([xs.repeat(res), torch.full((n,), top, device=device), zs.repeat_interleave(res)], -1)
    if pad:
        orig = torch.cat([orig, torch.full((pad, 3), PARK, device=device)])
    direction = torch.tensor([0.0, -1.0, 0.0], device=device).expand(n + pad, 3).contiguous()
    return orig, direction


def first_hits_skip_ceiling(extend2, orig, direction, lo_y: float, hi_y: float, *,
                            skip_ceiling: bool = True, ceiling_margin: float = 0.05):
    """First hits of downward probes with the ceiling-band re-cast.
    extend2(orig, dir) -> (t_hit, hit) in any hit-id space, hit < 0 a miss.
    Returns (t_hit, hit) with ceiling-band hits replaced by what lies below
    them (or -1 where nothing does)."""
    t_hit, hit = extend2(orig, direction)
    if hi_y - lo_y <= 10 * ceiling_margin:
        skip_ceiling = False  # flat scene: the top is the target
    if skip_ceiling:
        p_y = orig[:, 1] - t_hit  # direction is (0, -1, 0)
        near_top = (hit >= 0) & (p_y > hi_y - ceiling_margin)
        lowered = orig.clone()
        lowered[:, 1] = p_y - 1e-3
        orig2 = torch.where(near_top[:, None], lowered, PARK)
        t2, hit2 = extend2(orig2, direction)
        use2 = near_top & (hit2 >= 0)
        t_hit = torch.where(use2, (orig[:, 1] - orig2[:, 1]) + t2, t_hit)
        hit = torch.where(near_top, torch.where(use2, hit2, -1), hit)
    return t_hit, hit
