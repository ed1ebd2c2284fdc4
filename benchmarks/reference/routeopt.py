"""The route optimiser's first steps in plain PyTorch autograd.

The objective is the soft minimum (temperature T) of the route's dose over
every triangle of nonzero area, dose_t = 0.1 sum_w seconds_w E_t(lamp_w).
The parameters are the waypoints through lo + (hi - lo) sigmoid(raw) and
the dwell times through total x softmax(logits); each step is their
gradient and one Adam update (optax's order, b1 0.9, b2 0.999, eps 1e-8).

E_t at a lamp is the next-event estimate P / S sum_s G V: S points q on
each triangle (u, v uniforms folded onto it) seen from S points r on the rod
(x, base + u length, z), G = |d.n| / (4 pi |d|^3), d = q - r, and V the
visibility of q from r: no triangle hit before |d| (1 - 1e-3) - 1e-3
(reference/tracer.py). V is constant under differentiation. With
reflectance, virtual point lights add sum_k E_k: M source points drawn by
area (weight w = total area / M), their direct irradiance, n_bounces - 1
passes of the M x M Lambertian transfer F = |cos| |cos| / (pi |d|^2) V,
and one transfer of the summed exitance rho E to S points on each triangle.

Random numbers are the threefry draws of the seed's key (common random
numbers): waypoint w draws from fold_in(key, w), its interreflection from
fold_in(fold_in(key, w), 1); reference/threefry.py. Every visibility that
does not depend on the lamp (the sources' matrix and the receivers) is
traced once and kept for the steps that follow.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.reference import threefry
from benchmarks.reference.tracer import trace

EPS = 1e-3
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
_F = lambda x: float(np.float32(x))  # noqa: E731


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cumsum_blocked(p: np.ndarray, base: int = 16) -> np.ndarray:
    """f32 inclusive prefix sums in blocks of `base`, each block from its
    left end, the block totals scanned the same way (the order in which the
    upstream source draw sums the area probabilities)."""
    p = np.asarray(p, np.float32)
    n = p.shape[0]
    if n <= base:
        return np.cumsum(p, dtype=np.float32)
    blocks = np.zeros(-(-n // base) * base, np.float32)
    blocks[:n] = p
    inner = np.cumsum(blocks.reshape(-1, base), axis=1, dtype=np.float32)
    prefix = np.concatenate([np.zeros(1, np.float32), cumsum_blocked(inner[:, -1], base)[:-1]])
    return (inner + prefix[:, None]).reshape(-1)[:n]


class RouteProblem:
    """The objective of one route on one scene, its random numbers and its
    constant visibilities, in `dtype`."""

    def __init__(self, trace_scene, tris: np.ndarray, floor: float, route: dict, config: dict, traffic: dict,
                 seed: int, device, dtype=torch.float32, work_every: int = 0):
        self.scene, self.device, self.dtype = trace_scene, device, dtype
        f = dict(dtype=torch.float32, device=device)
        t = torch.from_numpy(np.ascontiguousarray(tris, np.float32)).to(device)
        self.v0, self.e1, self.e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
        c = _cross(self.e1, self.e2)
        norm = torch.sqrt((c * c).sum(-1, keepdim=True))
        self.normal = c / torch.clamp_min(norm, 1e-20)
        self.mask = norm[:, 0] > 0
        self.t_count = tris.shape[0]
        self.n_s = int(config["n_samples"])
        self.temperature = float(config["temperature"])
        self.lr = float(config["learning_rate"])
        self.base = float(floor + route["light_height"])
        self.length = float(route["light_length"])
        self.power = float(route["light_intensity"])
        self.key = threefry.key(seed)
        wp = np.array([[x, z] for x, z, _ in route["waypoints"]], np.float32)
        durs = np.array([s for _, _, s in route["waypoints"]], np.float32)
        m = float(config["bounds_margin"])
        v = tris.reshape(-1, 3)
        lo_np, hi_np = v.min(axis=0), v.max(axis=0)
        bounds = ((float(lo_np[0]) + m, float(lo_np[2]) + m), (float(hi_np[0]) - m, float(hi_np[2]) - m))
        wp = np.clip(wp, np.float32(bounds[0]) + 1e-3, np.float32(bounds[1]) - 1e-3)
        self.lo, self.hi = torch.tensor(bounds[0], **f), torch.tensor(bounds[1], **f)
        wp_t = torch.as_tensor(wp, **f)
        frac = torch.clamp((wp_t - self.lo) / torch.clamp_min(self.hi - self.lo, 1e-9), 1e-4, 1 - 1e-4)
        self.raw0 = torch.log(frac) - torch.log1p(-frac)
        self.total_time = float(np.sum(durs))
        self.logits0 = torch.log(torch.as_tensor(durs, **f) / self.total_time)
        self.n_way = wp.shape[0]
        self.reflectance = float(traffic.get("reflectance", 0.0))
        self.bounces = int(traffic.get("n_bounces", 1))
        self.n_src = int(traffic.get("n_sources", 64))
        self.work_every = work_every
        # (rays traced, their work scaled from the sample) of what a route
        # traces once and of one evaluation of the objective (rooflines/work.py)
        self.work = {"route": [0, 0.0], "forward": [0, 0.0]}
        self._work_of = "route"
        if self.reflectance > 0:
            areas = (0.5 * np.linalg.norm(np.cross(tris[:, 0] - tris[:, 1], tris[:, 0] - tris[:, 2]), axis=1)
                     ).astype(np.float32)
            total = np.float32(math.fsum(areas.astype(np.float64)))
            self.area_total = float(total)
            self.cdf = torch.from_numpy(cumsum_blocked(areas / total)).to(device)
            self._field = [self._constant_field(w) for w in range(self.n_way)]
        self._work_of = "forward"

    # -- random numbers -------------------------------------------------------

    def _tri_points(self, k, n_s: int):
        """(points f32[S, T, 3], normals) of S uniform points on each triangle."""
        ku, kv = threefry.split(k)
        u = threefry.uniform(ku, (n_s, self.t_count, 1), self.device)
        v = threefry.uniform(kv, (n_s, self.t_count, 1), self.device)
        flip = (u + v) > 1.0
        u, v = torch.where(flip, 1.0 - u, u), torch.where(flip, 1.0 - v, v)
        return self.v0[None] + u * self.e1[None] + v * self.e2[None], self.normal[None]

    # -- visibility -----------------------------------------------------------

    def _visible(self, orig, target) -> torch.Tensor:
        """f32 1 where the segment from orig to target (f32[N, 3]) meets no
        triangle before |d| (1 - eps) - eps."""
        with torch.no_grad():
            d = target - orig
            dist = torch.sqrt(_dot(d, d))
            dirs = d / torch.clamp_min(dist, 1e-20)[:, None]
            t, _ = trace(self.scene, orig, dirs, limit=dist * (1.0 - EPS) - EPS, dtype=self.dtype, any_hit=True)
            if self.work_every:
                _, _, w = trace(self.scene, orig[::self.work_every], dirs[::self.work_every], work=True)
                counts = self.work[self._work_of]
                counts[0] += orig.shape[0]
                counts[1] += float(w.sum()) * orig.shape[0] / w.shape[0]
            return (t == float("inf")).to(torch.float32)

    # -- the estimator ----------------------------------------------------------

    def _direct(self, lamp_xz, k, q, n, n_rod: int):
        """E f32[M] at points q f32[1|S, M, 3] (normals n) from n_rod rod
        points drawn from key k."""
        dt = self.dtype
        u_rod = threefry.uniform(k, (n_rod, 1), self.device)
        rod = torch.cat([lamp_xz[0].expand(n_rod, 1), self.base + u_rod.to(dt) * self.length,
                         lamp_xz[1].expand(n_rod, 1)], dim=-1)
        q = q.to(dt).expand(n_rod, -1, -1)
        d = q - rod[:, None, :]
        dd = torch.clamp_min(_dot(d, d), 1e-12)
        g = torch.abs(_dot(d, n.to(dt))) / torch.sqrt(dd) / (_F(4.0 * np.pi) * dd)
        orig = rod.detach().float()[:, None, :].expand(q.shape).reshape(-1, 3)
        vis = self._visible(orig, q.detach().float().reshape(-1, 3)).view(g.shape).to(dt)
        return self.power * (g * vis).sum(0) / n_rod

    def _constant_field(self, w: int):
        """The sources of waypoint w and what of their transfer is constant:
        (source ids, points, normals, F V of the sources' matrix, F V of
        the sources to the receivers)."""
        keys = threefry.split(threefry.fold_in(threefry.fold_in(self.key, w), 1), 4)
        u = threefry.uniform(keys[0], (self.n_src,), self.device)
        src = torch.searchsorted(self.cdf, self.cdf[-1] * (1.0 - u))
        ku, kv = threefry.split(keys[1])
        a = threefry.uniform(ku, (self.n_src, 1), self.device)
        b = threefry.uniform(kv, (self.n_src, 1), self.device)
        flip = (a + b) > 1.0
        a, b = torch.where(flip, 1.0 - a, a), torch.where(flip, 1.0 - b, b)
        x = self.v0[src] + a * self.e1[src] + b * self.e2[src]
        nx = self.normal[src]
        q, nq = self._tri_points(keys[3], self.n_s)
        q, nq = q.reshape(-1, 3), nq.expand(self.n_s, -1, -1).reshape(-1, 3)
        return src, x, nx, self._transfer(x, nx, x, nx, diagonal=False), self._transfer(x, nx, q, nq)

    def _transfer(self, x, nx, q, nq, diagonal: bool = True) -> torch.Tensor:
        """F V f32[B, P] from sources (x, nx) to receivers (q, nq)."""
        dt = self.dtype
        fv = []
        step = max(1, (1 << 24) // q.shape[0])
        for b0 in range(0, x.shape[0], step):
            xb, nb = x[b0:b0 + step], nx[b0:b0 + step]
            d = (q[None].to(dt) - xb[:, None].to(dt))
            dd = torch.clamp_min(_dot(d, d), 1e-12)
            root = torch.sqrt(dd)
            f = torch.abs(_dot(d, nb[:, None].to(dt))) / root * (torch.abs(_dot(d, nq[None].to(dt))) / root) / (
                _F(np.pi) * dd)
            orig = xb[:, None].expand(-1, q.shape[0], -1).reshape(-1, 3)
            vis = self._visible(orig, q[None].expand(xb.shape[0], -1, -1).reshape(-1, 3)).view(f.shape)
            fv.append(f * vis.to(dt))
        fv = torch.cat(fv)
        if not diagonal:
            fv = fv * (1.0 - torch.eye(fv.shape[0], fv.shape[1], device=fv.device, dtype=dt))
        return fv

    def _bounce(self, lamp_xz, w: int):
        dt = self.dtype
        src, x, nx, f_ss, f_sp = self._field[w]
        keys = threefry.split(threefry.fold_in(threefry.fold_in(self.key, w), 1), 4)
        rho = torch.full((self.n_src,), self.reflectance, dtype=dt, device=self.device)
        weight = _F(np.float32(self.area_total) / np.float32(self.n_src))
        e_dir = self._direct(lamp_xz, keys[2], x[None], nx[None], max(4, self.n_s))
        e_sum, e_k = e_dir, e_dir
        for _ in range(1, self.bounces):
            e_k = weight * ((rho * e_k) @ f_ss)
            e_sum = e_sum + e_k
        out = (rho * e_sum) @ f_sp
        return weight * out.view(self.n_s, self.t_count).mean(0)

    def dose(self, raw, logits) -> torch.Tensor:
        dt = self.dtype
        wp = (self.lo + (self.hi - self.lo) * torch.sigmoid(raw)).to(dt)
        durs = (self.total_time * torch.softmax(logits, dim=0)).to(dt)
        acc = torch.zeros(self.t_count, dtype=dt, device=self.device)
        for w in range(self.n_way):
            kw = threefry.fold_in(self.key, w)
            keys = threefry.split(kw, 3)
            q, n = self._tri_points(keys[0], self.n_s)
            e = self._direct(wp[w], keys[1], q, n, self.n_s)
            if self.reflectance > 0:
                e = e + self._bounce(wp[w], w)
            acc = acc + durs[w] * e
        return 0.1 * acc

    def loss(self, raw, logits) -> torch.Tensor:
        x = self.dose(raw, logits)[self.mask]
        return self.temperature * torch.logsumexp(-x / self.temperature, dim=0)

    def follow(self, steps: int):
        """(losses, first gradients per leaf, parameters after `steps`) of
        the optimiser's first steps from its start."""
        params = [self.raw0.clone().to(self.dtype).requires_grad_(True),
                  self.logits0.clone().to(self.dtype).requires_grad_(True)]
        state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
        losses, first = [], None
        for i in range(steps):
            loss = self.loss(*params)
            grads = torch.autograd.grad(loss, params)
            if first is None:
                first = [g.detach().float().clone() for g in grads]
            with torch.no_grad():
                for p, g, (mu, nu) in zip(params, grads, state):
                    mu.copy_((1 - B1) * g + B1 * mu)
                    nu.copy_((1 - B2) * (g * g) + B2 * nu)
                    c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(i + 1)) for b in (B1, B2))
                    p.add_(-self.lr * ((mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS)))
            losses.append(float(loss.detach()))
            self.work_every = 0  # the work sample is the first forward's
        return losses, first, [p.detach().float().clone() for p in params]
