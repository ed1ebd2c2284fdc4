"""Gradient-based route optimization (uvtrace/diff/optimize.py; BASELINE
config 4: "gradient descent on route waypoints to maximize min surface
dose").

The objective is a soft minimum of the cumulative dose over the target
triangles. The parameters are the waypoints' floor positions (through a
sigmoid into `bounds` when given) and, optionally, the dwell durations
(through a softmax to a fixed total time). Adam is written out in optax's
order (`_adam_step`), so a few steps stay within float rounding of
`optax.adam`; `torch.optim.Adam` adds eps after a differently rounded
square root.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from uvtrace_torch.diff.estimator import DiffScene, route_dose
from uvtrace_torch.diff.transfer import plan_route_transfer
from uvtrace_torch.ops import rng
from uvtrace_torch.utils.timing import span

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def softmin(x, temperature):
    """-T logsumexp(-x / T) over all of x: a smooth minimum."""
    return -temperature * torch.logsumexp((-x / temperature).reshape(-1), dim=0)


@dataclasses.dataclass
class RouteOptResult:
    waypoints_xz: np.ndarray
    durations: np.ndarray
    history: list
    final_min_dose: float
    # the estimator's dose over the target mask (real scans have unreachable
    # triangles that pin the raw minimum at 0; percentiles carry the signal)
    final_dose_masked: np.ndarray = None


def _adam_step(param, grad, state, step: int, learning_rate: float):
    """One Adam update of `param` in place, in optax.scale_by_adam's order:
    mu, then nu, then the bias corrections 1 - b**count in f32, then
    mu_hat / (sqrt(nu_hat) + eps), times -learning_rate, added."""
    mu, nu = state
    mu.copy_((1 - B1) * grad + B1 * mu)
    nu.copy_((1 - B2) * (grad * grad) + B2 * nu)
    c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(step)) for b in (B1, B2))
    update = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
    param.add_(-learning_rate * update)


def optimize_route(scene: DiffScene, init_waypoints_xz, init_durations, rod_base_y: float, rod_length: float,
                   power: float, *, steps: int = 100, learning_rate: float = 0.05, temperature: float = 5.0,
                   n_samples: int = 4, optimize_durations: bool = True, target_mask=None,
                   bounds: Optional[tuple] = None, seed: int = 0, progress: Optional[Callable] = None,
                   reflectance=None, areas=None, n_sources: int = 64, n_bounces: int = 1) -> RouteOptResult:
    """Maximize the (soft) minimum dose over the target triangles.

    target_mask: optional bool[T] restricting the objective (default: every
    triangle of nonzero area). bounds: optional ((xmin, zmin), (xmax,
    zmax)) box for the waypoints. reflectance (f32[T] or a scalar, needs
    `areas` = mesh.areas) adds the interreflection terms of `route_dose`
    (n_sources, n_bounces). optimize_durations=False freezes the durations:
    their update is zero, as optax.set_to_zero gives it. Every step draws
    from PRNGKey(seed): common random numbers. So with reflectance every
    step and the final evaluation see the same sources and receivers: their
    rays are traced once, into a transfer plan (diff/transfer.py) that this
    call holds and every evaluation reads.

    Traced as the span `opt.route`: `opt.transfer`, the plan (with
    reflectance only), then a unit `opt.step` a step (`diff.forward`,
    `diff.backward`, `opt.adam`, then `opt.loss_read`, the wait for the
    loss), then `opt.final`, the final evaluation."""
    dev = scene.v0.device
    f32 = dict(dtype=torch.float32, device=dev)
    t_count = scene.v0.shape[0]
    if reflectance is not None:
        if areas is None:
            raise ValueError("optimize_route(reflectance=...) needs areas=mesh.areas")
        reflectance = torch.as_tensor(reflectance, **f32).expand(t_count)
    wp = torch.as_tensor(np.asarray(init_waypoints_xz, np.float32), **f32).clone()
    lo = hi = None
    if bounds is not None:
        # the objective maps the raw parameters through lo + (hi - lo) sigmoid,
        # so the raw start is the inverse (logit) of the requested waypoints
        lo, hi = torch.tensor(bounds[0], **f32), torch.tensor(bounds[1], **f32)
        frac = torch.clamp((wp - lo) / torch.clamp_min(hi - lo, 1e-9), 1e-4, 1 - 1e-4)
        wp = torch.log(frac) - torch.log1p(-frac)
    total_time = float(np.sum(init_durations))
    logits = torch.log(torch.as_tensor(np.asarray(init_durations, np.float32), **f32) / total_time)
    if target_mask is not None:
        mask = torch.as_tensor(np.asarray(target_mask), device=dev)
    else:
        # every non-degenerate triangle: zero-area pads would pin the softmin at 0
        c = torch.cross(scene.e1, scene.e2, dim=-1)
        mask = torch.sqrt((c * c).sum(-1)) > 0
    key = rng.PRNGKey(seed)
    kw = dict(n_samples=n_samples, reflectance=reflectance, areas=areas, n_sources=n_sources,
              n_bounces=n_bounces)

    def waypoints_of(raw):
        return raw if bounds is None else lo + (hi - lo) * torch.sigmoid(raw)

    def durations_of(lg):
        return total_time * torch.softmax(lg, dim=0)

    def objective(raw, lg):
        dose = route_dose(scene, waypoints_of(raw), durations_of(lg), rod_base_y, rod_length, power, key, **kw)
        return -softmin(dose[mask], temperature)

    params = [wp.requires_grad_(True), logits.requires_grad_(True)]
    opt_state = [(torch.zeros_like(p), torch.zeros_like(p)) for p in params]
    history = []
    with span("opt.route", steps=steps):
        if reflectance is not None:
            with span("opt.transfer"):
                kw["transfer"] = plan_route_transfer(scene, key, wp.shape[0], areas, n_samples=n_samples,
                                                     n_sources=n_sources, n_bounces=n_bounces)
        for i in range(steps):
            # a step ends once its loss is on the host, before the caller's callback
            with span("opt.step", unit=True, step=i):
                with span("diff.forward"):
                    loss = objective(*params)
                with span("diff.backward"):
                    grads = torch.autograd.grad(loss, params)
                with span("opt.adam"), torch.no_grad():
                    for j, (p, g) in enumerate(zip(params, grads)):
                        if j == 1 and not optimize_durations:
                            continue  # frozen: a zero update
                        _adam_step(p, g, opt_state[j], i + 1, learning_rate)
                with span("opt.loss_read"):  # the wait for the device
                    history.append(loss.item())
            if progress:
                progress(i, history[-1])
        with span("opt.final"), torch.no_grad():
            wp, durations = waypoints_of(params[0]).detach(), durations_of(params[1])
            final_dose = route_dose(scene, wp, durations, rod_base_y, rod_length, power, key, **kw)[mask]
            result = RouteOptResult(
                waypoints_xz=wp.cpu().numpy(),
                durations=durations.cpu().numpy(),
                history=history,
                final_min_dose=float(final_dose.min()),
                final_dose_masked=final_dose.cpu().numpy(),
            )
    return result
