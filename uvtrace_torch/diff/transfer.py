"""A route's transfer plan: what the interreflection term of every waypoint
computes from the scene and the keys alone, traced once a route.

`route_dose` draws waypoint w's term from fold_in(fold_in(key, w), 1): its
sources (K11, from the area CDF), its M x M source-to-source matrix
F V (1 - I) and its receivers (a point on every triangle a sample, drawn in
K12) depend on that key and the geometry, not on the lamp, and so does the
visibility of every shadow ray between them. An optimizer that draws every
step from one key (common random numbers) traces the same rays each step.
`plan_route_transfer` runs the term's unplanned path once a waypoint (K11,
K12, the sort, K7, B2 and K13 for the matrix and every chunk of receivers)
and keeps its sources, its matrix and the chunks' visibility bytes (one a
ray, padded chunks included); `route_dose(transfer=...)` reads them and
traces only the rays that see the lamp (`_points_direct`). The result is
the unplanned one bit for bit: K13's kept-visibility mode sums in the
traced mode's order.

A plan names what it was built from: the scene, the key's words, the
waypoint count, the areas' digest and n_samples, n_sources, n_bounces.
`check` raises ValueError on any other input. The receivers go in chunks
of `SOURCE_CHUNK` sources, as `route_dose` takes them. Nothing keeps a plan
but its caller (`optimize_route` holds one for a call).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from uvtrace_torch.diff.bounce import receiver_visibility, transfer_matrix
from uvtrace_torch.diff.estimator import SOURCE_CHUNK, DiffScene, areas_digest, source_points
from uvtrace_torch.ops import rng
from uvtrace_torch.utils.timing import count


class WaypointTransfer(NamedTuple):
    """One waypoint's lamp-independent interreflection work."""

    src: torch.Tensor  # i64[M] source triangles (K11)
    x_m: torch.Tensor  # f32[M,3] source points
    n_m: torch.Tensor  # f32[M,3] source normals
    w: float  # the sources' weight, area total / M
    f_ss: Optional[torch.Tensor]  # f32[M,M] F V (1 - I); None for one bounce
    vis: tuple  # u8[chunk * P] the receivers' visibility of each chunk of sources


class RouteTransfer(NamedTuple):
    """The `WaypointTransfer` of every waypoint of a route, and what they
    were built from."""

    scene: DiffScene
    key: tuple  # the route key's two words
    n_waypoints: int
    areas: str  # the areas' digest
    n_samples: int
    n_sources: int
    n_bounces: int
    waypoints: tuple  # WaypointTransfer a waypoint

    def check(self, scene, key, n_waypoints: int, areas, *, n_samples: int, n_sources: int, n_bounces: int) -> None:
        """Raise ValueError unless the plan was built from these inputs."""
        if scene is not self.scene:
            raise ValueError("the transfer plan was built for another scene")
        given = dict(key=_words(key), n_waypoints=int(n_waypoints), areas=areas_digest(areas)[1],
                     n_samples=n_samples, n_sources=n_sources, n_bounces=n_bounces)
        for name, value in given.items():
            if getattr(self, name) != value:
                raise ValueError(f"the transfer plan was built for {name}={getattr(self, name)!r}, not {value!r}")


def _words(key) -> tuple:
    return tuple(int(x) & 0xFFFFFFFF for x in key)


def plan_route_transfer(scene: DiffScene, key, n_waypoints: int, areas, *, n_samples: int, n_sources: int = 64,
                        n_bounces: int = 1) -> RouteTransfer:
    """The transfer plan of a route of n_waypoints drawn from key, as
    `route_dose` with these sizes draws it (the counter
    `diff.transfer.built`)."""
    tri = (scene.v0, scene.e1, scene.e2, scene.normal)
    waypoints = []
    with torch.no_grad():
        for w in range(n_waypoints):
            keys = rng.split(rng.fold_in(rng.fold_in(key, w), 1), 4)  # route_dose's term key, bounce_irradiance's split
            src, x_m, n_m, wgt = source_points(scene, areas, keys, n_sources)
            f_ss = transfer_matrix(scene, x_m, n_m) if n_bounces > 1 else None
            vis = receiver_visibility(scene, (x_m, n_m), keys[3], n_samples, tri, SOURCE_CHUNK)
            waypoints.append(WaypointTransfer(src, x_m, n_m, wgt, f_ss, vis))
    count("diff.transfer.built")
    return RouteTransfer(scene, _words(key), int(n_waypoints), areas_digest(areas)[1], n_samples, n_sources,
                         n_bounces, tuple(waypoints))
