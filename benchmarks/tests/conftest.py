"""The harness's CPU tests: python3 -m pytest benchmarks/tests from the
root of the repository. A test that needs the card carries the `cuda`
marker and skips itself without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope="session")
def box_glb(tmp_path_factory):
    """A 252-triangle box room with clutter as a binary glTF."""
    from uvtrace_torch.geometry.procedural import make_box_room
    from uvtrace_torch.io.gltf_export import export_glb

    path = tmp_path_factory.mktemp("scene") / "box.glb"
    export_glb(str(path), make_box_room(subdivisions=4, clutter=6).tris)
    return str(path)


# the cells at a CPU's size: the box room, few photons, short routes
SMALL = {
    "dose.route_direct": {"traffic": {"photon_count": 1 << 14},
                          "cell": {"warmup": 1, "sample_first": 2, "trace_units": 3, "work_sample_every": 4}},
    "dose.bounce4": {"traffic": {"photon_count": 1 << 14},
                     "cell": {"warmup": 1, "sample_first": 2, "trace_units": 2, "work_sample_every": 4}},
    "routeopt.bounce2": {"traffic": {"n_sources": 8}, "config": {"steps": 5},
                         "cell": {"warmup_steps": 1, "trace_units": 4, "work_sample_every": 4}},
    "routeopt.direct": {"config": {"steps": 5}, "cell": {"warmup_steps": 1, "trace_units": 4, "work_sample_every": 4}},
}


@pytest.fixture
def small_run(box_glb):
    """small_run(cell, seed, trace=False) -> a harness Run of `cell` on the
    CPU at a CPU's size."""
    import time

    from benchmarks.harness import core

    def make(cell, seed=2 ** 31 + 7, trace=False, seconds=0.5):
        over = {k: dict(v) for k, v in SMALL[cell].items()}
        over.setdefault("config", {})["scene"] = box_glb
        return core.Run(cell, seed, seconds, trace, time.perf_counter(), device="cpu", overrides=over)

    return make
