"""The metrics that read the program's own spans (metrics/host_ms.py,
b2_rays_per_step.py, sort_interval_ms.py, build_s.py, through harness/spans.py): on
runs assembled by hand, spans outside the traced record are left out, a run
without spans or a program without the recorder gives None; then one traced
run of a cell at a CPU's size."""

import types

import pytest

from benchmarks.harness import core
from benchmarks.harness import spans as spans_io

READERS = ("host_ms", "b2_rays_per_step", "sort_interval_ms", "build_s")


def _reader(name):
    """A metric file's read, loaded as the harness loads it."""
    return core._load_metric(name)


MS = 1_000_000  # ns


def _span(i, name, start_ms, end_ms, parent=None, unit=None, device_ms=None, **attrs):
    return types.SimpleNamespace(id=i, name=name, parent=parent, unit=unit, start_ns=int(start_ms * MS),
                                 end_ns=int(end_ms * MS), attrs=attrs, device_ms=device_ms)


def _run(start_ms=1000.0, end_ms=2000.0, trace=True):
    return types.SimpleNamespace(trace=trace, record={"start": start_ms * 1e-3, "end": end_ms * 1e-3})


@pytest.fixture
def given(monkeypatch):
    """given(spans): the recorder's spans are these."""
    def use(spans):
        monkeypatch.setattr(spans_io, "recorded", lambda: spans)
    return use


def _steps(first_id, start_ms, wait_ms, b2_rays):
    """An optimizer step of 20 ms from start_ms, its unit its first id: a
    forward with two B2 launches, a backward, Adam and a loss read of
    wait_ms."""
    i, u = first_id, first_id
    return [
        _span(i, "opt.step", start_ms, start_ms + 20, parent=0, unit=u, step=i),
        _span(i + 1, "diff.forward", start_ms, start_ms + 10, parent=i, unit=u),
        _span(i + 2, "kernel.traverse_mxu_launch", start_ms + 1, start_ms + 2, parent=i + 1, unit=u,
              rays=b2_rays),
        _span(i + 3, "kernel.traverse_mxu_launch", start_ms + 3, start_ms + 4, parent=i + 1, unit=u,
              rays=b2_rays),
        _span(i + 4, "diff.backward", start_ms + 10, start_ms + 15, parent=i, unit=u),
        _span(i + 5, "opt.adam", start_ms + 15, start_ms + 16, parent=i, unit=u),
        _span(i + 6, "opt.loss_read", start_ms + 20 - wait_ms, start_ms + 20, parent=i, unit=u),
    ]


def _route():
    """A route whose first two steps lie in the record (1000-2000 ms) and
    whose third starts before its end and ends after it."""
    route = _span(0, "opt.route", 990, 2100, steps=3)
    return [route, *_steps(1, 1010, 2.0, 1 << 20), *_steps(8, 1040, 4.0, 1 << 20), *_steps(15, 1990, 1.0, 1 << 30)]


def test_host_ms_is_each_step_less_its_loss_read(given):
    given(_route())
    assert _reader("host_ms")(_run()) == pytest.approx(((20 - 2) + (20 - 4)) / 2)


def test_host_ms_leaves_out_a_routes_first_step(given):
    """A route's first step waits, inside its enqueue, for the device work
    of the route's set-up (the transfer plan): it is not the host's."""
    first = _steps(40, 1000, 2.0, 1 << 20)
    first[0].attrs["step"] = 0
    first[0].end_ns += 500 * MS  # its enqueue stalled behind the plan
    given([*first, *_steps(1, 1600, 2.0, 1 << 20), *_steps(8, 1640, 4.0, 1 << 20)])
    assert _reader("host_ms")(_run()) == pytest.approx(((20 - 2) + (20 - 4)) / 2)
    given(first)
    assert _reader("host_ms")(_run()) is None


def test_b2_rays_per_step_counts_the_steps_rays(given):
    spans = _route()
    # a B2 launch outside any step (the route's final evaluation) is not a step's
    spans.append(_span(30, "kernel.traverse_mxu_launch", 1100, 1101, parent=0, unit=None, rays=1 << 30))
    given(spans)
    assert _reader("b2_rays_per_step")(_run()) == pytest.approx(2 * (1 << 20) / 1e6)


def _iterations():
    out = []
    for k, t in enumerate((1010.0, 1400.0, 2500.0)):  # the third lies past the record's end
        i = 10 * k
        out += [_span(i, "sim.iteration", t, t + 300, unit=i, iteration=k),
                _span(i + 1, "sim.lamp", t, t + 290, parent=i, unit=i),
                _span(i + 2, "launch.chunk", t, t + 100, parent=i + 1, unit=i, g=0),
                _span(i + 3, "launch.bounce", t, t + 50, parent=i + 2, unit=i, b=0),
                _span(i + 4, "launch.sort", t + 1, t + 2, parent=i + 3, unit=i, device_ms=3.0),
                _span(i + 5, "launch.sort", t + 60, t + 61, parent=i + 2, unit=i, device_ms=5.0)]
    return out


def test_sort_interval_ms_is_the_sorts_device_interval_an_iteration(given):
    given(_iterations())
    assert _reader("sort_interval_ms")(_run()) == pytest.approx(8.0)


def test_sort_interval_ms_needs_the_device_interval(given):
    spans = _iterations()
    for s in spans:
        s.device_ms = None  # a run on the CPU: no events
    given(spans)
    assert _reader("sort_interval_ms")(_run()) is None


def test_build_s_sums_both_libraries_whatever_the_window(given):
    given([_span(0, "setup.native_library", 5, 305, built=False), _span(1, "setup.clusters", 305, 900),
           _span(2, "setup.kernel_library", 1500, 1700, built=True), *_route()])
    assert _reader("build_s")(_run(start_ms=5000, end_ms=6000)) == pytest.approx(0.5)
    given([_span(0, "setup.clusters", 305, 900)])
    assert _reader("build_s")(_run()) is None


@pytest.mark.parametrize("reader", READERS[:3])
def test_no_spans_in_the_record_read_none(given, reader):
    read = _reader(reader)
    given(_route() + _iterations())
    assert read(_run(start_ms=5000, end_ms=6000)) is None  # every span outside the record
    assert read(_run(trace=False)) is None  # a window, not a traced slice
    given([])
    assert read(_run()) is None
    given(None)  # a program without the recorder
    assert read(_run()) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    """A program whose timing module has no RECORDER (one older than the
    recorder): every reader gives None without raising."""
    from uvtrace_torch.utils import timing

    monkeypatch.delattr(timing, "RECORDER")
    assert spans_io.recorded() is None
    for reader in READERS:
        assert _reader(reader)(_run()) is None


def test_a_traced_run_reports_the_host_ms_of_its_steps(small_run):
    """routeopt.direct traced on the CPU at a CPU's size: the profiler's
    passes turn the program's spans on; host_ms.direct reads the first
    pass's steps, and build_s the native library's set-up."""
    from uvtrace_torch.bvh import native
    from uvtrace_torch.utils import timing

    native._load.cache_clear()  # loaded again, and its set-up span recorded, in the run's set-up
    first = len(timing.spans())  # a span's id is its place in the recorder
    out = core.execute(small_run("routeopt.direct", trace=True))
    assert out["correct"]
    steps = [s for s in timing.spans() if s.name == "opt.step" and s.id >= first]
    assert len(steps) == 2 * 4  # both passes of the 4-step slice
    host = out["metrics"]["host_ms.direct"]
    assert host["unit"] == "ms/step" and host["value"] > 0
    assert "build_s" in out["metrics"]
