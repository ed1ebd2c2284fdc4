"""What the metrics that read the program's own spans share: the spans of
the port's recorder (uvtrace_torch/utils/timing.py) that lie inside the
first traced pass's record, on the host clock both use (perf_counter).

The first traced pass records the device alone; the profiler's recording
turns the program's spans on, and the launch layer's sorts carry their
device interval, from two CUDA events (no other span takes events). Spans of the second pass (host and
device) lie after the record's end and are left out. A program without the
recorder, or a run without spans, gives None: its metrics are left out of
the result line.
"""

from __future__ import annotations


def recorded():
    """Every closed span of the process, or None where the program has no
    recorder."""
    from uvtrace_torch.utils import timing

    recorder = getattr(timing, "RECORDER", None)
    return None if recorder is None else recorder.spans()


def in_record(run):
    """The spans inside the traced record, or None (no traced record, no
    recorder, or no span in it)."""
    if not run.trace or run.record is None:
        return None
    spans = recorded()
    if not spans:
        return None
    t0, t1 = run.record["start"] * 1e9, run.record["end"] * 1e9
    inside = [s for s in spans if s.start_ns >= t0 and s.end_ns <= t1]
    return inside or None


def units(spans, name: str) -> dict:
    """{unit id: span} of the spans `name` that start a unit (sim.iteration,
    opt.step)."""
    return {s.unit: s for s in spans if s.name == name and s.unit is not None}


def ms(s) -> float:
    return (s.end_ns - s.start_ns) * 1e-6
