"""Milliseconds an iteration between the two CUDA events of each of the
launch layer's coherence sorts: the device intervals of the traced slice's
`launch.sort` spans (each a stable sort of the bounce rays' keys and the
gathers of the rays), over the `sim.iteration` spans. An interval on the
stream, not a sum of kernels: it holds the sort's kernels and whatever idle
of the device lies between its two events."""

from benchmarks.harness.spans import in_record, units


def read(run):
    spans = in_record(run)
    iterations = {} if spans is None else units(spans, "sim.iteration")
    sorts = [] if spans is None else [s for s in spans if s.name == "launch.sort" and s.unit in iterations]
    if not iterations or not sorts or any(s.device_ms is None for s in sorts):
        return None
    return sum(s.device_ms for s in sorts) / len(iterations)
