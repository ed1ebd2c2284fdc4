"""Host milliseconds a texel run spends on its top-down probe grid: the
traced slice's `sim.dose_grid` spans (the probes, the texel lookup and the
image's read-back to the host: the grid's wall time), over the slice's
whole runs. None where the program has no such span."""

from benchmarks.harness.spans import in_record, ms


def read(run):
    spans = in_record(run)
    grids = [] if spans is None else [s for s in spans if s.name == "sim.dose_grid"]
    return sum(ms(s) for s in grids) / run.record["runs"] if grids else None
