"""Millions of rays an optimizer step hands the split trace kernel B2: the
`rays` of the traced slice's `kernel.traverse_mxu_launch` spans (each
launch's batch, padding included) that lie in an `opt.step`, over the
steps."""

from benchmarks.harness.spans import in_record, units


def read(run):
    spans = in_record(run)
    steps = {} if spans is None else units(spans, "opt.step")
    if not steps:
        return None
    rays = sum(s.attrs["rays"] for s in spans if s.name == "kernel.traverse_mxu_launch" and s.unit in steps)
    return rays / len(steps) / 1e6
