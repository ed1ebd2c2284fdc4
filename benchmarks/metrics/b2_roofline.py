"""B2 (csrc/traverse_mxu.cu) over the traced slice, against the work its
rays need (rooflines/work.py): the dose's primaries and bounce segments, or
the route planner's shadow rays."""

from benchmarks.harness.readers import B2, roofline


def read(run):
    return roofline(run, B2)
