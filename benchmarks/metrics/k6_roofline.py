"""K6 (csrc/launch_ops.cu `texel_bin_kernel`) over the traced slice,
against the bytes its hits need (rooflines/texel.py)."""

from benchmarks.rooflines.texel import roofline


def read(run):
    return roofline(run) if run.trace else None
