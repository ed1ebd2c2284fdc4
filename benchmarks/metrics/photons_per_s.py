"""Photons the window's iterations traced into the dose map, over the whole
window (its start to the end of its last iteration)."""

from benchmarks.harness.readers import photons_per_s as read  # noqa: F401
