"""The 95th percentile of the window's iterations, each from its start until
its dose map is ready on the device (linear between order statistics)."""

from benchmarks.harness.readers import iter_p95_ms as read  # noqa: F401
