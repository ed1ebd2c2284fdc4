"""Device operations (kernels, copies, fills) of the traced slice per
iteration."""

from benchmarks.harness.readers import launches_per_item as read  # noqa: F401
