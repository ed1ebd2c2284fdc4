"""Device operations (kernels, copies, fills) of the traced slice per
optimizer step."""

from benchmarks.harness.readers import launches_per_item as read  # noqa: F401
