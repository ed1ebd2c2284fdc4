"""Device milliseconds an optimizer step outside B2: every device operation
of the traced slice but the split trace kernel's, per step."""

from benchmarks.harness.readers import outside_b2_ms as read  # noqa: F401
