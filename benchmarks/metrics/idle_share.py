"""Percent of the traced slice in which no device operation ran:
1 - (union of the device intervals) / span, from the one trace."""

from benchmarks.harness.readers import idle_share as read  # noqa: F401
