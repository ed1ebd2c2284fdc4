"""The whole window over the optimizer steps completed in it (each route's
own set-up and final evaluation lie in the window and in no step)."""

from benchmarks.harness.readers import step_ms as read  # noqa: F401
