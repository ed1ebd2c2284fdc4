"""The planner's wait a step, over whole routes: the window's start to the
end of the last route that ended in it, over the steps of those routes
(each route's own set-up, transfer plan and final evaluation lie in that
time and in no step; the steps of the route the window stops in are not
counted)."""

from benchmarks.harness.readers import step_ms as read  # noqa: F401
