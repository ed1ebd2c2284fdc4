"""Host milliseconds an optimizer step, the wait for its loss left out: the
mean over the traced slice's `opt.step` spans of each one's duration less
that of its `opt.loss_read` (the host's enqueue of the forward, the
backward and Adam; Python with the device running behind it). A route's
first step is left out: it is enqueued behind the route's set-up, whose
launches (with reflectance the transfer plan's, about 0.8 s of device work)
fill the launch queue, so its enqueue waits for the device."""

from benchmarks.harness.spans import in_record, ms


def read(run):
    spans = in_record(run)
    steps = [] if spans is None else [s for s in spans if s.name == "opt.step" and s.attrs.get("step") != 0]
    if not steps:
        return None
    wait = {}
    for s in spans:
        if s.name == "opt.loss_read":
            wait[s.parent] = wait.get(s.parent, 0.0) + ms(s)
    return sum(ms(s) - wait.get(s.id, 0.0) for s in steps) / len(steps)
