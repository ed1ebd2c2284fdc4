"""The traced slice: torch.profiler over a fixed slice of work, read into
device intervals, their union, the slice's span, and a breakdown.

The slice is traced twice. The first pass records the device alone (the
host's per-operation recording would stretch a host-bound step): busy_s is
the union of its device operations' intervals, window_s the host clock's
span of the slice, from a synchronize before it to one after it; the idle
share is 1 - busy / span. The second pass records the host too, inside the
range `bench.traced_slice`, and names the device's longest idle gaps by the
innermost host range around their middle (its gaps are those of a slice
slowed by that recording).
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import numpy as np

SPAN = "bench.traced_slice"
NAMED_GAPS = 256  # idle gaps named by what the host did; shorter ones are summed


def _device_events(events, torch):
    """Kernels, copies and fills: the device rows of the trace but the
    ranges that record_function mirrors onto the device's timeline."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.name != SPAN
            and not getattr(e, "is_user_annotation", False) and e.time_range.end > e.time_range.start]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameter list."""
    name = re.sub(r"^void ", "", name)
    name = re.sub(r"\(anonymous namespace\)::|at::native::|\(.*$", "", name)
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out)[:96]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]


def read(events, torch, window_s: float) -> dict:
    """{kernels: [(name, start_us, end_us)], busy_s, window_s, breakdown}
    of the device-only pass."""
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in _device_events(events, torch)]
    by_name = defaultdict(float)
    for name, a, b in dev:
        by_name[short_name(name)] += (b - a) * 1e-6
    busy = _union([[a, b] for _, a, b in dev])
    return {"kernels": dev, "busy_s": sum(b - a for a, b in busy) * 1e-6, "window_s": window_s,
            "breakdown": {"device_ops": _top(by_name), "idle_gaps": []}}


def idle_gaps(events, torch) -> list:
    """[[what the host did, seconds]] of the device's idle gaps inside the
    range SPAN of a pass that recorded the host."""
    spans = [e for e in events if e.name == SPAN and e.device_type != torch.autograd.DeviceType.CUDA]
    if not spans:
        return []
    s0, s1 = spans[0].time_range.start, spans[0].time_range.end
    dev = [(max(s0, e.time_range.start), min(s1, e.time_range.end)) for e in _device_events(events, torch)]
    busy = _union([[a, b] for a, b in dev if b > a])
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA and e.name != SPAN
            and not e.name.startswith("Activity Buffer")]
    h0 = np.array([e.time_range.start for e in host] or [0.0])
    h1 = np.array([e.time_range.end for e in host] or [-1.0])
    edges = [s0] + [x for iv in busy for x in iv] + [s1]
    idle = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a), reverse=True)
    gaps = defaultdict(float)
    for rank, (length, a, b) in enumerate(idle):
        what = f"gaps under {idle[NAMED_GAPS][0]:.0f} us" if rank >= NAMED_GAPS else "host"
        if rank < NAMED_GAPS:
            mid = 0.5 * (a + b)
            inside = np.nonzero((h0 <= mid) & (h1 >= mid))[0]
            if inside.size:
                what = host[inside[np.argmin(h1[inside] - h0[inside])]].name
        gaps[what] += length * 1e-6
    return _top(gaps)


def traced(work, device: str):
    """(record, reading) of `work()` traced: the record and the device
    numbers of the first pass, the idle gaps' names of the second."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        record = work()
        sync()
        t1 = time.perf_counter()
    reading = read(prof.events(), torch, t1 - t0)
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with record_function(SPAN):
            work()
            sync()
    reading["breakdown"]["idle_gaps"] = idle_gaps(prof.events(), torch)
    return record, reading


def device_time_s(profile: dict, names) -> float:
    """Seconds of device operations whose name holds one of `names`."""
    return sum(b - a for n, a, b in profile["kernels"] if any(k in n for k in names)) * 1e-6


def launches(profile: dict) -> int:
    return len(profile["kernels"])
