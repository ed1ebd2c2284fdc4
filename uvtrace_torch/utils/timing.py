"""Timing and progress reporting (uvtrace/utils/timing.py).

Replaces the reference's chrono Timer (template/precomp.h:277-288) and the
per-iteration stdout line "Progress: X% photon count: N delta time: ... total
time: ..." (myapp.cpp:166-169). On a CUDA device both fence with
torch.cuda.synchronize() before they read the clock, so a reading covers the
work queued before it. `device_trace` records a torch.profiler trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _fence(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """High-resolution elapsed-seconds timer (Timer, template/precomp.h:277).
    device: the torch device whose queued work a reading waits for (None:
    the host clock alone)."""

    def __init__(self, device=None):
        self.device = device
        self.reset()

    def reset(self):
        _fence(self.device)
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        _fence(self.device)
        return time.perf_counter() - self._start


class ProgressReporter:
    """Per-iteration progress in the reference's format."""

    def __init__(self, total_iterations: int, log=print, device=None):
        self.total = max(1, total_iterations)
        self.log = log
        self.timer = Timer(device)
        self.last = 0.0
        self.photons = 0

    def update(self, iteration: int, photons: int):
        now = self.timer.elapsed()
        delta = now - self.last
        self.last = now
        self.photons = photons
        pct = 100.0 * iteration / self.total
        self.log(
            f"Progress: {pct:.0f}% photon count: {photons} "
            f"delta time: {delta * 1e3:.0f}ms total time: {now * 1e3:.0f}ms "
            f"({photons / max(now, 1e-9) / 1e6:.2f} Mrays/s)"
        )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the block (host and, with a card, the
    CUDA kernels) and write it as a Chrome trace, log_dir/trace.json
    (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
