"""Timing and progress reporting (uvtrace/utils/timing.py).

Replaces the reference's chrono Timer (template/precomp.h:277-288) and the
per-iteration stdout line "Progress: X% photon count: N delta time: ... total
time: ..." (myapp.cpp:166-169). On a CUDA device both fence with
torch.cuda.synchronize() before they read the clock, so a reading covers the
work queued before it. `device_trace` records a torch.profiler trace.

The program's spans and counters (`span`, `count`): every layer of the port
opens a span where its work starts (the route loop, the launch layer, the
diff layer, each kernel launch, the set-up) and counts its work where it is
done (a kernel launch, a compilation, a collective). Spans record only while
tracing is on: while a torch.profiler records (each span is then also a
`record_function` range of the same name, so the profiler's trace carries
the program's layers over the device's timeline, and the profiler times
their kernels) or inside `tracing()`. Off, a span is one flag check and
records nothing; set-up spans (`setup_span`, a handful a process) record
always. Counters always count. Only the launch layer's coherence sorts
(`launch.sort`, a few an iteration) and the texel dose maps
(`shade.texel_map`, a few a texel run) take two CUDA events for their device
interval; no other span adds a call on the device's stream.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


MAX_SPANS = 1 << 20  # spans held in memory; later ones are counted in `spans.dropped`


class SpanRecord(NamedTuple):
    """A closed span: its id (its place in the recorder), name, the id of
    its parent (the innermost span open in the process when it opened, on
    any thread: the autograd engine runs a CUDA backward on a thread of its
    own while the caller waits), the id of its unit (the iteration or
    optimizer step it lies in, shared by all its spans), its host interval
    on `time.perf_counter_ns()`, its attributes, and for a span given a CUDA
    device the milliseconds between its two events on that device's current
    stream: the device's work inside the span, and its idle there."""

    id: int
    name: str
    parent: Optional[int]
    unit: Optional[int]
    start_ns: int
    end_ns: int
    attrs: dict
    device_ms: Optional[float]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Span:
    """An open span, the context manager that `span` gives while tracing."""

    __slots__ = ("recorder", "name", "id", "attrs", "_device", "_new_unit", "_epoch", "_stream", "_start", "_range")

    def __init__(self, recorder: "Recorder", name: str, device, new_unit: bool, attrs: dict):
        self.recorder, self.name, self.attrs = recorder, name, attrs
        self._device, self._new_unit = device, new_unit
        self.id = self._epoch = self._stream = self._start = self._range = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self.recorder._open_span(self)
        return self

    def __exit__(self, *exc) -> None:
        self.recorder._close_span(self)


class _Off:
    """The span of a disabled recorder: nothing recorded."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


class Recorder:
    """Spans and counters of one process (`RECORDER`; the module functions
    below are its methods). Closed spans are kept as columns of plain
    values, so that a long trace adds no objects for the garbage collector
    to walk but the timed spans' events."""

    def __init__(self):
        self.max_spans = MAX_SPANS
        self.tracing_depth = 0
        self._lock = threading.Lock()
        self._counters: collections.defaultdict[str, int] = collections.defaultdict(int)
        self._epoch = 0
        self._clear()

    def _clear(self) -> None:
        self._names: list[str] = []
        self._parents: list = []
        self._units: list = []
        self._starts: list[int] = []
        self._ends: list = []
        self._attrs: list[dict] = []
        self._events: dict = {}  # span id -> (start, end) events, until read
        self._device_ms: dict = {}  # span id -> ms, once read
        self._open: list[int] = []  # ids, process-wide, innermost last
        self._unit_ids = itertools.count()
        self._epoch += 1

    # ------------------------------------------------------------- counters

    def count(self, name: str, n: int = 1) -> None:
        """Add n to the counter `name`."""
        self._counters[name] += n

    def counters(self) -> collections.Counter:
        """A copy of every counter (one never counted reads 0)."""
        return collections.Counter(self._counters)

    # ---------------------------------------------------------------- spans

    def enabled(self) -> bool:
        """Whether spans record: inside `tracing()` or while a torch.profiler records."""
        return bool(self.tracing_depth or _autograd_profiler._is_profiler_enabled)

    def span(self, name: str, device=None, unit: bool = False, **attrs):
        """A context manager that records the span `name` with `attrs` while
        tracing is on (off: one flag check, no event, no allocation of its
        own, no device operation). device: a CUDA device on whose current
        stream two events time the span's device interval (the launch
        layer's sorts; a profiler times every kernel without them); unit:
        the span starts a new unit (an iteration, an optimizer step)."""
        if not (self.tracing_depth or _autograd_profiler._is_profiler_enabled):
            return _OFF
        return self._new(name, device, unit, attrs)

    def setup_span(self, name: str, **attrs):
        """A set-up span (`setup.*`): recorded whether tracing is on or not."""
        return self._new(name, None, False, attrs)

    def _new(self, name, device, unit, attrs):
        if len(self._names) >= self.max_spans:
            self.count("spans.dropped")
            return _OFF
        if device is not None and device.type != "cuda":
            device = None
        return Span(self, name, device, unit, attrs)

    def _open_span(self, s: Span) -> None:
        with self._lock:
            parent = self._open[-1] if self._open else None
            s.id, s._epoch = len(self._names), self._epoch
            self._names.append(s.name)
            self._parents.append(parent)
            unit = next(self._unit_ids) if s._new_unit else None if parent is None else self._units[parent]
            self._units.append(unit)
            self._starts.append(0)
            self._ends.append(None)
            self._attrs.append(s.attrs)
            self._open.append(s.id)
        if _autograd_profiler._is_profiler_enabled:
            s._range = torch.autograd.profiler.record_function(s.name)
            s._range.__enter__()
        if s._device is not None:
            s._stream = torch.cuda.current_stream(s._device)
            s._start = torch.cuda.Event(enable_timing=True)
            s._start.record(s._stream)
        self._starts[s.id] = time.perf_counter_ns()

    def _close_span(self, s: Span) -> None:
        end_ns = time.perf_counter_ns()
        if s._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(s._stream)
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None
        with self._lock:
            if s._epoch != self._epoch:  # opened before a reset
                return
            self._ends[s.id] = end_ns
            if s._start is not None:
                self._events[s.id] = (s._start, end)
            if self._open and self._open[-1] == s.id:
                self._open.pop()
            elif s.id in self._open:
                self._open.remove(s.id)

    def spans(self) -> list[SpanRecord]:
        """The closed spans, in the order they opened, with the device
        interval of each timed one read (a wait for its end event)."""
        with self._lock:
            for i, (start, end) in list(self._events.items()):
                end.synchronize()
                self._device_ms[i] = start.elapsed_time(end)
                del self._events[i]
            return [SpanRecord(i, self._names[i], self._parents[i], self._units[i], self._starts[i], end,
                               self._attrs[i], self._device_ms.get(i))
                    for i, end in enumerate(self._ends) if end is not None]

    @contextlib.contextmanager
    def tracing(self):
        """Record spans inside the block, with or without a profiler."""
        self.tracing_depth += 1
        try:
            yield self
        finally:
            self.tracing_depth -= 1

    def reset(self) -> None:
        """Forget every span and counter."""
        with self._lock:
            self._clear()
            self._counters.clear()


RECORDER = Recorder()
span, setup_span, count, counters, spans, tracing, reset = (
    RECORDER.span, RECORDER.setup_span, RECORDER.count, RECORDER.counters, RECORDER.spans, RECORDER.tracing,
    RECORDER.reset)
