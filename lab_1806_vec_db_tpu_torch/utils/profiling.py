"""Tracing and profiling seams (port of lab_1806_vec_db_tpu/utils/profiling.py).

- `span(name)`: the program's spans, one at each layer boundary of a search
  (PERF.md §3 lists the names).  Off, the default, it returns one shared
  no-op context.  While a `torch.profiler` records, a span enters a
  function-scope `RecordFunction` (`_RecordFunctionFast`), so it lands in
  the profiler's trace as a host range on the calling thread, on the clock
  of the kernels and copies it launched.  Unlike `record_function` (user
  scope), it adds no `gpu_user_annotation` copy of itself to the device's
  events, which a reader of device time would count as work on the card,
  and it costs about an eighth as much.  While a collector is on (`with
  collect() as spans:`), it adds its count, total and self seconds to that
  `Spans`.  Both may be on at once.  A counter is a span's count: the route
  spans (`flat.exact`, `flat.int8`, ...) count the searches of each route;
- a garbage-collector hook, one per process: while spans are on, each full
  (generation 2) collection is the span `py.gc.full`;
- `trace(log_dir)`: a context manager around `torch.profiler` that writes a
  Chrome trace (`trace.json`, viewable in chrome://tracing or Perfetto) of
  every CUDA kernel, copy, host operation and program span in scope;
- `Spans`: named host wall-clock accumulators (the reference bench's
  AvgRecorder), the collector's store: count, total and self seconds;
- `progress_bar(total)`: a stderr progress callback for bulk builds.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the host and, where CUDA is available, the
    device; on exit write `<log_dir>/trace.json` (the device is synchronized
    first, so every kernel launched in the block is in the trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Spans:
    """Named wall-clock accumulators (host clock): count, total seconds and
    self seconds (the total less this `Spans`' child spans on the same
    thread) per name.  `collect()` fills one with the program's spans."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.self_total = defaultdict(float)
        self._lock = threading.Lock()
        self._open = threading.local()  # .stack: this Spans' open spans on the thread, innermost last

    def span(self, name: str) -> "_Span":
        return _Span(name, self, False)

    def add(self, name: str, seconds: float, self_seconds: float) -> None:
        with self._lock:
            self.total[name] += seconds
            self.self_total[name] += self_seconds
            self.count[name] += 1

    def avg(self, name: str) -> float:
        c = self.count[name]
        return self.total[name] / c if c else 0.0

    def report(self) -> str:
        return "\n".join(
            f"{name}: total={self.total[name]:.3f}s n={self.count[name]} avg={self.avg(name)*1000:.2f}ms"
            f" self={self.self_total[name]:.3f}s"
            for name in sorted(self.total))


class _Span:
    """One span instance: enters a profiler range if `record`, and adds to
    `spans` if not None, with its self time kept by that `Spans`' stack on
    the thread."""

    __slots__ = ("name", "spans", "rf", "t0", "inner")

    def __init__(self, name: str, spans: Spans | None, record: bool):
        self.name, self.spans = name, spans
        self.rf = torch._C._profiler._RecordFunctionFast(name) if record else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.spans is not None:
            self.inner = 0.0
            stack = getattr(self.spans._open, "stack", None)
            if stack is None:
                stack = self.spans._open.stack = []
            stack.append(self)
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.spans is not None:
            dur = time.perf_counter() - self.t0
            stack = self.spans._open.stack
            stack.pop()  # `with` blocks nest: this span is the innermost open one
            if stack:
                stack[-1].inner += dur
            self.spans.add(self.name, dur, dur - self.inner)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()
_collector: Spans | None = None  # the Spans that `collect()` has on, if any


def span(name: str):
    """The context of the program span `name`: the shared no-op while no
    profiler records and no collector is on (the flag is read at each call:
    a profiler may start at any time)."""
    if _collector is None and not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, _collector, _autograd_profiler._is_profiler_enabled)


@contextlib.contextmanager
def collect():
    """Collect the program's spans (count, total and self seconds per name)
    into a new `Spans` for the block; yields it."""
    global _collector
    spans = Spans()
    prev, _collector = _collector, spans
    try:
        yield spans
    finally:
        _collector = prev


_gc_open: _Span | None = None  # the full collection in progress, while spans are on


def _gc_hook(phase: str, info: dict) -> None:
    global _gc_open
    if phase == "start":
        if info["generation"] != 2 or (_collector is None and not _autograd_profiler._is_profiler_enabled):
            return
        _gc_open = _Span("py.gc.full", _collector, _autograd_profiler._is_profiler_enabled)
        _gc_open.__enter__()
    elif _gc_open is not None:
        s, _gc_open = _gc_open, None
        s.__exit__(None, None, None)


def install_gc_hook() -> None:
    """Add the full-collection hook to `gc.callbacks` unless it is there:
    one hook per process."""
    if _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)


install_gc_hook()


def progress_bar(total: int, label: str = "build"):
    """A callback `cb(cur, n=None)` that writes `[label] cur/n (pct) rate/s
    ETA` to stderr, and a newline once cur reaches n."""
    start = time.perf_counter()

    def cb(cur: int, n: int | None = None):
        n = n or total
        rate = cur / max(time.perf_counter() - start, 1e-9)
        eta = (n - cur) / max(rate, 1e-9)
        sys.stderr.write(f"\r[{label}] {cur}/{n} ({100*cur/max(n,1):.0f}%) {rate:.0f}/s ETA {eta:.0f}s ")
        sys.stderr.flush()
        if cur >= n:
            sys.stderr.write("\n")

    return cb
