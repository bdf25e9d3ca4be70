"""Tracing and profiling seams (port of lab_1806_vec_db_tpu/utils/profiling.py).

- `trace(log_dir)`: a context manager around `torch.profiler` that writes a
  Chrome trace (`trace.json`, viewable in chrome://tracing or Perfetto) of
  every CUDA kernel, copy and host operation in scope;
- `Spans`: named host wall-clock accumulators (the reference bench's
  AvgRecorder);
- `progress_bar(total)`: a stderr progress callback for bulk builds.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block on the host and, where CUDA is available, the
    device; on exit write `<log_dir>/trace.json` (the device is synchronized
    first, so every kernel launched in the block is in the trace)."""
    import torch
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
    """Named wall-clock accumulators (host clock)."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def avg(self, name: str) -> float:
        c = self.count[name]
        return self.total[name] / c if c else 0.0

    def report(self) -> str:
        return "\n".join(
            f"{name}: total={self.total[name]:.3f}s n={self.count[name]} avg={self.avg(name)*1000:.2f}ms"
            for name in sorted(self.total))


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
