"""What the benchmark reads from a `torch.profiler` trace of the window.

`Trace.from_profiler` keeps, in seconds on the profiler's clock:
- `window`: the interval of the harness's `bench.window` span;
- `device`: every operation on the card inside it (kernels, copies,
  memsets: the device activities, not the device-side copies of host
  annotations), as (name, start, end);
- `host`: the host operations and the harness's spans of the thread that
  drove the window, as (name, start, end).

`busy_s` is the length of the union of the device intervals, so operations
that overlap on several streams count once.  `idle_gaps` names each gap in
that union by the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"
# kineto activity types of work on the card; the rest of the device-side
# events (gpu_user_annotation, ...) mirror host spans
_DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset", "concurrent kernel", "memcpy", "memset")


def union_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, t0: float, t1: float):
    """The (start, end) gaps of [t0, t1] that no interval covers."""
    out, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(s, e) for s, e in out if e > s]


class Trace:
    def __init__(self, window, device, host):
        self.device_kinds: dict = {}  # device-side events seen, by kineto activity type
        self.window = window
        t0, t1 = window
        self.device = [(n, max(s, t0), min(e, t1)) for n, s, e in device if e > t0 and s < t1]
        self.host = sorted(host, key=lambda x: x[1])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return union_length([(s, e) for _, s, e in self.device])

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_seconds(self, match=None) -> float:
        """Summed durations of the device operations whose name `match`
        accepts (all where None)."""
        return sum(e - s for n, s, e in self.device if match is None or match(n))

    def device_count(self, match=None) -> int:
        return sum(1 for n, _, _ in self.device if match is None or match(n))

    def top_device_ops(self, n: int = 10):
        by = defaultdict(float)
        for name, s, e in self.device:
            by[name] += e - s
        return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]

    def idle_gaps(self, n: int = 10):
        """Idle seconds of the card in the window, summed by what the host
        was doing at each gap's middle (its innermost operation or span),
        the n largest."""
        starts = [s for _, s, _ in self.host]
        by = defaultdict(float)
        for gs, ge in gaps([(s, e) for _, s, e in self.device], *self.window):
            mid = 0.5 * (gs + ge)
            name = "(no host operation)"
            i = bisect.bisect_right(starts, mid) - 1
            # the latest-starting host event still open at mid is the innermost
            while i >= 0:
                hn, hs, he = self.host[i]
                if he >= mid:
                    name = hn
                    break
                i -= 1
            by[name] += ge - gs
        return sorted(([k, v] for k, v in by.items()), key=lambda x: -x[1])[:n]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """Read a finished `torch.profiler.profile` whose window was wrapped in
        `record_function(WINDOW_SPAN)`."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        res = prof.profiler.kineto_results
        events = res.events()
        base = res.trace_start_ns()  # nanoseconds since the epoch do not fit a double's mantissa
        raw_dev, raw_host, window, tid = [], [], None, None
        kinds = defaultdict(int)
        for ev in events:
            s = (ev.start_ns() - base) * 1e-9
            e = s + ev.duration_ns() * 1e-9
            if ev.device_type() == cuda:
                kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else "kernel"
                kinds[kind] += 1
                if any(kind.endswith(w) for w in _DEVICE_WORK) and not ev.name().startswith("bench."):
                    raw_dev.append((ev.name(), s, e))
            else:
                if ev.name() == WINDOW_SPAN:
                    window, tid = (s, e), ev.start_thread_id()
                raw_host.append((ev.name(), s, e, ev.start_thread_id()))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
        host = [(n, s, e) for n, s, e, t in raw_host if t == tid and n != WINDOW_SPAN]
        out = cls(window, raw_dev, host)
        out.device_kinds = dict(kinds)
        return out
