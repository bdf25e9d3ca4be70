"""What the span readers (`metrics/<metric>.py`) share: the program's spans
in the traced window, on the profiler's clock.

The program records a span at each layer boundary of a search
(`lab_1806_vec_db_tpu_torch/utils/profiling.py:span`): while a
`torch.profiler` records, each is a `record_function` range, so it is a
host event of the window's thread in `Trace.host`, nested on that thread
under its caller's spans.  Each reader gives milliseconds a call of the
window, and None where the trace holds none of the program's spans (a
program that records none).
"""

from __future__ import annotations

import bisect

from .trace import gaps, union_length

# the first part of every program span's name (PERF.md §3 lists them)
PROGRAM_PREFIXES = ("db.", "flat.", "scan.", "store.", "py.gc.")


def has_program_spans(trace) -> bool:
    return trace is not None and any(n.startswith(PROGRAM_PREFIXES) for n, _, _ in trace.host)


def merged(trace, name: str):
    """The union of the intervals of the spans called `name`, clipped to the
    window, as sorted disjoint (start, end) pairs."""
    t0, t1 = trace.window
    out = []
    for s, e in sorted((max(s, t0), min(e, t1)) for n, s, e in trace.host if n == name):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def span_seconds(trace, name: str) -> float:
    """Seconds of the window inside a span called `name` (nested or
    repeated spans of one name count once)."""
    return union_length(merged(trace, name))


def self_seconds(trace, name: str, prefix: str) -> float:
    """Seconds inside a span called `name` and outside its descendants whose
    names start with `prefix`: the host events of the window's thread that
    start inside it, other than `name`'s own."""
    starts = [s for _, s, _ in trace.host]
    total = 0.0
    for s, e in merged(trace, name):
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
        inner = [(max(hs, s), min(he, e)) for hn, hs, he in trace.host[lo:hi]
                 if hn != name and hn.startswith(prefix)]
        total += (e - s) - union_length(inner)
    return total


def seconds_within(trace, name: str, outer: str) -> float:
    """Seconds of the window inside a span called `name` and inside a span
    called `outer` (the intersection of the two names' unions)."""
    a, b = merged(trace, name), merged(trace, outer)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_seconds_in(trace, name: str) -> float:
    """Seconds of the card's idle gaps in the window (`trace.gaps`) whose
    middle lies inside a span called `name`."""
    spans = merged(trace, name)
    starts = [s for s, _ in spans]
    total = 0.0
    for gs, ge in gaps([(s, e) for _, s, e in trace.device], *trace.window):
        mid = 0.5 * (gs + ge)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= spans[i][1]:
            total += ge - gs
    return total


def _per_call_ms(run, seconds):
    if not has_program_spans(run.trace):
        return None
    return seconds(run.trace) / run.calls * 1e3


def upload_ms(run):
    """Host ms a call inside `flat.upload`: the queries' copy to the card."""
    return _per_call_ms(run, lambda tr: span_seconds(tr, "flat.upload"))


def fetch_ms(run):
    """Host ms a call inside `flat.fetch`: the results' copies to the host,
    where the host waits for the card."""
    return _per_call_ms(run, lambda tr: span_seconds(tr, "flat.fetch"))


def planner_idle_ms(run):
    """Card-idle ms a call whose gap's middle lies inside `flat.knn_batch`."""
    return _per_call_ms(run, lambda tr: idle_seconds_in(tr, "flat.knn_batch"))


def db_self_ms(run):
    """Host ms a call inside `db.search` and outside its `flat.*`
    descendants: the DB layer's lock, cast and metadata join."""
    return _per_call_ms(run, lambda tr: self_seconds(tr, "db.search", "flat."))


def enqueue_ms(run):
    """Host ms a call inside `scan.knn_scan`: enqueuing the exact scan."""
    return _per_call_ms(run, lambda tr: span_seconds(tr, "scan.knn_scan"))


def gc_ms(run):
    """Host ms a call inside `py.gc.full` within `db.search`: the full
    garbage collections that the searches themselves set off (not those
    of the caller's work between searches)."""
    return _per_call_ms(run, lambda tr: seconds_within(tr, "py.gc.full", "db.search"))
