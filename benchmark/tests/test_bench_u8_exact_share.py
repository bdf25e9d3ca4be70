"""`u8.exact_share` and the uint8 route's other readers on hand-made traces:
the exact route's spans over the uint8 searches, the upload, fetch and
idle time a call, and nothing where the program has no such route or
spans."""

import sys
import types

import pytest

from benchmark import core
from benchmark.trace import Trace

METRIC = "u8.exact_share"
KERNEL = "(anonymous namespace)::scan_u8_exact_kernel(CUtensorMap_st, CUtensorMap_st, int const*)"


def read(metric, trace, monkeypatch, route=True, **run):
    reader = core.load_reader(metric)
    if hasattr(reader, "ROUTE_MODULE"):
        if route:
            monkeypatch.setitem(sys.modules, reader.ROUTE_MODULE, types.ModuleType(reader.ROUTE_MODULE))
        else:
            monkeypatch.delitem(sys.modules, reader.ROUTE_MODULE, raising=False)
    return reader.read(core.Run(trace=trace, calls=3, **run))


def searches(routed):
    """Three `knn_batch` calls in a 10 s window, the first `routed` through
    the exact route; a fourth starts after the window's end.  Each uploads
    for 0.1 s and fetches for 0.5 s.  On the card: the uint8 stage 1 (0.2 s
    a call), a select and a copy."""
    host, device = [], []
    for j, t in enumerate((0.5, 3.5, 6.5, 10.5)):
        host += [("u8.knn_batch", t, t + 2.0), ("u8.upload", t + 0.05, t + 0.15), ("u8.fetch", t + 1.4, t + 1.9)]
        if j < routed or t > 10:
            host += [("u8.scan", t + 0.2, t + 1.0), ("scan.select", t + 0.8, t + 0.9), ("u8.rescan", t + 1.0, t + 1.2)]
            device += [(KERNEL, t + 0.3, t + 0.5), ("select_survivors_kernel", t + 0.8, t + 0.85)]
        device.append(("Memcpy DtoH", t + 1.5, t + 1.55))
    return Trace((0.0, 10.0), device, host)


@pytest.mark.parametrize("routed,share", [(3, 1.0), (1, 1 / 3), (0, 0.0)])
def test_share_of_searches_through_the_exact_route(routed, share, monkeypatch):
    assert read(METRIC, searches(routed), monkeypatch) == pytest.approx(share)


def test_nothing_without_the_route_or_the_searches(monkeypatch):
    assert read(METRIC, searches(3), monkeypatch, route=False) is None
    assert read(METRIC, Trace((0.0, 10.0), [], [("flat.knn_batch", 1.0, 2.0)]), monkeypatch) is None
    assert core.load_reader(METRIC).read(core.Run(trace=None, calls=3)) is None


def test_roofline_and_glue_read_the_stage_one_kernel(monkeypatch):
    tr = searches(3)
    run = dict(config={"rows": 100_000_000, "dim": 128}, traffic={"call": "batch", "batch": 1000})
    # bound 12.94 ms over a mean of 200 ms a launch
    assert read("u8.scan_roofline", tr, monkeypatch, **run) == pytest.approx(100 * 2.56e13 / 1.979e15 / 0.2)
    # the select and the copy: 0.05 + 0.05 s a call
    assert read("u8.glue_ms", tr, monkeypatch) == pytest.approx(100.0)
    assert read("device.idle_share.u8_b1000", tr, monkeypatch) == pytest.approx(1 - 0.9 / 10)
    # a trace without the kernel (the parent's library path) reads nothing
    none = Trace((0.0, 10.0), [("Memcpy DtoH", 1.0, 2.0)], [("u8.knn_batch", 0.5, 3.0)])
    assert read("u8.scan_roofline", none, monkeypatch, **run) is None and read("u8.glue_ms", none, monkeypatch) is None


def test_upload_wait_and_idle_a_call(monkeypatch):
    tr = searches(3)
    assert read("u8.upload_ms", tr, monkeypatch) == pytest.approx(100.0)
    assert read("u8.wait_ms", tr, monkeypatch) == pytest.approx(500.0)
    # each call's gaps whose middle lies inside it: (t + 0.5, t + 0.8) and
    # (t + 0.85, t + 1.5); the gaps between calls lie outside every call
    assert read("u8.idle_ms", tr, monkeypatch) == pytest.approx((0.3 + 0.65) * 1e3)


@pytest.mark.parametrize("metric", ["u8.upload_ms", "u8.wait_ms", "u8.idle_ms"])
def test_no_span_reads_nothing(metric, monkeypatch):
    flat = Trace((0.0, 10.0), [("k1", 1.0, 2.0)], [("flat.knn_batch", 0.5, 3.0), ("flat.upload", 0.6, 0.7)])
    assert read(metric, flat, monkeypatch) is None
    assert core.load_reader(metric).read(core.Run(trace=None, calls=3)) is None
