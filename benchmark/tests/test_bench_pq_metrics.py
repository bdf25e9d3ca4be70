"""`pq.k7_share` and the Flat+PQ route's other readers on hand-made traces:
K7's route spans over the searches, K7's roofline, the device work outside
K7 and the idle time a call, and nothing where the program has no such
route or spans (the parent of the route's spans)."""

import sys
import types

import pytest

from benchmark import core, roofline_pq
from benchmark.trace import Trace

from test_bench_roofline_pq import K7, K11

CONFIG = {"rows": 1_000_000, "dim": 960, "pq": {"m": 320}}
TRAFFIC = {"call": "batch", "batch": 1000}


def read(metric, trace, monkeypatch, route=True, **run):
    reader = core.load_reader(metric)
    if hasattr(reader, "ROUTE_MODULE"):
        if route:
            monkeypatch.setitem(sys.modules, reader.ROUTE_MODULE, types.ModuleType(reader.ROUTE_MODULE))
        else:
            monkeypatch.delitem(sys.modules, reader.ROUTE_MODULE, raising=False)
    return reader.read(core.Run(trace=trace, calls=3, config=CONFIG, traffic=TRAFFIC, **run))


def searches(routed):
    """Three `knn_pq_batch` calls in a 10 s window, the first `routed`
    through K7's route, the others through the dense sums; a fourth starts
    after the window's end.  Each uploads for 0.1 s and fetches for 0.5 s.
    On the card: the lookup (0.05 s), K7 (0.2 s) or the dense sums, the
    top-ef sort (0.05 s), K2 (0.05 s) and a copy (0.05 s)."""
    host, device = [], []
    for j, t in enumerate((0.5, 3.5, 6.5, 10.5)):
        host += [("flat.knn_pq_batch", t, t + 2.0), ("flat.upload", t + 0.05, t + 0.15),
                 ("pq.lookup", t + 0.15, t + 0.3), ("pq.adc", t + 0.3, t + 1.0), ("flat.k2", t + 1.0, t + 1.2),
                 ("flat.fetch", t + 1.4, t + 1.9)]
        host.append(("pq.k7" if j < routed or t > 10 else "pq.dense", t + 0.3, t + 1.0))
        device += [("build_lookup", t + 0.2, t + 0.25),
                   (K7 if j < routed or t > 10 else "k8::dense_onehot_kernel", t + 0.35, t + 0.55),
                   ("sort", t + 0.6, t + 0.65), ("gather_dists_kernel", t + 1.05, t + 1.1),
                   ("Memcpy DtoH", t + 1.5, t + 1.55)]
    return Trace((0.0, 10.0), device, host)


@pytest.mark.parametrize("routed,share", [(3, 1.0), (1, 1 / 3), (0, 0.0)])
def test_share_of_searches_through_k7(routed, share, monkeypatch):
    assert read("pq.k7_share", searches(routed), monkeypatch) == pytest.approx(share)


def test_share_reads_nothing_without_the_route_or_the_searches(monkeypatch):
    assert read("pq.k7_share", searches(3), monkeypatch, route=False) is None
    flat = Trace((0.0, 10.0), [], [("flat.knn_batch", 1.0, 2.0), ("flat.k2", 1.5, 1.8)])
    assert read("pq.k7_share", flat, monkeypatch) is None
    assert core.load_reader("pq.k7_share").read(core.Run(trace=None, calls=3)) is None


def test_roofline_glue_and_idle_share(monkeypatch):
    tr = searches(3)
    bound = roofline_pq.k7_bound_s(1_000_000, 320, 1000)
    # K7's bound over its mean of 200 ms a launch
    assert read("k7_roofline", tr, monkeypatch) == pytest.approx(100 * bound / 0.2)
    # the lookup, the sort, K2 and the copy: 4 x 0.05 s a call
    assert read("pq.glue_ms", tr, monkeypatch) == pytest.approx(200.0)
    assert read("device.idle_share.pq_b1000", tr, monkeypatch) == pytest.approx(1 - 3 * 0.4 / 10)


def test_roofline_and_glue_read_nothing_without_k7(monkeypatch):
    dense = searches(0)
    assert read("k7_roofline", dense, monkeypatch) is None and read("pq.glue_ms", dense, monkeypatch) is None
    # K11's chunk-min is not K7
    k11 = Trace((0.0, 10.0), [(K11, 1.0, 2.0)], [("flat.knn_pq_batch", 0.5, 3.0)])
    assert read("k7_roofline", k11, monkeypatch) is None and read("pq.glue_ms", k11, monkeypatch) is None
    assert core.load_reader("k7_roofline").read(core.Run(trace=None, calls=3)) is None


def test_idle_a_call(monkeypatch):
    # each call's gaps whose middle lies inside it: (t + 0.25, t + 0.35),
    # (t + 0.55, t + 0.6), (t + 0.65, t + 1.05) and (t + 1.1, t + 1.5); the
    # gaps that span two calls have their middle between them
    assert read("pq.idle_ms", searches(3), monkeypatch) == pytest.approx((0.1 + 0.05 + 0.4 + 0.4) * 1e3)
    none = Trace((0.0, 10.0), [("k1", 1.0, 2.0)], [("flat.knn_batch", 0.5, 3.0)])
    assert read("pq.idle_ms", none, monkeypatch) is None
    assert core.load_reader("pq.idle_ms").read(core.Run(trace=None, calls=3)) is None
