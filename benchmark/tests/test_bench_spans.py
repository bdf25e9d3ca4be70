"""The span readers' arithmetic (`benchmark/spans.py` and the seven
`metrics/*.py` that read it), on hand-made traces."""

import pytest

from benchmark import core, spans
from benchmark.trace import Trace

SPAN_METRICS = ["flat.upload_ms", "flat.wait_ms", "flat.idle_ms", "db.self_ms", "search.enqueue_ms",
                "search.wait_ms", "db.gc_ms"]


def read(metric, trace, calls):
    return core.load_reader(metric).read(core.Run(trace=trace, calls=calls))


def batch_trace():
    """Two `knn_batch` calls in a 10 s window: upload, the int8 route, fetch;
    the card busy at (1.5, 2.5), (3.0, 4.0), (6.5, 8.5)."""
    host = [("bench.call", 0.5, 4.6), ("flat.knn_batch", 0.6, 4.5), ("flat.upload", 0.7, 1.2),
            ("aten::copy_", 0.8, 1.1), ("flat.int8", 1.2, 3.6), ("flat.k1", 1.3, 2.0),
            ("flat.decode", 2.0, 2.4), ("flat.k2", 2.4, 3.5), ("flat.fetch", 3.6, 4.4),
            ("bench.call", 5.0, 9.5), ("flat.knn_batch", 5.1, 9.4), ("flat.upload", 5.2, 6.0),
            ("flat.int8", 6.0, 8.0), ("flat.fetch", 8.0, 9.3)]
    device = [("k1", 1.5, 2.5), ("k2", 3.0, 4.0), ("copy", 6.5, 8.5)]
    return Trace((0.0, 10.0), device, host)


def single_trace():
    """Two `VecDB.search` calls; the second has a full collection in its join,
    one straddles its start and one falls between calls."""
    host = [("bench.call", 0.0, 3.0), ("db.search", 0.1, 2.9), ("db.cast", 0.2, 0.3),
            ("flat.knn", 0.4, 2.4), ("flat.upload", 0.45, 0.5), ("flat.exact", 0.5, 1.5),
            ("scan.knn_scan", 0.6, 1.4), ("aten::mm", 0.7, 0.8), ("flat.fetch", 1.5, 2.3),
            ("db.join", 2.5, 2.8), ("py.gc.full", 3.9, 4.2),
            ("bench.call", 4.0, 8.0), ("db.search", 4.1, 7.9), ("flat.knn", 4.2, 5.2),
            ("flat.exact", 4.3, 4.8), ("scan.knn_scan", 4.3, 4.7), ("flat.fetch", 4.8, 5.1),
            ("db.join", 5.3, 7.5), ("py.gc.full", 5.5, 7.0),
            ("py.gc.full", 8.2, 9.0)]
    device = [("gemv", 0.9, 1.9), ("gemv", 4.5, 5.0)]
    return Trace((0.0, 10.0), device, host)


def test_union_of_a_name_per_call():
    tr = batch_trace()
    assert read("flat.upload_ms", tr, 2) == pytest.approx((0.5 + 0.8) / 2 * 1e3)
    assert read("flat.wait_ms", tr, 2) == pytest.approx((0.8 + 1.3) / 2 * 1e3)
    # nested and overlapping spans of one name count once; clipped to the window
    tr = Trace((0.0, 4.0), [], [("flat.fetch", 1.0, 3.0), ("flat.fetch", 2.0, 2.5),
                                ("flat.fetch", 2.8, 3.5), ("flat.fetch", 3.9, 6.0)])
    assert spans.span_seconds(tr, "flat.fetch") == pytest.approx(2.6)
    assert read("search.wait_ms", tr, 1) == pytest.approx(2.6e3)


def test_single_query_spans():
    tr = single_trace()
    assert read("search.enqueue_ms", tr, 2) == pytest.approx((0.8 + 0.4) / 2 * 1e3)
    assert read("search.wait_ms", tr, 2) == pytest.approx((0.8 + 0.3) / 2 * 1e3)
    # only the collections' time inside `db.search` counts: 1.5 s in the join, 0.1 s of the straddler
    assert read("db.gc_ms", tr, 2) == pytest.approx((1.5 + 0.1) / 2 * 1e3)
    assert spans.seconds_within(tr, "py.gc.full", "db.search") == pytest.approx(1.6)
    assert spans.span_seconds(tr, "py.gc.full") == pytest.approx(1.5 + 0.3 + 0.8)


def test_self_time_is_the_span_less_its_named_descendants():
    tr = single_trace()
    # db.search 2.8 + 3.8 s; flat.knn 2.0 + 1.0 s; the cast, join and collection stay its own
    assert read("db.self_ms", tr, 2) == pytest.approx((0.8 + 2.8) / 2 * 1e3)
    db = spans.span_seconds(tr, "db.search")
    assert (spans.self_seconds(tr, "db.search", "flat.") + spans.span_seconds(tr, "flat.knn")
            == pytest.approx(db))
    # descendants nested in one another count once; the span's own name is not a descendant
    assert spans.self_seconds(tr, "flat.knn", "flat.") == pytest.approx((2.0 - 1.85) + (1.0 - 0.8))


def test_idle_whose_middle_lies_inside_the_span():
    tr = batch_trace()
    # gaps (0, 1.5) mid 0.75 in; (2.5, 3.0) mid 2.75 in; (4.0, 6.5) mid 5.25 in;
    # (8.5, 10) mid 9.25 in the second call: 1.5 + 0.5 + 2.5 + 1.5 = 6.0
    assert read("flat.idle_ms", tr, 2) == pytest.approx(6.0 / 2 * 1e3)
    # a gap whose middle lies outside the calls is the caller's, not the planner's:
    # (0, 4) mid 2.0 is out, (9, 10) mid 9.5 is in the second call
    tr = Trace((0.0, 10.0), [("k", 4.0, 9.0)], [("flat.knn_batch", 1.0, 1.9), ("flat.knn_batch", 9.4, 9.9)])
    assert spans.idle_seconds_in(tr, "flat.knn_batch") == pytest.approx(1.0)
    assert read("flat.idle_ms", tr, 2) == pytest.approx(500.0)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_no_program_spans_read_none(metric):
    """The parent's trace (only the harness's spans and aten operations) and
    an untraced run read nothing."""
    tr = Trace((0.0, 10.0), [("k1", 1.0, 2.0)], [("bench.call", 0.5, 4.0), ("aten::sort", 1.0, 1.5)])
    assert read(metric, tr, 3) is None
    assert read(metric, None, 3) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_program_spans_without_this_one_read_zero(metric):
    tr = Trace((0.0, 10.0), [("k1", 1.0, 2.0)], [("bench.call", 0.5, 4.0), ("store.mirror", 5.0, 6.0)])
    assert read(metric, tr, 3) == 0.0
