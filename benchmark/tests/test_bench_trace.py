"""The idle share as a union of intervals, on a synthetic trace."""

import pytest

from benchmark.trace import Trace, gaps, union_length


def test_union_counts_overlaps_once():
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert union_length([]) == 0.0


def test_gaps_between_intervals():
    assert gaps([(1, 2), (1.5, 3), (4, 5)], 0, 6) == [(0, 1), (3, 4), (5, 6)]
    assert gaps([(-1, 7)], 0, 6) == []


def test_idle_share_and_breakdown():
    device = [("k1", 1.0, 3.0), ("copy", 2.5, 3.5), ("k2", 6.0, 7.0), ("outside", 11.0, 12.0)]
    host = [("bench.call", 0.5, 4.0), ("aten::sort", 3.6, 3.9), ("bench.call", 4.5, 9.5),
            ("aten::copy_", 7.5, 9.0)]
    tr = Trace((0.0, 10.0), device, host)
    assert tr.busy_s == pytest.approx(3.5)
    assert tr.idle_share == pytest.approx(0.65)
    assert tr.device_seconds() == pytest.approx(4.0)
    assert tr.device_count(lambda n: n.startswith("k")) == 2
    assert tr.top_device_ops()[0] == ["k1", 2.0]
    # gaps (0, 1), (3.5, 6), (7, 10): named by the innermost host event open at their middles
    assert tr.idle_gaps() == [["bench.call", pytest.approx(3.5)], ["aten::copy_", pytest.approx(3.0)]]
