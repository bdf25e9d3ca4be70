"""`flat.select_kernel_share` on hand-made traces: the kernel route's spans
over the stage-1 searches, and nothing where the program has no such route."""

import sys
import types

import pytest

from benchmark import core
from benchmark.trace import Trace

METRIC = "flat.select_kernel_share"


def read(trace, monkeypatch, route=True):
    reader = core.load_reader(METRIC)
    if route:
        monkeypatch.setitem(sys.modules, reader.ROUTE_MODULE, types.ModuleType(reader.ROUTE_MODULE))
    else:
        monkeypatch.delitem(sys.modules, reader.ROUTE_MODULE, raising=False)
    return reader.read(core.Run(trace=trace, calls=3))


def batches(routed):
    """Three batch searches in a 10 s window, the first `routed` selecting
    through the kernel; a fourth starts after the window's end."""
    host = []
    for j, t in enumerate((0.5, 3.5, 6.5, 10.5)):
        host += [("flat.knn_batch", t, t + 2.0), ("flat.k1", t + 0.5, t + 1.0)]
        if j < routed or t > 10:
            host.append(("scan.select", t + 0.8, t + 0.9))
    return Trace((0.0, 10.0), [("k", 1.0, 1.2)], host)


@pytest.mark.parametrize("routed,share", [(3, 1.0), (1, 1 / 3), (0, 0.0)])
def test_share_of_stage_one_searches_through_the_kernel(routed, share, monkeypatch):
    assert read(batches(routed), monkeypatch) == pytest.approx(share)


def test_nothing_without_the_route_or_the_searches(monkeypatch):
    assert read(batches(3), monkeypatch, route=False) is None
    assert read(Trace((0.0, 10.0), [], [("flat.knn_batch", 1.0, 2.0)]), monkeypatch) is None
    assert core.load_reader(METRIC).read(core.Run(trace=None, calls=3)) is None
