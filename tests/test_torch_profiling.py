"""The program's spans (`utils/profiling.py:span`, `collect`, the
garbage-collector hook) on the CPU: off, they are one shared no-op that
enters no `record_function`; under `torch.profiler`, each search path's
spans nest as PERF.md §3 lists them; `collect()` counts them with total and
self seconds, beside the profiler too; a full collection is one
`py.gc.full`."""

import gc
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import FlatIndex
from lab_1806_vec_db_tpu_torch.utils import profiling
from lab_1806_vec_db_tpu_torch.utils.profiling import collect, span

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

PROGRAM = ("db.", "flat.", "scan.", "store.", "py.gc.")


def _rows(n, dim=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


@pytest.fixture(scope="module")
def int8_index():
    """Just over the exact scan's 65,536 rows, so `knn_batch` takes the int8 route."""
    return FlatIndex.from_numpy(_rows(65_600), "l2sqr", device="cpu")


@pytest.fixture(scope="module")
def vecdb(tmp_path_factory):
    db = VecDB(str(tmp_path_factory.mktemp("spans_db")), device="cpu")
    db.create_table_if_not_exists("t", 32, "cosine")
    db.batch_add("t", _rows(300), [{"id": str(i)} for i in range(300)])
    yield db
    db.close()


def _program_spans(prof):
    """(name, start, end) of the program's spans in a finished profile, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith(PROGRAM)), key=lambda x: (x[1], -x[2]))


def _tree(spans):
    """{parent name: [direct child names, in order]} and the roots, by time
    containment (one thread)."""
    children, roots, stack = {}, [], []
    for name, s, e in spans:
        while stack and not (stack[-1][1] <= s and e <= stack[-1][2]):
            stack.pop()
        if stack:
            children.setdefault(stack[-1][0], []).append(name)
        else:
            roots.append(name)
        stack.append((name, s, e))
    return roots, children


def _search(kind, int8_index, vecdb):
    q = _rows(4, seed=1)
    if kind == "int8":
        int8_index.knn_batch(q, 10)
    elif kind == "exact":
        int8_index.knn_batch(q, 10, exact=True)
    else:
        vecdb.search("t", q[0], 10)


NESTING = {
    "int8": (["flat.knn_batch"], {"flat.knn_batch": ["flat.upload", "flat.int8", "flat.fetch"],
                                  "flat.int8": ["flat.k1", "flat.decode", "flat.k2"]}),
    "exact": (["flat.knn_batch"], {"flat.knn_batch": ["flat.upload", "flat.exact", "flat.fetch"],
                                   "flat.exact": ["scan.knn_scan"]}),
    "vecdb": (["db.search"], {"db.search": ["db.cast", "flat.knn", "db.join"],
                              "flat.knn": ["flat.native"]}),
}


@pytest.mark.parametrize("kind", list(NESTING))
def test_spans_nest_under_the_profiler(kind, int8_index, vecdb):
    _search(kind, int8_index, vecdb)  # the first search's builds are not this test's
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _search(kind, int8_index, vecdb)
    assert _tree(_program_spans(prof)) == NESTING[kind]
    # function scope, not user scope: the profiler mirrors no span onto the device
    assert {e.scope for e in prof.events() if e.name.startswith(PROGRAM)} == {0}


def test_off_is_the_shared_noop_and_enters_no_record_function(int8_index, vecdb, monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"a profiler range {name!r} entered with spans off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled and profiling._collector is None
    assert span("db.search") is span("flat.k1") is profiling._NOOP
    for kind in NESTING:
        _search(kind, int8_index, vecdb)
    gc.collect()
    assert profiling._collector is None and profiling._gc_open is None


def test_mirror_and_selftest_only_on_the_first_int8_search():
    index = FlatIndex.from_numpy(_rows(65_600, seed=2), "l2sqr", device="cpu")
    q = _rows(2, seed=3)
    with collect() as first:
        index.knn_batch(q, 10)
    with collect() as second:
        index.knn_batch(q, 10)
    assert first.count["store.mirror"] == 1 and first.count["store.selftest"] == 1
    assert first.count["flat.int8"] == 1 and first.count["flat.k1"] == 1
    assert second.count["store.mirror"] == 0 and second.count["store.selftest"] == 0
    assert second.count["flat.int8"] == 1


def test_collect_totals_and_self_times_add_up():
    with collect() as spans:
        for _ in range(3):
            with span("a"):
                time.sleep(0.002)
                with span("b"):
                    time.sleep(0.003)
                    with span("c"):
                        time.sleep(0.001)
    assert spans.count == {"a": 3, "b": 3, "c": 3}
    assert spans.total["a"] == pytest.approx(spans.self_total["a"] + spans.total["b"], abs=1e-9)
    assert spans.total["b"] == pytest.approx(spans.self_total["b"] + spans.total["c"], abs=1e-9)
    assert spans.self_total["c"] == spans.total["c"]
    assert spans.self_total["a"] >= 3 * 0.002 and spans.self_total["b"] >= 3 * 0.003
    assert "a: total=" in spans.report() and span("a") is profiling._NOOP  # off again


def test_a_standalone_spans_keeps_its_own_stack():
    """A `Spans` used on its own and the collector do not take each other's
    spans as children: each keeps its own stack of open spans."""
    own = profiling.Spans()
    with collect() as spans:
        with own.span("own.outer"):
            with span("program"):
                time.sleep(0.002)
        with span("program.outer"):
            with own.span("own.inner"):
                time.sleep(0.002)
    assert own.self_total["own.outer"] == own.total["own.outer"] >= 0.002
    assert spans.self_total["program.outer"] == spans.total["program.outer"] >= 0.002
    assert dict(own.count) == {"own.outer": 1, "own.inner": 1}
    assert dict(spans.count) == {"program": 1, "program.outer": 1}


def test_collect_over_a_search_and_beside_the_profiler(int8_index):
    q = _rows(4, seed=4)
    int8_index.knn_batch(q, 10)
    with profile(activities=[ProfilerActivity.CPU]) as prof, collect() as spans:
        int8_index.knn_batch(q, 10)
    # a request's self times add up to its outermost span's total
    assert sum(spans.self_total.values()) == pytest.approx(spans.total["flat.knn_batch"], rel=1e-9)
    names = [n for n, _, _ in _program_spans(prof)]
    assert sorted(names) == sorted(n for n, c in spans.count.items() for _ in range(c))


def test_collect_on_many_threads():
    """Each thread keeps its own stack of open spans; the counts lose no update."""
    threads, per = 8, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with collect() as spans:
            def work():
                for _ in range(per):
                    with span("outer"):
                        with span("inner"):
                            pass

            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert spans.count["outer"] == spans.count["inner"] == threads * per
    assert spans.total["outer"] == pytest.approx(spans.self_total["outer"] + spans.total["inner"], rel=1e-6)


def test_a_full_collection_is_one_span():
    profiling.install_gc_hook()
    assert gc.callbacks.count(profiling._gc_hook) == 1
    with collect() as spans:
        gc.collect()
        gc.collect(1)  # a younger generation is not a full collection
    assert spans.count["py.gc.full"] == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gc.collect()
    assert [n for n, _, _ in _program_spans(prof)] == ["py.gc.full"]
    with collect() as spans:
        pass
    gc.collect()  # off: nothing recorded
    assert spans.count["py.gc.full"] == 0 and profiling._gc_open is None
