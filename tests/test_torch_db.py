"""The slice as a whole: the port's VecDB against the JAX package's VecDB.

One sequence of user calls runs on both packages (the port on the CPU), and
the results must agree: the same metadata in the same order, distances to
rtol 1e-5 / atol 1e-6 (the reference answers single queries with its native
scan, the port with its exact f32 GEMM scan).  DB directories interchange,
the error surface matches, and uint8 tables (once unported) work, with the
reference's refusals."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu import VecDB as JVecDB
from lab_1806_vec_db_tpu_torch import VecDB

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _open(which, path):
    return JVecDB(str(path)) if which == "jax" else VecDB(str(path), device="cpu")


def _data(n=300, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, dim), dtype=np.float32), rng.random((12, dim), dtype=np.float32)


def _assert_same_results(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert [m for m, _ in ra] == [m for m, _ in rb]
        np.testing.assert_allclose([d for _, d in ra], [d for _, d in rb], rtol=1e-5, atol=1e-6)


def _session(db, rows, queries, dist):
    """create, batch_add with metadata, delete, search with upper_bound,
    batch_search; returns everything the user saw."""
    out = [db.create_table_if_not_exists("t", rows.shape[1], dist),
           db.create_table_if_not_exists("t", rows.shape[1], dist)]
    db.batch_add("t", rows.tolist(), [{"id": str(i), "even": str(i % 2 == 0)} for i in range(len(rows))])
    db.add("t", rows[0].tolist(), {"id": "dup"})
    out.append(db.delete("t", {"even": "True", "id": "4"}))
    out.append(db.delete("t", {"id": "no-such-row"}))
    out.append(db.get_len("t"))
    full = db.search("t", queries[0].tolist(), 8)
    ub = (full[3][1] + full[4][1]) / 2  # no result sits on the bound
    out.append(db.search("t", queries[0].tolist(), 8, None, ub))
    out.append(db.search("t", queries[1].tolist(), 5, ef=40))
    out.append(db.batch_search("t", queries, 6))
    out.append(db.batch_search("t", queries, 6, upper_bound=ub))
    out.append(full)
    return out


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_same_session_same_results(dist, tmp_path):
    rows, queries = _data()
    results = {}
    for which in ("jax", "torch"):
        db = _open(which, tmp_path / which)
        try:
            results[which] = _session(db, rows, queries, dist)
        finally:
            db.close()
    j, t = results["jax"], results["torch"]
    assert t[:5] == j[:5] == [True, False, 1, 0, 300]
    _assert_same_results(t[5:7], j[5:7])
    _assert_same_results(t[7], j[7])
    _assert_same_results(t[8], j[8])
    _assert_same_results([t[9]], [j[9]])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_db_directory_opens_in_the_other_package(writer, reader, tmp_path):
    rows, queries = _data(seed=1)
    db = _open(writer, tmp_path)
    db.create_table_if_not_exists("a", 32, "l2sqr")
    db.create_table_if_not_exists("b c", 32, "cosine")
    db.batch_add("a", rows, [{"k": str(i)} for i in range(len(rows))])
    db.batch_add("b c", rows[:50], [{"k": str(i)} for i in range(50)])
    db.delete("a", {"k": "3"})
    expect = [db.batch_search("a", queries, 4), db.batch_search("b c", queries, 4)]
    db.close()
    db = _open(reader, tmp_path)
    try:
        assert sorted(db.get_all_keys()) == ["a", "b c"]
        assert (db.get_len("a"), db.get_dim("a"), db.get_dist("b c")) == (299, 32, "cosine")
        got = [db.batch_search("a", queries, 4), db.batch_search("b c", queries, 4)]
    finally:
        db.close()
    for g, e in zip(got, expect):
        _assert_same_results(g, e)


@pytest.mark.parametrize("which", ["jax", "torch"])
def test_error_surface(which, tmp_path):
    db = _open(which, tmp_path)
    try:
        with pytest.raises(ValueError):
            db.create_table_if_not_exists("t", 4, "dot")
        with pytest.raises(RuntimeError):
            db.get_len("missing")
        with pytest.raises(RuntimeError):
            db.search("missing", [0.0] * 4, 1)
        db.create_table_if_not_exists("t", 4, "l2sqr")
        with pytest.raises(ValueError):
            db.add("t", [0.0] * 3, {})
        assert db.search("t", [0.0] * 4, 3) == []
        assert db.batch_search("t", [[0.0] * 4], 3) == [[]]
        with pytest.raises(RuntimeError):
            _open(which, tmp_path)  # the directory lock
    finally:
        db.close()


def test_unported_features_raise_not_implemented(tmp_path):
    """The features that raised NotImplementedError before they were ported
    now work: PQ, HNSW and uint8 tables (whose HNSW and PQ refusals name
    float32, as the reference's do), and a uint8 directory written by the
    JAX package opens and searches exactly."""
    db = VecDB(str(tmp_path / "db"), device="cpu")
    try:
        db.create_table_if_not_exists("t", 4, "l2sqr")
        db.add("t", [1.0, 0.0, 0.0, 0.0], {"a": "b"})
        db.build_pq_table("t")  # PQ is ported
        assert db.has_pq_table("t")
        db.build_hnsw_index("t")  # HNSW is ported
        assert db.has_hnsw_index("t")
        assert db.create_table_if_not_exists("u", 4, "l2sqr", data_type="uint8")
        db.batch_add("u", [[0, 0, 0, 0], [200.7, 3, 300, -1]], [{"i": "0"}, {"i": "1"}])
        assert db.search("u", [200, 3, 255, 0], 1) == [({"i": "1"}, 0.0)]
        for build in (db.build_hnsw_index, db.build_pq_table):
            with pytest.raises(RuntimeError, match="float32"):
                build("u")
    finally:
        db.close()
    jdb = JVecDB(str(tmp_path / "jdb"))
    jdb.create_table_if_not_exists("u", 4, "l2sqr", data_type="uint8")
    jdb.batch_add("u", np.eye(4, dtype=np.float32) * 9, [{"i": str(i)} for i in range(4)])
    jdb.close()
    db = VecDB(str(tmp_path / "jdb"), device="cpu")
    try:
        assert db.get_len("u") == 4
        assert db.search("u", [9, 1, 0, 0], 2) == [({"i": "0"}, 1.0), ({"i": "1"}, 145.0)]
    finally:
        db.close()


def test_cuda_default_without_a_card_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VecDB(str(tmp_path / "db"))
    assert not (tmp_path / "db").exists()


def test_two_stage_batch_search_through_vecdb(tmp_path):
    """Above 65,536 rows batch_search takes the two-stage plan (the plain
    K1 and K2 on the CPU): recall@10 against the exact scan stays >= 0.99."""
    from lab_1806_vec_db_tpu_torch.models import FlatIndex

    rng = np.random.default_rng(3)
    n, dim = 70_000, 16
    rows = rng.standard_normal((n, dim), dtype=np.float32)
    queries = rng.standard_normal((64, dim), dtype=np.float32)
    db = VecDB(str(tmp_path), device="cpu")
    try:
        db.create_table_if_not_exists("big", dim, "l2sqr")
        db.batch_add("big", rows, [{"i": str(i)} for i in range(n)])
        res = db.batch_search("big", queries, 10)
    finally:
        db.close()
    _, gt = FlatIndex.from_numpy(rows, "l2sqr", device="cpu").knn_batch(queries, 10, exact=True)
    got = [[int(m["i"]) for m, _ in r] for r in res]
    rec = np.mean([len(set(g) & set(r)) / 10 for g, r in zip(gt.tolist(), got)])
    assert rec >= 0.99


def _seeded_hnsw(path, seed, rows, reopen):
    """Build an HNSW index on a table of `VecDB(path, seed=seed)` (created,
    or with `reopen` closed and opened again first); returns its levels and
    level-0 links and the PQ codebooks."""
    db = VecDB(str(path), device="cpu", seed=seed)
    try:
        db.create_table_if_not_exists("t", rows.shape[1], "l2sqr")
        db.batch_add("t", rows, [{"i": str(i)} for i in range(len(rows))])
        if reopen:
            db.close()
            db = VecDB(str(path), device="cpu", seed=seed)
        db.build_hnsw_index("t")
        db.build_pq_table("t", 0.5, 4, 8)
        tbl = db._inner._table_mgr("t").obj
        index = tbl.inner.inner
        return index.levels[: len(rows)].copy(), index.links0[: len(rows)].copy(), tbl.pq.codebooks.copy()
    finally:
        db.close()


@pytest.mark.parametrize("reopen", [False, True])
def test_seeded_vecdb_builds_the_same_graph(reopen, tmp_path):
    """`VecDB(dir, seed=s)` seeds the tables it creates and opens: two
    builds of one table give the same levels, links and PQ codebooks (the
    graph-route ids of two runs then compare); without a seed the levels
    come from fresh entropy, as in the reference."""
    rows = np.random.default_rng(5).standard_normal((600, 16), dtype=np.float32)
    a = _seeded_hnsw(tmp_path / "a", 11, rows, reopen)
    b = _seeded_hnsw(tmp_path / "b", 11, rows, reopen)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].max() > 0  # upper levels were drawn
    unseeded = [_seeded_hnsw(tmp_path / f"u{i}", None, rows, reopen)[0] for i in range(3)]
    assert any(not np.array_equal(u, unseeded[0]) for u in unseeded[1:])


_ISOLATION = """
import sys
import numpy as np
import lab_1806_vec_db_tpu_torch as P
from lab_1806_vec_db_tpu_torch.models import FlatIndex
from lab_1806_vec_db_tpu_torch.ops import gather as G, scan as S
rng = np.random.default_rng(0)
base = rng.standard_normal((70000, 8), dtype=np.float32)
idx = FlatIndex.from_numpy(base, "l2sqr", device="cpu")
d, i = idx.knn_batch(base[:4], 3)
assert (i[:, 0] == np.arange(4)).all()
db = P.VecDB(sys.argv[1], device="cpu")
db.create_table_if_not_exists("t", 8, "cosine")
db.batch_add("t", base[:10], [{"i": str(j)} for j in range(10)])
assert db.search("t", base[2], 1)[0][0] == {"i": "2"}
db.create_table_if_not_exists("h", 8, "l2sqr")
db.batch_add("h", base[:300], [{"i": str(j)} for j in range(300)])
db.build_hnsw_index("h")
assert db.batch_search("h", base[5:7], 1, ef=32)[0][0][0] == {"i": "5"}
db.close()
from lab_1806_vec_db_tpu_torch.models import HNSWIndex
from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF, traverse as TR
h = HNSWIndex.build(base[:300], "l2sqr", device="cpu")
h.knn_with_ef_batch(base[:2], 3, 32, route="graph")
h.traversal_stats(base[:2], 3, 32)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "lab_1806_vec_db_tpu.")) or m == "lab_1806_vec_db_tpu")
print("BAD", bad)
print("LAUNCHES", S.scan_chunkmin_int8_packed.launches, G.gather_dists.launches,
      TR.traverse.launches, BF.beam_pre.launches, BF.beam_post.launches)
"""


def test_port_imports_no_jax_and_launches_nothing_on_cpu(tmp_path):
    """In a fresh interpreter, CPU searches through the port (Flat and HNSW,
    both graph loops) leave jax and the JAX package out of sys.modules, and
    every kernel launch counter at 0 (CPU tensors take the plain versions)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _ISOLATION, str(tmp_path)], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout
    assert "LAUNCHES 0 0 0 0 0" in res.stdout
