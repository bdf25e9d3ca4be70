"""HNSW tables of the PyTorch port against the JAX package, on the CPU: the
bulk build, the graph search on a graph the JAX package built, checkpoints
and DB directories in both directions, and the error surface.

The port runs on device="cpu", where the kernel wrappers run their plain
versions.  Both packages draw levels from np.random.default_rng(seed), so
levels, the entry point and the upper levels must be equal; level-0 link
rows may differ only where f32 sums in different orders break a near-tie
(>= 99% identical rows)."""

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu import VecDB as JVecDB
from lab_1806_vec_db_tpu.models import FlatIndex as JFlat
from lab_1806_vec_db_tpu.models import HNSWIndex as JHNSW
from lab_1806_vec_db_tpu.utils.config import HNSWConfig as JConfig
from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import HNSWIndex, PQTable, VecStore
from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF
from lab_1806_vec_db_tpu_torch.ops import traverse as TR
from lab_1806_vec_db_tpu_torch.utils.config import HNSWConfig, PQConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _distinct_rows(x, n):
    """The first n distinct rows of x, in order."""
    _, first = np.unique(x, axis=0, return_index=True)
    return x[np.sort(first)[:n]].copy()


def _twins(x):
    """Indices of the rows of x that have an exact duplicate in x."""
    _, inverse, counts = np.unique(x, axis=0, return_inverse=True, return_counts=True)
    return np.flatnonzero(counts[inverse.ravel()] > 1)


@pytest.mark.parametrize("rows", ["distinct", "literal"])
@pytest.mark.parametrize("bulk", [False, True], ids=["host_links", "device_links"])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_build_matches_reference(dist, bulk, rows, gist_1000, monkeypatch):
    """On distinct rows >= 99% of level-0 link rows are identical.  The
    literal slice gist_1000[:600, :16] holds an exact duplicate (rows 50
    and 444): every heuristic test of a candidate against the twin compares
    two equal true distances, which the packages' f32 sums round
    differently.  That may change the twins' own link rows and which twin
    other rows link to, and nothing else: with the twins' ids taken out,
    every other row must be identical."""
    import lab_1806_vec_db_tpu.models.hnsw as JH
    import lab_1806_vec_db_tpu_torch.models.hnsw as TH

    vecs = _distinct_rows(gist_1000[:, :16], 600) if rows == "distinct" else gist_1000[:600, :16].copy()
    for mod in (JH, TH):  # BULK_LINKS_MIN=1: device-canonical links from the first batch
        monkeypatch.setattr(mod, "BULK_LINKS_MIN", 1 if bulk else 10**9)
    a = JHNSW.build(vecs, dist, JConfig(ef_construction=60, M=8), seed=7)
    b = HNSWIndex.build(vecs, dist, HNSWConfig(ef_construction=60, M=8), seed=7, device="cpu")
    n = len(vecs)
    assert not b._links0_canonical_dev
    np.testing.assert_array_equal(b.levels[:n], a.levels[:n])
    assert (b.entry_point, b.enter_level) == (a.entry_point, a.enter_level)
    assert len(b.upper) == len(a.upper)
    for ua, ub in zip(a.upper, b.upper):
        np.testing.assert_array_equal(ub.ids[: ub.n], ua.ids[: ua.n])
        np.testing.assert_array_equal(ub.links[: ub.n], ua.links[: ua.n])
    la, lb = a.links0[:n], b.links0[:n]
    twins = _twins(vecs)
    if rows == "distinct":
        assert len(twins) == 0
        same = (la == lb).all(1).mean()
        assert same >= 0.99, same
        return
    assert len(twins) == 2
    def others(row):  # the row's links in order, without the twins and the -1 padding
        return row[(row >= 0) & ~np.isin(row, twins)]

    for r in np.flatnonzero(~(la == lb).all(1)):
        if r not in twins:
            np.testing.assert_array_equal(others(lb[r]), others(la[r]), err_msg=f"row {r}")


def test_build_from_store_matches_build(gist_1000):
    vecs = gist_1000[:400, :32].copy()
    a = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(M=8), seed=5, device="cpu")
    b = HNSWIndex.build_from_store(VecStore.from_numpy(vecs, "l2sqr", device="cpu"),
                                   HNSWConfig(M=8), seed=5)
    n = len(vecs)
    assert (a.entry_point, a.enter_level) == (b.entry_point, b.enter_level)
    np.testing.assert_array_equal(a.levels[:n], b.levels[:n])
    np.testing.assert_array_equal(a.links0[:n], b.links0[:n])
    q = gist_1000[500:520, :32].copy()
    da, ia = a.knn_with_ef_batch(q, 5, 32)
    db, ib = b.knn_with_ef_batch(q, 5, 32)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(da, db)


@pytest.fixture(scope="module")
def jax_graph(gist_1000):
    """One graph the JAX package built from the full-width Gist slice."""
    base = gist_1000[:800].copy()
    return JHNSW.build(base, "l2sqr", JConfig(), seed=0), base, gist_1000[800:900].copy()


@pytest.mark.parametrize("ef", [16, 64])
def test_graph_search_matches_reference(jax_graph, ef):
    a, base, q = jax_graph
    arrays, meta = a.state()
    b = HNSWIndex.from_state(arrays, meta, device="cpu")
    dj, ij = a.knn_with_ef_batch(q, 10, ef, route="graph")
    dt, it = b.knn_with_ef_batch(q, 10, ef, route="graph")
    assert (it == ij).all(1).mean() >= 0.99
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    _, gt = JFlat.from_numpy(base, "l2sqr").knn_batch(q, 10)

    def recall(ids):
        return np.mean([len(set(gt[i]) & set(ids[i])) / 10 for i in range(len(q))])

    assert abs(recall(it) - recall(ij)) <= 0.01
    if ef == 64:
        assert recall(it) >= 0.95
    # "auto" on the CPU is the graph route; the scan route is exact-grade
    _, ia = b.knn_with_ef_batch(q, 10, ef)
    np.testing.assert_array_equal(ia, it)
    _, isc = b.knn_with_ef_batch(q, 10, ef, route="scan")
    assert recall(isc) >= recall(it)
    with pytest.raises(ValueError):
        b.knn_with_ef_batch(q, 10, ef, route="warp")


def test_traversal_stats_and_single_queries(jax_graph):
    """traversal_stats (the K4 -> K2 -> K5 loop on the card; the classic
    loop here) counts novel rows within the search budget, and single-query
    search is the batch path."""
    a, base, q = jax_graph
    b = HNSWIndex.from_state(*a.state(), device="cpu")
    d, i, rows = b.traversal_stats(q, 10, 64)
    dg, ig = b.knn_with_ef_batch(q, 10, 64, route="graph")
    assert (i == ig).all(1).mean() >= 0.9  # exact vs bf16 traversal distances
    assert d.shape == (len(q), 10) and rows.shape == (len(q),)
    assert (rows >= 64).all() and (rows <= len(base)).all()
    one = b.knn_with_ef(q[3], 10, 64)
    assert [p.index for p in one] == ig[3].tolist()
    assert [p.index for p in b.knn(q[3], 5)] == b.knn_batch(q[3:4], 5)[1][0].tolist()


@pytest.mark.parametrize("include_vectors", [True, False])
def test_checkpoints_interchange(jax_graph, tmp_path, include_vectors):
    a, base, q = jax_graph
    ext = None if include_vectors else base
    a.save(str(tmp_path / "jax.npz"), include_vectors=include_vectors)
    b = HNSWIndex.load(str(tmp_path / "jax.npz"), external_vectors=ext, device="cpu")
    b.save(str(tmp_path / "torch.npz"), include_vectors=include_vectors)
    c = JHNSW.load(str(tmp_path / "torch.npz"), external_vectors=ext)
    assert (c.entry_point, c.enter_level) == (a.entry_point, a.enter_level)
    np.testing.assert_array_equal(c.links0[: len(base)], a.links0[: len(base)])
    for ua, uc in zip(a.upper, c.upper):
        np.testing.assert_array_equal(uc.links[: uc.n], ua.links[: ua.n])
    _, ij = a.knn_with_ef_batch(q, 10, 40)
    _, ic = c.knn_with_ef_batch(q, 10, 40)
    _, it = b.knn_with_ef_batch(q, 10, 40)
    np.testing.assert_array_equal(ic, ij)
    assert (it == ij).all(1).mean() >= 0.99
    # a device-born store as the vector source
    d = HNSWIndex.load(str(tmp_path / "torch.npz"), device="cpu",
                       external_store=VecStore.from_device(torch.from_numpy(base), "l2sqr"))
    np.testing.assert_array_equal(d.knn_with_ef_batch(q, 10, 40)[1], it)


def _open(which, path):
    return JVecDB(str(path)) if which == "jax" else VecDB(str(path), device="cpu")


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_hnsw_db_directory_opens_in_the_other_package(writer, reader, tmp_path):
    rng = np.random.default_rng(4)
    rows = rng.random((300, 32), dtype=np.float32)
    queries = rng.random((12, 32), dtype=np.float32)
    db = _open(writer, tmp_path)
    db.create_table_if_not_exists("h", 32, "cosine")
    db.batch_add("h", rows, [{"k": str(i)} for i in range(len(rows))])
    db.build_hnsw_index("h", 64)
    assert db.has_hnsw_index("h")
    expect = db.batch_search("h", queries, 5, ef=40)
    db.close()
    db = _open(reader, tmp_path)
    try:
        assert db.has_hnsw_index("h") and db.get_len("h") == 300
        got = db.batch_search("h", queries, 5, ef=40)
        one = db.search("h", queries[0], 5, ef=40)
    finally:
        db.close()
    assert [[m for m, _ in r] for r in got] == [[m for m, _ in r] for r in expect]
    for g, e in zip(got, expect):
        np.testing.assert_allclose([d for _, d in g], [d for _, d in e], rtol=1e-5, atol=1e-6)
    assert [m for m, _ in one] == [m for m, _ in expect[0]]


def test_hnsw_table_error_surface_and_delete(tmp_path):
    rng = np.random.default_rng(5)
    rows = rng.random((200, 8), dtype=np.float32)
    db = VecDB(str(tmp_path), device="cpu")
    try:
        db.create_table_if_not_exists("t", 8, "l2sqr")
        db.batch_add("t", rows, [{"i": str(i)} for i in range(len(rows))])
        db.build_hnsw_index("t")
        assert db.has_hnsw_index("t")
        db.build_hnsw_index("t")  # already HNSW: a no-op
        assert db.search("t", rows[7], 1, ef=32)[0][0] == {"i": "7"}
        # an added row joins the graph incrementally
        db.add("t", np.full(8, 5.0, np.float32), {"i": "far"})
        assert db.search("t", np.full(8, 5.0, np.float32), 1, ef=32)[0][0] == {"i": "far"}
        # delete downgrades the table to Flat (the reference's rule)
        assert db.delete("t", {"i": "7"}) == 1
        assert not db.has_hnsw_index("t") and db.get_len("t") == 200
        assert all(m["i"] != "7" for m, _ in db.search("t", rows[7], 5, ef=32))
        db.build_hnsw_index("t")
        db.clear_hnsw_index("t")
        assert not db.has_hnsw_index("t")
    finally:
        db.close()
    # PQ search on an HNSW index: a row finds itself, a bad route raises
    index = HNSWIndex.build(rows, "l2sqr", HNSWConfig(M=8), seed=0, device="cpu")
    pq = PQTable.train(rows, PQConfig(n_bits=4, m=4, dist="l2sqr"), seed=0, device="cpu")
    assert index.knn_pq(rows[0], 3, 32, pq)[0].index == 0
    with pytest.raises(ValueError):
        index.knn_pq_batch(rows[:2], 3, 32, pq, route="warp")


def test_empty_single_and_index_bytes():
    index = HNSWIndex(4, "l2sqr", HNSWConfig(), device="cpu")
    assert index.knn([0.0, 0.0, 0.0, 0.0], 3) == []
    index.add([1.0, 0.0, 0.0, 0.0])
    res = index.knn([1.0, 0.0, 0.0, 0.0], 3)
    assert len(res) == 1 and res[0].index == 0
    rng = np.random.default_rng(6)
    index.batch_add(rng.random((300, 4), dtype=np.float32))
    index.knn_with_ef_batch(rng.random((3, 4), dtype=np.float32), 5, 20)
    links = index._links0_device()
    graph = links.numel() * 4 + sum(ul._dev_links.numel() * 4 + ul._dev_pos.numel() * 4
                                    for ul in index.upper if ul._dev_links is not None)
    assert index.index_bytes() == index.store.device_bytes() + graph
    assert index.store._dev_bf16 is not None  # the CPU route's traversal copy, counted
    assert TR.traverse.launches == BF.beam_pre.launches == BF.beam_post.launches == 0
