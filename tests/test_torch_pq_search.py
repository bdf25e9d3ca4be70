"""The PQ slice of the PyTorch port as a whole (Flat+PQ, HNSW+PQ on its four
routes, PQ tables through `VecDB`) against the JAX package, on the CPU, with
the PQ table and the HNSW graph carried across in the JAX package's npz
files.

Tolerances: Flat+PQ (and so the HNSW scan route, which is the same scan)
must return the ids of the reference's accelerator composition
(`adc_scan_chunkmin(interpret=True)` and an exact rerank), with recall@10
within 0.02 of the reference's `FlatIndex.knn_pq_batch`.  The graph route scores nodes with the bf16 ADC
sums of the reference's accelerator path (`adc_dists_for_ids`), while the
reference's CPU route sums in f32, so near-equal nodes may swap in the
beam: >= 95% of the top-10 ids equal, recall within 0.02."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu import VecDB as JVecDB
from lab_1806_vec_db_tpu.models import FlatIndex as JFlat
from lab_1806_vec_db_tpu.models import HNSWIndex as JHNSW
from lab_1806_vec_db_tpu.models import PQTable as JPQTable
from lab_1806_vec_db_tpu.ops import pallas_adc as PA
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu.utils.config import HNSWConfig as JHNSWConfig
from lab_1806_vec_db_tpu.utils.config import PQConfig as JPQConfig
from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import FlatIndex, HNSWIndex, PQTable
from lab_1806_vec_db_tpu_torch.ops import adc as A
from lab_1806_vec_db_tpu_torch.ops.distance import calc_dist_host
from lab_1806_vec_db_tpu_torch.ops import merge as M

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

N, DIM, K = 4096, 32, 10
N_GRAPH = 800  # rows of the carried graphs (the JAX build stays small)


@pytest.fixture(scope="module")
def rows(gist_1000):
    """4096 base rows and 40 queries of 32 real Gist values each (the
    bundled slice cut into 32-wide rows)."""
    flat = gist_1000.reshape(-1, DIM)
    return flat[:N].copy(), flat[20000:20040].copy()


def _recall(gt, ids):
    return float(np.mean([len(set(g) & set(r)) / K for g, r in zip(gt, ids)]))


def _carried(tmp_path, vecs, dist, n_bits=4, m=16):
    """The reference's PQ table, saved and loaded into the port."""
    jt = JPQTable.train(vecs, JPQConfig(n_bits=n_bits, m=m, dist=dist, k_means_size=2048), seed=0)
    jt.save(str(tmp_path / f"pq_{dist}_{n_bits}.npz"))
    return jt, PQTable.load(str(tmp_path / f"pq_{dist}_{n_bits}.npz"), device="cpu")


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("ef", [10, 30])
def test_flat_pq_equals_reference_composition(dist, ef, tmp_path):
    """Flat+PQ on 4096 Gaussian rows (K7 needs at least 4 * ef chunks of
    32 rows, more than the bundled Gist slice holds): the ids of the
    reference's K7 + rerank composition; at ef = 10, where the chunk-min's
    collision loss (~ef^2 / (2 * 128) candidates) is small, recall@10 within
    0.02 of the reference's own CPU route (its f32 full ADC scan)."""
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    q = rng.standard_normal((40, DIM)).astype(np.float32)
    jt, pt = _carried(tmp_path, vecs, dist)
    # the reference's accelerator composition: the K7 scan, then an exact rerank
    lookup, q_norms = jt.create_lookup(jnp.asarray(q))
    codes_s, perm = jt.device_scan()
    _, cb, cb_sq = jt.device()
    _, cand = PA.adc_scan_chunkmin(lookup, codes_s, perm, N, cb_sq, q_norms, ef, dist,
                                   packed=True, interpret=True)
    jf = JFlat.from_numpy(vecs, dist)
    vd, vc = jf.store.device()
    _, expect = JT.knn_gathered(jnp.asarray(q), vd, cand, K, dist, base_cache=vc)
    flat = FlatIndex.from_numpy(vecs, dist, device="cpu")
    _, got = flat.knn_pq_batch(q, K, ef, pt)
    np.testing.assert_array_equal(got, np.asarray(expect))
    if ef == 10:
        _, gt = flat.knn_batch(q, K, exact=True)
        _, ref_ids = jf.knn_pq_batch(q, K, ef, jt)
        assert abs(_recall(gt, got) - _recall(gt, ref_ids)) <= 0.02
    assert A.adc_chunkmin.launches == 0


@pytest.fixture(scope="module")
def graph_rows(rows):
    """The first 800 rows and the queries, centered on the rows' mean: the
    raw Gist values are all positive, which puts every cosine distance near
    0, where the bf16 rounding of the graph route's LUT decides the order."""
    vecs, q = rows
    mu = vecs[:N_GRAPH].mean(0)
    return vecs[:N_GRAPH] - mu, q - mu


@pytest.fixture(scope="module")
def graphs(graph_rows, tmp_path_factory):
    """The reference's HNSW graphs over the graph rows, one per metric, each
    loaded into the port: dist -> (jax index, port index)."""
    vecs, _ = graph_rows
    out = {}
    for dist in ("l2sqr", "cosine"):
        path = str(tmp_path_factory.mktemp("hnsw") / f"h_{dist}.npz")
        jh = JHNSW.build(vecs, dist, JHNSWConfig(), seed=0)
        jh.save(path)
        out[dist] = jh, HNSWIndex.load(path, device="cpu")
    return out


@pytest.mark.parametrize("dist,n_bits,m", [("l2sqr", 4, 16), ("cosine", 4, 16),
                                           ("l2sqr", 8, 8), ("cosine", 8, 8)])
def test_hnsw_pq_graph_route_against_reference(dist, n_bits, m, graph_rows, graphs, tmp_path):
    """The graph route (node distances on K8 / K9's ids shape, classic loop
    on the CPU) against the reference's CPU graph route on the same graph
    and PQ table: >= 95% of the top-10 ids equal, recall within 0.02."""
    vecs, q = graph_rows
    jh, ph = graphs[dist]
    jt, pt = _carried(tmp_path, vecs, dist, n_bits=n_bits, m=m)
    _, expect = jh.knn_pq_batch(q, K, 60, jt, route="graph")
    launches = M.merge_sorted.launches
    _, got = ph.knn_pq_batch(q, K, 60, pt, route="graph")
    assert M.merge_sorted.launches == launches
    assert np.mean(got == expect) >= 0.95
    _, gt = FlatIndex.from_numpy(vecs, dist, device="cpu").knn_batch(q, K, exact=True)
    assert abs(_recall(gt, got) - _recall(gt, expect)) <= 0.02


def test_hnsw_pq_mirror_auto_and_scan_routes(graph_rows, graphs, tmp_path):
    """route="mirror" is exact-grade and at least as good as the graph;
    "auto" on the CPU is the graph route; "scan" is Flat+PQ's scan (here the
    dense K8 sums: 25 chunks of 32 rows are fewer than 4 * ef); a bad route
    raises (tests/test_pq.py:96-119)."""
    vecs, q = graph_rows
    _, ph = graphs["l2sqr"]
    _, pt = _carried(tmp_path, vecs, "l2sqr")
    _, gt = FlatIndex.from_numpy(vecs, "l2sqr", device="cpu").knn_batch(q, K, exact=True)
    _, i_m = ph.knn_pq_batch(q, K, 60, pt, route="mirror")
    _, i_g = ph.knn_pq_batch(q, K, 60, pt, route="graph")
    assert _recall(gt, i_m) >= _recall(gt, i_g)
    _, i_a = ph.knn_pq_batch(q, K, 60, pt, route="auto")
    np.testing.assert_array_equal(i_a, i_g)
    _, i_s = ph.knn_pq_batch(q, K, 30, pt, route="scan")
    _, i_f = FlatIndex.from_store(ph.store).knn_pq_batch(q, K, 30, pt)
    np.testing.assert_array_equal(i_s, i_f)
    with pytest.raises(ValueError):
        ph.knn_pq_batch(q, K, 60, pt, route="warp")
    # the single-query form is the batch of one (the 800 rows hold exact
    # duplicates, so compare distances, which ties leave alone)
    d_one, _ = ph.knn_pq_batch(q[:1], K, 60, pt, route="auto")
    pairs = ph.knn_pq(q[0], K, 60, pt)
    np.testing.assert_array_equal([p.distance for p in pairs], d_one[0])


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_hnsw_pq_n_bits_8_routes(dist, graph_rows, graphs, tmp_path):
    """n_bits = 8 (k = 256), route "scan": the dense K9 sums
    (`adc_scan_pallas`) keeping ef candidates, then the exact rerank, give
    the ids of the reference's composition (`adc_scan_pallas(interpret=True)`
    + `knn_gathered`): equal distances (rtol 1e-6), and ids that carry them.
    The rows hold exact duplicates, which the two reranks order apart
    differently, so the ids are checked through their distances."""
    vecs, q = graph_rows
    _, ph = graphs[dist]
    jt, pt = _carried(tmp_path, vecs, dist, n_bits=8, m=8)
    lookup, q_norms = jt.create_lookup(jnp.asarray(q))
    codes, _, cb_sq = jt.device()
    _, cand = PA.adc_scan_pallas(lookup, codes, N_GRAPH, cb_sq, q_norms, 40, dist,
                                 interpret=True)
    jf = JFlat.from_numpy(vecs, dist)
    vd, vc = jf.store.device()
    d_exp, expect = JT.knn_gathered(jnp.asarray(q), vd, cand, K, dist, base_cache=vc)
    d_got, got = ph.knn_pq_batch(q, K, 40, pt, route="scan")
    np.testing.assert_allclose(d_got, np.asarray(d_exp), rtol=1e-6, atol=1e-6)
    for b in range(len(q)):
        d_ids = [calc_dist_host(q[b], vecs[i], dist) for i in got[b]]
        np.testing.assert_allclose(d_ids, d_got[b], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_db_with_pq_table_opens_in_the_other_package(writer, graph_rows, tmp_path):
    """A DB directory with a PQ table, written by one package, opens in the
    other with the same codes and codebooks, and its searches find the
    same neighbors: >= 90% of the top-10 ids shared (the two packages'
    ADC candidate pools round the LUT differently, int8 here and f32 on the
    JAX package's CPU route, and the rows hold exact duplicates)."""
    vecs, q = graph_rows
    meta = [{"i": str(i)} for i in range(len(vecs))]
    opener = {"jax": lambda: JVecDB(str(tmp_path)),
              "torch": lambda: VecDB(str(tmp_path), device="cpu")}
    pq_of = lambda db: db._inner._table_mgr("t").obj.pq
    reader = "torch" if writer == "jax" else "jax"
    db = opener[writer]()
    try:
        db.create_table_if_not_exists("t", DIM, "l2sqr")
        db.batch_add("t", vecs, meta)
        db.build_pq_table("t", 0.5, 4, 8)
        before = db.batch_search("t", q, K, ef=64)
        codes, codebooks = pq_of(db).codes, pq_of(db).codebooks
    finally:
        db.close()
    db = opener[reader]()
    try:
        assert db.has_pq_table("t")
        np.testing.assert_array_equal(pq_of(db).codes, codes)
        np.testing.assert_array_equal(pq_of(db).codebooks, codebooks)
        after = db.batch_search("t", q, K, ef=64)
        got = [{m["i"] for m, _ in r} for r in after]
        want = [{m["i"] for m, _ in r} for r in before]
        assert np.mean([len(g & w) / K for g, w in zip(got, want)]) >= 0.9
        db.clear_pq_table("t")
        assert not db.has_pq_table("t")
    finally:
        db.close()


def test_build_pq_table_checks_and_defaults(tmp_path):
    db = VecDB(str(tmp_path), device="cpu")
    try:
        db.create_table_if_not_exists("t", 12, "cosine")
        with pytest.raises(RuntimeError):
            db.build_pq_table("t")  # empty table
        rng = np.random.default_rng(0)
        db.batch_add("t", rng.standard_normal((300, 12)).astype(np.float32),
                     [{"i": str(i)} for i in range(300)])
        for bad in ((1.5, None, None), (None, 5, None), (None, None, 13)):
            with pytest.raises(RuntimeError):
                db.build_pq_table("t", *bad)
        db.build_pq_table("t")
        table = db._inner._table_mgr("t").obj
        cfg = table.pq.config
        assert (cfg.n_bits, cfg.m, cfg.k_means_size, cfg.k_means_max_iter) == (4, 4, 30, 20)
        res = db.search("t", rng.standard_normal(12).astype(np.float32), 5, ef=40)
        assert len(res) == 5
        db.add("t", [0.0] * 12, {"i": "x"})  # a write drops the PQ table
        assert not db.has_pq_table("t")
    finally:
        db.close()
