"""The PCA projection and the Flat planner's scan modes of the PyTorch port
against the JAX package (ops/project.py, the store's PCA mirror, and the
reference's VECDB_TPU_SCAN modes, which the port takes as `scan=` /
`pca_dim=` arguments).

The reference side runs as tests/test_project.py runs it: the module knobs
`_SCAN_MODE` / `_PCA_DIM` / `_EXACT_BELOW` monkeypatched, on the CPU.  Its
CPU stage 1 takes a full top-r where the port's plain K1 keeps one survivor
per strided 128-row group, so the candidate sets differ by design and the
recalls are compared within a stated margin rather than id for id.

Tolerances: the fitted mean atol 1e-5; each principal direction equal up to
sign, |<p_i, p_ref_i>| >= 1 - 1e-4 on a separated spectrum; projected rows,
scales and caches rtol 1e-5 (atol 1e-5 of the largest magnitude, for
entries near zero); int8 lanes equal except +-1 at rounding boundaries on
<= 0.1% of them; PCA recall@10 >= 0.95 and within 0.02 of the reference's;
bf16 recall within 0.01; "exact" ids equal except between tied distances
(rtol 1e-6).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.models import FlatIndex as JFlatIndex
from lab_1806_vec_db_tpu.models import flat as jflat_mod
from lab_1806_vec_db_tpu.ops import pallas_gather as PG
from lab_1806_vec_db_tpu.ops import project as JPJ
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import FlatIndex, HNSWIndex, ScanMode, VecStore
from lab_1806_vec_db_tpu_torch.models import flat as flat_mod
from lab_1806_vec_db_tpu_torch.models import mirror as MR
from lab_1806_vec_db_tpu_torch.ops import project as PJ
from lab_1806_vec_db_tpu_torch.ops import scan as S
from lab_1806_vec_db_tpu_torch.utils.config import HNSWConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _lowrank(n, dim, n_queries, rank, seed=0):
    """tests/test_project.py's generator: spectral decay in a random
    rank-`rank` basis plus 0.01 noise."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((dim, rank)))[0].astype(np.float32)
    scales = (1.0 / np.sqrt(1 + np.arange(rank))).astype(np.float32)

    def draw(m):
        z = rng.standard_normal((m, rank)).astype(np.float32) * scales
        return z @ basis.T + 0.01 * rng.standard_normal((m, dim)).astype(np.float32)

    return draw(n), draw(n_queries)


def _separated(n=600, dim=64, d_red=6, seed=1):
    """Rows along `d_red` directions with well-separated variances, plus an
    offset (so the l2sqr mean is not zero) and small noise."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((dim, d_red)))[0].astype(np.float32)
    z = rng.standard_normal((n, d_red)).astype(np.float32) * (12.0 / (1.6 ** np.arange(d_red)))
    off = rng.standard_normal(dim).astype(np.float32)
    return (z @ basis.T + off + 0.01 * rng.standard_normal((n, dim))).astype(np.float32)


def _recall(gt, ids, k=10):
    return float(np.mean([len(set(g[:k]) & set(r[:k])) / k for g, r in zip(gt, ids)]))


def _close(a, b, rtol=1e-5):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * float(np.abs(b).max()))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pca_fit_matches_reference(dist):
    x = _separated()
    proj, mu = PJ.pca_fit(torch.from_numpy(x), len(x), 6, dist)
    jproj, jmu = JPJ.pca_fit(jnp.asarray(x), len(x), 6, dist)
    assert proj.shape == (64, 6) and proj.dtype == np.float32 and mu.dtype == np.float32
    np.testing.assert_allclose(mu, jmu, atol=1e-5)
    if dist == "cosine":
        assert not mu.any()
    cos = np.abs((proj * np.asarray(jproj)).sum(0))
    assert (cos >= 1 - 1e-4).all(), cos


def test_pca_fit_ignores_padded_rows():
    x = _separated(n=100, dim=32, d_red=4, seed=2)
    padded = np.zeros((160, 32), np.float32)
    padded[:100] = x
    padded[100:] = 5.0  # rows past n_valid must not count, whatever they hold
    p1, m1 = PJ.pca_fit(torch.from_numpy(x), 100, 4, "l2sqr")
    p2, m2 = PJ.pca_fit(torch.from_numpy(padded), 100, 4, "l2sqr")
    np.testing.assert_allclose(m1, m2, atol=1e-5)
    assert (np.abs((p1 * p2).sum(0)) >= 1 - 1e-4).all()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("d_red", [16, 32])
def test_project_and_quantize_match_reference(dist, d_red):
    base, _ = _lowrank(2000, 96, 1, rank=40, seed=3)
    jproj, jmu = JPJ.pca_fit(jnp.asarray(base), len(base), d_red, dist)
    proj, mu = torch.from_numpy(np.array(jproj)), torch.from_numpy(np.array(jmu))
    xt = torch.from_numpy(base)
    _close(PJ.project(xt, proj, mu).numpy(), np.asarray(JPJ.project(jnp.asarray(base), jproj, jmu)))
    q8, sc, ca = MR.project_quantize(xt, proj, mu, dist)
    jq8, jsc, jca = (np.asarray(a) for a in JPJ.project_quantize(jnp.asarray(base), jproj, jmu, dist))
    # K1 reads 128-lane boxes: the projected lanes are zero-padded to 128
    assert q8.shape == (2000, 128) and q8.dtype == torch.int8
    assert not q8[:, d_red:].any()
    _close(sc.numpy(), jsc)
    _close(ca.numpy(), jca)
    diff = np.abs(q8[:, :d_red].numpy().astype(np.int32) - jq8.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    if dist == "cosine":
        assert not ca.any()


def test_pca_state_carries_across_packages():
    """(proj, mu) fitted by either package, as numpy, gives the other's
    project_quantize the same mirror (within the rounding above)."""
    base, _ = _lowrank(1500, 64, 1, rank=20, seed=4)
    proj, mu = PJ.pca_fit(torch.from_numpy(base), len(base), 16, "l2sqr")
    jq8, jsc, jca = (np.asarray(a) for a in JPJ.project_quantize(
        jnp.asarray(base), jnp.asarray(proj), jnp.asarray(mu), "l2sqr"))
    q8, sc, ca = MR.project_quantize(torch.from_numpy(base), torch.from_numpy(proj),
                                     torch.from_numpy(mu), "l2sqr")
    diff = np.abs(q8[:, :16].numpy().astype(np.int32) - jq8.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    _close(sc.numpy(), jsc)
    _close(ca.numpy(), jca)


@pytest.fixture(scope="module")
def lowrank_65k():
    # 65,536 rows: 512 survivor groups of K1, so ten neighbours rarely share one
    return _lowrank(65536, 96, 50, rank=24, seed=0)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pca_scan_recall_matches_reference(monkeypatch, dist, lowrank_65k):
    base, queries = lowrank_65k
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    idx = FlatIndex.from_numpy(base, dist, device="cpu", scan="pca", pca_dim=32)
    assert idx.uses_pca and idx.rerank_depth(10) == 160
    gt_d, gt_i = idx.knn_batch(queries, 10, exact=True)
    S.scan_chunkmin_int8_packed.launches = 0
    d, i = idx.knn_batch(queries, 10)
    rec = _recall(gt_i, i)
    assert rec >= 0.95, rec
    # the projected mirror was built, at 32 lanes padded to 128, in row order
    p8 = idx.store.device_proj_int8(32).q8
    assert p8.shape == (idx.store.capacity, 128)
    # returned distances are exact f32 for the ids returned
    for q in range(5):
        for c, row in enumerate(i[q]):
            if row in gt_i[q]:
                assert abs(d[q][c] - gt_d[q][list(gt_i[q]).index(row)]) < 1e-3

    monkeypatch.setattr(jflat_mod, "_SCAN_MODE", "pca")
    monkeypatch.setattr(jflat_mod, "_PCA_DIM", 32)
    monkeypatch.setattr(jflat_mod, "_EXACT_BELOW", 0)
    _, ji = JFlatIndex.from_numpy(base, dist).knn_batch(queries, 10)
    jrec = _recall(gt_i, ji)
    assert abs(rec - jrec) <= 0.02, (rec, jrec)


def test_pca_mirror_incremental_sync(monkeypatch):
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    rng = np.random.default_rng(3)
    base = rng.standard_normal((512, 48)).astype(np.float32)
    index = FlatIndex.from_numpy(base, "l2sqr", device="cpu", scan="pca", pca_dim=16)
    index.knn_batch(base[:4], 5)  # builds the projected mirror
    proj0 = index.store.device_proj_int8(16).proj.clone()
    index.store.swap_remove(0)
    v_new = rng.standard_normal(48).astype(np.float32)
    index.store.push(v_new)
    d, i = index.knn_batch(v_new[None, :], 1)
    assert i[0][0] == 511 and d[0][0] < 1e-5
    # the fit stayed fixed; the new row went through it
    m = index.store.device_proj_int8(16)
    proj, mu, p8, psc = m.proj, m.mu, m.q8, m.scale
    assert torch.equal(proj, proj0)
    q8v, scv, cav = MR.project_quantize(torch.from_numpy(v_new[None, :]), proj, mu, "l2sqr")
    # (a product's rounding may depend on how many rows it holds)
    assert int((p8[511].int() - q8v[0].int()).abs().max()) <= 1
    assert np.isclose(float(psc[511]), float(scv[0]), rtol=1e-5, atol=0)


def test_pca_sentinels_on_invalid_rows():
    rng = np.random.default_rng(5)
    store = VecStore.from_numpy(rng.standard_normal((300, 40)).astype(np.float32), "cosine",
                                device="cpu")
    _, psc, pca, _ = store.device_proj_int8(8)
    assert store.capacity == 512
    big = float(torch.tensor(S._BIG))  # the sentinel as f32
    assert (psc[300:] == 0).all() and (pca[300:] == big).all()
    assert (psc[:300] > 0).all() and (pca[:300] == 0).all()  # cosine: cache 0
    store.swap_remove(10)  # row 299 moves to 10; slot 299 becomes invalid
    _, psc, pca, _ = store.device_proj_int8(8)
    assert float(psc[299]) == 0.0 and float(pca[299]) == big
    assert float(psc[10]) > 0 and float(pca[10]) == 0.0
    # counted in the store's device bytes; dropped by free_scan_mirrors
    before = store.device_bytes()
    store.free_scan_mirrors()
    assert store._pca_mirror is None
    assert before - store.device_bytes() >= 512 * 128 + 2 * 512 * 4 + 40 * 8 * 4


def test_pca_small_dim_degrades_to_int8(monkeypatch):
    # tests/test_project.py's clustered rows, at 65,536 rows (K1's survivor
    # groups; the reference's CPU stage 1 is a full top-r at its 1,000)
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 64)).astype(np.float32)
    base = centers[rng.integers(0, 16, 65536)] + 0.3 * rng.standard_normal((65536, 64)).astype(np.float32)
    queries = centers[rng.integers(0, 16, 20)] + 0.3 * rng.standard_normal((20, 64)).astype(np.float32)
    index = FlatIndex.from_numpy(base, "l2sqr", device="cpu", scan="pca", pca_dim=256)
    assert not index.uses_pca and index.rerank_depth(10) == 40
    _, gt_i = index.knn_batch(queries, 10, exact=True)
    _, i = index.knn_batch(queries, 10)
    assert index.store._pca_mirror is None and index.store._int8_mirror is not None
    assert _recall(gt_i, i) >= 0.95


def _tied_equal(ids, jids, d):
    """ids equal except between result slots whose distances tie."""
    for r in range(len(ids)):
        for c in np.nonzero(ids[r] != jids[r])[0]:
            assert np.isclose(d[r, c], d[r], rtol=1e-6, atol=0).sum() > 1, (r, c)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_exact_mode_matches_reference(monkeypatch, dist, lowrank_65k):
    base, queries = lowrank_65k
    base = base[:20000]
    idx = FlatIndex.from_numpy(base, dist, device="cpu", scan="exact")
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)  # the mode alone forces the exact scan
    d, i = idx.knn_batch(queries, 10)
    assert idx.store._int8_mirror is None
    _, ei = idx.knn_batch(queries, 10, exact=True)
    np.testing.assert_array_equal(i, ei)
    monkeypatch.setattr(jflat_mod, "_SCAN_MODE", "exact")
    monkeypatch.setattr(jflat_mod, "_EXACT_BELOW", 0)
    _, ji = JFlatIndex.from_numpy(base, dist).knn_batch(queries, 10)
    _tied_equal(i, ji, d)


@pytest.mark.parametrize("mode", ["bf16", "2stage"])
def test_bf16_mode_recall_matches_reference(monkeypatch, mode):
    """Against the reference's accelerator composition of the mode, run by
    hand on the CPU (its XLA `scan_candidates`, then the rerank kernel in
    interpret mode): its CPU branch orders the final k on the bf16 copy
    instead, which the port does not do."""
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((64, 96)).astype(np.float32)
    base = centers[rng.integers(0, 64, 30000)] + 0.5 * rng.standard_normal((30000, 96)).astype(np.float32)
    queries = centers[rng.integers(0, 64, 40)] + 0.5 * rng.standard_normal((40, 96)).astype(np.float32)
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    idx = FlatIndex.from_numpy(base, "l2sqr", device="cpu", scan=mode)
    _, gt = idx.knn_batch(queries, 10, exact=True)
    _, i = idx.knn_batch(queries, 10)
    assert idx.store._dev_bf16 is not None and idx.store._int8_mirror is None
    js = JFlatIndex.from_numpy(base, "l2sqr").store
    scan_vecs, scan_cache = js.device_traversal()
    q = jnp.asarray(queries)
    _, cand = JT.scan_candidates(q, scan_vecs, scan_cache, jnp.int32(len(base)),
                                 idx.rerank_depth(10), "l2sqr")
    _, ji = PG.rerank_topk_rs(q, PG.prepare_rerank_base(js.device()[0]), cand, 10, "l2sqr",
                              interpret=True)
    rec, jrec = _recall(gt, i), _recall(gt, np.asarray(ji))
    assert abs(rec - jrec) <= 0.01, (rec, jrec)


def test_mode_reaches_hnsw_scan_route(monkeypatch):
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    base, queries = _lowrank(3000, 64, 20, rank=16, seed=7)
    index = HNSWIndex.build(base, "l2sqr", HNSWConfig(M=8, ef_construction=40), seed=1,
                            device="cpu")
    index.store.scan_mode = ScanMode("pca", 16)  # the route reads its store's mode
    _, gt = FlatIndex.from_numpy(base, "l2sqr", device="cpu").knn_batch(queries, 10, exact=True)
    _, i = index.knn_with_ef_batch(queries, 10, 200, route="scan")
    assert index.store._pca_mirror is not None and index.store._pca_mirror.proj.shape[1] == 16
    assert index.store._int8_mirror is None
    assert _recall(gt, i) >= 0.8


def test_mode_reaches_vecdb(monkeypatch, tmp_path):
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)
    base, queries = _lowrank(3000, 64, 10, rank=16, seed=8)
    meta = [{"id": str(j)} for j in range(len(base))]
    with VecDB(str(tmp_path / "db"), device="cpu", scan="pca", pca_dim=16) as db:
        db.create_table_if_not_exists("t", 64, "l2sqr")
        db.batch_add("t", base, meta)
        db.batch_search("t", queries, 10)
        inner = db._inner._table_mgr("t").obj.inner.inner
        assert inner.store.scan_mode == ScanMode("pca", 16) and inner.store._pca_mirror is not None
        db.build_hnsw_index("t")
        hnsw = db._inner._table_mgr("t").obj.inner.inner
        assert isinstance(hnsw, HNSWIndex) and hnsw.store.scan_mode == ScanMode("pca", 16)
        db.clear_hnsw_index("t")
        assert db._inner._table_mgr("t").obj.inner.inner.store.scan_mode.scan == "pca"
    with VecDB(str(tmp_path / "db"), device="cpu", scan="2stage") as db:  # reopened in another mode
        assert db._inner._table_mgr("t").obj.inner.inner.store.scan_mode == ScanMode("bf16")


def test_unknown_mode_raises(tmp_path):
    with pytest.raises(ValueError):
        FlatIndex(8, "l2sqr", device="cpu", scan="pca8")
    with pytest.raises(ValueError):
        FlatIndex(8, "l2sqr", device="cpu", scan="pca", pca_dim=0)
    with pytest.raises(ValueError):
        ScanMode("fp8")
    with pytest.raises(ValueError):
        VecDB(str(tmp_path / "db"), device="cpu", scan="nope")
    assert not os.path.exists(tmp_path / "db")
