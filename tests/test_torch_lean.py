"""The lean store tier of the PyTorch port (`VecStore.from_device_blocks`)
against the JAX package's: the counterpart of tests/test_lean_tier.py, plus
the lean int8 mirror and bf16 rerank rows equal to the reference's from the
same fill, and the ingest-sorted binned IVF equal to the reference's on the
reference's own posting layout.

Block generators hand both packages the same numpy rows.  JAX lean stores
stay at <= 2,500 rows (the reference side runs its kernels in interpret
mode)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.models import IVFIndex as JIVF
from lab_1806_vec_db_tpu.models.store import VecStore as JVecStore
from lab_1806_vec_db_tpu.utils.config import IVFConfig as JIVFConfig
from lab_1806_vec_db_tpu_torch.models import FlatIndex, HNSWIndex, IVFIndex, VecStore
from lab_1806_vec_db_tpu_torch.models import ivf as ivf_mod
from lab_1806_vec_db_tpu_torch.utils.config import IVFConfig
from lab_1806_vec_db_tpu_torch.utils.profiling import collect

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _clustered(n, dim, n_q, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, dim)).astype(np.float32)
    base = (0.3 * rng.standard_normal((n, dim)) + centers[rng.integers(0, 16, n)]).astype(np.float32)
    qs = (0.3 * rng.standard_normal((n_q, dim)) + centers[rng.integers(0, 16, n_q)]).astype(np.float32)
    return base, qs


def _recall(gt, ids, k):
    return np.mean([len(set(gt[i][:k]) & set(ids[i][:k])) / k for i in range(len(gt))])


def _fill(base):
    return lambda row0, rows: torch.from_numpy(base[row0 : row0 + rows])


def _jfill(base):
    return lambda row0, rows: jnp.asarray(base[row0 : row0 + rows])


def test_lean_flat_two_stage_recall():
    N, dim, k = 6000, 64, 10
    base, qs = _clustered(N, dim, 16)
    _, gt = FlatIndex.from_numpy(base, "l2sqr", device="cpu").knn_batch(qs, k, exact=True)
    store = VecStore.from_device_blocks(_fill(base), N, dim, "l2sqr", block_rows=2048, device="cpu")
    assert store.tier == "lean" and len(store) == N
    d, ids = FlatIndex.from_store(store).knn_batch(qs, k)
    assert _recall(gt, ids, k) >= 0.9
    assert (np.diff(d, axis=1) >= -1e-4).all()


def test_lean_refuses_f32_and_mutation():
    N, dim = 600, 32
    base, _ = _clustered(N, dim, 2)
    store = VecStore.from_device_blocks(_fill(base), N, dim, "l2sqr", block_rows=256, device="cpu")
    for fn in (store.device, lambda: store.push(np.zeros(dim, np.float32)),
               lambda: store.batch_push(np.zeros((2, dim), np.float32)), lambda: store.swap_remove(0),
               lambda: store.random_sample(4, np.random.default_rng(0)), store.state_arrays,
               store.device_traversal, lambda: store.to_type(np.float16), store.numpy,
               lambda: HNSWIndex.build_from_store(store)):
        with pytest.raises(RuntimeError, match="lean"):
            fn()
    q8, scale, cache, perm = store.device_int8()
    assert q8.dtype == torch.int8 and store.device_rerank().dtype == torch.bfloat16
    assert isinstance(store.int8_reliable(), bool)
    # the caches are the data on this tier: freeing them does nothing
    store.free_search_caches()
    store.free_scan_mirrors()
    assert store.device_int8().q8 is q8 and store.device_bytes() > 0
    with pytest.raises(RuntimeError, match="lean"):
        FlatIndex.from_store(store)._knn_device(np.zeros((1, dim), np.float32), 5, exact=True)
    # on the full tier they drop the derived mirrors, which rebuild the same
    full = VecStore.from_numpy(base, "l2sqr", device="cpu")
    before = [t.clone() for t in full.device_int8()]
    full.device_traversal()
    full.free_search_caches()
    assert full._int8_mirror is None and full._dev_bf16 is None
    full.device_int8()
    full.free_scan_mirrors()
    assert full._int8_mirror is None
    for a, b in zip(full.device_int8(), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_lean_mirror_bytes_match_reference(dist):
    """Same fill -> the same permuted int8 mirror (bytes, permutation, and
    channels to rtol 1e-6) and the same bf16 rerank rows."""
    N, dim = 2500, 70
    base, _ = _clustered(N, dim, 1, seed=4)
    s = VecStore.from_device_blocks(_fill(base), N, dim, dist, block_rows=1024, device="cpu")
    j = JVecStore.from_device_blocks(_jfill(base), N, dim, dist, block_rows=1024)
    q8, sc, ca, perm = (t.numpy() for t in s.device_int8())
    jq8, jsc, jca, jperm = (np.asarray(a) for a in j.device_int8())
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(q8, jq8)
    np.testing.assert_allclose(sc, jsc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ca, jca, rtol=1e-6, atol=0)
    from lab_1806_vec_db_tpu.ops import pallas_gather as PG

    # the reference's (rows * SR, 128) slab holds each row zero-padded
    rows = np.asarray(j.device_rerank().astype(jnp.float32)).reshape(-1, PG.rerank_dim_pad(dim))[:N, :dim]
    np.testing.assert_array_equal(s.device_rerank()[:N].float().numpy(), rows)
    assert s.int8_reliable() == j.int8_reliable()


def test_lean_binned_ivf_recall():
    N, dim, k = 6000, 64, 10
    base, qs = _clustered(N, dim, 16, seed=3)
    _, gt = FlatIndex.from_numpy(base, "l2sqr", device="cpu").knn_batch(qs, k, exact=True)
    idx = IVFIndex.from_device_blocks(_fill(base), N, dim, "l2sqr", IVFConfig(k=16), seed=0,
                                      block_rows=2048, device="cpu")
    assert idx.store.tier == "lean"
    _, ids = idx._knn_device_binned(qs, k, 4)
    assert _recall(gt, ids.numpy(), k) >= 0.85
    # the small-batch route on a lean store streams the union through K2
    _, ids_g = idx.knn_batch(qs, k, n_probes=4)
    assert _recall(gt, ids_g, k) >= 0.85


def test_sorted_mirror_matches_scan_mirror():
    """mirror="sorted" (the ingest-sorted scale layout) gives the same binned
    results as the scan layout's gathered copy; Flat refuses the sorted
    store."""
    N, dim, k = 6000, 64, 10
    base, qs = _clustered(N, dim, 16, seed=5)
    kw = dict(seed=0, block_rows=2048, device="cpu")
    idx_scan = IVFIndex.from_device_blocks(_fill(base), N, dim, "l2sqr", IVFConfig(k=16), **kw)
    idx_sorted = IVFIndex.from_device_blocks(_fill(base), N, dim, "l2sqr", IVFConfig(k=16),
                                             mirror="sorted", **kw)
    assert idx_sorted.store.mirror_layout == "sorted"
    np.testing.assert_array_equal(idx_scan.posting, idx_sorted.posting)
    d1, i1 = idx_scan._knn_device_binned(qs, k, 4)
    d2, i2 = idx_sorted._knn_device_binned(qs, k, 4)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())
    # the sorted store's binned mirror IS the store's tensor (no second copy)
    assert idx_sorted._dev_binned[0] is idx_sorted.store.device_int8().q8
    assert idx_sorted.index_bytes() < idx_scan.index_bytes()
    with pytest.raises(ValueError, match="sorted"):
        FlatIndex.from_store(idx_sorted.store)
    with pytest.raises(ValueError, match="mirror"):
        IVFIndex.from_device_blocks(_fill(base), N, dim, "l2sqr", IVFConfig(k=16), mirror="x", **kw)


def test_sorted_layout_mismatch_raises(monkeypatch):
    """An IVFIndex whose recomputed layout is not the ingest's must refuse
    the binned search (it would decode wrong ids)."""
    N, dim = 3000, 32
    base, qs = _clustered(N, dim, 4, seed=6)
    idx = IVFIndex.from_device_blocks(_fill(base), N, dim, "l2sqr", IVFConfig(k=8), block_rows=1024,
                                      mirror="sorted", device="cpu")
    monkeypatch.setattr(ivf_mod, "_LCAP_QUANTILE", 0.0)
    with pytest.raises(ValueError, match="layout mismatch"):
        idx._knn_device_binned(qs, 5, 2)


def test_sorted_lean_binned_matches_reference():
    """The reference's sorted lean build (its k-means, its posting): the
    port's lean store laid out the same way searches to the reference's ids,
    distances within rtol 1e-5 (both rerank on the bf16 rows)."""
    N, dim, k = 2400, 48, 10
    base, qs = _clustered(N, dim, 12, seed=8)
    ref = JIVF.from_device_blocks(_jfill(base), N, dim, "l2sqr", JIVFConfig(k=4), seed=0,
                                  block_rows=1024, mirror="sorted")
    lpad, perm_pad, ov = ivf_mod._sorted_layout(ref.posting, ref.posting_len, 4)
    cap = 4 * lpad + len(ov)
    perm = np.concatenate([perm_pad, ov]).astype(np.int32)
    perm[perm < 0] = np.arange(N, cap, dtype=np.int32)
    assert cap == ref.store.capacity
    store = VecStore.from_device_blocks(_fill(base), N, dim, "l2sqr", block_rows=1024, perm=perm,
                                        cap=cap, device="cpu")
    np.testing.assert_array_equal(store.device_int8().q8.numpy(), np.asarray(ref.store.device_int8()[0]))
    port = IVFIndex(store, IVFConfig(k=4), ref.centroids, ref.posting, ref.posting_len)
    rd, ri = ref._knn_device_binned(jnp.asarray(qs), k, 2, interpret=True)
    pd, pi = port._knn_device_binned(qs, k, 2)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5, atol=1e-5)


def test_lean_exact_distance_refinement():
    """Exact returned distances (hnsw_index.rs:624-633): with the generator
    kept, lean Flat results refine to exact f32; without it the bf16
    precision is advertised and the distances are bf16-grade.  The
    refinement reads the batch the search uploaded."""
    N, dim, k = 4000, 64, 10
    base, qs = _clustered(N, dim, 12, seed=3)
    store = VecStore.from_device_blocks(_fill(base), N, dim, "l2sqr", block_rows=1024, device="cpu")
    assert store.distance_precision == "f32"
    with collect() as spans:
        d, ids = FlatIndex.from_store(store).knn_batch(qs, k)
    assert spans.count["flat.upload"] == 1
    np.testing.assert_allclose(d, ((base[ids] - qs[:, None, :]) ** 2).sum(-1), rtol=1e-5, atol=1e-5)
    assert (np.diff(d, axis=1) >= -1e-6).all()
    one = FlatIndex.from_store(store).knn(qs[0], k)
    assert [p.index for p in one] == ids[0].tolist()

    store2 = VecStore.from_device_blocks(_fill(base), N, dim, "l2sqr", block_rows=1024, keep_fill=False,
                                         device="cpu")
    assert store2.distance_precision == "bfloat16" and store2.refine_distances(qs, ids) is None
    d2, ids2 = FlatIndex.from_store(store2).knn_batch(qs, k)
    np.testing.assert_allclose(d2, ((base[ids2] - qs[:, None, :]) ** 2).sum(-1), rtol=2e-2, atol=1e-2)


def test_lean_exact_rows_and_refinement():
    """exact_rows regenerates only the blocks that hold the ids (zero rows
    for -1); refine_distances gives the exact f32 distances of a result's
    ids (cosine too)."""
    N, dim = 3000, 32
    base, qs = _clustered(N, dim, 6, seed=5)
    calls = []

    def fill(row0, rows):
        calls.append(row0)
        return torch.from_numpy(base[row0 : row0 + rows])

    store = VecStore.from_device_blocks(fill, N, dim, "l2sqr", block_rows=512, device="cpu")
    calls.clear()
    ids = np.array([0, 511, 512, 2999, 7, -1])
    rows = store.exact_rows(ids).numpy()
    np.testing.assert_allclose(rows[:5], base[ids[:5]], rtol=1e-6)
    np.testing.assert_array_equal(rows[5], np.zeros(dim, np.float32))
    assert sorted(calls) == [0, 512, 2560]
    for dist in ("l2sqr", "cosine"):
        s = VecStore.from_device_blocks(_fill(base), N, dim, dist, block_rows=640, device="cpu")
        knn = np.argsort(((base[None] - qs[:, None]) ** 2).sum(-1), axis=1)[:, :5]
        knn[0, -1] = -1
        refined = s.refine_distances(qs, knn)
        v = base[knn]
        if dist == "l2sqr":
            true = ((v - qs[:, None, :]) ** 2).sum(-1)
        else:
            true = 1 - (v * qs[:, None]).sum(-1) / (np.linalg.norm(v, axis=-1) * np.linalg.norm(qs, axis=-1)[:, None])
        assert np.isinf(refined[0, -1])
        np.testing.assert_allclose(refined[knn >= 0], true[knn >= 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_lean_hnsw_graph_route(dist):
    """The lean branch of HNSW's graph route (the reference's
    knn_with_ef_batch on a lean store): a graph built on a full store,
    attached to a lean store of the same rows, searched by the same code the
    card runs (`_graph_knn_device`: K2's descent and K3 over the bf16 rows,
    their plain versions here), then `_graph_result`.  With the generator
    kept the top k's distances are the JAX package's `refine_distances` of
    the same ids (exact f32, rtol 1e-5, sorted ascending); with
    keep_fill=False the bf16 beam's distances stand.  Neither package builds
    HNSW on a lean store: tests/test_lean_tier.py emulates the route the
    same way."""
    N, dim, k, ef = 800, 48, 10, 40
    base, qs = _clustered(N, dim, 16, seed=11)
    index = HNSWIndex.build(base, dist, seed=5, device="cpu")
    assert index.links0.shape[1] == 32  # M = 16: K3's route (E * L == 128)
    full_bd, full_bi = index._graph_knn_device(torch.from_numpy(qs), ef)
    lean = VecStore.from_device_blocks(_fill(base), N, dim, dist, block_rows=640, device="cpu")
    index.store = lean
    assert lean.device_rerank().shape[0] != index.links0.shape[0]  # the route fits links0
    q = index._queries(qs)
    bd, bi = index._graph_knn_device(q, ef)
    d, ids = index._graph_result(q, bd, bi, k)
    assert sorted(ids.ravel().tolist()) == sorted(bi[:, :k].numpy().ravel().tolist())
    jstore = JVecStore.from_device_blocks(_jfill(base), N, dim, dist, block_rows=640)
    ref = jstore.refine_distances(qs, bi[:, :k].numpy())
    order = np.argsort(ref, axis=1, kind="stable")
    np.testing.assert_array_equal(ids, np.take_along_axis(bi[:, :k].numpy(), order, 1))
    np.testing.assert_allclose(d, np.take_along_axis(ref, order, 1), rtol=1e-5, atol=1e-6)
    v, q64 = base[ids].astype(np.float64), qs.astype(np.float64)[:, None, :]
    if dist == "l2sqr":
        true = ((v - q64) ** 2).sum(-1)
    else:
        true = 1 - (v * q64).sum(-1) / (np.linalg.norm(v, axis=-1) * np.linalg.norm(q64, axis=-1))
    np.testing.assert_allclose(d, true, rtol=1e-5, atol=1e-6)
    assert (np.diff(d, axis=1) >= 0).all()
    # the bf16 beam finds what the f32 beam finds on the same graph
    _, gt = FlatIndex.from_numpy(base, dist, device="cpu").knn_batch(qs, k, exact=True)
    assert abs(_recall(gt, ids, k) - _recall(gt, full_bi[:, :k].numpy(), k)) <= 0.02

    index.store = VecStore.from_device_blocks(_fill(base), N, dim, dist, block_rows=640,
                                              keep_fill=False, device="cpu")
    bd2, bi2 = index._graph_knn_device(q, ef)
    assert torch.equal(bi2, bi) and torch.equal(bd2, bd)
    d2, ids2 = index._graph_result(q, bd2, bi2, k)
    np.testing.assert_array_equal(d2, bd[:, :k].numpy())
    np.testing.assert_array_equal(ids2, bi[:, :k].numpy())
