"""IVF of the PyTorch port against the JAX package's IVFIndex.

The reference builds and saves each index (its k-means draws from
jax.random, which torch cannot reproduce); the port loads the npz and must
search it as the reference does: the binned route (`_knn_device_binned`, K10
in interpret mode on the reference side, its plain version here) returns the
reference's ids with distances within rtol 1e-5 (f32 summation order), the
gathered route the same.  The port's own build is held to the reference
tests' recall gates, and npz files load in both directions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.models import IVFIndex as JIVF
from lab_1806_vec_db_tpu.utils.config import IVFConfig as JIVFConfig
from lab_1806_vec_db_tpu_torch.models import FlatIndex, IVFIndex
from lab_1806_vec_db_tpu_torch.models import ivf as ivf_mod
from lab_1806_vec_db_tpu_torch.utils.config import IVFConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _clustered(n, dim, n_queries, seed=0, n_clusters=8):
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.standard_normal((n_clusters, dim)).astype(np.float32)
    base = centers[rng.integers(0, n_clusters, n)] + 0.5 * rng.standard_normal((n, dim)).astype(np.float32)
    queries = centers[rng.integers(0, n_clusters, n_queries)] + 0.5 * rng.standard_normal(
        (n_queries, dim)).astype(np.float32)
    return base.astype(np.float32), queries.astype(np.float32)


def _recall(gt, ids, k):
    return np.mean([len(set(gt[q][:k]) & set(ids[q][:k])) / k for q in range(len(gt))])


_BUILT = {}


def _ref_index(tmp_path_factory, dist, n=6000, dim=64, nq=40, seed=0, k=4):
    """(reference index, port index loaded from its npz, base, queries)."""
    key = (dist, n, dim, nq, seed, k)
    if key not in _BUILT:
        base, qs = _clustered(n, dim, nq, seed=seed, n_clusters=4)
        ref = JIVF.from_numpy(base, dist, JIVFConfig(k=k), seed=1)
        path = str(tmp_path_factory.mktemp("ivf") / "ref.npz")
        ref.save(path)
        _BUILT[key] = (ref, IVFIndex.load(path, device="cpu"), base, qs)
    return _BUILT[key]


def _assert_same_results(ref_out, port_out, atol=1e-5):
    rd, ri = (np.asarray(a) for a in ref_out)
    pd, pi = (a.numpy() if isinstance(a, torch.Tensor) else a for a in port_out)
    np.testing.assert_array_equal(pi, ri)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    np.testing.assert_allclose(pd[fin], rd[fin], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("n_probes", [2, 4])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_binned_matches_reference(tmp_path_factory, dist, n_probes):
    ref, port, _, qs = _ref_index(tmp_path_factory, dist)
    np.testing.assert_array_equal(port.posting, ref.posting)
    expect = ref._knn_device_binned(jnp.asarray(qs), 10, n_probes, interpret=True)
    got = port._knn_device_binned(qs, 10, n_probes)
    _assert_same_results(expect, got)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_binned_recall_port_build(dist):
    """The port's own build (torch k-means) meets the reference test's
    gates (tests/test_ivf_binned.py::test_binned_search_recall)."""
    base, qs = _clustered(6000, 64, 40, n_clusters=4)
    index = IVFIndex.from_numpy(base, dist, IVFConfig(k=4), seed=1, device="cpu")
    _, gt = FlatIndex.from_numpy(base, dist, device="cpu").knn_batch(qs, 10, exact=True)
    d, i = index._knn_device_binned(qs, 10, 4)
    d, i = d.numpy(), i.numpy()
    assert _recall(gt, i, 10) >= 0.95
    assert all(np.all(np.diff(d[q][np.isfinite(d[q])]) >= -1e-6) for q in range(len(qs)))
    _, i2 = index._knn_device_binned(qs, 10, 2)
    assert _recall(gt, i2.numpy(), 10) >= 0.9


def test_binned_agrees_with_gathered_path():
    """Binned vs the per-query union path (CPU knn_batch): overlap >= 0.85,
    and the binned route's distances are the exact f32 distances."""
    base, qs = _clustered(4000, 48, 16, seed=3, n_clusters=4)
    index = IVFIndex.from_numpy(base, "l2sqr", IVFConfig(k=4), seed=1, device="cpu")
    _, i_old = index.knn_batch(qs, 5, n_probes=4)
    d_new, i_new = (a.numpy() for a in index._knn_device_binned(qs, 5, 4))
    assert np.mean([len(set(i_old[q]) & set(i_new[q])) / 5 for q in range(len(qs))]) >= 0.85
    ok = i_new >= 0
    true = ((base[i_new[ok]] - np.repeat(qs, 5, 0).reshape(16, 5, -1)[ok]) ** 2).sum(-1)
    np.testing.assert_allclose(d_new[ok], true, rtol=1e-5, atol=1e-3)


def test_overflow_segment(monkeypatch, tmp_path_factory):
    """Rows spilled past the list cap stay findable (K1's overflow scan);
    with the cap at the shortest list most rows spill."""
    monkeypatch.setattr(ivf_mod, "_LCAP_QUANTILE", 0.0)
    base, qs = _clustered(6000, 64, 30, n_clusters=4, seed=5)
    index = IVFIndex.from_numpy(base, "l2sqr", IVFConfig(k=4), seed=1, device="cpu")
    assert index._device_sorted()[5] is not None
    _, gt = FlatIndex.from_numpy(base, "l2sqr", device="cpu").knn_batch(qs, 10, exact=True)
    _, i = index._knn_device_binned(qs, 10, 4)
    assert _recall(gt, i.numpy(), 10) >= 0.95
    # the same spill on both sides (the reference binds its quantile as a
    # default argument, so its layout function is wrapped instead): the
    # overflow route gives the reference's results
    import functools
    from lab_1806_vec_db_tpu.models import ivf as jivf_mod

    monkeypatch.setattr(jivf_mod, "_sorted_layout",
                        functools.partial(jivf_mod._sorted_layout, cap_quantile=0.0))
    ref = JIVF.from_numpy(base, "l2sqr", JIVFConfig(k=4), seed=1)
    path = str(tmp_path_factory.mktemp("ivf_ov") / "ref.npz")
    ref.save(path)
    port = IVFIndex.load(path, device="cpu")
    assert port._device_sorted()[5] is not None and ref._device_sorted()[5] is not None
    assert port._device_sorted()[4] == ref._device_sorted()[4]  # lpad
    _assert_same_results(ref._knn_device_binned(jnp.asarray(qs), 10, 2, interpret=True),
                         port._knn_device_binned(qs, 10, 2))


def test_small_batch_and_many_probes(tmp_path_factory):
    """B = 33 (the reference pads 95 queries to a sentinel list; the port
    bins the 33 alone) and n_probes > nlist: the reference's results."""
    ref, port, base, _ = _ref_index(tmp_path_factory, "l2sqr")
    _, qs = _clustered(4000, 64, 33, seed=11, n_clusters=4)
    _assert_same_results(ref._knn_device_binned(jnp.asarray(qs), 10, 4, interpret=True),
                         port._knn_device_binned(qs, 10, 4))
    d, i = port._knn_device_binned(qs[:16], 5, 8)
    assert tuple(i.shape) == (16, 5)
    _assert_same_results(ref._knn_device_binned(jnp.asarray(qs[:16]), 5, 8, interpret=True), (d, i))
    _, gt = FlatIndex.from_numpy(base, "l2sqr", device="cpu").knn_batch(qs, 10, exact=True)
    assert _recall(gt, port._knn_device_binned(qs, 10, 4)[1].numpy(), 10) >= 0.95


def test_drop_counters_match_reference(tmp_path_factory):
    """300 queries on 4 lists overflow the 128-query bins: the dropped
    (query, list) pairs, counted like the reference's."""
    ref, port, _, _ = _ref_index(tmp_path_factory, "l2sqr")
    _, qs = _clustered(300, 64, 300, seed=13, n_clusters=4)
    ref._knn_device_binned(jnp.asarray(qs), 10, 4, interpret=True)
    ref._note_drops()
    port._knn_device_binned(qs, 10, 4)
    port._note_drops()
    assert port.last_dropped_pairs == ref.last_dropped_pairs > 0
    total = port.dropped_pairs_total
    port._knn_device_binned(qs, 10, 4)
    port._note_drops()
    assert port.dropped_pairs_total == 2 * total
    port._note_drops()  # nothing pending: unchanged
    assert port.dropped_pairs_total == 2 * total


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_gathered_route_matches_reference(tmp_path_factory, dist):
    """knn_batch on the CPU: the probed posting union, reranked by
    knn_gathered on both sides, and the same union through K2's blocked
    rerank (`rerank_topk_blocked`, the CUDA / lean route).  knn_gathered uses
    the cached-norm formula |q|^2 + |v|^2 - 2 q.v, whose cancellation at
    these norms (|q|^2 ~ 1e3) leaves ~1e-3 absolute on both sides: atol 2e-3
    there, rtol 1e-5 between K2's direct sums and the reference's."""
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import kmeans as KM

    ref, port, _, qs = _ref_index(tmp_path_factory, dist)
    expect = ref.knn_batch(qs, 10, n_probes=2)
    got = port.knn_batch(qs, 10, n_probes=2)
    _assert_same_results(expect, got, atol=2e-3)
    q = torch.from_numpy(qs)
    cent, posting = port._device()
    _, probe = KM.find_n_nearest(q, cent, 2, dist)
    cand = posting[probe.long()].reshape(len(qs), -1)
    assert cand.shape[1] > 512  # several K2 blocks
    bd, bi = G.rerank_topk_blocked(q, port.store.device_rerank(), cand, 10, dist)
    np.testing.assert_array_equal(bi.numpy(), got[1])
    np.testing.assert_allclose(bd.numpy(), got[0], rtol=1e-5, atol=2e-3)


def test_port_build_oracle_identity(gist_1000, tmp_path):
    """tests/test_ivf.py's gates on the port's own build: posting lists
    cover every row once, save / load without vectors, the IVF top-6 equals
    Flat's, and probing every list is exhaustive."""
    vecs = gist_1000[:, :12].copy()
    cfg = IVFConfig(k=7, k_means_size=len(vecs) // 10, k_means_max_iter=20, k_means_tol=1e-6)
    flat = FlatIndex.from_numpy(vecs, "l2sqr", device="cpu")
    ivf = IVFIndex.from_numpy(vecs, "l2sqr", cfg, seed=42, device="cpu")
    ids = ivf.posting[ivf.posting >= 0]
    assert sorted(ids.tolist()) == list(range(len(vecs)))
    p = tmp_path / "ivf.npz"
    ivf.save(str(p), include_vectors=False)
    ivf = IVFIndex.load(str(p), external_vectors=vecs, device="cpu")
    res = ivf.knn(vecs[200], 6)
    assert [r.index for r in res] == [r.index for r in flat.knn(vecs[200], 6)]
    ds = [r.distance for r in res]
    assert ds == sorted(ds) and len(res) == 6

    small = gist_1000[:300, :12].copy()
    ivf16 = IVFIndex.from_numpy(small, "l2sqr", IVFConfig(k=16), seed=1, device="cpu")
    flat16 = FlatIndex.from_numpy(small, "l2sqr", device="cpu")
    assert [r.index for r in ivf16.knn_with_ef(small[10], 5, 16)] == [r.index for r in flat16.knn(small[10], 5)]


def test_npz_loads_both_ways(tmp_path):
    """The port's npz loads in the reference and searches the same; the
    reference's loads in the port (vectors external) and searches the same."""
    base, qs = _clustered(1500, 32, 8, seed=7, n_clusters=4)
    port = IVFIndex.from_numpy(base, "cosine", IVFConfig(k=6, k_means_max_iter=5), seed=3, device="cpu")
    p = str(tmp_path / "port.npz")
    port.save(p)
    ref = JIVF.load(p)
    np.testing.assert_array_equal(ref.posting, port.posting)
    np.testing.assert_array_equal(ref.centroids, port.centroids)
    assert ref.config.k == 6 and ref.config.k_means_max_iter == 5
    _assert_same_results(ref.knn_batch(qs, 5, n_probes=3), port.knn_batch(qs, 5, n_probes=3), atol=2e-3)

    ref2 = JIVF.from_numpy(base, "l2sqr", JIVFConfig(k=5), seed=2)
    p2 = str(tmp_path / "ref.npz")
    ref2.save(p2, include_vectors=False)
    with pytest.raises(ValueError, match="no vectors"):
        IVFIndex.load(p2, device="cpu")
    port2 = IVFIndex.load(p2, external_vectors=base, device="cpu")
    assert port2.config.k == 5 and port2.dist == "l2sqr"
    _assert_same_results(ref2.knn_batch(qs, 5, n_probes=2), port2.knn_batch(qs, 5, n_probes=2), atol=2e-3)


def test_from_store_and_index_bytes():
    """from_store on a device-born store; index_bytes grows by the sorted
    copy once the binned route built it."""
    from lab_1806_vec_db_tpu_torch.models import VecStore

    base, qs = _clustered(3000, 32, 8, seed=9, n_clusters=4)
    store = VecStore.from_device(torch.from_numpy(base), "l2sqr")
    index = IVFIndex.from_store(store, IVFConfig(k=4, k_means_max_iter=10), seed=0)
    assert sorted(index.posting[index.posting >= 0].tolist()) == list(range(3000))
    before = index.index_bytes()
    index._knn_device_binned(qs, 5, 2)
    q8s, _, _, perm_pad, lpad, _ = index._dev_binned
    assert index.index_bytes() >= before + q8s.numel() + perm_pad.numel() * 4
    assert lpad % 512 == 0
