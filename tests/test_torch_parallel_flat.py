"""The sharded indexes of the PyTorch port (parallel/sharded.py) against the
JAX package's, on the CPU: the mesh, Flat (exact and two-stage), k-means,
PQ Flat and IVF, their checkpoints (every `kind` written by either package
and read by the other), and the DB layer's mesh mirror.

The JAX package's mesh is the conftest's 8-device host mesh (its Pallas
kernels run in interpret mode, as its own tests run them); the port's is
`make_mesh(n, device="cpu")`, n shards on the CPU, where the kernel
wrappers run their plain versions.  Each test is the counterpart of one in
tests/test_parallel.py, held against the JAX package's sharded class on
the same inputs.  The sharded HNSW is in test_torch_parallel_hnsw.py, the
sharded IVF-PQ and the harness's mesh path in test_torch_parallel_ivfpq.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu import VecDB as JVecDB
from lab_1806_vec_db_tpu.models.pq_table import PQTable as JPQTable
from lab_1806_vec_db_tpu.parallel import sharded as JS
from lab_1806_vec_db_tpu.utils.config import HNSWConfig as JHNSWConfig
from lab_1806_vec_db_tpu.utils.config import IVFConfig as JIVFConfig
from lab_1806_vec_db_tpu.utils.config import PQConfig as JPQConfig
from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import PQTable
from lab_1806_vec_db_tpu_torch.parallel import sharded as S
from lab_1806_vec_db_tpu_torch.utils.config import HNSWConfig, IVFConfig, PQConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def cpu_mesh(n):
    return S.make_mesh(n, device="cpu")


def exact_ids(base, q, k):
    return np.argsort(((base[None] - q[:, None]) ** 2).sum(-1), axis=1, kind="stable")[:, :k]


def _recall(ids, gt):
    return np.mean([len(set(ids[r]) & set(gt[r])) / gt.shape[1] for r in range(len(gt))])


def _jax_pq(base, seed=1, m=16):
    return JPQTable.train(base, JPQConfig(n_bits=4, m=m, dist="l2sqr"), seed=seed)


def _port_pq(jpq):
    return PQTable.from_state(*jpq.state(), device="cpu")


def _jax_row_gen(base):
    base_j = jnp.asarray(base)
    import jax

    return (lambda params, key, row_ids: base_j[jnp.clip(row_ids, 0, len(base) - 1)], (),
            jax.random.PRNGKey(0))


# ---- mesh ----


def test_mesh_has_8_devices():
    """make_mesh never shrinks: 8 CPU shards are 8 shards (the JAX mesh of
    the conftest has 8 devices too); devices= may repeat a device; a CUDA
    mesh without a card raises instead of moving to the CPU."""
    assert JS.make_mesh().devices.size == 8
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and mesh.lead == torch.device("cpu")
    assert S.make_mesh(devices=["cpu"] * 3).size == 3
    with pytest.raises(ValueError):
        S.make_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        S.make_mesh(2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            S.make_mesh(4)
        with pytest.raises(RuntimeError, match="cuda"):
            S.make_mesh(devices=["cuda:0"] * 4)


def test_shards_are_views_of_rows_on_their_device():
    rows = torch.arange(40 * 4, dtype=torch.float32).reshape(40, 4)
    base, cache, n_local, shard = S.shard_base(cpu_mesh(3), rows, "l2sqr")
    assert (shard, n_local) == (14, (14, 14, 12))
    assert base[1].untyped_storage().data_ptr() == rows.untyped_storage().data_ptr()
    torch.testing.assert_close(torch.cat(base), rows)
    assert S.shard_base(cpu_mesh(8), rows[:13], "l2sqr")[2] == (8, 5, 0, 0, 0, 0, 0, 0)


# ---- Flat ----


FLAT_CASES = [(size, n) for size in (1, 2, 3, 4, 8) for n in (333, 13)]


@pytest.mark.parametrize("size,n", FLAT_CASES)
def test_sharded_flat_matches_single_device(size, n, gist_1000):
    """Exact sharded scan: ids equal to the JAX package's on the same mesh
    size, distances within rtol 1e-5; n = 333 is a multiple of no size
    but 1 and 3, n = 13 leaves shards empty."""
    base = gist_1000[:n, :64].copy()
    q = gist_1000[500:510, :64].copy()
    dj, ij = JS.ShardedFlatIndex(JS.make_mesh(size), base, "l2sqr").knn_batch(q, 7)
    d, i = S.ShardedFlatIndex(cpu_mesh(size), base, "l2sqr").knn_batch(q, 7)
    np.testing.assert_array_equal(i, np.asarray(ij))
    np.testing.assert_allclose(d, np.asarray(dj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i, exact_ids(base, q, 7))


def assert_equal_within_ties(d, i, dj, ij):
    """Distances within rtol 1e-5; ids equal except where two rows lie at
    the same distance, whose order the packages' selections may swap."""
    np.testing.assert_allclose(d, dj, rtol=1e-5, atol=1e-6)
    for r, c in zip(*np.nonzero(i != ij)):
        tie = np.isclose(dj[r], d[r, c], rtol=1e-6, atol=0)
        assert i[r, c] in ij[r][tie] or tie[-1], (r, c, i[r], ij[r])


@pytest.mark.parametrize("size,n", FLAT_CASES)
def test_sharded_two_stage_matches_exact(size, n, gist_1000):
    """The two-stage path (bf16 candidates, exact distances): ids equal to
    the JAX package's, distances within rtol 1e-5, ascending.  On the
    reference test's doubled rows (every row twice, so every distance
    ties) the ids agree within ties and the recall against the exact scan
    is >= 0.9."""
    q = gist_1000[:16, :32].copy()
    base = gist_1000[:n, :32].copy()
    dj, ij = JS.ShardedFlatIndex(JS.make_mesh(size), base, "l2sqr").knn_batch(q, 10, exact=False)
    d, i = S.ShardedFlatIndex(cpu_mesh(size), base, "l2sqr").knn_batch(q, 10, exact=False)
    np.testing.assert_array_equal(i, np.asarray(ij))
    np.testing.assert_allclose(d, np.asarray(dj), rtol=1e-5, atol=1e-6)
    assert (np.diff(d[:, : min(n, 10)], axis=1) >= -1e-6).all()

    twice = np.vstack([gist_1000[:, :32]] * 2)[: n * 6].astype(np.float32)
    dj, ij = JS.ShardedFlatIndex(JS.make_mesh(size), twice, "l2sqr").knn_batch(q, 10, exact=False)
    index = S.ShardedFlatIndex(cpu_mesh(size), twice, "l2sqr")
    d, i = index.knn_batch(q, 10, exact=False)
    assert_equal_within_ties(d, i, np.asarray(dj), np.asarray(ij))
    assert _recall(i, index.knn_batch(q, 10, exact=True)[1]) >= 0.9


def test_sharded_flat_serde_roundtrip(tmp_path, gist_1000):
    base = gist_1000[:210, :32].copy()
    q = gist_1000[300:308, :32].copy()
    mesh = cpu_mesh(8)
    idx = S.ShardedFlatIndex(mesh, base, "l2sqr")
    p = str(tmp_path / "flat.npz")
    idx.save(p)
    d1, i1 = idx.knn_batch(q, 6)
    d2, i2 = S.ShardedFlatIndex.load(p, mesh).knn_batch(q, 6)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    p2 = str(tmp_path / "flat.topo.npz")
    idx.save(p2, include_vectors=False)
    np.testing.assert_array_equal(S.ShardedFlatIndex.load(p2, mesh, external_base=base).knn_batch(q, 6)[1], i1)
    with pytest.raises(ValueError):
        S.ShardedFlatIndex.load(p2, mesh)
    with pytest.raises(ValueError, match="kind"):
        S.ShardedIVFIndex.load(p, mesh)


# ---- k-means ----


@pytest.mark.parametrize("size", [1, 3, 8])
def test_sharded_kmeans_step(size, gist_1000):
    base = gist_1000[:256, :16].copy()
    cents = base[:4].copy()
    jidx = JS.ShardedFlatIndex(JS.make_mesh(size), base, "l2sqr")
    want = np.asarray(JS.kmeans_step_sharded(jidx.base, jidx.n_local, jnp.asarray(cents), "l2sqr",
                                             jidx.mesh))
    mesh = cpu_mesh(size)
    idx = S.ShardedFlatIndex(mesh, base, "l2sqr")
    got = S.kmeans_step_sharded(idx.base, idx.n_local, cents, "l2sqr", mesh).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    a = ((base[:, None, :] - cents[None]) ** 2).sum(-1).argmin(1)
    expect = np.stack([base[a == c].mean(0) if (a == c).any() else cents[c] for c in range(4)])
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-5)


def test_sharded_kmeans_step_keeps_empty_clusters():
    base = np.zeros((40, 4), np.float32)
    base[20:] = 1.0
    cents = np.array([[0, 0, 0, 0], [1, 1, 1, 1], [9, 9, 9, 9]], np.float32)
    mesh = cpu_mesh(4)
    idx = S.ShardedFlatIndex(mesh, base, "l2sqr")
    got = S.kmeans_step_sharded(idx.base, idx.n_local, cents, "l2sqr", mesh).numpy()
    np.testing.assert_array_equal(got, cents)


# ---- PQ Flat ----


@pytest.mark.parametrize("size", [1, 4, 8])
def test_sharded_pq_matches_single_device(size, gist_1000):
    """With the JAX table carried across by from_state, the port's sharded
    ADC scan + exact top-k returns the JAX package's ids."""
    base = gist_1000[:300, :48].copy()
    q = gist_1000[500:508, :48].copy()
    jpq = _jax_pq(base)
    dj, ij = JS.ShardedPQFlatIndex(JS.make_mesh(size), base, jpq, "l2sqr").knn_batch(q, 5, ef=40)
    d, i = S.ShardedPQFlatIndex(cpu_mesh(size), base, _port_pq(jpq), "l2sqr").knn_batch(q, 5, ef=40)
    np.testing.assert_array_equal(i, np.asarray(ij))
    np.testing.assert_allclose(d, np.asarray(dj), rtol=1e-5, atol=1e-6)


def test_sharded_pq_flat_serde_roundtrip(tmp_path, gist_1000):
    base = gist_1000[:300, :48].copy()
    q = gist_1000[500:506, :48].copy()
    pq = PQTable.train(base, PQConfig(n_bits=4, m=16, dist="l2sqr"), seed=1, device="cpu")
    idx = S.ShardedPQFlatIndex(cpu_mesh(8), base, pq, "l2sqr")
    p = str(tmp_path / "pq.npz")
    idx.save(p)
    d1, i1 = idx.knn_batch(q, 5, ef=40)
    d2, i2 = S.ShardedPQFlatIndex.load(p, cpu_mesh(8)).knn_batch(q, 5, ef=40)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


# ---- IVF ----


@pytest.mark.parametrize("size", [2, 8])
def test_sharded_ivf_matches_probe_oracle(size, gist_1000):
    """With the same centroids the port's sharded IVF returns the JAX
    package's ids, and exactly the top-k of the union of the probed lists."""
    base = gist_1000[:401, :32].copy()
    q = gist_1000[500:510, :32].copy()
    cents = base[np.random.default_rng(3).choice(len(base), 8, replace=False)].copy()
    k, p = 5, 3
    jidx = JS.ShardedIVFIndex(JS.make_mesh(size), base, "l2sqr", JIVFConfig(k=8), centroids=cents)
    idx = S.ShardedIVFIndex(cpu_mesh(size), base, "l2sqr", IVFConfig(k=8), centroids=cents)
    dj, ij = jidx.knn_batch(q, k, n_probes=p)
    d, i = idx.knn_batch(q, k, n_probes=p)
    np.testing.assert_array_equal(i, np.asarray(ij))
    np.testing.assert_allclose(d, np.asarray(dj), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(idx._assign, np.asarray(jidx._assign))
    dc = ((q[:, None] - cents[None]) ** 2).sum(-1)
    assign = ((base[:, None] - cents[None]) ** 2).sum(-1).argmin(1)
    for r in range(len(q)):
        cand = np.flatnonzero(np.isin(assign, np.argsort(dc[r], kind="stable")[:p]))
        dd = ((base[cand] - q[r]) ** 2).sum(-1)
        assert set(i[r].tolist()) == set(cand[np.argsort(dd, kind="stable")[:k]].tolist())


def test_sharded_ivf_distributed_fit_all_probes_is_exact(gist_1000):
    """The port's own fit (k-means++ on the sample + 2 sharded Lloyd
    steps): with every list probed it equals the exact sharded scan, as
    the JAX package's does."""
    base = gist_1000[:300, :24].copy()
    q = gist_1000[400:408, :24].copy()
    mesh = cpu_mesh(8)
    idx = S.ShardedIVFIndex(mesh, base, "l2sqr", IVFConfig(k=6, k_means_size=128), seed=1,
                            refine_steps=2)
    d1, i1 = idx.knn_batch(q, 7, n_probes=6)
    d2, i2 = S.ShardedFlatIndex(mesh, base, "l2sqr").knn_batch(q, 7)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-6)
    jidx = JS.ShardedIVFIndex(JS.make_mesh(), base, "l2sqr", JIVFConfig(k=6, k_means_size=128),
                              seed=1, refine_steps=2)
    np.testing.assert_array_equal(i1, np.asarray(jidx.knn_batch(q, 7, n_probes=6)[1]))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_sharded_ivf_probe_scan_equals_gathered_candidates(dist, gist_1000):
    """The list-by-list probe scan selects what `topk.knn_gathered` selects
    over the (B, p * lmax) gathered posting candidates (the reference's
    formulation), ties included: every row appears twice, so every
    distance ties and the order falls to probe order, then row order."""
    from lab_1806_vec_db_tpu_torch.models.ivf import _build_posting
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import kmeans as KM
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    x = np.vstack([gist_1000[:150, :24]] * 2)
    base = torch.from_numpy(x)
    q = torch.from_numpy(gist_1000[400:420, :24].copy())
    cache = D.dist_cache(base, dist)
    cents = base[:7]
    post, lens = _build_posting(KM.find_nearest(base, cents, dist).numpy(), 7)
    post = torch.from_numpy(post)
    _, probe = KM.find_n_nearest(q, cents, 3, dist)
    d, i = S._probe_scan(q, base, cache, post, lens, probe, 9, dist)
    dg, ig = T.knn_gathered(q, base, post[probe.long()].reshape(20, -1), 9, dist, base_cache=cache)
    np.testing.assert_array_equal(i.numpy(), ig.numpy())
    np.testing.assert_allclose(d.numpy(), dg.numpy(), rtol=1e-5, atol=1e-6)


def test_sharded_ivf_serde_roundtrip_and_mesh_resize(tmp_path, gist_1000):
    """The port's own fit saved and re-placed on 8, 4 and 2 shards: the
    same probed lists give the same results."""
    base = gist_1000[:300, :24].copy()
    q = gist_1000[400:408, :24].copy()
    idx = S.ShardedIVFIndex(cpu_mesh(8), base, "l2sqr", IVFConfig(k=6, k_means_size=128), seed=1)
    p = str(tmp_path / "ivf.npz")
    idx.save(p)
    d1, i1 = idx.knn_batch(q, 5, n_probes=3)
    for size in (8, 4, 2):
        d2, i2 = S.ShardedIVFIndex.load(p, cpu_mesh(size)).knn_batch(q, 5, n_probes=3)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-6)


# ---- checkpoints: every kind, both directions, with a resize ----


def _pair(kind, base, tmp_path):
    """(JAX index on 4 devices, port index on 4 CPU shards) of one kind over
    the same rows, and the search that compares them."""
    jm, pm = JS.make_mesh(4), cpu_mesh(4)
    if kind == "sharded_flat":
        return (JS.ShardedFlatIndex(jm, base, "l2sqr"), S.ShardedFlatIndex(pm, base, "l2sqr"),
                lambda ix, q: ix.knn_batch(q, 6))
    if kind == "sharded_pq_flat":
        jpq = _jax_pq(base)
        return (JS.ShardedPQFlatIndex(jm, base, jpq, "l2sqr"),
                S.ShardedPQFlatIndex(pm, base, _port_pq(jpq), "l2sqr"),
                lambda ix, q: ix.knn_batch(q, 5, ef=40))
    if kind == "sharded_ivf":
        cents = base[:6].copy()
        return (JS.ShardedIVFIndex(jm, base, "l2sqr", JIVFConfig(k=6), centroids=cents),
                S.ShardedIVFIndex(pm, base, "l2sqr", IVFConfig(k=6), centroids=cents),
                lambda ix, q: ix.knn_batch(q, 5, n_probes=3))
    if kind == "sharded_hnsw":
        return (JS.ShardedHNSWIndex(jm, base, "l2sqr", JHNSWConfig(M=6), seed=0),
                S.ShardedHNSWIndex(pm, base, "l2sqr", HNSWConfig(M=6), seed=0),
                lambda ix, q: ix.knn_with_ef_batch(q, 7, ef=300))
    cfg = dict(nlist=6, sample_rows=280, block_rows=128)
    return (JS.ShardedIVFPQIndex(jm, base, "l2sqr",
                                 pq_config=JPQConfig(n_bits=4, m=12, dist="l2sqr", k_means_size=280),
                                 row_gen=_jax_row_gen(base), **cfg),
            S.ShardedIVFPQIndex(pm, base, "l2sqr",
                                pq_config=PQConfig(n_bits=4, m=12, dist="l2sqr", k_means_size=280),
                                **cfg),
            lambda ix, q: (ix.knn_batch(q, 5, n_probes=6, ef=280, chunk=1, interpret=True)
                           if isinstance(ix, JS.ShardedIVFPQIndex)
                           else ix.knn_batch(q, 5, n_probes=6, ef=280, chunk=1)))


KINDS = ["sharded_flat", "sharded_pq_flat", "sharded_ivf", "sharded_hnsw", "sharded_ivfpq"]


CLASSES = {"sharded_flat": (JS.ShardedFlatIndex, S.ShardedFlatIndex),
           "sharded_pq_flat": (JS.ShardedPQFlatIndex, S.ShardedPQFlatIndex),
           "sharded_ivf": (JS.ShardedIVFIndex, S.ShardedIVFIndex),
           "sharded_hnsw": (JS.ShardedHNSWIndex, S.ShardedHNSWIndex),
           "sharded_ivfpq": (JS.ShardedIVFPQIndex, S.ShardedIVFPQIndex)}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_interchange(kind, writer, gist_1000, tmp_path):
    """A checkpoint of every kind written by either package loads in the
    other onto a 4-shard mesh and answers as the writer does; the port
    loads it onto 2 shards too (HNSW rebuilds with a warning, exact at
    exhaustive ef; the others re-place).  Exact results are compared as
    ids, IVF-PQ's (every list probed, dense) against the exact kNN."""
    base = gist_1000[:280, :24].copy()
    q = gist_1000[400:410, :24].copy()
    jidx, pidx, search = _pair(kind, base, tmp_path)
    jcls, pcls = CLASSES[kind]
    src, path = (jidx, pidx)[writer == "port"], str(tmp_path / f"{kind}.npz")
    src.save(path)
    from lab_1806_vec_db_tpu.utils.serde import load_arrays

    assert load_arrays(path)[1]["kind"] == kind
    want = np.asarray(search(src, q)[1])
    if kind == "sharded_ivfpq":
        np.testing.assert_array_equal(want, exact_ids(base, q, 5))
        kw = dict(external_base=base)
    else:
        kw = {}
    if writer == "port":
        if kind == "sharded_ivfpq":
            kw["row_gen"] = _jax_row_gen(base)
        other = jcls.load(path, JS.make_mesh(4), **kw)
        np.testing.assert_array_equal(np.asarray(search(other, q)[1]), want)
        kw.pop("row_gen", None)
    else:
        other = pcls.load(path, cpu_mesh(4), **kw)
        np.testing.assert_array_equal(search(other, q)[1], want)
    if kind == "sharded_hnsw":
        with pytest.warns(UserWarning, match="rebuild"):
            resized = pcls.load(path, cpu_mesh(2))
        assert resized.default_ef == src.default_ef
    else:
        resized = pcls.load(path, cpu_mesh(2), **kw)
    assert resized.mesh.size == 2
    np.testing.assert_array_equal(np.asarray(search(resized, q)[1]), want)


# ---- the DB layer's mesh mirror ----


def _same_results(a, b):
    """Two packages' search results: the same metadata in the same order,
    distances within rtol 1e-5."""
    a, b = ([a], [b]) if a and isinstance(a[0], tuple) else (a, b)
    assert [[m for m, _ in row] for row in a] == [[m for m, _ in row] for row in b]
    np.testing.assert_allclose([[d for _, d in row] for row in a], [[d for _, d in row] for row in b],
                               rtol=1e-5, atol=1e-6)


def test_vecdb_mesh_matches_jax_mesh_mirror(tmp_path, gist_1000, monkeypatch):
    """VecDB(dir, mesh=4, device="cpu") against the JAX DB under
    VECDB_TPU_MESH=4: equal results for f32 Flat, HNSW (with and without
    ef) and uint8 tables, single and batched; a write drops the mirror and
    the new row is found."""
    monkeypatch.setenv("VECDB_TPU_MESH", "4")
    x = gist_1000[:300, :32].copy()
    q = gist_1000[400:410, :32].copy()
    meta = [{"i": str(r)} for r in range(len(x))]
    jdb = JVecDB(str(tmp_path / "jdb"))
    db = VecDB(str(tmp_path / "db"), device="cpu", mesh=4)
    try:
        u8 = np.clip(x * 255, 0, 255).astype(np.float32)
        for d_ in (jdb, db):
            d_.create_table_if_not_exists("t", 32, "l2sqr")
            d_.batch_add("t", x, meta)
            d_.create_table_if_not_exists("u", 32, "l2sqr", data_type="uint8")
            d_.batch_add("u", u8, meta)
        inner = db._inner._table_mgr("t").obj.inner
        assert inner.mesh.size == 4 and inner._mirror is None
        for key, qq in (("t", q), ("u", np.clip(q * 255, 0, 255))):
            _same_results(db.batch_search(key, qq, 5), jdb.batch_search(key, qq, 5))
        assert inner._mirror is not None
        _same_results(db.search("t", q[0], 5), jdb.search("t", q[0], 5))
        new = (x[3] + 7.0).astype(np.float32)
        for d_ in (jdb, db):
            d_.add("t", new, {"i": "new"})
        assert inner._mirror is None  # the write dropped it
        assert db.search("t", new, 1) == [({"i": "new"}, 0.0)]
        _same_results(db.search("t", new, 1), jdb.search("t", new, 1))
        for d_ in (jdb, db):
            d_.build_hnsw_index("t")
        _same_results(db.batch_search("t", q, 5, ef=20), jdb.batch_search("t", q, 5, ef=20))
        _same_results(db.search("t", q[1], 5, ef=20), jdb.search("t", q[1], 5, ef=20))
        assert db.delete("t", {"i": "new"}) == 1 and jdb.delete("t", {"i": "new"}) == 1
        _same_results(db.batch_search("t", q, 5), jdb.batch_search("t", q, 5))
    finally:
        jdb.close()
        db.close()


def test_vecdb_mesh_without_a_card_raises(tmp_path, monkeypatch):
    """VecDB(dir, mesh=4) on the default device needs a card: it raises and
    leaves the directory untouched (no move to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VecDB(str(tmp_path / "db"), mesh=4)
    assert not (tmp_path / "db").exists()
