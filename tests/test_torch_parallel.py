"""The sharded indexes of the PyTorch port (parallel/sharded.py) against the
JAX package's, on the CPU.

The JAX package's mesh is the conftest's 8-device host mesh (its Pallas
kernels run in interpret mode, as its own tests run them); the port's is
`make_mesh(n, device="cpu")`, n shards on the CPU, where the kernel
wrappers run their plain versions.  Each test here is the counterpart of
one in tests/test_parallel.py, held against the JAX package's sharded class
on the same inputs, plus the checkpoint interchange of every `kind` in both
directions, the DB layer's mesh mirror and the harness's mesh path.  JAX
HNSW graphs stay at <= 800 rows."""

import os
import re

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
from lab_1806_vec_db_tpu_torch.bench import harness
from lab_1806_vec_db_tpu_torch.models import PQTable
from lab_1806_vec_db_tpu_torch.parallel import dryrun_multichip
from lab_1806_vec_db_tpu_torch.parallel import sharded as S
from lab_1806_vec_db_tpu_torch.utils.config import BenchConfig, HNSWConfig, IVFConfig, PQConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")


def cpu_mesh(n):
    return S.make_mesh(n, device="cpu")


def exact_ids(base, q, k):
    return np.argsort(((base[None] - q[:, None]) ** 2).sum(-1), axis=1, kind="stable")[:, :k]


def _recall(ids, gt):
    return np.mean([len(set(ids[r]) & set(gt[r])) / gt.shape[1] for r in range(len(gt))])


def _twins(x):
    _, inverse, counts = np.unique(x, axis=0, return_inverse=True, return_counts=True)
    return np.flatnonzero(counts[inverse.ravel()] > 1)


# ---- the mesh ----


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


def _jax_pq(base, seed=1, m=16):
    return JPQTable.train(base, JPQConfig(n_bits=4, m=m, dist="l2sqr"), seed=seed)


def _port_pq(jpq):
    return PQTable.from_state(*jpq.state(), device="cpu")


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


# ---- HNSW ----


@pytest.fixture(scope="module")
def jax_hnsw(gist_1000, tmp_path_factory):
    """A sharded graph the JAX package built (640 x 32 over 8 shards) and
    its checkpoints with and without vectors."""
    base = gist_1000[:640, :32].copy()
    idx = JS.ShardedHNSWIndex(JS.make_mesh(), base, "l2sqr", JHNSWConfig(M=8), seed=1)
    d = tmp_path_factory.mktemp("shnsw")
    idx.save(str(d / "full.npz"))
    idx.save(str(d / "topo.npz"), include_vectors=False)
    return idx, base, gist_1000[700:712, :32].copy(), d


@pytest.mark.parametrize("ef", [24, 64])
def test_sharded_hnsw_distances_are_exact_and_sorted(jax_hnsw, ef):
    """On the JAX package's graph the port returns the JAX search's ids;
    the distances are the true distances of those ids, ascending."""
    jidx, base, q, d = jax_hnsw
    idx = S.ShardedHNSWIndex.load(str(d / "full.npz"), cpu_mesh(8))
    dist, ids = idx.knn_with_ef_batch(q, 5, ef=ef)
    dj, ij = jidx.knn_with_ef_batch(q, 5, ef=ef)
    np.testing.assert_array_equal(ids, np.asarray(ij))
    np.testing.assert_allclose(dist, np.asarray(dj), rtol=1e-5, atol=1e-5)
    assert (ids >= 0).all() and (ids < len(base)).all()
    true = ((base[ids] - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dist, true, rtol=1e-4, atol=1e-4)
    assert (np.diff(dist, axis=1) >= -1e-5).all()
    np.testing.assert_array_equal(idx.knn_with_ef_batch(q, 5, ef=ef)[1], ids)


def test_sharded_hnsw_exhaustive_ef_is_exact(gist_1000):
    """At ef >= every shard's rows each beam is exhaustive: the port's
    sharded HNSW equals the exact sharded scan (and the JAX package's)."""
    base = gist_1000[:280, :24].copy()
    q = gist_1000[400:410, :24].copy()
    idx = S.ShardedHNSWIndex(cpu_mesh(8), base, "l2sqr", HNSWConfig(M=6), seed=0)
    d1, i1 = idx.knn_with_ef_batch(q, 7, ef=64)
    d2, i2 = S.ShardedFlatIndex(cpu_mesh(8), base, "l2sqr").knn_batch(q, 7)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=1e-5)
    jidx = JS.ShardedHNSWIndex(JS.make_mesh(), base, "l2sqr", JHNSWConfig(M=6), seed=0)
    np.testing.assert_array_equal(i1, np.asarray(jidx.knn_with_ef_batch(q, 7, ef=64)[1]))


@pytest.mark.parametrize("size", [4, 8])
def test_sharded_hnsw_parallel_build_matches_serial(size, gist_1000):
    """A parallel build (a thread per shard) equals a serial one bit for
    bit; and the port's per-shard graphs are the JAX package's: levels,
    entries and upper levels equal, >= 99% of level-0 link rows identical,
    any other difference only at exact duplicate rows."""
    base = gist_1000[:240, :24].copy()
    q = gist_1000[400:410, :24].copy()
    mesh = cpu_mesh(size)
    par = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=6), seed=0, parallel=True)
    ser = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=6), seed=0, parallel=False)
    np.testing.assert_array_equal(par.links0, ser.links0)
    np.testing.assert_array_equal(par.entries, ser.entries)
    for (la, pa), (lb, pb) in zip(par.uppers, ser.uppers):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(pa, pb)
    d1, i1 = par.knn_with_ef_batch(q, 7, ef=24)
    d2, i2 = ser.knn_with_ef_batch(q, 7, ef=24)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)

    jidx = JS.ShardedHNSWIndex(JS.make_mesh(size), base, "l2sqr", JHNSWConfig(M=6), seed=0)
    np.testing.assert_array_equal(par.entries, np.asarray(jidx.entries))
    np.testing.assert_array_equal(par.n_local, np.asarray(jidx.n_local))
    assert len(par.uppers) == len(jidx.uppers)
    for (lp, pp), (lj, pj) in zip(par.uppers, jidx.uppers):
        np.testing.assert_array_equal(pp[:, : pj.shape[1]], np.asarray(pj)[:, : pp.shape[1]])
        np.testing.assert_array_equal(lp, np.asarray(lj))
    jl = np.asarray(jidx.links0)
    same, rows = 0, 0
    for s in range(size):
        n_l = int(par.n_local[s])
        a, b = par.links0[s, :n_l], jl[s, :n_l]
        lo = s * par.shard
        twins = set(_twins(base[lo : lo + n_l]).tolist())
        diff = [r for r in np.flatnonzero(~(a == b).all(1)) if r not in twins]
        same += n_l - len(diff)
        rows += n_l
    assert same / rows >= 0.99


def test_sharded_hnsw_empty_shards(gist_1000):
    """n small against the mesh: shards without rows (n_local 0, entry -1)
    build, search and save; the result is the exact kNN."""
    base = gist_1000[:20, :16].copy()
    q = gist_1000[30:34, :16].copy()
    idx = S.ShardedHNSWIndex(cpu_mesh(8), base, "l2sqr", HNSWConfig(M=4), seed=0)
    assert list(idx.n_local) == [8, 8, 4, 0, 0, 0, 0, 0]
    assert list(idx.entries[3:]) == [-1] * 5
    d, i = idx.knn_with_ef_batch(q, 6, ef=16)
    np.testing.assert_array_equal(i, exact_ids(base, q, 6))
    jidx = JS.ShardedHNSWIndex(JS.make_mesh(), base, "l2sqr", JHNSWConfig(M=4), seed=0)
    np.testing.assert_array_equal(i, np.asarray(jidx.knn_with_ef_batch(q, 6, ef=16)[1]))
    np.testing.assert_array_equal(idx.entries, np.asarray(jidx.entries))


# ---- IVF-PQ ----


def _ivfpq_data(gist_1000, n=800, dim=48):
    return np.ascontiguousarray(gist_1000[:n, :dim]), np.ascontiguousarray(gist_1000[900:910, :dim])


def _jax_row_gen(base):
    base_j = jnp.asarray(base)
    import jax

    return (lambda params, key, row_ids: base_j[jnp.clip(row_ids, 0, len(base) - 1)], (),
            jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_ivfpq(gist_1000, tmp_path_factory):
    """The JAX package's sharded IVF-PQ (the reference test's fixture:
    800 x 48, nlist 8, m 16, 8 shards), saved."""
    base, q = _ivfpq_data(gist_1000)
    idx = JS.ShardedIVFPQIndex(JS.make_mesh(), base, "l2sqr", nlist=8,
                               pq_config=JPQConfig(n_bits=4, m=16, dist="l2sqr", k_means_size=400),
                               sample_rows=400, block_rows=256, row_gen=_jax_row_gen(base))
    path = str(tmp_path_factory.mktemp("sivfpq") / "jax.npz")
    idx.save(path)
    return idx, base, q, path


def _agree_within_ties(d, i, dj, ij):
    """Share of (query, rank) entries whose id is in the other's row, or
    whose distance ties the other's at that rank."""
    ok = [(i[r, c] in set(ij[r].tolist())) or np.isclose(d[r, c], dj[r, c], rtol=1e-5)
          for r in range(len(i)) for c in range(i.shape[1])]
    return float(np.mean(ok))


@pytest.mark.parametrize("size", [8, 4])
def test_sharded_ivfpq_all_probes_is_exact(jax_ivfpq, size):
    """Loaded from the JAX package's checkpoint with external_base (the
    shards re-encoded on the port's mesh): every list probed with a dense
    overflow scan and the exact refine gives the exact kNN, distances exact
    f32 and ascending, ids as the JAX search's."""
    jidx, base, q, path = jax_ivfpq
    idx = S.ShardedIVFPQIndex.load(path, cpu_mesh(size), external_base=base)
    d, i = idx.knn_batch(q, 5, n_probes=idx.nlist, ef=400, chunk=1)
    np.testing.assert_array_equal(i, exact_ids(base, q, 5))
    for r in range(len(q)):
        np.testing.assert_allclose(d[r], ((base[i[r]] - q[r]) ** 2).sum(-1), rtol=1e-4, atol=1e-5)
        assert np.all(np.diff(d[r]) >= -1e-6)
    _, ij = jidx.knn_batch(q, 5, n_probes=jidx.nlist, ef=400, chunk=1, interpret=True)
    np.testing.assert_array_equal(i, np.asarray(ij))


def test_sharded_ivfpq_recall_and_serde(jax_ivfpq, tmp_path):
    """At 6 of 8 probes the port agrees with the JAX search as sets within
    ties at >= 99% of (query, rank), with useful recall; the port's own
    checkpoint re-places onto 4 shards and still searches exactly."""
    jidx, base, q, path = jax_ivfpq
    idx = S.ShardedIVFPQIndex.load(path, cpu_mesh(8), external_base=base)
    assert (idx.lpad, idx.ov_cap) == (jidx.lpad, jidx.ov_cap)
    d, i = idx.knn_batch(q, 5, n_probes=6, ef=128)
    dj, ij = (np.asarray(a) for a in jidx.knn_batch(q, 5, n_probes=6, ef=128, interpret=True))
    assert _agree_within_ties(d, i, dj, ij) >= 0.99
    assert _recall(i, exact_ids(base, q, 5)) >= 0.6
    p = str(tmp_path / "port.npz")
    idx.save(p)
    idx4 = S.ShardedIVFPQIndex.load(p, cpu_mesh(4), external_base=base)
    _, i4 = idx4.knn_batch(q, 5, n_probes=idx4.nlist, ef=400, chunk=1)
    np.testing.assert_array_equal(i4, exact_ids(base, q, 5))


def test_sharded_ivfpq_built_by_the_port(gist_1000):
    """The port's own build (global training, per-shard layouts at a common
    lpad / overflow capacity) and from_fill with a row source: exact at
    all probes, and the two builds give the same ids."""
    base, q = _ivfpq_data(gist_1000)
    cfg = PQConfig(n_bits=4, m=16, dist="l2sqr", k_means_size=400)
    kw = dict(nlist=8, pq_config=cfg, sample_rows=400, block_rows=256)
    idx = S.ShardedIVFPQIndex(cpu_mesh(4), base, "l2sqr", **kw)
    bt = torch.from_numpy(base)
    idx2 = S.ShardedIVFPQIndex.from_fill(cpu_mesh(4), lambda r0, n: bt[r0 : r0 + n], len(base),
                                         base.shape[1], "l2sqr", row_gen=lambda ids: bt[ids.long()],
                                         **kw)
    d, i = idx.knn_batch(q, 5, n_probes=8, ef=400, chunk=1)
    np.testing.assert_array_equal(i, exact_ids(base, q, 5))
    np.testing.assert_array_equal(idx2.knn_batch(q, 5, n_probes=8, ef=400, chunk=1)[1], i)
    for sub in idx._subs:
        assert sub.lpad == idx.lpad and sub._codes_ov.shape[0] == idx.ov_cap
    assert idx.index_bytes() > 0


def test_sharded_ivfpq_auto_chunk_is_a_kernel_chunk(gist_1000):
    """390 rows in 2 lists on 1 shard: 195 rows a list, so the reference's
    auto chunk min(16, 195 // 16) is 12, which no K11 instantiation (nor
    the reference's lpad % chunk check) takes; the port rounds it down to
    8, and a shard's search refuses 12 itself."""
    base, q = _ivfpq_data(gist_1000, n=390, dim=16)
    idx = S.ShardedIVFPQIndex(cpu_mesh(1), base, "l2sqr", nlist=2, sample_rows=390, block_rows=128,
                              pq_config=PQConfig(n_bits=4, m=8, dist="l2sqr", k_means_size=390))
    d, i = idx.knn_batch(q, 5, n_probes=2, ef=390)
    d8, i8 = idx.knn_batch(q, 5, n_probes=2, ef=390, chunk=8)
    np.testing.assert_array_equal(i, i8)
    np.testing.assert_array_equal(d, d8)
    assert (i >= 0).all()
    qt = torch.from_numpy(q)
    with pytest.raises(ValueError, match="chunk"):
        idx._subs[0].search_candidates(qt, *idx.pq.create_lookup(qt), 5, 2, 390, 32, 12)


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


def test_sharded_hnsw_serde_roundtrip(tmp_path, jax_hnsw):
    """The JAX package's topology-only checkpoint loads with external_base;
    the port's checkpoints round-trip; a different mesh size rebuilds
    (with the saved default_ef) and refuses without vectors."""
    jidx, base, q, d = jax_hnsw
    mesh = cpu_mesh(8)
    idx = S.ShardedHNSWIndex.load(str(d / "topo.npz"), mesh, external_base=base)
    d1, i1 = idx.knn_with_ef_batch(q, 7, ef=24)
    np.testing.assert_array_equal(i1, np.asarray(jidx.knn_with_ef_batch(q, 7, ef=24)[1]))
    p = str(tmp_path / "hnsw.npz")
    idx.save(p)
    d2, i2 = S.ShardedHNSWIndex.load(p, mesh).knn_with_ef_batch(q, 7, ef=24)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    idx.default_ef = 33
    p2 = str(tmp_path / "hnsw.topo.npz")
    idx.save(p2, include_vectors=False)
    with pytest.warns(UserWarning, match="rebuild"):
        idx4 = S.ShardedHNSWIndex.load(p2, cpu_mesh(4), external_base=base)
    assert idx4.default_ef == 33
    np.testing.assert_array_equal(idx4.knn_with_ef_batch(q, 7, ef=300)[1], exact_ids(base, q, 7))
    with pytest.raises(ValueError):
        S.ShardedHNSWIndex.load(p2, cpu_mesh(4))


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


# ---- the harness's mesh path and the dry run ----


@pytest.mark.parametrize("algo", ["flat", "hnsw", "ivfpq"])
def test_harness_mesh_sweep_end_to_end(algo, tmp_path):
    """config/real1000_mesh8_{algo}.toml through the port's run_bench on an
    8-shard CPU mesh (the results file redirected into tmp_path): Flat's
    recall is exactly 1, HNSW's and IVF-PQ's useful; with an index cache a
    second run loads the sharded checkpoint.  HNSW runs the first 100 of
    the 1,000 queries (with their ground truth): its CPU beam gathers
    (B, 128, 960) rows per step and shard, ~50 s a sweep at 1,000."""
    from lab_1806_vec_db_tpu_torch.utils.candidates import GroundTruth

    root = os.path.abspath(ROOT)
    with open(os.path.join(root, "config", f"real1000_mesh8_{algo}.toml")) as f:
        text = f.read().replace('"data/', f'"{root}/data/')
    text = re.sub(r'(?m)^bench_output = .*$', f'bench_output = "{tmp_path / "results.toml"}"', text)
    text = re.sub(r'(?m)^index_cache = .*$', f'index_cache = "{tmp_path / "index.npz"}"', text)
    if algo == "hnsw":
        gt = GroundTruth.load(os.path.join(root, "data", "cli", "gnd.npz"))
        GroundTruth(gt.rows[:100]).save(tmp_path / "gnd100.npz")
        text = re.sub(r'(?m)^gnd_path = .*$', f'gnd_path = "{tmp_path / "gnd100.npz"}"', text)
        text = text.replace("[test]\n", "[test]\nlimit = 100\n")
    (tmp_path / "cfg.toml").write_text(text)
    cfg = BenchConfig.load_from_toml_file(tmp_path / "cfg.toml")
    assert cfg.mesh == 8
    res = harness.run_bench(cfg, device="cpu")
    floor = {"flat": 1.0, "hnsw": 0.9, "ivfpq": 0.5}[algo]
    assert min(res["recall"]) >= floor and res["build_seconds"] is not None
    assert (tmp_path / "index.npz").exists() and (tmp_path / "results.toml").exists()
    res2 = harness.run_bench(cfg, device="cpu")
    assert res2["build_seconds"] is None
    if algo != "hnsw":  # the HNSW cache holds the same graphs
        assert res2["recall"] == res["recall"]


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_graft_entry_compiles(n_shards):
    """dryrun_multichip, the counterpart of __graft_entry__.py's: every
    sharded path on tiny shapes against its exact oracle."""
    dryrun_multichip(n_shards, "cpu")
