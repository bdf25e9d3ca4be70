"""The sharded HNSW of the PyTorch port (parallel/sharded.py) against the JAX
package's, on the CPU: search on the JAX package's graph, exhaustive ef,
the parallel build, empty shards and checkpoints.

The JAX package's mesh is the conftest's 8-device host mesh; the port's is
`make_mesh(n, device="cpu")`, n shards on the CPU, where the kernel
wrappers run their plain versions.  JAX HNSW graphs stay at <= 800 rows."""

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.parallel import sharded as JS
from lab_1806_vec_db_tpu.utils.config import HNSWConfig as JHNSWConfig
from lab_1806_vec_db_tpu_torch.parallel import sharded as S
from lab_1806_vec_db_tpu_torch.utils.config import HNSWConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def cpu_mesh(n):
    return S.make_mesh(n, device="cpu")


def exact_ids(base, q, k):
    return np.argsort(((base[None] - q[:, None]) ** 2).sum(-1), axis=1, kind="stable")[:, :k]


def _twins(x):
    _, inverse, counts = np.unique(x, axis=0, return_inverse=True, return_counts=True)
    return np.flatnonzero(counts[inverse.ravel()] > 1)


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
