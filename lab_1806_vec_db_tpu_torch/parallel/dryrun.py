"""A dry run of every sharded path on tiny shapes, each against an exact
oracle (the counterpart of the JAX package's `__graft_entry__.py:
dryrun_multichip`, with the same checks at the same sizes).

    python -m lab_1806_vec_db_tpu_torch.parallel.dryrun [n_shards] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from . import sharded as S
from ..utils.config import HNSWConfig, IVFConfig, PQConfig


def dryrun_multichip(n_shards: int, device="cuda") -> None:
    """Build an `n_shards` mesh on `device` and run the sharded Flat scan
    (exact and two-stage), one sharded Lloyd step, the sharded IVF (k-means
    fit + sharded refinement), HNSW and IVF-PQ, asserting that the
    exhaustive settings return the exact kNN ids; raises AssertionError on
    a disagreement."""
    mesh = S.make_mesh(n_shards, device=device)
    rng = np.random.default_rng(0)
    N, dim, k_clusters, B, k = 64 * n_shards, 32, 4, 8, 5
    base = rng.standard_normal((N, dim)).astype(np.float32)
    queries = rng.standard_normal((B, dim)).astype(np.float32)
    exact_ids = np.argsort(((base[None] - queries[:, None]) ** 2).sum(-1), axis=1)[:, :k]

    # sharded exact kNN: per-shard blocked scan + the merge
    index = S.ShardedFlatIndex(mesh, base, "l2sqr")
    d, i = index.knn_batch(queries, k)
    assert d.shape == (B, k) and i.shape == (B, k)
    assert (i >= 0).all() and (i < N).all()
    diff = base[i] - queries[:, None, :]
    d_exact = np.sort((diff * diff).sum(-1), axis=1)
    full = base[None] - queries[:, None, :]
    d_all = np.sort((full * full).sum(-1), axis=1)[:, :k]
    np.testing.assert_allclose(np.sort(d, axis=1), d_all, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.sort(d, axis=1), d_exact, rtol=1e-4, atol=1e-4)

    # the two-stage path: per-shard bf16 candidates + exact distances
    d2, i2 = index.knn_batch(queries, k, exact=False)
    assert d2.shape == (B, k) and i2.shape == (B, k)

    # one data-parallel Lloyd step (per-shard partials summed on the lead)
    new_c = S.kmeans_step_sharded(index.base, index.n_local, base[:k_clusters], "l2sqr", mesh)
    assert tuple(new_c.shape) == (k_clusters, dim) and bool(new_c.isfinite().all())

    # sharded IVF: with every list probed the search is exhaustive
    ivf = S.ShardedIVFIndex(mesh, base, "l2sqr", IVFConfig(k=k_clusters), seed=0, refine_steps=1)
    d3, i3 = ivf.knn_batch(queries, k, n_probes=2)
    assert d3.shape == (B, k) and (i3 >= 0).all() and (i3 < N).all()
    np.testing.assert_array_equal(ivf.knn_batch(queries, k, n_probes=k_clusters)[1], exact_ids)

    # sharded HNSW: at ef >= every shard's rows each beam is exhaustive
    hnsw = S.ShardedHNSWIndex(mesh, base, "l2sqr", HNSWConfig(M=4), seed=0)
    d4, i4 = hnsw.knn_with_ef_batch(queries, k, ef=16)
    assert d4.shape == (B, k) and (i4 >= 0).all() and (i4 < N).all()
    np.testing.assert_array_equal(hnsw.knn_with_ef_batch(queries, k, ef=N)[1], exact_ids)

    # sharded IVF-PQ: every list probed, a dense overflow scan and the exact
    # refine return the exact kNN ids
    sivfpq = S.ShardedIVFPQIndex(mesh, base, "l2sqr", nlist=4,
                                 pq_config=PQConfig(n_bits=4, m=16, dist="l2sqr", k_means_size=N),
                                 sample_rows=N, block_rows=64, seed=0)
    d5, i5 = sivfpq.knn_batch(queries, k, n_probes=4, ef=N, chunk=1)
    assert d5.shape == (B, k)
    np.testing.assert_array_equal(i5, exact_ids)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry run of every sharded path on tiny shapes")
    ap.add_argument("n_shards", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_shards, args.device)
    print(f"dryrun_multichip({args.n_shards}, {args.device!r}): ok")


if __name__ == "__main__":
    main()
