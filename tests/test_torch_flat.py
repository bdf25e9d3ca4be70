"""FlatIndex of the PyTorch port against the JAX package's FlatIndex.

- the exact path on the bundled gist_1000 slice: ids equal, distances to
  rtol 1e-5 (both are f32 GEMMs with cached norms, summed in other orders);
- the forced two-stage path against the JAX package's TPU pipeline composed
  by hand on the CPU (`device_int8` -> packed scan in interpret mode ->
  `decode_perm` -> DMA rerank in interpret mode): ids equal wherever the
  distances do not tie, distances to rtol 1e-5;
- checkpoints written by either package load in the other.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.models import FlatIndex as JFlatIndex
from lab_1806_vec_db_tpu.ops import pallas_gather as PG
from lab_1806_vec_db_tpu.ops import pallas_scan as PS
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu_torch.models import FlatIndex, PQTable, VecStore
from lab_1806_vec_db_tpu_torch.ops import gather as G
from lab_1806_vec_db_tpu_torch.ops import scan as S
from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _untied(d):
    """Mask of result slots whose distance is not tied with a neighbour."""
    tied = np.isclose(d[:, :-1], d[:, 1:], rtol=1e-6, atol=0)
    mask = np.ones_like(d, dtype=bool)
    mask[:, :-1] &= ~tied
    mask[:, 1:] &= ~tied
    return mask


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_exact_path_matches_reference(dist, gist_1000):
    base, queries = gist_1000[:900], gist_1000[900:]
    jd, ji = JFlatIndex.from_numpy(base, dist).knn_batch(queries, 10)
    idx = FlatIndex.from_numpy(base, dist, device="cpu")
    d, i = idx.knn_batch(queries, 10)
    assert d.dtype == np.float32 and i.dtype == np.int32 and d.shape == (100, 10)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)
    # the single-query entry point is the exact path too
    pairs = idx.knn(queries[3], 10)
    assert [p.index for p in pairs] == ji[3].tolist()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_two_stage_path_matches_reference_pipeline(dist):
    n, dim, B, k = 5000, 128, 16, 10
    rng = np.random.default_rng(0)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((B, dim)).astype(np.float32)

    idx = FlatIndex.from_numpy(base, dist, device="cpu")
    r = idx.rerank_depth(k)
    assert r == 40
    d, i = idx.knn_batch(queries, k, exact=False)

    js = JFlatIndex.from_numpy(base, dist).store
    b8, sc, ca, perm = js.device_int8()
    _, cand = PS.scan_candidates_int8_packed(
        jnp.asarray(queries), b8, sc, ca, jnp.int32(b8.shape[0]), r, dist, interpret=True)
    cand = JT.decode_perm(cand, perm, jnp.int32(n))
    jd, ji = PG.rerank_topk_rs(
        jnp.asarray(queries), PG.prepare_rerank_base(js.device()[0]), cand, k, dist,
        interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)
    ok = _untied(jd)
    assert (i == ji)[ok].all()


def test_two_stage_path_runs_plain_kernels_on_cpu():
    """On CPU tensors the two-stage path reaches the kernels' plain versions
    and launches nothing; its answers are the exact scan's on easy data."""
    rng = np.random.default_rng(1)
    base = rng.standard_normal((3000, 64)).astype(np.float32)
    idx = FlatIndex.from_numpy(base, "l2sqr", device="cpu")
    k1, k2 = S.scan_chunkmin_int8_packed.launches, G.gather_dists.launches
    _, i2 = idx.knn_batch(base[:20], 1, exact=False)
    assert (S.scan_chunkmin_int8_packed.launches, G.gather_dists.launches) == (k1, k2)
    np.testing.assert_array_equal(i2[:, 0], np.arange(20))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_checkpoints_interchange(dist, tmp_path, gist_1000):
    base, queries = gist_1000[:200, :64], gist_1000[200:210, :64]
    JFlatIndex.from_numpy(base, dist).save(tmp_path / "jax.npz")
    FlatIndex.from_numpy(base, dist, device="cpu").save(tmp_path / "torch.npz")
    a = FlatIndex.load(tmp_path / "jax.npz", device="cpu")
    b = JFlatIndex.load(tmp_path / "torch.npz")
    assert len(a) == len(b) == 200 and a.dist == b.dist == dist
    np.testing.assert_array_equal(a.store.numpy(), b.store.numpy())
    da, ia = a.knn_batch(queries, 5)
    db, ib = b.knn_batch(queries, 5)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-6)


def test_from_device_matches_from_numpy(gist_1000):
    base = gist_1000[:300, :48]
    a = FlatIndex.from_numpy(base, "l2sqr", device="cpu")
    b = FlatIndex.from_store(VecStore.from_device(torch.from_numpy(base.copy()), "l2sqr"))
    da, ia = a.knn_batch(base[:8], 5)
    db, ib = b.knn_batch(base[:8], 5)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-6)
    assert a.index_bytes() == b.index_bytes()


def test_pq_search_is_not_ported():
    """Flat+PQ search (`knn_pq`): each row finds itself first, at its exact
    distance (the ADC candidates are reranked exactly)."""
    rows = np.random.default_rng(3).standard_normal((300, 8)).astype(np.float32)
    pq = PQTable.train(rows, PQConfig(n_bits=4, m=4, dist="l2sqr"), seed=0, device="cpu")
    idx = FlatIndex.from_numpy(rows, "l2sqr", device="cpu")
    for i in (0, 5, 299):
        first = idx.knn_pq(rows[i], 2, 10, pq)[0]
        assert first.index == i and abs(first.distance) < 1e-4
