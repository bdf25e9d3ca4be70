"""k-means of the PyTorch port (`ops/kmeans.py`, `models/kmeans.py`) against
the JAX package, on the CPU.

jax.random and torch draw different numbers, so the port's k-means++ seeding
cannot reproduce the reference's; `lloyd` is held against the reference
from the reference's own seeds instead (its `kmeans_fit` with max_iter=0),
to rtol 1e-5: the same assignments, centroid sums that differ only in f32
summation order.  Nearest-centroid ids must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.ops import kmeans as JKM
from lab_1806_vec_db_tpu.ops import pq as JP
from lab_1806_vec_db_tpu_torch.models import KMeans
from lab_1806_vec_db_tpu_torch.ops import kmeans as KM
from lab_1806_vec_db_tpu_torch.utils.config import KMeansConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("n_valid", [512, 400])
def test_lloyd_from_reference_init_equals_reference(dist, n_valid, gist_1000):
    data = gist_1000[:512, 100:108].copy()
    key = jax.random.PRNGKey(3)
    args = (jnp.asarray(data), jnp.int32(n_valid), 16)
    init = np.array(JKM.kmeans_fit(key, *args, 0, 1e-6, dist))
    expect = np.asarray(JKM.kmeans_fit(key, *args, 20, 1e-6, dist))
    got = KM.lloyd(torch.from_numpy(data.copy()), n_valid, torch.from_numpy(init), 20, 1e-6, dist)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_batched_lloyd_equals_reference_per_subspace(dist, gist_1000):
    """All m PQ subspaces in one call equal the reference's vmapped k-means
    (its `train_codebooks`), each stopping on its own tol."""
    dim, m = 24, 8
    data = gist_1000[:300, :dim].copy()
    idx, mask, _ = JP.group_gather_indices(dim, m)
    grouped = JP.regroup(jnp.asarray(data), jnp.asarray(idx), jnp.asarray(mask))
    key = jax.random.PRNGKey(0)
    init = np.array(JP.train_codebooks(key, grouped, jnp.int32(300), 16, 0, 1e-6, dist))
    expect = np.asarray(JP.train_codebooks(key, grouped, jnp.int32(300), 16, 20, 1e-6, dist))
    got = KM.lloyd(torch.from_numpy(np.asarray(grouped)), 300, torch.from_numpy(init), 20, 1e-6,
                   dist)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_find_nearest_and_n_nearest_match_reference(dist, gist_1000):
    vecs = gist_1000[:200, :16].copy()
    cents = gist_1000[300:332, :16].copy()
    expect = np.asarray(JKM.find_nearest(jnp.asarray(vecs), jnp.asarray(cents), dist))
    got = KM.find_nearest(torch.from_numpy(vecs), torch.from_numpy(cents), dist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)
    ed, ei = JKM.find_n_nearest(jnp.asarray(vecs), jnp.asarray(cents), 5, dist)
    gd, gi = KM.find_n_nearest(torch.from_numpy(vecs), torch.from_numpy(cents), 5, dist)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
    np.testing.assert_allclose(gd.numpy(), np.asarray(ed), rtol=1e-5, atol=1e-6)


def test_kmeanspp_init_seeding():
    """Seeds are valid data rows, distinct on distinct data, reproducible
    from the generator's seed; all-equal rows fall back to uniform."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 200, 4)).astype(np.float32))
    a = KM.kmeanspp_init(x, 150, 16, "l2sqr", torch.Generator().manual_seed(5))
    b = KM.kmeanspp_init(x, 150, 16, "l2sqr", torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    for p in range(3):
        rows = {tuple(r) for r in x[p, :150].numpy().tolist()}
        seeds = [tuple(r) for r in a[p].numpy().tolist()]
        assert all(s in rows for s in seeds) and len(set(seeds)) == 16
    same = torch.ones((1, 50, 4))
    c = KM.kmeanspp_init(same, 50, 8, "l2sqr", torch.Generator().manual_seed(0))
    assert torch.equal(c, torch.ones((1, 8, 4)))


def test_kmeans_class(gist_1000):
    """The component class: fits on its device, `selected` restricts the
    dims, and its nearest-centroid queries agree with one another."""
    vecs = gist_1000[:300, :32].copy()
    km = KMeans.from_numpy(vecs, KMeansConfig(k=8, selected=(4, 20)), seed=1, device="cpu")
    assert km.centroids.shape == (8, 16)
    ids = km.find_nearest_batch(vecs[:10])
    assert [km.find_nearest(v) for v in vecs[:10]] == ids.tolist()
    assert km.find_n_nearest(vecs[0], 3)[0] == ids[0]
    with pytest.raises(ValueError):
        KMeans.from_numpy(vecs, KMeansConfig(k=0), device="cpu")
