"""HNSW link selection (ops/graph.py) of the PyTorch port against the JAX
package's, on the CPU.

The pools are full of exact ties: distances drawn from a few integers for the
heuristic, and vectors with small integer coordinates for the arrange step
(their dot products and norms are exact in f32 in both packages), so the
selections are held to equal ids, ties broken by position as `lax.top_k`
breaks them."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import graph as JG
from lab_1806_vec_db_tpu_torch.ops import graph as GR

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _tied_pool(rng, B=64, C=24, n_ids=500):
    ids = np.stack([rng.choice(n_ids, C, replace=False) for _ in range(B)]).astype(np.int32)
    ids[:, -3:] = -1
    d = rng.integers(0, 4, (B, C)).astype(np.float32)
    d[ids < 0] = np.inf
    order = np.argsort(d, axis=1, kind="stable")
    ids, d = np.take_along_axis(ids, order, 1), np.take_along_axis(d, order, 1)
    pair = rng.integers(0, 5, (B, C, C)).astype(np.float32)
    pair = np.minimum(pair, pair.transpose(0, 2, 1))
    pair[(ids < 0)[:, :, None] | (ids < 0)[:, None, :]] = np.inf
    return ids, d, pair


@pytest.mark.parametrize("limit", [4, 8, 30])
def test_heuristic_select_matches_reference(limit):
    ids, d, pair = _tied_pool(np.random.default_rng(limit))
    sel_j, keep_j = JG.heuristic_select(jnp.asarray(ids), jnp.asarray(d), jnp.asarray(pair), limit)
    sel_t, keep_t = GR.heuristic_select(*(torch.from_numpy(a) for a in (ids, d, pair)), limit)
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def test_sort_candidates_and_duplicates():
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 20, (16, 30)).astype(np.int32)
    d = rng.integers(0, 3, (16, 30)).astype(np.float32)
    si_j, sd_j = JG.sort_candidates(jnp.asarray(ids), jnp.asarray(d))
    si_t, sd_t = GR.sort_candidates(torch.from_numpy(ids), torch.from_numpy(d))
    np.testing.assert_array_equal(si_t.numpy(), np.asarray(si_j))
    np.testing.assert_array_equal(sd_t.numpy(), np.asarray(sd_j))
    # later copies of a valid id, found without a (B, C, C) compare
    dup = GR.later_duplicates(torch.from_numpy(ids)).numpy()
    brute = np.array([[x >= 0 and x in row[:j] for j, x in enumerate(row)] for row in ids])
    np.testing.assert_array_equal(dup, brute)


def _int_vectors(rng, n=300, dim=8):
    v = rng.integers(-3, 4, (n, dim)).astype(np.float32)
    v[v.sum(1) == 0, 0] = 1.0  # no zero rows (cosine)
    return v


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pairwise_among_matches_reference(dist):
    rng = np.random.default_rng(2)
    vecs = _int_vectors(rng)
    ids = rng.integers(-1, 300, (8, 20)).astype(np.int32)
    expect = JG.pairwise_among(jnp.asarray(vecs), jnp.asarray(ids), dist)
    got = GR.pairwise_among(torch.from_numpy(vecs), torch.from_numpy(ids), dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-6, atol=1e-6)


def _arrange_inputs(rng, P=32, width=8, A=16, n=300):
    rows = np.full((P, width), -1, np.int32)
    new = np.full((P, A), -1, np.int32)
    piv = rng.choice(n, P, replace=False).astype(np.int32)
    for p in range(P):
        k = rng.integers(0, width + 1)
        rows[p, :k] = rng.choice(n, k, replace=False)
        a = rng.integers(1, A + 1)
        new[p, :a] = rng.integers(0, n, a)  # may repeat ids already linked
    return piv, rows, new


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_arrange_links_batch_matches_reference(dist):
    rng = np.random.default_rng(3)
    vecs = _int_vectors(rng)
    piv, rows, new = _arrange_inputs(rng)
    expect = JG.arrange_links_batch(jnp.asarray(vecs), jnp.asarray(rows), jnp.asarray(piv),
                                    jnp.asarray(new), dist, 8)
    got = GR.arrange_links_batch(*(torch.from_numpy(a) for a in (vecs, rows, piv, new)), dist, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_arrange_links_inplace_matches_reference(dist):
    """Padding pivots (ids >= cap) are dropped, never written."""
    rng = np.random.default_rng(4)
    vecs = _int_vectors(rng)
    cap = len(vecs)
    links = np.full((cap, 8), -1, np.int32)
    links[:, :5] = rng.integers(0, cap, (cap, 5))
    piv, _, new = _arrange_inputs(rng, P=24)
    piv_new = np.full((32, 1 + new.shape[1]), -1, np.int32)
    piv_new[:, 0] = cap  # rows 24..31: padding
    piv_new[:24, 0] = piv
    piv_new[:24, 1:] = new
    expect = np.asarray(JG.arrange_links_inplace(jnp.asarray(vecs), jnp.asarray(links),
                                                 jnp.asarray(piv_new), dist, 8))
    links_t = torch.from_numpy(links.copy())
    out = GR.arrange_links_inplace(torch.from_numpy(vecs), links_t, torch.from_numpy(piv_new),
                                   dist, 8)
    assert out is links_t  # written in place
    np.testing.assert_array_equal(links_t.numpy(), expect)
    untouched = np.setdiff1d(np.arange(cap), piv)
    np.testing.assert_array_equal(links_t.numpy()[untouched], links[untouched])
