"""K4 / K5 (the fused lock-step beam body) and the lock-step loops of the
PyTorch port against the JAX package, on the CPU.

On CPU tensors the port's wrappers run the kernels' plain versions; the CUDA
kernels are held against those on the card by `chip_smoke.py`.  K4 and K5
only compare and move values, so their plain versions must equal the JAX
package's XLA twins bit for bit.  The loops take their node distances from
each package's own f32 arithmetic, so distances agree to rtol 1e-6 and ids
exactly (the data has no near-ties at that level)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import beam as JBM
from lab_1806_vec_db_tpu.ops import pallas_beam as PB
from lab_1806_vec_db_tpu_torch.ops import beam as BM
from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF


def _rand_state(rng, B=40, W=128, R=256, EL=128, E=4, N=5000, ef=100):
    """The inputs of tests/test_pallas_beam.py:_rand_state, with the beam's
    live width `ef` as a parameter."""
    beam_i = rng.integers(0, N, (B, W)).astype(np.int32)
    beam_i[:, ef:] = -1
    beam_d = np.sort(rng.random((B, W)).astype(np.float32), axis=1)
    beam_d[beam_i < 0] = np.inf
    beam_e = (rng.random((B, W)) < 0.5).astype(np.int32)
    beam_e[beam_i < 0] = 0
    ring = rng.integers(-1, N, (B, R)).astype(np.int32)
    selq = np.full((B, 128), -1, np.int32)
    selq[:, :E] = rng.integers(-1, N, (B, E))
    nbrs = rng.integers(-1, N, (B, EL)).astype(np.int32)
    nbrs[:, 3] = beam_i[:, 0]
    nbrs[:, 5] = ring[:, 2]
    nbrs[:, 7] = nbrs[:, 1]
    return beam_d, beam_i, beam_e, ring, selq, nbrs


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("ef", [100, 180])
@pytest.mark.parametrize("E,EL,W", [(4, 128, 128), (8, 256, 256)])
def test_beam_pre_plain_equals_reference(E, EL, W, ef):
    rng = np.random.default_rng(0)
    _, beam_i, _, ring, selq, nbrs = _rand_state(rng, W=W, EL=EL, E=E, ef=min(ef, W))
    expect = PB.beam_pre_ref(*map(jnp.asarray, (beam_i, ring, selq, nbrs)), E=E)
    got = BF.beam_pre(*_t(beam_i, ring, selq, nbrs), E)
    for name, a, b in zip(("comp", "ring", "cnt"), expect, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("ef", [100, 180])
@pytest.mark.parametrize("E,W", [(4, 128), (8, 256)])
def test_beam_post_plain_equals_reference(E, W, ef):
    rng = np.random.default_rng(1)
    beam_d, beam_i, beam_e, _, _, _ = _rand_state(rng, W=W, E=E, ef=min(ef, W))
    nd = rng.random((40, W)).astype(np.float32)
    nids = rng.integers(-1, 5000, (40, W)).astype(np.int32)
    nd[nids < 0] = np.inf
    nd[:, 10] = nd[:, 11] = beam_d[:, 2]  # exact ties with the beam and in the tile
    expect = PB.beam_post_ref(*map(jnp.asarray, (beam_d, beam_i, beam_e, nd, nids)), ef=ef, E=E)
    got = BF.beam_post(*_t(beam_d, beam_i, beam_e, nd, nids), ef, E)
    for name, a, b in zip(("d", "i", "e", "sel"), expect, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_beam_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(2)
    beam_d, beam_i, beam_e, ring, selq, nbrs = _t(*_rand_state(rng))
    with pytest.raises(TypeError):
        BF.beam_pre(beam_i.long(), ring, selq, nbrs, 4)
    with pytest.raises(ValueError):
        BF.beam_pre(beam_i, ring, selq[:, :64], nbrs, 4)
    with pytest.raises(ValueError):
        BF.beam_pre(beam_i, ring, selq, nbrs[:, :100], 4)  # EL not a multiple of 32
    with pytest.raises(ValueError):
        BF.beam_post(beam_d[:, :96], beam_i[:, :96], beam_e[:, :96], beam_d[:, :96],
                     beam_i[:, :96], 50, 4)  # W not a power of two
    with pytest.raises(TypeError):
        BF.beam_post(beam_d.double(), beam_i, beam_e, beam_d, beam_i, 50, 4)


def _knn_graph(rng, N=400, dim=16, L=8):
    vecs = rng.standard_normal((N, dim)).astype(np.float32)
    d2 = ((vecs[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return vecs, np.argsort(d2, axis=1)[:, :L].astype(np.int32)


def _fns(vecs, links, queries):
    """Node-distance and links functions for both packages."""
    vj, lj, qj = jnp.asarray(vecs), jnp.asarray(links), jnp.asarray(queries)
    vt, lt, qt = _t(vecs, links, queries)

    def nd_j(ids):
        d = jnp.sum((vj[jnp.maximum(ids, 0)] - qj[:, None, :]) ** 2, axis=-1)
        return jnp.where(ids >= 0, d, jnp.inf)

    def nd_t(ids):
        d = ((vt[ids.clamp_min(0).long()] - qt[:, None, :]) ** 2).sum(-1)
        return torch.where(ids >= 0, d, float("inf"))

    return (nd_j, lambda ids: lj[ids]), (nd_t, lambda ids: lt[ids.long()])


@pytest.mark.parametrize("expand,ef", [(4, 24), (2, 40)])
def test_fused_loop_matches_reference(expand, ef):
    rng = np.random.default_rng(4)
    vecs, links = _knn_graph(rng, N=300)
    queries = rng.standard_normal((8, vecs.shape[1])).astype(np.float32)
    (nd_j, lf_j), (nd_t, lf_t) = _fns(vecs, links, queries)
    entry = np.zeros(8, np.int32)
    d_r, i_r, rows_r = JBM.beam_search_fused(jnp.asarray(entry), nd_j, lf_j, ef, max_iters=100,
                                             expand=expand, ring_size=128, use_kernels=False,
                                             with_stats=True)
    d_t, i_t, rows_t = BM.beam_search_fused(torch.from_numpy(entry), nd_t, lf_t, ef, max_iters=100,
                                            expand=expand, ring_size=128, with_stats=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_r))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_r), rtol=1e-6)


@pytest.mark.parametrize("expand,ring", [(1, 64), (4, 128)])
def test_classic_loop_matches_reference(expand, ring):
    rng = np.random.default_rng(3)
    vecs, links = _knn_graph(rng)
    queries = rng.standard_normal((16, vecs.shape[1])).astype(np.float32)
    (nd_j, lf_j), (nd_t, lf_t) = _fns(vecs, links, queries)
    entry = np.zeros(16, np.int32)
    d_r, i_r, rows_r = JBM.beam_search(jnp.asarray(entry), nd_j, lf_j, 32, max_iters=200,
                                       expand=expand, ring_size=ring, with_stats=True)
    d_t, i_t, rows_t = BM.beam_search(torch.from_numpy(entry), nd_t, lf_t, 32, max_iters=200,
                                      expand=expand, ring_size=ring, with_stats=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_r))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_r), rtol=1e-6)


def test_greedy_descent_matches_reference():
    rng = np.random.default_rng(5)
    vecs, links = _knn_graph(rng, N=300, L=4)
    queries = rng.standard_normal((32, vecs.shape[1])).astype(np.float32)
    (nd_j, lf_j), (nd_t, lf_t) = _fns(vecs, links, queries)
    entry = rng.integers(0, 300, 32).astype(np.int32)
    expect = JBM.greedy_descent(jnp.asarray(entry), nd_j, lambda ids: lf_j(ids), 64)
    got = BM.greedy_descent(torch.from_numpy(entry), nd_t, lambda ids: lf_t(ids), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_loops_count_their_host_syncs():
    rng = np.random.default_rng(6)
    vecs, links = _knn_graph(rng, N=200)
    queries = rng.standard_normal((4, vecs.shape[1])).astype(np.float32)
    _, (nd_t, lf_t) = _fns(vecs, links, queries)
    BM.host_syncs.update(beam=0, greedy=0)
    _, _, rows = BM.beam_search_fused(torch.zeros(4, dtype=torch.int32), nd_t, lf_t, 16,
                                      max_iters=500, expand=4, ring_size=128, with_stats=True)
    # one read per iteration run, plus the read that found the loop done
    assert 1 < BM.host_syncs["beam"] < 500
    assert (rows > 16).all() and (rows <= 201).all()
