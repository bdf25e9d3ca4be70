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
from lab_1806_vec_db_tpu_torch.bench.beam_states import edge_state
from lab_1806_vec_db_tpu_torch.ops import beam as BM
from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


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


# ---- the CUDA kernels' algorithms, emulated on the CPU --------------------
# K5 (csrc/beam_post.cu) merges by rank and K4 (csrc/beam_pre.cu) dedups
# through hash tables; the emulations below follow those algorithms step by
# step and must give the plain versions' (and the JAX twins') outputs.

def _order_key(d: torch.Tensor) -> torch.Tensor:
    """K5's order key as int64: monotone in the float order, -0 and +0 one
    key, NaN the largest."""
    u = torch.where(d == 0, torch.zeros_like(d), d).view(torch.int32).long() & 0xFFFFFFFF
    k = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(torch.isnan(d), torch.full_like(k, 0xFFFFFFFF), k)


def _k5_emulated(beam_d, beam_i, beam_e, nd, nids, ef, E):
    """K5's algorithm: keep the tile lanes with d < +inf, sort them by
    (d, lane), place each key by co-rank (searchsorted over the other sorted
    side), write the positions < min(ef, W), then re-mask and select."""
    B, W = beam_d.shape
    m = min(ef, W)
    d = torch.full((B, W), float("inf"))
    i = torch.full((B, W), -1, dtype=torch.int32)
    e = torch.zeros((B, W), dtype=torch.int32)
    for b in range(B):
        live = (nd[b] < float("inf")).nonzero()[:, 0]
        tkey, order = torch.sort(_order_key(nd[b, live]) * W + live)
        lanes = live[order]
        bkey = _order_key(beam_d[b, :m]) * W  # a beam key sits below an equal tile key
        pos_t = torch.arange(len(lanes)) + torch.searchsorted(bkey, tkey, right=True)
        pos_b = torch.arange(m) + torch.searchsorted(tkey, bkey, right=False)
        for pos, src_d, src_i, src_e in ((pos_t, nd[b, lanes], nids[b, lanes], torch.zeros_like(lanes)),
                                         (pos_b, beam_d[b, :m], beam_i[b, :m], beam_e[b, :m])):
            keep = pos < m
            d[b, pos[keep]], i[b, pos[keep]], e[b, pos[keep]] = src_d[keep], src_i[keep], src_e[keep].int()
    alive = torch.isfinite(d) & (i >= 0)
    d, i, e = d.masked_fill(~alive, float("inf")), i.masked_fill(~alive, -1), e.masked_fill(~alive, 0)
    unexp = (e == 0) & (i >= 0)
    selm = unexp & (torch.cumsum(unexp, 1) <= E)
    sel = torch.full((B, 128), -1, dtype=torch.int32)
    for b in range(B):
        ids = i[b, selm[b]]
        sel[b, : len(ids)] = ids
    return d, i, e | selm.int(), sel


@pytest.mark.parametrize("W,ef,E,EL", [(128, 100, 1, 128), (128, 128, 4, 128), (1024, 600, 8, 128),
                                       (1024, 1024, 4, 128), (1024, 600, 4, 256)])
def test_k5_merge_by_rank_emulated(W, ef, E, EL):
    rng = np.random.default_rng(W + ef + E)
    beam_d, beam_i, beam_e, _, _, _, nd, nids = edge_state(rng, 24, W, 256, EL, E, ef)
    args = _t(beam_d, beam_i, beam_e, nd, nids)
    want = BF.beam_post_ref(*args, ef, E)
    got = _k5_emulated(*args, ef, E)
    jax_want = PB.beam_post_ref(*map(jnp.asarray, (beam_d, beam_i, beam_e, nd, nids)), ef=ef, E=E)
    for name, a, b, c in zip(("d", "i", "e", "sel"), got, want, jax_want):
        assert torch.equal(a, b), name
        np.testing.assert_array_equal(b.numpy(), np.asarray(c), err_msg=name)
    # the states hold what they are meant to
    assert (nd[::4] == np.inf).all() and (W <= 128 or ((nd < np.inf).sum(1) > 128).any())
    assert (np.isneginf(nd).any() and np.isneginf(beam_d).any()
            and ((beam_d == np.inf) & (beam_i >= 0)).any() and ((nd < np.inf) & (nids < 0)).any())


def test_k5_emulated_empty_tile_and_ties():
    """The loop's first call (an empty tile) and a tile whose every live key
    ties a beam key or another tile key."""
    rng = np.random.default_rng(11)
    B, W, ef, E = 8, 128, 100, 4
    beam_d, beam_i, beam_e, _, _, _, _, _ = edge_state(rng, B, W, 256, 128, E, ef)
    for nd in (np.full((B, W), np.inf, np.float32), np.repeat(beam_d[:, :1], W, 1)):
        nids = np.where(nd < np.inf, rng.integers(0, 5000, (B, W)), -1).astype(np.int32)
        args = _t(beam_d, beam_i, beam_e, nd, nids)
        for a, b in zip(_k5_emulated(*args, ef, E), BF.beam_post_ref(*args, ef, E)):
            assert torch.equal(a, b)


def _table_insert(table, h, id_):
    s = h(id_)
    while table[s] not in (-1, id_):
        s = (s + 1) % len(table)
    table[s] = id_
    return s


def _table_contains(table, h, id_):
    s = h(id_)
    while table[s] != -1:
        if table[s] == id_:
            return True
        s = (s + 1) % len(table)
    return False


def _k4_emulated(beam_i, ring, selq, nbrs, E, tiny, rng):
    """K4's algorithm: the beam's and the ring's ids >= 0 in an
    open-addressing set, the tile's ids in a second table that keeps each
    id's smallest lane, both filled in a random order (the kernel's threads
    race); a lane is fresh iff its id is >= 0, missing from the set and the
    lane is its id's smallest.  `tiny` sizes both tables just above their
    distinct ids and hashes to 4 buckets, so probes collide at length."""
    B, W = beam_i.shape
    R, EL = ring.shape[1], nbrs.shape[1]

    def table(n_ids, n_kernel):
        size = 1
        while size < (n_ids + 1 if tiny else n_kernel):
            size *= 2
        log2 = size.bit_length() - 1
        h = ((lambda x: (x % 4) * size // 4) if tiny
             else (lambda x: ((x * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - log2)))
        return [-1] * size, h

    comp = np.full((B, W), -1, np.int32)
    cnt = np.zeros((B, 128), np.int32)
    for b in range(B):
        held = [int(v) for v in np.concatenate([beam_i[b], ring[b]]) if v >= 0]
        s_set, h_set = table(len(set(held)), 2 * (W + R))
        for v in rng.permutation(held) if held else []:
            _table_insert(s_set, h_set, int(v))
        tile = [int(v) for v in nbrs[b]]
        s_tid, h_tid = table(len({v for v in tile if v >= 0}), 2 * EL)
        s_lane = [EL] * len(s_tid)
        slot = {}
        for t in rng.permutation(EL):
            if tile[t] >= 0:
                slot[t] = _table_insert(s_tid, h_tid, tile[t])
                s_lane[slot[t]] = min(s_lane[slot[t]], int(t))
        fresh = [t for t in range(EL) if tile[t] >= 0 and s_lane[slot[t]] == t
                 and not _table_contains(s_set, h_set, tile[t])]
        comp[b, : len(fresh)] = [tile[t] for t in fresh]
        cnt[b] = len(fresh)
    return comp, np.concatenate([selq[:, :E], ring[:, : R - E]], 1), cnt


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("W,R,EL,E,ef", [(128, 256, 128, 4, 100), (1024, 256, 128, 4, 600),
                                         (256, 128, 256, 8, 256)])
def test_k4_hash_dedup_emulated(W, R, EL, E, ef, tiny):
    rng = np.random.default_rng(W + R + EL)
    _, beam_i, _, ring, selq, nbrs, _, _ = edge_state(rng, 12, W, R, EL, E, ef)
    want = BF.beam_pre(*_t(beam_i, ring, selq, nbrs), E)
    jax_want = PB.beam_pre_ref(*map(jnp.asarray, (beam_i, ring, selq, nbrs)), E=E)
    got = _k4_emulated(beam_i, ring, selq, nbrs, E, tiny, rng)
    for name, a, b, c in zip(("comp", "ring", "cnt"), got, want, jax_want):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
        np.testing.assert_array_equal(b.numpy(), np.asarray(c), err_msg=name)
    # dup-heavy rows, ring holes and the beam's -1 tail are present
    assert len(np.unique(nbrs[1])) <= 20 and (ring < 0).any() and (beam_i < 0).any()


@pytest.mark.parametrize("make", ["random_state", "loop_state", "edge_state"])
def test_beam_states_plain_and_emulated_agree(make):
    """Every generator of `bench/beam_states.py` (the smoke's and
    time_adc.py's states) at the HNSW+PQ graph route's ef 600 shape, B cut
    to 6: the plain K4 / K5 equal the JAX twins and the emulated kernels."""
    from lab_1806_vec_db_tpu_torch.bench import beam_states

    rng = np.random.default_rng(6)
    W, R, EL, E, ef = 1024, 256, 128, 4, 600
    beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids = getattr(beam_states, make)(
        rng, 6, W, R, EL, E, ef, 200_000)
    assert (beam_d[:, 1:] >= beam_d[:, :-1]).all()  # the beam is ascending
    pre = BF.beam_pre(*_t(beam_i, ring, selq, nbrs), E)
    for a, b, c in zip(pre, PB.beam_pre_ref(*map(jnp.asarray, (beam_i, ring, selq, nbrs)), E=E),
                       _k4_emulated(beam_i, ring, selq, nbrs, E, False, rng)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), c)
    args = _t(beam_d, beam_i, beam_e, nd, nids)
    post = BF.beam_post(*args, ef, E)
    jax_post = PB.beam_post_ref(*map(jnp.asarray, (beam_d, beam_i, beam_e, nd, nids)), ef=ef, E=E)
    for a, b, c in zip(post, jax_post, _k5_emulated(*args, ef, E)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(a, c)
