"""K6 (the sorted-beam merge of the classic lock-step loop) of the PyTorch
port against the JAX package, on the CPU.

On CPU tensors `merge.merge_sorted` runs its plain version (a stable sort
of [beam, tile]); the CUDA kernel is held against that on the card by
`chip_smoke.py`.  K6 only compares and moves values, so every finite entry
must equal the reference's `merge_sorted(interpret=True)` bit for bit
(distances, ids and flags), ties included; the reference leaves its inf
tail's ids and flags unspecified, so only the tail's distances are held."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.ops import pallas_merge as PM
from lab_1806_vec_db_tpu_torch.bench import beam_states as BS
from lab_1806_vec_db_tpu_torch.ops import beam as BM
from lab_1806_vec_db_tpu_torch.ops import merge as M

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _state(rng, B, ef, EL, live, n=5000):
    """A sorted beam with `live` entries (inf / -1 / False after), random
    flags, and a scored tile with stale lanes and exact ties with the beam
    and within itself."""
    beam_d = np.sort(rng.random((B, ef)).astype(np.float32), axis=1)
    beam_i = rng.integers(0, n, (B, ef)).astype(np.int32)
    beam_e = rng.random((B, ef)) < 0.5
    beam_d[:, live:], beam_i[:, live:], beam_e[:, live:] = np.inf, -1, False
    nd = rng.random((B, EL)).astype(np.float32)
    nids = rng.integers(0, n, (B, EL)).astype(np.int32)
    stale = rng.random((B, EL)) < 0.3
    nd[stale], nids[stale] = np.inf, -1
    nd[:, 1] = beam_d[:, 0]  # a tie with the beam
    nd[:, 2] = nd[:, 5]  # a tie inside the tile
    nids[:, 1], nids[:, 2] = 7, 9
    return beam_d, beam_i, beam_e, nd, nids


def _check(expect, got):
    ed, ei, ee = (np.asarray(x) for x in expect)
    gd, gi, ge = (x.numpy() for x in got)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    np.testing.assert_array_equal(gd, ed)
    fin = np.isfinite(ed)
    np.testing.assert_array_equal(gi[fin], ei[fin])
    np.testing.assert_array_equal(ge[fin], ee[fin])


@pytest.mark.parametrize("B,ef,EL,live", [(40, 100, 128, 60), (17, 120, 32, 120), (8, 200, 128, 0),
                                          (5, 64, 256, 10)])
def test_merge_plain_equals_reference(B, ef, EL, live):
    rng = np.random.default_rng(ef + EL)
    st = _state(rng, B, ef, EL, live)
    expect = PM.merge_sorted(*map(jnp.asarray, st), interpret=True)
    launches = M.merge_sorted.launches
    got = M.merge_sorted(*(torch.from_numpy(a) for a in st))
    assert M.merge_sorted.launches == launches  # CPU tensors: the plain version
    _check(expect, got)


def test_merge_all_stale_tile_keeps_the_beam():
    rng = np.random.default_rng(3)
    beam_d, beam_i, beam_e, nd, nids = _state(rng, 6, 50, 64, 30)
    nd[:], nids[:] = np.inf, -1
    st = (beam_d, beam_i, beam_e, nd, nids)
    got = M.merge_sorted(*(torch.from_numpy(a) for a in st))
    _check(PM.merge_sorted(*map(jnp.asarray, st), interpret=True), got)
    np.testing.assert_array_equal(got[1].numpy()[:, :30], beam_i[:, :30])
    np.testing.assert_array_equal(got[2].numpy()[:, :30], beam_e[:, :30])


def test_merge_rejects_mismatched_operands():
    rng = np.random.default_rng(0)
    beam_d, beam_i, beam_e, nd, nids = (torch.from_numpy(a) for a in _state(rng, 4, 16, 32, 8))
    with pytest.raises(ValueError):
        M.merge_sorted(beam_d, beam_i, beam_e, nd, nids[:, :16])
    with pytest.raises(TypeError):
        M.merge_sorted(beam_d, beam_i, beam_e.int(), nd, nids)


def test_classic_loop_runs_its_merge_through_k6(monkeypatch):
    """The classic lock-step loop (the CPU route, and CUDA with fused=False)
    merges with `merge.merge_sorted` every iteration."""
    calls = []
    real = M.merge_sorted

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(M, "merge_sorted", spy)
    rng = np.random.default_rng(1)
    links = torch.from_numpy(rng.integers(0, 300, (300, 8)).astype(np.int32))
    pts = torch.from_numpy(rng.random((300, 4)).astype(np.float32))
    q = torch.from_numpy(rng.random((3, 4)).astype(np.float32))
    nd = lambda ids: ((pts[ids.clamp_min(0).long()] - q[:, None, :]) ** 2).sum(-1)
    d, i = BM.beam_search(torch.zeros(3, dtype=torch.int32), nd, lambda ids: links[ids.long()], 20,
                          50, expand=2, fused=False)
    assert calls and all(s == (3, 20) for s in calls)
    assert (torch.diff(d, dim=1)[torch.isfinite(d[:, 1:])] >= 0).all()


# ---- K6's algorithm (csrc/merge_sorted.cu), emulated on the CPU -----------
# The kernel merges by rank: no sort, every key's merged position counted.
# The emulation follows its passes step by step and must give the plain
# version's bits on every lane, the +inf / NaN tail included.

def _order_key(d: torch.Tensor) -> torch.Tensor:
    """beam_body.cuh's order_key as int64: monotone in the float order, -0
    and +0 one key, NaN the largest (as tests/test_torch_beam.py's)."""
    u = torch.where(d == 0, torch.zeros_like(d), d).view(torch.int32).long() & 0xFFFFFFFF
    k = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(torch.isnan(d), torch.full_like(k, 0xFFFFFFFF), k)


def _k6_emulated(beam_d, beam_i, beam_e, nd, nids):
    """Pass A: the beam's order keys and the tile keys (order key, lane);
    B: each tile key's rank is the count of tile keys below it, its
    order key goes to slot `rank` of the sorted tile, and rank + the beam
    keys at or below it is its position; C: beam lane j goes to j + the tile
    keys below it.  Positions < ef are written; each must be written once."""
    B, ef = beam_d.shape
    EL = nd.shape[1]
    d = torch.full((B, ef), float("nan"))
    i = torch.full((B, ef), -2, dtype=torch.int32)
    e = torch.zeros((B, ef), dtype=torch.bool)
    writes = torch.zeros((B, ef), dtype=torch.int64)
    for b in range(B):
        bkey = _order_key(beam_d[b])
        tord = _order_key(nd[b])
        tkey = tord * EL + torch.arange(EL)  # the kernel's u64 (order key << 32 | lane): one order
        rank = (tkey[None, :] < tkey[:, None]).sum(1)
        tsd = torch.empty(EL, dtype=torch.int64)
        tsd[rank] = tord
        pos_t = rank + torch.searchsorted(bkey, tord, right=True)
        pos_b = torch.arange(ef) + torch.searchsorted(tsd, bkey, right=False)
        for pos, src_d, src_i, src_e in ((pos_t, nd[b], nids[b], torch.zeros(EL, dtype=torch.bool)),
                                         (pos_b, beam_d[b], beam_i[b], beam_e[b])):
            keep = pos < ef
            d[b, pos[keep]], i[b, pos[keep]], e[b, pos[keep]] = src_d[keep], src_i[keep], src_e[keep]
            writes[b].index_add_(0, pos[keep], torch.ones(int(keep.sum()), dtype=torch.int64))
    assert (writes == 1).all()
    return d, i, e


@pytest.mark.parametrize("case", sorted(BS.MERGE_EDGE_CASES))
def test_k6_merge_by_rank_emulated(case):
    """The emulation equals the plain version bit for bit (d as bits, i, e)
    and the reference's interpret-mode kernel on every lane.  The
    reference's compare-exchange treats NaN as neither above nor equal to
    anything, so its network does not sort NaN inputs (even finite lanes
    come out of order); on `nan_tile` it runs with the NaN lanes as +inf,
    which sort just below NaN, and is held on the finite lanes.  (A tile key
    enters the output only below some beam key, so NaN tile lanes never do;
    the beam's NaN tail does, after the +inf tile lanes.)"""
    st = BS.merge_edge_state(np.random.default_rng(len(case)), case)
    args = [torch.from_numpy(a) for a in st]
    got, want = _k6_emulated(*args), M.merge_sorted(*args)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    beam_d, beam_i, beam_e, nd, nids = st
    nan = np.isnan(beam_d).any() or np.isnan(nd).any()
    jd, ji, je = (np.asarray(x) for x in PM.merge_sorted(
        *map(jnp.asarray, (np.where(np.isnan(beam_d), np.inf, beam_d), beam_i, beam_e,
                           np.where(np.isnan(nd), np.inf, nd), nids)), interpret=True))
    keep = np.isfinite(got[0].numpy()) if nan else np.ones(got[0].shape, bool)
    np.testing.assert_array_equal(got[0].numpy().view(np.int32)[keep], jd.view(np.int32)[keep])
    np.testing.assert_array_equal(got[1].numpy()[keep], ji[keep])
    np.testing.assert_array_equal(got[2].numpy()[keep], je[keep])
    # the states hold what they are meant to
    B, ef, EL = BS.MERGE_EDGE_CASES[case]
    assert beam_d.shape == (B, ef) and nd.shape == (B, EL)
    assert (np.diff(beam_d, axis=1)[np.isfinite(beam_d[:, 1:])] >= 0).all()
    held = {"signed_zero": lambda: (np.signbit(nd) & (nd == 0)).any() and ((nd == 0) & ~np.signbit(nd)).any()
                                   and (np.signbit(beam_d) & (beam_d == 0)).any(),
            "neg_inf": lambda: np.isneginf(beam_d).any() and np.isneginf(nd).any(),
            "inf_tails": lambda: ((beam_d == np.inf) & (beam_i >= 0)).any()
                                 and ((nd == np.inf) & (nids >= 0)).any(),
            "nan_tile": lambda: np.isnan(beam_d).any() and np.isnan(nd).any() and np.isnan(got[0].numpy()).any(),
            "stale_tile": lambda: (nd == np.inf).all(),
            "single_live": lambda: (beam_i[:, 1:] == -1).all() and (beam_i[:, 0] >= 0).all(),
            "wide_tile": lambda: EL > ef, "odd_ef": lambda: ef % 2 == 1, "one_query": lambda: B == 1,
            "ties": lambda: bool(np.isin(nd[np.isfinite(nd)], beam_d).any())}
    assert held[case]()
