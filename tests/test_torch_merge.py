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
from lab_1806_vec_db_tpu_torch.ops import beam as BM
from lab_1806_vec_db_tpu_torch.ops import merge as M


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
