"""K11 (the binned ADC chunk-min of IVF-PQ) and K7's chunk and selector
options, in the PyTorch port against the JAX package, on the CPU.

On CPU tensors the port's wrappers run the kernels' plain versions; the CUDA
kernels are held against those on the card by `chip_smoke.py`.  Both sides
take the same numpy inputs and the reference kernels run with
interpret=True.  The int8 sums are exact and both sides round the epilogue
in the same IEEE operations, so survivors and positions are EQUAL; where
the reference selects with `approx_min_k` (exact on the CPU, but its ties
come out in no defined order) the ids are equal up to the order and the
choice among equal distances.  The port
writes K11's survivors as (nlist, QB, lpad / chunk), the reference as
(nlist, lpad / chunk, QB); bin columns without a query are compared nowhere
(the reference scores them against query 0, the port writes +inf)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.ops import pallas_adc as PA
from lab_1806_vec_db_tpu.ops import pq as JP
from lab_1806_vec_db_tpu_torch.ops import adc as A

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _t(a):
    return torch.from_numpy(np.array(a))


def _lut_inputs(rng, B, m):
    lookup = (rng.random((B, m, 16)) * rng.uniform(0.5, 2.0, (B, 1, 1))).astype(np.float32)
    cb_sq = (rng.random((m, 16)) + 0.1).astype(np.float32)
    q_norms = (rng.random(B) + 0.5).astype(np.float32)
    return lookup, cb_sq, q_norms


def _binned_inputs(seed, nlist=4, lpad=1024, QB=32, B=None, m=16):
    """Cluster-sorted packed codes with lists shorter than lpad (one empty,
    one full), and bins with a ragged number of filled columns per list (one
    list probed by nobody, one with every column filled)."""
    B = max(80, QB) if B is None else B
    rng = np.random.default_rng(seed)
    lookup, cb_sq, q_norms = _lut_inputs(rng, B, m)
    codes = JP.pack_codes_4bit(rng.integers(0, 16, (nlist * lpad, m)).astype(np.uint8))
    lens = np.array([lpad - 37, 0, lpad, 300][:nlist], np.int32)
    bins = np.full((nlist, QB), -1, np.int32)
    for l, filled in enumerate([5, QB, 0, 17][:nlist]):
        bins[l, :filled] = rng.choice(B, filled, replace=False)
    return lookup, codes, lens, bins, cb_sq, q_norms


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("chunk,QB", [(8, 32), (16, 64), (32, 32), (4, 96), (16, 96)])
def test_k11_plain_equals_reference(dist, chunk, QB):
    """K11's plain version against `adc_chunkmin_binned(interpret=True)` on
    the filled columns: minima and global slots equal."""
    lookup, codes, lens, bins, cb_sq, q_norms = _binned_inputs(11, QB=QB)
    nlist, lpad = bins.shape[0], codes.shape[0] // bins.shape[0]
    ed, ei = PA.adc_chunkmin_binned(
        jnp.asarray(lookup), jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(bins),
        jnp.asarray(cb_sq), jnp.asarray(q_norms), dist, packed=True, chunk=chunk, lpad=lpad,
        interpret=True)
    cw = codes.shape[1]
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), dist, True, cw)
    launches = A.adc_chunkmin_binned.launches
    gd, gi = A.adc_chunkmin_binned(_t(codes), lut_q, scales, _t(q_norms), cs_q, cs_scale,
                                   _t(lens), _t(bins), lpad, True, chunk)
    assert A.adc_chunkmin_binned.launches == launches  # CPU tensors: the plain version
    assert gd.shape == (nlist, QB, lpad // chunk)
    filled = bins >= 0
    ed, ei = np.swapaxes(np.asarray(ed), 1, 2), np.swapaxes(np.asarray(ei), 1, 2)
    np.testing.assert_array_equal(gd.numpy()[filled], ed[filled])
    np.testing.assert_array_equal(gi.numpy()[filled], ei[filled])
    # rows past a list's length are +inf; an empty list's survivors too
    assert np.isinf(gd.numpy()[0, :5, (lpad - 37) // chunk + 1:]).all()
    assert np.isinf(gd.numpy()[~filled]).all()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_k11_survivors_tie_to_the_lowest_slot(dist):
    """All-equal codes tie every row of a chunk: each survivor is the
    chunk's first global slot."""
    lookup, _, _, bins, cb_sq, q_norms = _binned_inputs(3, nlist=2, lpad=512)
    codes = np.zeros((1024, 8), np.uint8)
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), dist, True, 8)
    lens = _t(np.array([512, 200], np.int32))
    d, p = A.adc_chunkmin_binned(_t(codes), lut_q, scales, _t(q_norms), cs_q, cs_scale, lens,
                                 _t(bins[:2]), 512, True, 16)
    first = np.arange(32) * 16
    np.testing.assert_array_equal(p.numpy()[0, :5], np.broadcast_to(first, (5, 32)))
    np.testing.assert_array_equal(p.numpy()[1, :32], np.broadcast_to(512 + first, (32, 32)))
    assert np.isinf(d.numpy()[1, :, 13:]).all() and np.isfinite(d.numpy()[1, :, :12]).all()


@pytest.mark.parametrize("N", [32, 64])
def test_k11_stage_offset_is_the_swizzle_the_descriptor_reads(N):
    """K11's producer gathers each stage's LUT rows through the bins: thread
    tid copies 16-byte chunk c = tid % 32 of block rows tid // 32, + 4, ...
    (row n = the LUT row of bin column n, query 0's row for an empty column)
    to `k11_stage_offset`; each sub-stage q and k-step kk of the consumers'
    wgmma reads B through a descriptor at q * N * 128 + 32 kk (rows 128 bytes
    apart, 8-row groups 1024 apart, the address swizzled by the hardware).
    Emulated on one stage: the descriptor returns each column's LUT row's 32
    columns of that k-step, and the copies fill the stage exactly once."""
    rng = np.random.default_rng(N)
    B, Kd, s = 80, 1024, 1  # two 512-column stages; emulate the second
    lut = rng.integers(-127, 128, (B, Kd)).astype(np.int8)
    bins = np.full(A._K11_BLOCK, -1)
    bins[: N - 5] = rng.choice(B, N - 5, replace=False)
    bins[3] = -1  # a hole: reads row 0, discarded by the epilogue
    rows = lut[np.where(bins[:N] >= 0, bins[:N], 0)]
    stage = np.zeros(A._K11_SUBS * N * A._K11_SUB, np.int16) - 999
    for tid in range(128):
        c = tid % 32
        for n in range(tid // 32, N, 4):
            at = A.k11_stage_offset(n, 16 * c, N)
            assert at % 16 == 0 and (stage[at : at + 16] == -999).all()
            stage[at : at + 16] = rows[n, s * 512 + 16 * c : s * 512 + 16 * c + 16]
    assert (stage != -999).all()
    n = np.arange(N)[:, None]
    c = np.arange(512)[None, :]
    np.testing.assert_array_equal(stage[A.k11_stage_offset(n, c, N)], rows[:, s * 512 : s * 512 + 512])
    for q in range(A._K11_SUBS):
        for kk in range(4):
            k = np.arange(32)[None, :]
            addr = 32 * kk + (n // 8) * 1024 + (n % 8) * 128 + k
            addr = q * N * 128 + (addr ^ (((addr >> 7) & 7) << 4))
            col = s * 512 + q * 128 + 32 * kk
            np.testing.assert_array_equal(stage[addr], rows[:, col : col + 32])


def _plan_inputs(QB):
    """bins where the N choice matters: an empty list, one column, 32 and 33
    filled columns, a hole before the last filled column, the last block
    partly past QB; lens 0, below one half-pass, one row past a pass, full."""
    lpad, nlist = 1536, 6
    bins = np.full((nlist, QB), -1, np.int32)
    for l, cols in enumerate([[], [0], list(range(32)), list(range(33)), [0, 1, 40], list(range(QB))]):
        cols = [c for c in cols if c < QB]
        bins[l, cols] = np.arange(len(cols)) % 50
    lens = np.array([700, 1536, 0, 513, 256, 1200], np.int32)
    return lpad, torch.from_numpy(bins), torch.from_numpy(lens)


@pytest.mark.parametrize("QB", [32, 64, 96])
def test_k11_plan_picks_n_and_skips_dead_rows(QB):
    """`k11_plan`: a block's N is 0 without a filled column, 32 when its last
    filled column is among its first 32 (holes do not matter), else 64; a
    consumer (256 rows of a pass at N 32, 128 at N 64) runs its product only
    if its first row is below the list's length."""
    lpad, bins, lens = _plan_inputs(QB)
    n, live = A.k11_plan(lens, bins, lpad)
    nb = -(-QB // 64)
    want_n = np.zeros((6, nb), np.int64)
    want_live = np.zeros((6, nb, lpad // 128), bool)
    for l in range(6):
        for b in range(nb):
            cols = np.nonzero(bins[l, 64 * b : 64 * b + 64].numpy() >= 0)[0]
            want_n[l, b] = 0 if len(cols) == 0 else (32 if cols.max() < 32 else 64)
            if want_n[l, b]:
                half = 256 if want_n[l, b] == 32 else 128
                for r in range(lpad // 128):
                    want_live[l, b, r] = (128 * r) // half * half < int(lens[l])
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_array_equal(live.numpy(), want_live)
    wide = QB > 32  # lists 3 and 4 fill a column past 32
    assert n[0].tolist() == [0] * nb and n[1, 0] == 32 and n[2, 0] == 32
    assert n[3, 0] == n[4, 0] == (64 if wide else 32)
    if QB == 96:
        assert n[5].tolist() == [64, 32]  # the second block: 32 columns wide
    # 513 rows: the consumer holding row 512 runs (128 rows at N 64, 256 at N 32)
    assert live[3, 0].tolist() == [True] * (5 if wide else 6) + [False] * (7 if wide else 6)
    assert live[4, 0].tolist() == [True, True] + [False] * 10  # 256 rows
    assert not live[2].any() and not live[0].any()  # no rows; no query


def _emulate_k11(codes, lut_q, scales, q_norms, cs_q, cs_scale, lens, bins, lpad, chunk):
    """K11's decomposition on the CPU, in the plain version's arithmetic:
    each (list, 64-column block) runs its first N = k11_plan's columns over
    the rows of its live consumers only; everything else is +inf at each
    chunk's first slot."""
    nlist, QB = bins.shape
    n, live = A.k11_plan(lens, bins, lpad)
    d_all, p_all = A.adc_chunkmin_binned_ref(codes, lut_q, scales, q_norms, cs_q, cs_scale, lens, bins,
                                             lpad, True, chunk)
    SL = lpad // chunk
    out_d = torch.full((nlist, QB, SL), float("inf"))
    first = (torch.arange(nlist)[:, None, None] * lpad + torch.arange(SL)[None, None, :] * chunk)
    out_p = first.expand(nlist, QB, SL).to(torch.int32).clone()
    per = 128 // chunk  # survivors of 128 rows
    for l in range(nlist):
        for b in range(n.shape[1]):
            cols = slice(64 * b, min(64 * b + int(n[l, b]), QB))
            for r in np.nonzero(live[l, b].numpy())[0]:
                rows = slice(r * per, (r + 1) * per)
                out_d[l, cols, rows] = d_all[l, cols, rows]
                out_p[l, cols, rows] = p_all[l, cols, rows]
    return out_d, out_p


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("QB", [32, 64, 96])
def test_k11_plan_loses_no_survivor(dist, QB):
    """What K11 skips (blocks without a filled column, columns past N,
    consumers past lens[l]) holds only +inf survivors at each chunk's
    first slot: the emulated decomposition equals the plain version
    everywhere, filled columns or not."""
    lpad, bins, lens = _plan_inputs(QB)
    rng = np.random.default_rng(QB)
    lookup, cb_sq, q_norms = _lut_inputs(rng, 50, 16)
    codes = _t(JP.pack_codes_4bit(rng.integers(0, 16, (6 * lpad, 16)).astype(np.uint8)))
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), dist, True, 8)
    args = (codes, lut_q, scales, _t(q_norms), cs_q, cs_scale, lens, bins, lpad)
    for chunk in (4, 16):
        ed, ep = _emulate_k11(*args, chunk)
        gd, gp = A.adc_chunkmin_binned(*args, True, chunk)
        assert torch.equal(ed, gd) and torch.equal(ep, gp)


def _assert_equal_up_to_ties(gd, gi, ed, ei, surv_d, surv_id):
    """Distances equal; every returned id is a survivor at its returned
    distance, and below each row's last returned distance the ids of each
    distance are the same set on both sides (all such survivors)."""
    np.testing.assert_array_equal(gd, ed)
    for b in range(gd.shape[0]):
        last = gd[b][np.isfinite(gd[b])].max()
        for v in np.unique(gd[b][np.isfinite(gd[b])]):
            tied = set(surv_id[b][surv_d[b] == v].tolist())
            mine, ref = set(gi[b][gd[b] == v].tolist()), set(ei[b][ed[b] == v].tolist())
            assert mine <= tied and ref <= tied, (b, v)
            if v < last:
                assert mine == ref == tied, (b, v)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("chunk", A.CHUNKS)
def test_k7_chunks_equal_reference_approx_transposed(dist, chunk):
    """K7's plain version at every chunk against the reference's
    `adc_scan_chunkmin(chunk=c, selector="approx", transposed=True)` fed
    the same codes transposed: distances equal, ids equal up to ties (the
    reference takes approx_min_k where S > 4 k_out: chunks 1-8 here)."""
    rng = np.random.default_rng(chunk)
    N, B, m, n_valid, k_out = 1500, 12, 16, 1400, 24
    lookup, cb_sq, q_norms = _lut_inputs(rng, B, m)
    codes = JP.pack_codes_4bit(rng.integers(0, 16, (N, m)).astype(np.uint8))
    perm = rng.permutation(N).astype(np.int32)
    ed, ei = PA.adc_scan_chunkmin(
        jnp.asarray(lookup), jnp.asarray(codes.T), jnp.asarray(perm), n_valid,
        jnp.asarray(cb_sq), jnp.asarray(q_norms), k_out, dist, packed=True, chunk=chunk,
        selector="approx", transposed=True, interpret=True)
    gd, gi = A.adc_scan_chunkmin(_t(lookup), _t(codes), _t(perm), n_valid, _t(cb_sq), _t(q_norms),
                                 k_out, dist, packed=True, chunk=chunk, selector="approx")
    S = 1536 // chunk
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), dist, True, 8)
    sd, sp = A.adc_chunkmin(_t(codes), lut_q, scales, _t(q_norms), cs_q, cs_scale, n_valid, True,
                            S, chunk)
    surv_id = perm[np.minimum(sp.numpy(), N - 1)]
    _assert_equal_up_to_ties(gd.numpy(), gi.numpy(), np.asarray(ed), np.asarray(ei), sd.numpy(),
                             surv_id)
    if S <= 4 * k_out:  # the reference's exact top-k: ties to the lower position
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))


def test_chunk_and_selector_are_checked():
    lookup, cb_sq, q_norms = _lut_inputs(np.random.default_rng(0), 4, 8)
    codes = torch.zeros((256, 4), dtype=torch.uint8)
    perm = torch.arange(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk"):
        A.adc_scan_chunkmin(_t(lookup), codes, perm, 256, _t(cb_sq), _t(q_norms), 4, "l2sqr",
                            packed=True, chunk=12)
    with pytest.raises(ValueError, match="selector"):
        A.adc_scan_chunkmin(_t(lookup), codes, perm, 256, _t(cb_sq), _t(q_norms), 4, "l2sqr",
                            packed=True, selector="fast")
    lut_q, scales, _, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), "l2sqr", True, 4)
    bins = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="lpad"):
        A.adc_chunkmin_binned(codes, lut_q, scales, _t(q_norms), None, cs_scale,
                              torch.tensor([256], dtype=torch.int32), bins, 256, True, 16)
