"""K7, K8 and K9 (the ADC kernels) of the PyTorch port against the JAX
package, on the CPU.

On CPU tensors the port's wrappers run the kernels' plain versions; the CUDA
kernels are held against those on the card by `chip_smoke.py`.  Both sides
take the same inputs, made once as numpy (codes, LUT rows, norms), and the
reference kernels run with interpret=True.  Tolerances:

- int8 LUTs (K7, K8 dense): the sums are exact int32 sums of the same int8
  entries, so ids are equal and distances agree to rtol 1e-6 (K7; the
  cosine epilogue's rounding is the same IEEE operations) or exactly (K8);
- bf16 / f32 LUTs: the sums differ from the reference's one-hot matmul in
  summation order only: rtol 1e-5 (K7 f32 also rtol 1e-6 with ids equal,
  its sums being short)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.ops import pallas_adc as PA
from lab_1806_vec_db_tpu.ops import pq as JP
from lab_1806_vec_db_tpu_torch.ops import adc as A

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _inputs(seed, N=3000, B=12, m=16, k=16, packed=True):
    """Random ADC operands shaped like a PQ table's: (B, m, k) LUT rows,
    codes (N, m) and their packed bytes, a permutation, centroid sqnorms and
    query norms."""
    rng = np.random.default_rng(seed)
    lookup = (rng.random((B, m, k)) * rng.uniform(0.5, 2.0, (B, 1, 1))).astype(np.float32)
    codes = rng.integers(0, k, (N, m)).astype(np.uint8)
    stored = JP.pack_codes_4bit(codes) if packed else codes
    perm = rng.permutation(N).astype(np.int32)
    cb_sq = (rng.random((m, k)) + 0.1).astype(np.float32)
    q_norms = (rng.random(B) + 0.5).astype(np.float32)
    return lookup, codes, stored, perm, cb_sq, q_norms


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("lut_dtype", ["int8", "f32"])
@pytest.mark.parametrize("packed", [True, False])
def test_k7_plain_equals_reference_chunkmin(dist, lut_dtype, packed):
    """K7's plain version (chunk-min survivors, top-k, id decode) against
    `adc_scan_chunkmin(interpret=True)`, with n_valid < N (masked tail) and
    an m whose packed width is not a multiple of 4 bytes."""
    lookup, _, stored, perm, cb_sq, q_norms = _inputs(7, N=3000, m=14, packed=packed)
    stored_s = stored[perm]
    n_valid, k_out = 2900, 20
    ed, ei = PA.adc_scan_chunkmin(
        jnp.asarray(lookup), jnp.asarray(stored_s), jnp.asarray(perm), n_valid,
        jnp.asarray(cb_sq), jnp.asarray(q_norms), k_out, dist, packed=packed,
        lut_dtype=lut_dtype, interpret=True)
    launches = A.adc_chunkmin.launches
    gd, gi = A.adc_scan_chunkmin(_t(lookup), _t(stored_s), _t(perm), n_valid, _t(cb_sq),
                                 _t(q_norms), k_out, dist, packed=packed, lut_dtype=lut_dtype)
    assert A.adc_chunkmin.launches == launches  # CPU tensors: the plain version
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
    np.testing.assert_allclose(gd.numpy(), np.asarray(ed), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_k7_survivors_tie_to_the_lowest_position(dist):
    """Equal int8 sums are common; each chunk keeps its lowest position.
    All-equal codes make every row of a chunk tie."""
    lookup, _, _, _, cb_sq, q_norms = _inputs(3, N=512, m=8)
    codes = np.zeros((512, 4), np.uint8)
    codes[100] = 0x11  # one row that differs
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), dist, True, 4)
    d, p = A.adc_chunkmin(_t(codes), lut_q, scales, _t(q_norms), cs_q, cs_scale, 480, True, 16)
    got, tied = p.numpy(), [s for s in range(15) if s != 3]
    np.testing.assert_array_equal(got[:, tied], np.broadcast_to(np.array(tied) * 32, got[:, tied].shape))
    assert np.isinf(d.numpy()[:, 15]).all() and (got[:, 15] == 480).all()  # rows >= 480 masked
    assert np.isfinite(d.numpy()[:, :15]).all()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("packed", [True, False])
def test_k8_ids_plain_against_reference(dist, packed):
    """K8's ids shape (bf16 LUT) against `adc_dists_for_ids(interpret=True)`,
    with -1 ids and a fully converged query: rtol 1e-5."""
    lookup, _, stored, _, cb_sq, q_norms = _inputs(11, N=500, B=9, m=16, packed=packed)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 500, (9, 13)).astype(np.int32)
    ids[0, 3] = -1
    ids[5, :] = -1
    expect = PA.adc_dists_for_ids(jnp.asarray(lookup), jnp.asarray(q_norms), jnp.asarray(stored),
                                  jnp.asarray(cb_sq), jnp.asarray(ids), dist, 16, packed=packed,
                                  interpret=True)
    got = A.adc_dists_for_ids(_t(lookup), _t(q_norms), _t(stored), _t(cb_sq), _t(ids), dist, 16,
                              packed)
    np.testing.assert_array_equal(np.isinf(got.numpy()), ids < 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_k9_ids_plain_against_reference(dist):
    """K9's ids shape (k = 256, n_bits = 8) against the reference: rtol 1e-5."""
    lookup, _, stored, _, cb_sq, q_norms = _inputs(12, N=400, B=5, m=6, k=256, packed=False)
    ids = np.random.default_rng(2).integers(-1, 400, (5, 40)).astype(np.int32)
    expect = PA.adc_dists_for_ids(jnp.asarray(lookup), jnp.asarray(q_norms), jnp.asarray(stored),
                                  jnp.asarray(cb_sq), jnp.asarray(ids), dist, 6, packed=False,
                                  interpret=True)
    got = A.adc_dists_for_ids(_t(lookup), _t(q_norms), _t(stored), _t(cb_sq), _t(ids), dist, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("packed", [True, False])
def test_k8_dense_int8_equals_reference(packed):
    """K8's dense shape with an int8 LUT against
    `adc_sums(lut_dtype="int8", interpret=True)`: equal."""
    lookup, _, stored, _, _, _ = _inputs(5, N=700, B=10, m=15, packed=packed)
    expect = PA.adc_sums(jnp.asarray(stored), jnp.asarray(lookup), packed=packed,
                         lut_dtype="int8", interpret=True)
    got = A.adc_sums(_t(stored), _t(lookup), packed=packed, lut_dtype="int8")
    assert got.shape == (700, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("lut_dtype", ["bf16", "f32"])
def test_k8_dense_float_luts_against_reference(lut_dtype):
    lookup, _, stored, _, _, _ = _inputs(6, N=600, B=7, m=16)
    expect = PA.adc_sums(jnp.asarray(stored), jnp.asarray(lookup), packed=True,
                         lut_dtype=lut_dtype, interpret=True)
    got = A.adc_sums(_t(stored), _t(lookup), packed=True, lut_dtype=lut_dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("exact", [False, True])
def test_k9_dense_against_reference(exact):
    """K9 (k = 256, step-wise in the reference: bf16 whatever lut_dtype
    says, f32 under exact) against `adc_sums(interpret=True)`: rtol 1e-5."""
    lookup, _, stored, _, _, _ = _inputs(8, N=600, B=6, m=5, k=256, packed=False)
    expect = PA.adc_sums(jnp.asarray(stored), jnp.asarray(lookup), exact=exact, interpret=True)
    got = A.adc_sums(_t(stored), _t(lookup), exact=exact, lut_dtype="int8")
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("k,packed,exact", [(16, True, False), (16, True, True), (256, False, False)])
def test_adc_scan_pallas_plain_composition_ids_equal(dist, k, packed, exact):
    """The dense scan + blocked top-k (`adc_scan_pallas`), over two blocks
    with a masked tail, with the reference's int8 default (k = 16), f32
    (exact) or bf16 (k = 256).  Distances agree to rtol 1e-5 and ids are
    equal, except that int8 sums tie often and the reference's block top-k
    (`approx_min_k`) orders equal distances in no set order: there every id
    whose distance is below the row's last one is in the other's answer."""
    lookup, _, stored, _, cb_sq, q_norms = _inputs(9, N=1000, B=8, m=8, k=k, packed=packed)
    n_valid = 963
    ed, ei = PA.adc_scan_pallas(jnp.asarray(lookup), jnp.asarray(stored), n_valid,
                                jnp.asarray(cb_sq), jnp.asarray(q_norms), 25, dist, packed=packed,
                                exact=exact, block=512, interpret=True)
    gd, gi = A.adc_scan_pallas(_t(lookup), _t(stored), n_valid, _t(cb_sq), _t(q_norms), 25, dist,
                               packed=packed, exact=exact, block=512)
    ed, ei, gd, gi = np.asarray(ed), np.asarray(ei), gd.numpy(), gi.numpy()
    np.testing.assert_allclose(gd, ed, rtol=1e-5, atol=1e-6)
    if k == 16 and not exact:
        for r in range(len(ed)):
            assert set(gi[r, gd[r] < gd[r, -1]]) <= set(ei[r])
            assert set(ei[r, ed[r] < ed[r, -1]]) <= set(gi[r])
    else:
        np.testing.assert_array_equal(gi, ei)
    assert (gi < n_valid).all()


def test_wrappers_reject_what_the_kernels_do_not_take():
    lookup, _, stored, _, _, _ = _inputs(4, N=100, B=2, m=8, k=256, packed=False)
    packed = JP.pack_codes_4bit(stored % 16)
    with pytest.raises(ValueError):  # k = 256 codes are never nibble-packed
        A.adc_sums(_t(packed), _t(lookup), packed=True)
    with pytest.raises(ValueError):  # K7 serves k = 16 tables
        A.adc_scan_chunkmin(_t(lookup), _t(stored), torch.arange(100, dtype=torch.int32), 100,
                            torch.zeros((8, 256)), torch.ones(2), 5, "l2sqr")
    with pytest.raises(ValueError):  # the int8 LUT needs its scales
        A.adc_sums_dense(_t(stored), torch.zeros((2, 8, 16), dtype=torch.int8), None, 8, False)


@pytest.mark.parametrize("R,N", [(1001, 1100), (33, 2050)])
def test_k9_dense_plain_equals_stepwise_reference(R, N):
    """K9's dense plain version at the cosine route's R = B + 1 = 1001 and at
    N past K9's 1024-row tile (and 32-row LUT block), against the reference's
    `_adc_sums_stepwise` in interpret mode: equal (one group a step, so the
    reference adds the groups in order too)."""
    lookup, _, stored, _, _, _ = _inputs(13, N=N, B=R, m=3, k=256, packed=False)
    expect = PA._adc_sums_stepwise(jnp.asarray(stored), jnp.asarray(lookup), False, False, True)
    lut, scales = A.round_lut(_t(lookup))
    got = A.adc_sums_dense(_t(stored), lut, scales, 3, False)
    assert got.shape == (R, N)
    np.testing.assert_array_equal(got.numpy().T, np.asarray(expect))


@pytest.mark.parametrize("lut_dtype", [torch.bfloat16, torch.float32])
def test_k9_dense_layout_emulated(lut_dtype):
    """A numpy emulation of K9's dense kernel on `k9_dense_layout`: each
    stage's LUT rows at the odd word stride, the rows' code words, the
    lookups of each lane (one LUT row) and the in-order f32 adds.  The 32
    lanes looking up one code hit 32 distinct banks, the stages fit a CTA's
    shared memory, and the emulated sums equal the plain version bit for
    bit at R and N past one CTA's block, with m not a multiple of 4."""
    lay = A.k9_dense_layout(lut_dtype)
    size = 2 if lut_dtype == torch.bfloat16 else 4
    assert lay["stride"] % 2 == 1 and lay["words"] == A.K9_G * 256 * size // 4
    assert lay["smem_bytes"] <= A._SMEM_MAX
    lanes = np.arange(A.K9_QB)
    for g in range(A.K9_G):
        for c in range(256):
            banks = (lanes * lay["stride"] + (g * 256 + c) * size // 4) % 32
            assert len(set(banks.tolist())) == 32
    R, N, m = 40, 1100, 6
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 256, (N, m)).astype(np.uint8)
    lut = torch.from_numpy(rng.random((R, m, 256)).astype(np.float32) * 4 - 1).to(lut_dtype)
    lut_f = lut.float().numpy()
    out = np.zeros((R, N), np.float32)
    steps = -(-m // A.K9_G)
    for r0 in range(0, R, A.K9_QB):
        for n0 in range(0, N, A.K9_RB):
            acc = np.zeros((A.K9_QB, A.K9_RB), np.float32)
            for s in range(steps):
                stage = np.zeros(A.K9_QB * lay["stride"] * 4 // size, np.float32)  # entries
                words = np.zeros(A.K9_RB, np.uint32)
                for q in range(min(A.K9_QB, R - r0)):
                    for g in range(min(A.K9_G, m - s * A.K9_G)):
                        at = (q * lay["stride"] * 4 + g * 256 * size) // size
                        stage[at : at + 256] = lut_f[r0 + q, s * A.K9_G + g]
                for x in range(min(A.K9_RB, N - n0)):
                    for e in range(min(A.K9_G, m - s * A.K9_G)):
                        words[x] |= np.uint32(codes[n0 + x, s * A.K9_G + e]) << np.uint32(8 * e)
                for q in range(A.K9_QB):
                    base = q * lay["stride"] * 4 // size
                    for g in range(A.K9_G):
                        c = (words >> np.uint32(8 * g)) & np.uint32(255)
                        acc[q] = acc[q] + stage[base + g * 256 + c.astype(np.int64)]
            rq, nx = min(A.K9_QB, R - r0), min(A.K9_RB, N - n0)
            out[r0 : r0 + rq, n0 : n0 + nx] = acc[:rq, :nx]
    ref = A.adc_sums_dense_ref(_t(codes), lut, None, m, False)
    np.testing.assert_array_equal(out, ref.numpy())


def test_k7_stage_offset_is_the_swizzle_the_descriptor_reads():
    """K7 stages its LUT as TMA's 128-byte swizzle writes a 128-byte x 128-row
    box (16-byte chunk j of row n at chunk j ^ (n % 8) of a 1024-byte
    aligned stage), and each k-step's wgmma descriptor starts 32 bytes
    further into the stage; the hardware swizzles the address it computes
    (rows 128 bytes apart, 8-row groups 1024 apart).  `k7_stage_offset`
    equals the former, and reading a staged LUT through the latter returns
    each query's 32 LUT columns of that k-step."""
    n = np.arange(128)[:, None]
    c = np.arange(128)[None, :]
    linear = n * 128 + c
    swizzled = linear ^ (((linear >> 7) & 7) << 4)
    np.testing.assert_array_equal(A.k7_stage_offset(n, c), swizzled)
    rng = np.random.default_rng(3)
    lut = rng.integers(-127, 128, (128, 512)).astype(np.int8)  # Kd 512: 4 stages
    for kt in range(4):
        stage = np.zeros(128 * 128, np.int8)
        stage[A.k7_stage_offset(n, c)] = lut[:, kt * 128 : (kt + 1) * 128]
        for kk in range(4):
            k = np.arange(32)[None, :]
            addr = 32 * kk + (n // 8) * 1024 + (n % 8) * 128 + k
            addr = addr ^ (((addr >> 7) & 7) << 4)
            np.testing.assert_array_equal(stage[addr], lut[:, kt * 128 + 32 * kk : kt * 128 + 32 * kk + 32])


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_k7_pack_keeps_the_survivors(dist):
    """K7's kernel takes nibble-packed codes; `k7_pack` packs one code a byte
    (cw 14 -> 7 bytes, padded to 8) and zero-pads the LUT and the cosine
    column.  The plain version over the packed operands equals it over the
    unpacked ones."""
    lookup, codes, _, _, cb_sq, q_norms = _inputs(17, N=700, B=9, m=14)
    unpacked = np.pad(codes, ((0, 0), (0, 2)))  # cw 16: one code a byte
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), dist, False, 16)
    pc, pl, pcs = A.k7_pack(_t(unpacked), lut_q, cs_q)
    assert pc.shape == (700, 8) and pl.shape == (9, 256)
    np.testing.assert_array_equal(pc.numpy()[:, :7], JP.pack_codes_4bit(codes))
    S = 768 // 8
    a = A.adc_chunkmin(_t(unpacked), lut_q, scales, _t(q_norms), cs_q, cs_scale, 690, False, S, 8)
    b = A.adc_chunkmin(pc, pl, scales, _t(q_norms), pcs, cs_scale, 690, True, S, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_k7_k9_wrappers_reject_what_the_new_kernels_do_not_take():
    """K9 takes no int8 LUT at k = 256; K7 takes cw % 4 == 0 and 16 LUT
    columns per code group (on every device)."""
    lookup, _, stored, _, cb_sq, q_norms = _inputs(4, N=256, B=2, m=8, k=16, packed=True)
    with pytest.raises(ValueError):
        A.adc_sums_dense(torch.zeros((10, 8), dtype=torch.uint8),
                         torch.zeros((2, 8, 256), dtype=torch.int8), torch.ones(2), 8, False)
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(_t(lookup), _t(cb_sq), "l2sqr", True, 4)
    with pytest.raises(ValueError):  # cw 3
        A.adc_chunkmin(torch.zeros((256, 3), dtype=torch.uint8), lut_q, scales, _t(q_norms), cs_q,
                       cs_scale, 256, True, 8)
    with pytest.raises(ValueError):  # 8 groups of packed codes against a 4-group LUT
        A.adc_chunkmin(torch.zeros((256, 4), dtype=torch.uint8), lut_q[:, :64], scales, _t(q_norms),
                       cs_q, cs_scale, 256, True, 8)


@pytest.mark.parametrize("B", [1, 13, 1000])
@pytest.mark.parametrize("C", [1, 16, 128, 2048])
def test_k8_ids_plan_covers_every_pair_once(C, B):
    """K8's ids plan (`k8_ids_plan`: queries per CTA, warps per query,
    passes, so candidates per lane) gives every (b, c) exactly one (CTA,
    warp, lane, pass) at the graph route's widths (1, 16, 128) and
    codes_pq_10m's pool (2048), with bf16 and f32 LUT rows of m = 320 in
    shared memory; the cosine route's shared row fits at any width."""
    for itemsize in (2, 4):
        plan = A.k8_ids_plan(C, 320, itemsize)
        assert plan["smem_bytes"] <= A._SMEM_MAX and plan["wq"] * plan["qc"] <= A._K8_WARPS
        wq, qc = plan["wq"], plan["qc"]
        count = np.zeros((B, C), np.int64)
        for cta in range(-(-B // qc)):
            for w in range(A._K8_WARPS):
                b = cta * qc + w // wq
                if w // wq >= qc or b >= B:
                    continue
                for p in range(plan["passes"]):
                    c = p * 32 * wq + (w % wq) * 32 + np.arange(32)
                    np.add.at(count[b], c[c < C], 1)
        assert (count == 1).all()
        assert A.k8_ids_plan(C, 320, itemsize, shared=True)["smem_bytes"] == 320 * 16 * itemsize


def test_k8_ids_code_words_unpack_the_groups():
    """K8's ids kernel reads a code row 16 bytes at a time as four
    little-endian words and takes group e of the 16 bytes as nibble e % 8 of
    word e // 8 (packed) or byte e % 4 of word e // 4 (one code a byte):
    the groups `unpack_codes` gives."""
    _, codes, stored, _, _, _ = _inputs(9, N=50, B=1, m=64, packed=True)
    for packed, rows in ((True, stored), (False, codes)):
        gpc = 32 if packed else 16
        for k in range(0, rows.shape[1], 16):
            words = np.ascontiguousarray(rows[:, k : k + 16]).view("<u4")  # (N, 4)
            e = np.arange(gpc)
            if packed:
                got = (words[:, e >> 3] >> (4 * (e & 7))) & 15
            else:
                got = (words[:, e >> 2] >> (8 * (e & 3))) & 15
            g0 = (k // 16) * gpc
            np.testing.assert_array_equal(got, codes[:, g0 : g0 + gpc])


@pytest.mark.parametrize("m", [8, 13, 19, 320])
def test_k8_dense_operands_keep_the_sums(m):
    """K8's one-hot dense kernel takes K7's operands (`k8_dense_operands`):
    the code width zero-padded to a multiple of 4 and the int8 LUT as
    (R, 32 cw') columns, zero past group m.  The plain version over those
    (m' = 2 cw' groups) equals it over the original operands, and so does a
    one-hot product in K7's column order."""
    lookup, _, stored, _, _, _ = _inputs(12, N=300, B=5, m=m, packed=True)
    lut, scales = A.round_lut(_t(lookup), "int8")
    codes = _t(stored)
    pc, pl = A.k8_dense_operands(codes, lut)
    cw4 = -(-stored.shape[1] // 4) * 4
    assert pc.shape == (300, cw4) and pl.shape == (5, 32 * cw4) and pl.dtype == torch.int8
    expect = A.adc_sums_dense_ref(codes, lut, scales, m, True)
    got = A.adc_sums_dense_ref(pc, pl.reshape(5, 2 * cw4, 16), scales, 2 * cw4, True)
    assert torch.equal(got, expect)
    c = A.unpack_codes(pc, 2 * cw4, True)  # the one-hot rows K7's A registers encode
    onehot = torch.nn.functional.one_hot(c, 16).reshape(300, 32 * cw4).long()
    assert torch.equal((pl.long() @ onehot.T).float() * scales[:, None], expect)
