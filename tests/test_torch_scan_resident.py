"""K12, K13, K14 (the q-resident scans) and their stage-1 candidate
functions, of the PyTorch port against the JAX package's Pallas kernels run
in interpret mode on the CPU.

On the CPU the port's wrappers run the kernels' plain PyTorch versions; the
CUDA kernels are held against those on the card by `chip_smoke.py`.  The
same inputs, made from a numpy seed, go to both sides: ragged row counts
(3000, not a multiple of 1024 or 2048), n_valid below the row count (whole
chunks past it), dims 40 and 48 (not multiples of 16 or 64).

Tolerances:
- K13 and K14 equal element for element (ids too): the plain versions round
  to bf16 after every operation, as interpret mode does;
- K12 rtol 1e-5 / atol 1e-6 on the survivors: the f32 sums run in another
  order; ids equal except where the two rows lie within that tolerance.
The entry points compute the query cache themselves, the port in float64
and the reference in f32, which can move a bf16 distance by one ulp: there
the distances agree within one bf16 ulp and the ids wherever no other
candidate lies within that ulp of them."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import distance as JD
from lab_1806_vec_db_tpu.ops import pallas_scan as PS
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu_torch.ops import distance as D
from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR
from lab_1806_vec_db_tpu_torch.ops import topk as T

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

N, B, N_VALID = 3000, 8, 2800


def _make(n, dim, b, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((b, dim)).astype(np.float32)
    return base, qs


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _bf16_inputs(dist, dim, seed=0, n=N):
    """K12's operands from the JAX package: bf16 queries and rows (as
    numpy f32 holding bf16 values), the f32 caches."""
    base, qs = _make(n, dim, B, seed)
    cache = np.array(JD.dist_cache(jnp.asarray(base), dist))
    qc = np.array(JD.dist_cache(jnp.asarray(qs), dist))
    q_bf = np.asarray(jnp.asarray(qs).astype(jnp.bfloat16).astype(jnp.float32))
    b_bf = np.asarray(jnp.asarray(base).astype(jnp.bfloat16).astype(jnp.float32))
    return q_bf, qc, b_bf, cache


def _int8_inputs(dist, dim, seed=0, n=N):
    """K13 / K14's operands in the RAW channels (scale s_x, cache |x|^2 or
    |x|), from the JAX package."""
    base, qs = _make(n, dim, B, seed)
    b8, bsc = JT.quantize_rows_int8(jnp.asarray(base))
    q8, qsc = JT.quantize_rows_int8(jnp.asarray(qs))
    cache = JD.dist_cache(jnp.asarray(base), dist)
    qc = JD.dist_cache(jnp.asarray(qs), dist)
    return q8, qsc, qc, b8, bsc, cache


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("dim", [40, 48])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_chunkmin_matches_pallas_kernel(dist, dim):
    """K12's (B, N_pad/128) survivors: rtol 1e-5 / atol 1e-6, ids equal
    except between rows within that tolerance; chunks wholly past n_valid
    give (+inf, their first row) on both sides."""
    q_bf, qc, b_bf, cache = _bf16_inputs(dist, dim)
    jd, ji = PS.scan_chunkmin(jnp.asarray(q_bf).astype(jnp.bfloat16), jnp.asarray(qc),
                              jnp.asarray(b_bf).astype(jnp.bfloat16), jnp.asarray(cache),
                              jnp.int32(N_VALID), dist, interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = SR.scan_chunkmin(_bf16(q_bf), torch.from_numpy(qc), _bf16(b_bf), torch.from_numpy(cache),
                              N_VALID, dist)
    td, ti = td.numpy(), ti.numpy()
    assert td.shape == ti.shape == jd.shape == (B, 3072 // 128) and ti.dtype == np.int32
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    past = np.arange(td.shape[1]) * 128 >= N_VALID
    assert np.isinf(td[:, past]).all()
    np.testing.assert_array_equal(ti[:, past], ji[:, past])
    # where the ids differ, the port's row is as near as the reference's
    dots = q_bf.astype(np.float64) @ b_bf.astype(np.float64).T
    if dist == "l2sqr":
        dm = qc[:, None] + cache[None, :] - 2.0 * dots
    else:
        dm = 1.0 - dots / np.maximum(qc[:, None] * cache[None, :], 1e-10)
    diff = ti != ji
    rows = np.nonzero(diff)[0]
    a, b = dm[rows, ti[diff]], dm[rows, ji[diff]]
    assert (np.abs(a - b) <= 1e-5 * np.abs(b) + 1e-6).all()
    assert diff.mean() < 0.05


@pytest.mark.parametrize("dim", [40, 48])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_dist_int8_matches_pallas_kernel(dist, dim):
    """K13's (B, N_pad) bf16 matrix: equal element for element, +inf from
    n_valid on."""
    args = _int8_inputs(dist, dim, seed=1)
    jo = np.asarray(PS.scan_dist_int8(*args, jnp.int32(N_VALID), dist, interpret=True).astype(jnp.float32))
    to = SR.scan_dist_int8(*_t(*args), N_VALID, dist)
    assert to.dtype == torch.bfloat16 and to.shape == jo.shape == (B, 3072)
    np.testing.assert_array_equal(to.float().numpy(), jo)
    assert np.isinf(jo[:, N_VALID:]).all()


@pytest.mark.parametrize("dim", [40, 48])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_chunkmin_int8_t_matches_pallas_kernel(dist, dim):
    """K14's (N_pad/128, B) survivors and lowest argmins: equal element for
    element (bf16 values tie often; the lowest row wins on both sides)."""
    args = _int8_inputs(dist, dim, seed=2)
    jd, ji = PS.scan_chunkmin_int8_t(*args, jnp.int32(N_VALID), dist, interpret=True)
    td, ti = SR.scan_chunkmin_int8_t(*_t(*args), N_VALID, dist)
    assert td.shape == ti.shape == jd.shape == (4096 // 128, B)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _assert_candidates(bd, bi, od, oi, ulp):
    """Distances within `ulp` (relative) of the reference's; ids equal
    wherever no neighbouring rank lies within that of the distance."""
    np.testing.assert_array_equal(np.isinf(bd), np.isinf(od))
    np.testing.assert_array_equal(bi < 0, oi < 0)
    fin = np.isfinite(od)
    np.testing.assert_allclose(bd[fin], od[fin], rtol=ulp, atol=1e-6)
    tol = ulp * np.abs(od) + 1e-6
    with np.errstate(invalid="ignore"):
        near_prev = np.abs(od - np.roll(od, 1, axis=1)) <= tol
        near_next = np.abs(od - np.roll(od, -1, axis=1)) <= tol
    near_prev[:, 0] = False
    near_next[:, -1] = False
    alone = fin & ~near_prev & ~near_next
    np.testing.assert_array_equal(bi[alone], oi[alone])
    for b_row, o_row in zip(bi, oi):
        o_set = set(o_row[o_row >= 0].tolist())
        assert len(set(b_row.tolist()) & o_set) >= 0.95 * len(o_set)


@pytest.mark.parametrize("r", [20, 40])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_candidates_pallas_matches_reference(dist, r):
    """K12's stage 1 (r below and above the 24 survivors of 3072 rows):
    ((B, r) f32 ascending, (B, r) int32), -1 / +inf padded."""
    base, qs = _make(N, 48, B, seed=3)
    cache = JD.dist_cache(jnp.asarray(base), dist)
    base_bf = jnp.asarray(base).astype(jnp.bfloat16)
    od, oi = PS.scan_candidates_pallas(jnp.asarray(qs), base_bf, cache, jnp.int32(N_VALID), r, dist,
                                       interpret=True)
    bd, bi = SR.scan_candidates_pallas(torch.from_numpy(qs), _bf16(base_bf.astype(jnp.float32)),
                                       torch.from_numpy(np.array(cache)), N_VALID, r, dist)
    assert bd.shape == bi.shape == (B, r) and bd.dtype == torch.float32 and bi.dtype == torch.int32
    _assert_candidates(bd.numpy(), bi.numpy(), np.asarray(od), np.asarray(oi), 1e-5)
    assert (bi.numpy() >= 0).sum(1).max() == min(r, 22)  # 2800 rows fill 22 chunks


@pytest.mark.parametrize("n,r", [(N, 20), (200, 1100)])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_candidates_int8_pallas_matches_reference(dist, n, r):
    """K13's stage 1 over every row (r above the 1024 padded rows too)."""
    base, qs = _make(n, 48, B, seed=4)
    b8, bsc = JT.quantize_rows_int8(jnp.asarray(base))
    cache = JD.dist_cache(jnp.asarray(base), dist)
    nv = min(n, N_VALID)
    od, oi = PS.scan_candidates_int8_pallas(jnp.asarray(qs), b8, bsc, cache, jnp.int32(nv), r, dist,
                                            interpret=True)
    bd, bi = SR.scan_candidates_int8_pallas(torch.from_numpy(qs), *_t(b8, bsc, cache), nv, r, dist)
    assert bd.shape == bi.shape == (B, r)
    _assert_candidates(bd.numpy(), bi.numpy(), np.asarray(od), np.asarray(oi), 2.0 ** -8)
    assert (bi.numpy() >= 0).sum(1).max() == min(r, nv)


@pytest.mark.parametrize("r", [20, 40])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_candidates_int8_chunkmin_matches_reference(dist, r):
    """K14's stage 1 (queries padded to 128; r below and above the 32
    survivors of 4096 rows)."""
    base, qs = _make(N, 48, B, seed=5)
    b8, bsc = JT.quantize_rows_int8(jnp.asarray(base))
    cache = JD.dist_cache(jnp.asarray(base), dist)
    od, oi = PS.scan_candidates_int8_chunkmin(jnp.asarray(qs), b8, bsc, cache, jnp.int32(N_VALID), r, dist,
                                              interpret=True)
    bd, bi = SR.scan_candidates_int8_chunkmin(torch.from_numpy(qs), *_t(b8, bsc, cache), N_VALID, r, dist)
    assert bd.shape == bi.shape == (B, r)
    _assert_candidates(bd.numpy(), bi.numpy(), np.asarray(od), np.asarray(oi), 2.0 ** -8)
    assert (bi.numpy() >= 0).sum(1).max() == min(r, 22)


def test_smallest_positions_breaks_ties_by_position():
    """K13's top-r (`topk.smallest_positions`) is exact, ascending, ties to
    the lower position, and +0.0 / -0.0 tie as equals, like a stable sort."""
    d = torch.tensor([[3.0, 1.0, 2.0, 1.0, -0.0, 0.0, float("inf"), 1.0],
                      [5.0, 5.0, 5.0, 5.0, 4.0, 5.0, 5.0, -1.0]]).to(torch.bfloat16)
    bd, bi = T.smallest_positions(d, 5)
    sd, si = torch.sort(d.float() + 0.0, dim=1, stable=True)
    torch.testing.assert_close(bd, sd[:, :5], rtol=0, atol=0)
    np.testing.assert_array_equal(bi.numpy(), si[:, :5].numpy())


def test_wrappers_reject_what_the_kernels_do_not_take():
    q8, qsc, qc, b8, bsc, cache = _t(*_int8_inputs("l2sqr", 48))
    with pytest.raises(TypeError):
        SR.scan_dist_int8(q8.float(), qsc, qc, b8, bsc, cache, N, "l2sqr")
    with pytest.raises(ValueError):
        SR.scan_chunkmin_int8_t(q8[:, :32], qsc, qc, b8, bsc, cache, N, "l2sqr")
    with pytest.raises(ValueError):
        SR.scan_dist_int8(q8, qsc[:1], qc, b8, bsc, cache, N, "l2sqr")
    with pytest.raises(ValueError, match="Invalid distance"):
        SR.scan_chunkmin_int8_t(q8, qsc, qc, b8, bsc, cache, N, "dot")
    q_bf, qcb, b_bf, cb = _bf16_inputs("l2sqr", 48)
    with pytest.raises(TypeError):
        SR.scan_chunkmin(torch.from_numpy(q_bf), torch.from_numpy(qcb), _bf16(b_bf), torch.from_numpy(cb), N,
                         "l2sqr")


def test_cpu_runs_launch_no_kernel():
    """On CPU tensors every wrapper takes its plain version: no count moves."""
    counts = [SR.scan_chunkmin.launches, SR.scan_dist_int8.launches, SR.scan_chunkmin_int8_t.launches]
    base, qs = _make(500, 40, 3, seed=6)
    b8, bsc = _t(*JT.quantize_rows_int8(jnp.asarray(base)))
    cache = torch.from_numpy(base).square().sum(1)
    SR.scan_candidates_int8_pallas(torch.from_numpy(qs), b8, bsc, cache, 500, 4, "l2sqr")
    SR.scan_candidates_int8_chunkmin(torch.from_numpy(qs), b8, bsc, cache, 500, 4, "l2sqr")
    SR.scan_candidates_pallas(torch.from_numpy(qs), torch.from_numpy(base).to(torch.bfloat16), cache, 500, 4,
                              "l2sqr")
    assert counts == [SR.scan_chunkmin.launches, SR.scan_dist_int8.launches, SR.scan_chunkmin_int8_t.launches] \
        == [0, 0, 0]


@pytest.mark.parametrize("n_pad,b", [(1024, 1), (3072, 130), (1_000_448, 1000), (4096, 40_000)])
def test_k12_plan_covers_every_chunk_once(n_pad, b):
    """K12's plan (`k12_plan`, which sizes the kernel's launch) gives every
    (128-query tile, 128-row chunk) to exactly one CTA, as the kernel walks
    it (CTA (x, y): chunks y, y + ctas, ...), in one wave where the query
    tiles leave room for one."""
    plan = SR.k12_plan(n_pad, b, 132)
    chunks = n_pad // 128
    assert plan["qtiles"] == -(-b // 128) and plan["chunks"] == chunks
    assert plan["qtiles"] * plan["ctas"] <= 132 or plan["ctas"] == 1
    count = np.zeros((plan["qtiles"], chunks), np.int64)
    for y in range(plan["ctas"]):
        count[:, y::plan["ctas"]] += 1
    assert (count == 1).all()


def _k12_chunk_emulate(d, row0):
    """K12's chunk-min as its consumer runs it, for one chunk: accumulator
    register i of lane l in warp w holds (query, chunk row)
    `k12_acc_coords(w, l, i)`; each lane folds its 32 rows of each of its
    two queries in ascending order into a (d, row) minimum (the smaller d,
    then the lower row), then the quad's lanes l ^ 1 and l ^ 2 in turn;
    lane 4 g of each warp holds queries 16 w + g and 16 w + g + 8.
    d: (64, 128) f32 with +inf where row >= n_valid -> ((64,) d, (64,) row)."""
    warp, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    best = np.full((4, 32, 2), np.inf, np.float32)
    brow = np.full((4, 32, 2), 2**31 - 1, np.int64)

    def keep_min(bd, br, d2, r2):
        take = (d2 < bd) | ((d2 == bd) & (r2 < br))
        return np.where(take, d2, bd), np.where(take, r2, br)

    for nt in range(16):
        for j in range(2):
            for h in range(2):
                q, r = SR.k12_acc_coords(warp, lane, nt * 4 + 2 * h + j)
                best[..., h], brow[..., h] = keep_min(best[..., h], brow[..., h], d[q, r], row0 + r)
    for off in (1, 2):
        best, brow = keep_min(best, brow, best[:, lane[0] ^ off], brow[:, lane[0] ^ off])
    out_d, out_i = np.empty(64, np.float32), np.empty(64, np.int64)
    for w in range(4):
        for g in range(8):
            for h in range(2):
                out_d[16 * w + g + 8 * h], out_i[16 * w + g + 8 * h] = best[w, 4 * g, h], brow[w, 4 * g, h]
    return out_d, out_i


@pytest.mark.parametrize("n_valid", [128 * 5 + 128, 128 * 5 + 70, 128 * 5])
def test_k12_chunk_min_emulated(n_valid):
    """The emulated lane / quad reduction equals `_chunk_min` (the plain
    version's): the lowest row wins ties, including equal rows on both sides
    of the 64-row middle of a chunk (rows 63 / 64 and 0 / 127, lanes of
    different quads), rows of one lane (8 / 9) and of one quad's lanes
    (1 / 2); rows at or past n_valid are +inf, and a chunk wholly past it
    gives (+inf, its first row)."""
    rng = np.random.default_rng(7)
    row0 = 128 * 5
    d = rng.standard_normal((64, 128)).astype(np.float32)
    for q, pair in enumerate([(63, 64), (64, 63), (0, 127), (127, 0), (8, 9), (2, 1), (66, 120)] * 9):
        if q < 64:
            d[q, list(pair)] = -10.0 - q
    d[3, 100] = -100.0  # a masked row may not win when n_valid cuts it
    rows = row0 + np.arange(128)
    dm = np.where(rows[None, :] < n_valid, d, np.inf).astype(np.float32)
    got_d, got_i = _k12_chunk_emulate(dm, row0)
    want_d, want_i = SR._chunk_min(torch.from_numpy(dm))
    np.testing.assert_array_equal(got_d, want_d[:, 0].numpy())
    np.testing.assert_array_equal(got_i, row0 + want_i[:, 0].numpy())
    if n_valid <= row0:
        assert np.isinf(got_d).all() and (got_i == row0).all()
    else:
        assert got_i[0] == row0 + 63 and got_i[1] == row0 + 63 and got_i[2] == row0
        assert got_i[4] == row0 + 8 and got_i[5] == row0 + 1


def _k12_dots(q, x, boxes):
    """K12's summation order with exact partials: each partial sums the
    products of `boxes` 64-lane boxes exactly, plus the compensation carried
    in it, rounded once to f32 (the tensor cores' own truncation is not
    emulated); the running sum s' = s + p in f32, and the partial keeps
    p - (s' - s)."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    lanes = 64 * boxes
    s = np.zeros((q.shape[0], x.shape[0]), np.float32)
    e = np.zeros_like(s)
    for k0 in range(0, q.shape[1], lanes):
        p = (q64[:, k0 : k0 + lanes] @ x64[:, k0 : k0 + lanes].T + e).astype(np.float32)
        s2 = s + p
        e = p - (s2 - s)
        s = s2
    return s


@pytest.mark.parametrize("boxes", [1, 2, 3])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_k12_compensated_partials_within_rtol(dist, boxes):
    """At D 960 on Gist-spectrum rows, K12's compensated partials of 1, 2 or
    3 boxes (the kernel's CBOX is 3) keep every dot within 2^-23 of float64 (an f32
    ulp at the top of its binade) and
    every chunk survivor within rtol 1e-5 / atol 1e-6 of the plain
    version's (float64 sums rounded once)."""
    from lab_1806_vec_db_tpu_torch.bench import synth

    x = synth.make_device(2048, 960, 4, "cpu").to(torch.bfloat16)
    q = synth.make_device(64, 960, 5, "cpu").to(torch.bfloat16)
    xf, qf = x.float().numpy(), q.float().numpy()
    dots = _k12_dots(qf, xf, boxes)
    exact = qf.astype(np.float64) @ xf.astype(np.float64).T
    assert (np.abs(dots - exact) <= 2.0**-23 * np.abs(exact)).all()  # 1 ulp at the top of a binade
    qc, ca = D.dist_cache(q.float(), dist), D.dist_cache(x.float(), dist)
    dt, qct, cat = torch.from_numpy(dots), qc[:, None], ca[None, :]
    d = (qct + cat) - 2.0 * dt if dist == "l2sqr" else 1.0 - dt / (qct * cat).clamp_min(1e-10)
    got = SR._chunk_min(d)[0]
    ref = SR.scan_chunkmin_ref(q, qc, x, ca, 2048, dist)[0]
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ K13 / K14 layout ----

@pytest.mark.parametrize("n_pad", [1024, 3 * 2048, 1_000_448, 1_001_472])
@pytest.mark.parametrize("b", [1, 50, 1000, 1024])
def test_k12_plan_covers_every_k13_k14_chunk_once(n_pad, b):
    """K13 / K14's launch (`k12_plan`, at their N_pad multiples and batch
    sizes): every (128-query tile, 128-row chunk) goes to exactly one CTA
    and, within it, to one consumer (the CTA's i-th chunk to consumer
    i % 2), the two consumers of a CTA a chunk apart at most, in one wave of
    132 SMs."""
    plan = SR.k12_plan(n_pad, b, 132)
    chunks = n_pad // 128
    assert plan["qtiles"] == -(-b // 128) and plan["chunks"] == chunks
    assert plan["qtiles"] * plan["ctas"] <= 132
    count = np.zeros((plan["qtiles"], chunks, 2), np.int64)
    for y in range(plan["ctas"]):
        for i, c in enumerate(range(y, chunks, plan["ctas"])):
            count[:, c, i % 2] += 1
        per = count[0, y :: plan["ctas"]].sum(0)
        assert abs(int(per[0]) - int(per[1])) <= 1
    assert (count.sum(-1) == 1).all()


def _k13_stage_and_store(d, n0, a, row0, B, out):
    """K13's epilogue for one accumulator as its consumer runs it: register
    2 nt + h of lane (w, l) packs rows (8 nt + 2 t, + 1) of query 16 w + g +
    8 h (`k12_acc_coords` of registers 4 nt + 2 h and + 1) in place; the
    pairs go to the 16 KB staging buffer at (nt // 8) * 8192 + q * 128 +
    16 ((nt % 8) ^ g) + 4 t; two TMA stores of 64 x 64 bf16 boxes with the
    128-byte swizzle (piece s of smem row q holds the box row's piece
    s ^ (q % 8)) write it at (query n0 + 64 a, rows row0 and row0 + 64) of
    `out`, clipping queries >= B.  d: (64, 128) f32 of bf16 values.
    Returns the staging words written per store instruction, for the bank
    check."""
    stg = np.full(4096, -1, np.int64)  # 16 KB as 4-byte words: the (query, row) of each bf16 pair
    lanes = []
    for nt in range(16):
        for h in range(2):
            banks = []
            for w in range(4):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    q0, r0 = SR.k12_acc_coords(w, lane, 4 * nt + 2 * h)
                    q1, r1 = SR.k12_acc_coords(w, lane, 4 * nt + 2 * h + 1)
                    assert (q0, r1) == (q1, r0 + 1) and q0 == 16 * w + g + 8 * h and r0 == 8 * nt + 2 * t
                    byte = (nt // 8) * 8192 + q0 * 128 + 16 * ((nt % 8) ^ g) + 4 * t
                    assert stg[byte // 4] == -1  # each word written once
                    stg[byte // 4] = q0 * 128 + r0
                    banks.append((byte // 4) % 32)
            lanes.append(banks)
    assert (stg >= 0).all()
    for box in range(2):
        for q in range(64):
            if n0 + 64 * a + q >= B:
                continue  # TMA clips the query rows past B
            for s in range(8):
                piece = s ^ (q % 8)  # the box row's 16-byte piece held at position s
                for k in range(4):
                    qq, rr = divmod(int(stg[(box * 8192 + q * 128 + 16 * s) // 4 + k]), 128)
                    assert qq == q and rr == 64 * box + 8 * piece + 2 * k
                    for j in range(2):
                        assert np.isnan(out[n0 + 64 * a + q, row0 + rr + j])
                        out[n0 + 64 * a + q, row0 + rr + j] = d[qq, rr + j]
    return lanes


@pytest.mark.parametrize("B,n0", [(1000, 896), (1000, 0), (50, 0), (64, 0)])
def test_k13_staged_tile_emulated(B, n0):
    """K13's staged tile writes every (query < B, row) of a chunk exactly
    once, at its place in the (B, N_pad) output, and drops the query rows
    past B; each store instruction's 32 lanes of a warp hit 32 banks; the
    in-place packing reads every accumulator register before it is
    overwritten (register 2 nt + h is written at step (nt, h), after the
    steps that read it)."""
    rng = np.random.default_rng(8)
    row0, n_pad = 256, 1024
    out = np.full((B, n_pad), np.nan, np.float32)
    tile = _bf16(rng.standard_normal((128, 128))).float().numpy()
    for a in range(2):
        for banks in _k13_stage_and_store(tile[64 * a : 64 * a + 64], n0, a, row0, B, out):
            for w in range(4):
                assert len(set(banks[32 * w : 32 * w + 32])) == 32
    q_hi = min(B, n0 + 128)
    np.testing.assert_array_equal(out[n0:q_hi, row0 : row0 + 128], tile[: q_hi - n0])
    written = ~np.isnan(out)
    assert written.sum() == (q_hi - n0) * 128
    read_at = {}
    for step in range(32):  # step (nt, h) = 2 nt + h reads registers 2 step, 2 step + 1
        read_at[2 * step] = read_at[2 * step + 1] = step
    assert all(read_at[k] <= k for k in range(32))


def _k14_chunk_emulate(d, row0):
    """K14's chunk-min as its consumer runs it, for one accumulator (64
    queries) of a chunk: each lane starts at (+inf, row0 + 2 t) and folds
    its 32 rows of each of its two queries (`k12_acc_coords`) in ascending
    order with a strict <, then the quad's lanes l ^ 1 and l ^ 2 in turn,
    keeping the smaller d, then the lower row; lane t of a quad holds the
    result of all four.  d: (64, 128) f32, +inf past n_valid -> ((64,) d,
    (64,) row)."""
    warp, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
    t = lane % 4
    best = np.full((4, 32, 2), np.inf, np.float32)
    brow = np.repeat((row0 + 2 * t)[..., None], 2, -1).astype(np.int64)
    for nt in range(16):
        for h in range(2):
            for j in range(2):
                q, r = SR.k12_acc_coords(warp, lane, nt * 4 + 2 * h + j)
                take = d[q, r] < best[..., h]
                best[..., h] = np.where(take, d[q, r], best[..., h])
                brow[..., h] = np.where(take, row0 + r, brow[..., h])
    for off in (1, 2):
        d2, r2 = best[:, lane[0] ^ off], brow[:, lane[0] ^ off]
        take = (d2 < best) | ((d2 == best) & (r2 < brow))
        best, brow = np.where(take, d2, best), np.where(take, r2, brow)
    out_d, out_i = np.empty(64, np.float32), np.empty(64, np.int64)
    for w in range(4):
        for g in range(8):
            for h in range(2):
                lanes = 4 * g + np.arange(4)
                assert (best[w, lanes, h] == best[w, 4 * g, h]).all() and (brow[w, lanes, h] == brow[w, 4 * g, h]).all()
                out_d[16 * w + g + 8 * h], out_i[16 * w + g + 8 * h] = best[w, 4 * g, h], brow[w, 4 * g, h]
    return out_d, out_i


@pytest.mark.parametrize("n_valid", [128 * 3 + 128, 128 * 3 + 70, 128 * 3 + 1, 128 * 3])
def test_k14_chunk_min_emulated(n_valid):
    """The emulated K14 lane / quad reduction over both accumulators equals
    `_chunk_min` (the plain version's) on bf16 values: the lowest row wins
    ties in one lane (rows 8 / 9, 0 / 2 ... of one t), across a quad's lanes
    (rows 1 / 2), across the 64-row middle (63 / 64, 0 / 127) and
    three-way; rows at or past n_valid are +inf, and a chunk wholly past it
    gives (+inf, its first row)."""
    rng = np.random.default_rng(9)
    row0 = 128 * 3
    d = _bf16(rng.standard_normal((128, 128)) * 4).float().numpy()  # 3 significant digits: many ties
    pairs = [(63, 64), (64, 63), (0, 127), (127, 0), (8, 9), (2, 1), (66, 120), (16, 8, 24), (5, 69, 101)]
    for q in range(128):
        d[q, list(pairs[q % len(pairs)])] = -10.0 - q // len(pairs)
    d[3, 100] = -100.0  # a masked row may not win when n_valid cuts it
    rows = row0 + np.arange(128)
    dm = np.where(rows[None, :] < n_valid, d, np.inf).astype(np.float32)
    want_d, want_i = SR._chunk_min(torch.from_numpy(dm))
    for a in range(2):
        got_d, got_i = _k14_chunk_emulate(dm[64 * a : 64 * a + 64], row0)
        np.testing.assert_array_equal(got_d, want_d[64 * a : 64 * a + 64, 0].numpy())
        np.testing.assert_array_equal(got_i, row0 + want_i[64 * a : 64 * a + 64, 0].numpy())
    if n_valid <= row0:
        assert np.isinf(want_d.numpy()).all() and (want_i.numpy() == 0).all()


def test_bf16_doubling_is_exact():
    """K13 / K14 skip the rounding of bf(2 p): for every bf16 value p
    (subnormals, +-0, +-inf, the largest finite, random ones), 2 p in f32
    is already a bf16 value (or +-inf), so bf(2 p) = 2 p bit for bit."""
    bits = torch.arange(0, 1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    p = bits.float()
    p = p[~torch.isnan(p)]
    two_p = 2.0 * p
    assert torch.equal(SR._bf(two_p).view(torch.int32), two_p.view(torch.int32))


@pytest.mark.parametrize("n", [1, 1023, 1025, 2047, 2049, 4100])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_int8_wrappers_on_ragged_rows_match_padded_reference(dist, n):
    """On the CPU the K13 / K14 wrappers equal their plain versions on the
    base zero-padded to N_pad (1024 / 2048 rows), for N that is not a
    multiple, with n_valid below and above N: the rows past N are zero rows
    with scale and cache 0, the semantics the kernel gives them by reading
    the base in place (TMA's zero fill, guarded channel loads)."""
    base, qs = _make(n, 48, B, seed=10)
    q8, qsc, qc, b8, bsc, cache = _t(*_int8_inputs(dist, 48, seed=10, n=n))
    for nv in (max(n - 7, 0), n + 5):
        want13 = SR.scan_dist_int8_ref(q8, qsc, qc, *SR._pad_rows(SR._NB, b8, bsc, cache), nv, dist)
        got13 = SR.scan_dist_int8(q8, qsc, qc, b8, bsc, cache, nv, dist)
        assert got13.shape == (B, -(-n // 1024) * 1024) and torch.equal(got13, want13)
        pad = got13[:, n:].float()
        zero = SR._epilogue_bf16(torch.zeros(()), qsc[:, None], qc[:, None], torch.zeros(()), torch.zeros(()), dist)
        past = torch.arange(n, got13.shape[1]) >= nv
        np.testing.assert_array_equal(pad.numpy(), torch.where(past, float("inf"), zero.expand_as(pad)).numpy())
        want14 = SR.scan_chunkmin_int8_t_ref(q8, qsc, qc, *SR._pad_rows(SR._NB_T, b8, bsc, cache), nv, dist)
        got14 = SR.scan_chunkmin_int8_t(q8, qsc, qc, b8, bsc, cache, nv, dist)
        assert got14[0].shape == (-(-n // 2048) * 16, B)
        assert torch.equal(got14[0], want14[0]) and torch.equal(got14[1], want14[1])
