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
from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR
from lab_1806_vec_db_tpu_torch.ops import topk as T

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
