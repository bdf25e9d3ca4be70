"""The stage-1 survivor select: the plain version's contract on hand-made
(S, B) survivors, the kernel's algorithm (`csrc/select_survivors.cu`)
emulated step by step against it, the shape rule that sends a call to the
kernel, and the wrapper's refusals.

The CUDA kernel itself is held bit for bit against the plain version on the
card by `chip_smoke.py`'s select phase."""

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu_torch.ops import distance as D
from lab_1806_vec_db_tpu_torch.ops import scan as S
from lab_1806_vec_db_tpu_torch.ops import survivors as SV
from lab_1806_vec_db_tpu_torch.ops import topk as T
from lab_1806_vec_db_tpu_torch.utils import profiling

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

NEG_ZERO = -(2**31)  # the packed bits of -0.0 at level 0


def _bits(x):
    return int(np.array(x, np.float32).view(np.int32))


def _packed(values):
    """An (S, B) int32 survivor array from rows of packed ints."""
    return torch.tensor(np.array(values, np.int64).astype(np.int32))


def _reference(packed: np.ndarray, r: int):
    """The contract written out in numpy: a stable argsort of each query's
    survivors viewed as f32 (numpy's puts NaN last and ties -0.0 with
    +0.0), the first r decoded, (+inf, -1) past S and at >= 1e38."""
    S_, B = packed.shape
    d = np.full((B, r), np.inf, np.float32)
    i = np.full((B, r), -1, np.int32)
    for b in range(B):
        col = packed[:, b]
        order = np.argsort(col.view(np.float32), kind="stable")[:r]
        v = col[order]
        dd = (v & ~127).view(np.float32)
        ii = (order // 16) * 2048 + order % 16 + (v & 127) * 16
        bad = dd >= np.float32(1e38)
        d[b, : len(order)] = np.where(bad, np.inf, dd)
        i[b, : len(order)] = np.where(bad, -1, ii)
    return d, i


def _assert_bits_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got[0], np.float32).view(np.int32),
                                  np.asarray(want[0], np.float32).view(np.int32))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _plain(packed, r):
    d, i = S.select_survivors(packed, r)
    return d.numpy(), i.numpy()


# ---- the plain version's contract on hand-made inputs ----

def test_ties_go_to_the_lower_position():
    one, two = _bits(1.0), _bits(2.0)
    # query 0: equal values at positions 1, 3, 4; query 1: all equal
    packed = _packed([[two, one], [one, one], [two | 5, one], [one, one], [one, one]])
    d, i = _plain(packed, 4)
    np.testing.assert_array_equal(i[0], [1, 3, 4, 0])
    np.testing.assert_array_equal(d[0], [1.0, 1.0, 1.0, 2.0])
    np.testing.assert_array_equal(i[1], [0, 1, 2, 3])


@pytest.mark.parametrize("neg_first", [True, False])
def test_negative_zero_ties_with_positive_zero(neg_first):
    """-0.0 and +0.0 are one key: the lower position comes first, and each
    keeps its own sign bit."""
    first, second = (NEG_ZERO, 0) if neg_first else (0, NEG_ZERO)
    packed = _packed([[_bits(1.0)], [first], [_bits(-1.0)], [second]])
    d, i = _plain(packed, 4)
    np.testing.assert_array_equal(i[0], [2, 1, 3, 0])
    assert np.signbit(d[0, 1]) == neg_first and np.signbit(d[0, 2]) != neg_first
    _assert_bits_equal((d, i), _reference(packed.numpy(), 4))


def test_sentinel_survivors_are_inf_and_minus_one():
    big = _bits(3.0e38)
    packed = _packed([[big | 3], [_bits(0.5) | 7], [big], [_bits(0.25)]])
    d, i = _plain(packed, 4)
    np.testing.assert_array_equal(i[0], [3, 1 + 7 * 16, -1, -1])
    assert np.isinf(d[0, 2:]).all() and (d[0, 2:] > 0).all()


def test_r_past_the_survivors_is_padded():
    rng = np.random.default_rng(0)
    packed = torch.from_numpy(rng.integers(0, 2**30, (16, 3)).astype(np.int32))
    d, i = _plain(packed, 40)
    assert d.shape == (3, 40) and i.dtype == np.int32
    assert np.isinf(d[:, 16:]).all() and (i[:, 16:] == -1).all()
    assert np.isfinite(d[:, :16]).all() and (i[:, :16] >= 0).all()
    _assert_bits_equal((d, i), _reference(packed.numpy(), 40))


def test_one_query():
    rng = np.random.default_rng(1)
    vals = (rng.random(300).astype(np.float32) + 0.5).view(np.int32) & ~127 | rng.integers(0, 128, 300)
    packed = torch.from_numpy(vals.astype(np.int32)[:, None])
    d, i = _plain(packed, 12)
    assert d.shape == (1, 12) and (np.diff(d[0]) >= 0).all()
    _assert_bits_equal((d, i), _reference(packed.numpy(), 12))


# ---- the kernel's algorithm, emulated ----

_TR, _GPL = 512, 16
_GROUPS = 32 * _GPL


def _order_key(v: np.ndarray) -> np.ndarray:
    """`order_key` of the kernel: -0.0 as +0.0, NaN last, at 0xFFFFFFFE
    (uint32 as int64; 0xFFFFFFFF marks a row past S)."""
    u = v.astype(np.int64) & 0xFFFFFFFF
    u = np.where(u == 0x80000000, 0, u)
    k = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where((u & 0x7FFFFFFF) > 0x7F800000, 0xFFFFFFFE, k)


def _pass_one_bound(keys: np.ndarray, r: int) -> int:
    """Pass 1 of the kernel on one query's keys: the least key (past 512 r,
    the two least) of each of 512 groups (group (lane, j) holds the
    positions 32 j + lane mod 512), then a binary search between their least
    and greatest for a key with at least r of them at or below it, stopped
    within 127 of the least such key."""
    row = np.arange(len(keys)) % _TR
    group = ((row // 32) % _GPL) * 32 + row % 32
    per = 2 if r > _GROUPS else 1
    g = np.full((_GROUPS, per), 0xFFFFFFFF, np.int64)  # a group with fewer keys: the key no bound takes
    for j in range(_GROUPS):
        least = np.sort(keys[group == j])[:per]
        g[j, : len(least)] = least
    lo, hi = int(g.min()), int(g.max())
    while hi - lo > 127:
        mid = lo + (hi - lo) // 2
        if int((g <= mid).sum()) >= r:
            hi = mid
        else:
            lo = mid + 1
    return hi


def _cap(r: int) -> int:
    """The kernel's buffer a query for r: the least power of two >= 2 r,
    at least 64 (its launcher's rule)."""
    cap = 64
    while cap < 2 * r:
        cap *= 2
    return cap


def _select_emulate(packed: np.ndarray, r: int):
    """The kernel, query by query: pass 1's bound T0 (where S > 2 r); pass 2's 512-row tiles, each appended at once where its
    rows below the bound fit the buffer, else 32 rows at a time, the buffer
    cut to its r least whenever the next 32 would overflow it; the final
    sort and decode -> ((B, r) f32, (B, r) int32, cuts made)."""
    S_, B = packed.shape
    cap = _cap(r)
    d = np.full((B, r), np.inf, np.float32)
    ids = np.full((B, r), -1, np.int32)
    cuts = 0
    for b in range(B):
        keys = _order_key(packed[:, b])
        pos = np.arange(S_)
        lim = 0xFFFFFFFF
        if S_ > 2 * r:
            t0 = _pass_one_bound(keys, r)
            lim = min(t0, 0xFFFFFFFE) + 1
            assert int((keys <= t0).sum()) >= r  # T0 bounds the r-th key
        buf = []
        for t0 in range(0, S_, _TR):
            tile = pos[t0 : t0 + _TR]
            if len(buf) + int((keys[tile] < lim).sum()) <= cap:  # the tile at once
                buf += [(int(keys[ss]) << 32) | int(ss) for ss in tile[keys[tile] < lim]]
                continue
            for s0 in range(t0, min(t0 + _TR, S_), 32):  # else 32 rows at a time
                s = pos[s0 : s0 + 32]
                take = keys[s] < lim
                if not take.any():
                    continue
                if len(buf) + int(take.sum()) > cap:
                    buf = sorted(buf)[:r]
                    lim = buf[r - 1] >> 32
                    take = keys[s] < lim
                    cuts += 1
                buf += [(int(kk) << 32) | int(ss) for kk, ss in zip(keys[s][take], s[take])]
        best = sorted(buf)[:r]
        for j, item in enumerate(best):
            sj = item & 0xFFFFFFFF
            v = int(packed[sj, b])
            dj = np.array(v & ~127, np.int64).astype(np.int32).view(np.float32)
            if dj >= np.float32(1e38):
                continue
            d[b, j] = dj
            ids[b, j] = (sj // 16) * 2048 + sj % 16 + (v & 127) * 16
    return d, ids, cuts


def _bound_le(key: int):
    """`Bound::at_most` of the kernel -> (le as f32, all)."""
    k = 0x7FFFFFFE if key == 0x7FFFFFFF else key
    if k >= 0xFF800000:
        return np.float32(np.inf), key >= 0xFFFFFFFE
    bits = (k ^ 0x80000000) if k & 0x80000000 else (~k & 0xFFFFFFFF)
    return np.array(bits, np.uint32).view(np.float32), False


def test_bound_on_f32_values_is_the_key_bound():
    """Pass 2 tests a survivor as f32 (f <= le, or every key passes); that
    is `key <= bound` for every bound the kernel sets (pass 1's T0, a cut's
    r-th key less one) and every value, -0.0, denormals, infinities and NaN
    among them."""
    specials = np.array([0, NEG_ZERO, 1, -(2**31) + 1, 0x7F800000, -8388608, 0x7FC00000, -4194304,
                         0x7F7FFFFF, -8388609, _bits(1.0), _bits(-1.0), _bits(3.0e38) | 5], np.int64).astype(np.int32)
    rng = np.random.default_rng(9)
    vals = np.concatenate([specials, rng.integers(-(2**31), 2**31, 2000).astype(np.int32)])
    keys = _order_key(vals)
    f = vals.view(np.float32)
    bounds = {int(k) for k in keys} | {int(k) - 1 for k in keys} | {0x7FFFFFFF, 0xFF800000, 0xFFFFFFFD,
                                                                   0xFFFFFFFE, 0xFFFFFFFF, 0}
    with np.errstate(invalid="ignore"):
        for key in sorted(bounds):
            le, all_ = _bound_le(key)
            np.testing.assert_array_equal((f <= le) | all_, keys <= key, err_msg=f"bound {key:#x}")


def _survivor_like(rng, S_, B, spread=0.5):
    """K1-like survivors: positive distances around 1 with a level each."""
    dist = (1.0 + spread * rng.standard_normal((S_, B))).astype(np.float32)
    return (dist.view(np.int32) & ~127) | rng.integers(0, 128, (S_, B)).astype(np.int32)


def _heavy_ties(rng, S_, B):
    """Few distinct keys: four values (+0.0 and -0.0 among them) at two levels."""
    vals = np.array([0, NEG_ZERO, _bits(0.75), _bits(0.75) | 1], np.int64).astype(np.int32)
    return vals[rng.integers(0, 4, (S_, B))]


def _descending(rng, S_, B):
    """Each query's keys fall with the position: every survivor beats the
    ones before it (a bound built during the pass would keep them all)."""
    base = np.linspace(2.0, 0.1, S_, dtype=np.float32)[:, None].repeat(B, 1)
    return base.view(np.int32) & ~127 | rng.integers(0, 128, (S_, B)).astype(np.int32)


def _with_oddities(rng, S_, B):
    """Survivors with sentinels, negatives, ±0.0 and a NaN among them."""
    p = _survivor_like(rng, S_, B)
    p[rng.random((S_, B)) < 0.2] = _bits(3.0e38) | 5
    p[rng.random((S_, B)) < 0.05] = _bits(-0.01) | 9
    p[:5] = NEG_ZERO
    p[5:8] = 0
    p[9, 0] = 0x7FC00000
    return p


# (maker, S, B, r): pass 1 and the buffer's cut at the cell's r and pca's,
# HNSW's r past pass 1's 512 groups, S within the buffer, r past S
_EMULATED = {
    "cell_r40": (_survivor_like, 2400, 3, 40),
    "pca_r160": (_survivor_like, 2400, 2, 160),
    "hnsw_r600": (_survivor_like, 1568, 1, 600),
    "hnsw_r600_past_buffer": (_survivor_like, 3000, 1, 600),
    "overflow_s80": (_survivor_like, 80, 3, 40),
    "r_past_s": (_survivor_like, 16, 2, 40),
    "heavy_ties": (_heavy_ties, 2400, 3, 40),
    "descending": (_descending, 2400, 2, 40),
    "oddities": (_with_oddities, 1200, 2, 40),
}


@pytest.mark.parametrize("case", list(_EMULATED), ids=list(_EMULATED))
def test_kernel_algorithm_emulated_equals_plain(case):
    """The kernel's two passes and its buffer, emulated, give the plain
    version's bits on every input, whether or not the buffer had to be cut."""
    maker, S_, B, r = _EMULATED[case]
    packed = maker(np.random.default_rng(7), S_, B)
    d, i, cuts = _select_emulate(packed, r)
    want = _plain(torch.from_numpy(packed), r)
    _assert_bits_equal((d, i), want)
    _assert_bits_equal(want, _reference(packed, r))
    if case == "heavy_ties":
        assert cuts > 0  # the buffer's cut is exercised
    if case in ("cell_r40", "pca_r160", "hnsw_r600", "hnsw_r600_past_buffer", "descending"):
        assert cuts == 0  # pass 1's bound keeps about r


def _k1_output(dist, n, dim, B, seed):
    """K1's plain output on test_torch_scan.py's inputs (a numpy seed's
    normal rows and queries), with the port's channels."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal((n, dim)).astype(np.float32))
    qs = torch.from_numpy(rng.standard_normal((B, dim)).astype(np.float32))
    b8, sc = T.quantize_rows_int8(base)
    cache = D.dist_cache(base, dist)
    if dist == "cosine":
        sc, cache = sc / cache.clamp_min(1e-20), torch.zeros_like(cache)
    q8, qs2, qc = S.quantize_queries(qs, dim, dist)
    return S.scan_chunkmin_int8_packed(q8, qs2, qc, b8, sc, cache)


@pytest.mark.parametrize("r", [12, 40])
@pytest.mark.parametrize("dist,n,dim", [("l2sqr", 4200, 32), ("cosine", 4200, 128),
                                        ("l2sqr", 40_000, 32), ("cosine", 40_000, 32)])
def test_select_on_k1_outputs(dist, n, dim, r):
    """On K1's own survivors (S 48 within the buffer; S 320 through pass 1)
    the select, the contract written out in numpy and the kernel's
    algorithm give the same bits."""
    packed = _k1_output(dist, n, dim, 8, seed=1)
    got = _plain(packed, r)
    _assert_bits_equal(got, _reference(packed.numpy(), r))
    _assert_bits_equal(_select_emulate(packed.numpy(), r)[:2], got)


def test_pass_one_bound_keeps_about_r():
    """On unclustered keys the bound from 512 group minima lets through
    little more than r survivors (the reason the buffer is 2 r)."""
    rng = np.random.default_rng(3)
    packed = _survivor_like(rng, 7936, 4)
    for b in range(4):
        keys = _order_key(packed[:, b])
        assert 40 <= int((keys <= _pass_one_bound(keys, 40)).sum()) <= 2 * 40


# ---- the shape rule and the wrapper ----

class _Fake:
    """A stand-in for a CUDA tensor: what `takes_kernel` and
    `select_top_r`'s checks read of it."""

    def __init__(self, shape, dtype=torch.int32, cuda=True, contiguous=True):
        self.shape, self.dtype, self.is_cuda, self.device = shape, dtype, cuda, "cuda" if cuda else "cpu"
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous


@pytest.mark.parametrize("S_,B,r,taken", [
    (7936, 1000, 40, True),     # the cell
    (7936, 1000, 160, True),    # pca
    (1568, 1000, 600, True),    # HNSW's scan route at ef 600
    (80, 1000, 40, True),       # an IVF overflow segment
    (16, 1000, 40, True),       # r past S
    (7936, 1, 40, True),
    (7936, 1001, 40, True),
    (7936, 1000, 1024, True),   # the buffer's largest r
    (7936, 1000, 1025, False),  # past what the shared-memory buffer holds
    (7936, 1000, 0, True),      # nothing to write: the launcher returns at once
    (2**20, 2**11, 40, True),   # S B past 2^31: the kernel addresses the survivors through size_t
])
def test_shape_rule(S_, B, r, taken):
    assert SV.takes_kernel(_Fake((S_, B)), r) == taken


@pytest.mark.parametrize("fake,error", [
    (_Fake((7936, 1000), cuda=False), None), (_Fake((7936, 1000), dtype=torch.int64), (TypeError, "int32")),
    (_Fake((7936, 1000), contiguous=False), (ValueError, "contiguous")),
    (_Fake((7936, 1000, 1)), (ValueError, r"\(S, B\)")),
], ids=["cpu", "int64", "strided", "3d"])
def test_shape_rule_needs_a_contiguous_int32_cuda_matrix(fake, error):
    """The rule reads only the device and r: a CUDA tensor the kernel cannot
    read reaches the wrapper's error inside the kernel's route, never the
    sort; a CPU tensor takes the sort."""
    if error is None:
        assert not SV.takes_kernel(fake, 40)
        return
    assert SV.takes_kernel(fake, 40)
    with profiling.collect() as spans, pytest.raises(error[0], match=error[1]):
        S.select_survivors(fake, 40)
    assert spans.count["scan.select"] == 1 and SV.select_top_r.launches == 0


@pytest.mark.parametrize("r", [-1, SV.R_MAX + 1])
def test_wrapper_refuses_r_outside_its_buffer(r):
    with pytest.raises(ValueError, match="buffer"):
        SV.select_top_r(_Fake((7936, 1000)), r)
    assert SV.select_top_r.launches == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    good = torch.zeros((64, 4), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        SV.select_top_r(good.long(), 8)
    with pytest.raises(ValueError, match=r"\(S, B\)"):
        SV.select_top_r(good.reshape(-1), 8)
    with pytest.raises(ValueError, match="contiguous"):
        SV.select_top_r(good.T, 8)
    with pytest.raises(ValueError, match="device cpu"):
        SV.select_top_r(good, 8)
    assert SV.select_top_r.launches == 0


def test_cpu_calls_take_the_plain_version():
    """On the CPU `select_survivors` never enters the kernel's route: no
    `scan.select` span and no launch."""
    packed = torch.from_numpy(_survivor_like(np.random.default_rng(5), 300, 2))
    with profiling.collect() as spans:
        _plain(packed, 40)
    assert spans.count["scan.select"] == 0 and SV.select_top_r.launches == 0


def test_kernel_route_is_one_span_a_call(monkeypatch):
    """Where the rule holds, `select_survivors` is one `scan.select` span
    around the kernel's call and nothing else."""
    packed = torch.zeros((80, 3), dtype=torch.int32)
    calls = []
    monkeypatch.setattr(SV, "takes_kernel", lambda p, r: True)
    monkeypatch.setattr(SV, "select_top_r", lambda p, r: calls.append((p, r)) or ("d", "i"))
    with profiling.collect() as spans:
        assert S.select_survivors(packed, 40) == ("d", "i")
    assert spans.count["scan.select"] == 1 and calls == [(packed, 40)]
