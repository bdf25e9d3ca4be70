"""The exact small-batch scan (`ops/scan_small.py`, `csrc/scan_exact_small.cu`)
and the rule by which `topk.knn_scan` hands it a call.

On the CPU: the plain version against float64, its tie order and padding,
the difference form where the GEMM chain's l2sqr loses digits, and the
dispatch rule (a CPU tensor never takes the kernel; each shape outside the
rule takes the chain).  Marked `cuda` (skipped without a card; on the card,
where the JAX package that tests/conftest.py imports is not installed:
`python -m pytest tests/test_torch_scan_small.py -m cuda -q --noconftest`):
the kernel against the plain version and float64, and its launch counter."""

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu_torch.ops import distance as D
from lab_1806_vec_db_tpu_torch.ops import scan_small as SS
from lab_1806_vec_db_tpu_torch.ops import topk as T
from lab_1806_vec_db_tpu_torch.utils import profiling

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

DISTS = ["l2sqr", "cosine"]


def _rows(n, dim, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32))


def _f64(x, q, dist):
    """(B, n) float64 distances."""
    x, q = x.double(), q.double()
    if dist == "l2sqr":
        return ((q[:, None, :] - x[None]) ** 2).sum(-1)
    return 1 - (q @ x.T) / (q.norm(dim=1)[:, None] * x.norm(dim=1)[None]).clamp_min(1e-10)


# ---- the plain version ----


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("dist", DISTS)
def test_plain_matches_float64(dist, B):
    """Distances within rtol 1e-6 of float64 for the rows they name, and
    those rows are float64's top k (no near-ties in this draw)."""
    x, q = _rows(500, 64, 1), _rows(B, 64, 2)
    d, i = SS.exact_scan_small_ref(q, x, D.dist_cache(x, dist), 500, 10, dist)
    e = _f64(x, q, dist)
    own = torch.gather(e, 1, i.long())
    torch.testing.assert_close(d.double(), own, rtol=1e-6, atol=0)
    assert torch.equal(i.long(), torch.sort(e, dim=1, stable=True)[1][:, :10])
    assert bool((d[:, 1:] >= d[:, :-1]).all())


@pytest.mark.parametrize("dist", DISTS)
def test_ties_keep_the_lower_id(dist):
    x = _rows(64, 32, 3)
    x[40] = x[7]
    x[12] = x[7]
    x[50] = x[7]
    q = (x[7] * 1.5)[None] if dist == "cosine" else x[7][None] + 0.01
    d, i = SS.exact_scan_small_ref(q, x, D.dist_cache(x, dist), 64, 4, dist)
    assert i[0].tolist() == [7, 12, 40, 50]
    assert len(set(d[0].tolist())) == 1


@pytest.mark.parametrize("dist", DISTS)
def test_fewer_rows_than_k_pad_with_inf_and_minus_one(dist):
    x, q = _rows(20, 16, 4), _rows(2, 16, 5)
    d, i = SS.exact_scan_small_ref(q, x, D.dist_cache(x, dist), 3, 8, dist)
    assert bool((i[:, :3] >= 0).all()) and bool((i[:, :3] < 3).all())
    assert bool((i[:, 3:] == -1).all()) and bool(torch.isinf(d[:, 3:]).all())
    d, i = SS.exact_scan_small_ref(q, x, D.dist_cache(x, dist), 0, 8, dist)
    assert d.shape == (2, 8) and bool((i == -1).all()) and bool(torch.isinf(d).all())


@pytest.mark.parametrize("dist", DISTS)
def test_rows_past_n_valid_are_never_returned(dist):
    """Padding rows equal to the query (distance 0) stay out."""
    x, q = _rows(100, 16, 6), _rows(1, 16, 7)
    x[60:] = q[0]
    d, i = SS.exact_scan_small_ref(q, x, D.dist_cache(x, dist), 60, 10, dist)
    assert bool((i < 60).all()) and bool((i >= 0).all())
    assert bool((d > 1e-3).all())


def test_difference_form_meets_rtol_where_the_gemm_form_misses():
    """Near-duplicate rows far from the origin: q^2 + x^2 - 2 q.x cancels
    (the chain's l2sqr, ROADMAP queue 1's fault, made small); the difference
    form keeps the digits."""
    rng = np.random.default_rng(8)
    c = rng.standard_normal(128).astype(np.float32) * 30
    x = torch.from_numpy(c + rng.standard_normal((400, 128)).astype(np.float32) * 0.05)
    q = torch.from_numpy(c + rng.standard_normal((1, 128)).astype(np.float32) * 0.05)
    cache = D.dist_cache(x, "l2sqr")
    e = _f64(x, q, "l2sqr")

    def rel(d, i):
        own = torch.gather(e, 1, i.long())
        return float(((d.double() - own).abs() / own).max())

    assert rel(*T.knn_scan(q, x, cache, 400, 10, "l2sqr")) > 1e-5
    assert rel(*SS.exact_scan_small_ref(q, x, cache, 400, 10, "l2sqr")) <= 1e-5


def test_nan_rows_count_as_inf():
    x, q = _rows(10, 8, 9), _rows(1, 8, 10)
    x[2] = float("nan")
    d, i = SS.exact_scan_small_ref(q, x, D.dist_cache(x, "l2sqr"), 10, 10, "l2sqr")
    assert 2 not in i[0].tolist() and i[0, -1] == -1 and torch.isinf(d[0, -1])


# ---- the rule ----


def test_plan_covers_the_rows_in_one_wave():
    for n, per_sm, sms in [(200_000, 3, 132), (1_000_000, 2, 132), (127, 3, 132), (1, 3, 132), (0, 3, 132)]:
        grid, slab = SS.plan(n, per_sm, sms)
        assert 1 <= grid <= per_sm * sms and grid * slab >= n
        assert grid == 1 or slab >= SS._MIN_CTA_ROWS
    assert SS.plan(200_000, 3, 132) == (396, 506)


@pytest.mark.parametrize("B,dim,k,ok", [
    (1, 960, 10, True), (SS.B_MAX, 960, SS.K_MAX, True), (SS.B_MAX + 1, 960, 10, False),
    (1, 960, SS.K_MAX + 1, False), (1, 962, 10, False), (0, 960, 10, False), (1, 960, 0, False),
    (SS.B_MAX, 4 * 1024, 10, False)])
def test_shape_rule(B, dim, k, ok):
    assert SS.fits(B, dim, k) is ok


def test_rows_rule():
    x = _rows(64, 16, 11)
    assert SS.rows_fit(x)
    assert not SS.rows_fit(x.to(torch.bfloat16))
    assert not SS.rows_fit(x[:, :8])  # not contiguous
    assert not SS.rows_fit(x.reshape(-1)[1:1 + 63 * 16].reshape(63, 16))  # off the 16-byte boundary


def _routes(q, x, k, dist="l2sqr"):
    """Runs knn_scan; returns how many calls took the kernel route."""
    with profiling.collect() as spans:
        T.knn_scan(q, x, D.dist_cache(x.float(), dist), x.shape[0], k, dist)
    return spans.count["scan.exact_small"]


def test_a_cpu_tensor_never_takes_the_kernel():
    x, q = _rows(300, 64, 12), _rows(1, 64, 13)
    launches = SS.exact_scan_small.launches
    assert not SS.takes_kernel(q, x, 10)
    assert _routes(q, x, 10) == 0
    assert SS.exact_scan_small.launches == launches


@pytest.mark.parametrize("case", ["inside", "B_MAX + 1", "K_MAX + 1", "bf16 rows", "dim % 4 != 0"])
def test_each_shape_outside_the_rule_takes_the_chain(case, monkeypatch):
    """With the card check forced true, the rule alone picks the route; the
    kernel route on a CPU tensor runs the plain version, which agrees with
    the chain."""
    monkeypatch.setattr(SS, "_on_card", lambda q, b: True)
    B, dim, k, dtype = 1, 64, 10, torch.float32
    if case == "B_MAX + 1":
        B = SS.B_MAX + 1
    elif case == "K_MAX + 1":
        k = SS.K_MAX + 1
    elif case == "bf16 rows":
        dtype = torch.bfloat16
    elif case == "dim % 4 != 0":
        dim = 62
    x, q = _rows(300, dim, 14).to(dtype), _rows(B, dim, 15)
    assert _routes(q, x, k) == (1 if case == "inside" else 0)
    if case == "inside":
        cache = D.dist_cache(x, "l2sqr")
        d, i = T.knn_scan(q, x, cache, 300, k, "l2sqr")
        dc, ic = SS.exact_scan_small_ref(q, x, cache, 300, k, "l2sqr")
        assert torch.equal(i, ic) and torch.equal(d, dc)


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _check_kernel(x, q, n, k, dist):
    """The kernel against the plain version and float64: distances within
    1e-5 (relative; cosine against its range), ids equal except where the
    float64 distances tie within 1e-6."""
    cache = D.dist_cache(x, dist)
    kd, ki = SS.exact_scan_small(q, x, cache, n, k, dist)
    rd, ri = SS.exact_scan_small_ref(q, x, cache, n, k, dist)
    kk = min(k, n)
    assert bool((ki[:, kk:] == -1).all()) and bool(torch.isinf(kd[:, kk:]).all())
    if not kk:
        return
    floor = 1.0 if dist == "cosine" else 1e-30
    ek, er = (torch.gather(_f64(x[:n], q, dist), 1, i[:, :kk].long()) for i in (ki, ri))
    assert float(((kd[:, :kk].double() - ek).abs() / ek.abs().clamp_min(floor)).max()) < 1e-5
    torch.testing.assert_close(kd[:, :kk], rd[:, :kk], rtol=1e-5, atol=1e-5)
    differ = ki[:, :kk] != ri[:, :kk]
    if bool(differ.any()):
        gap = (ek.sort(1)[0] - er.sort(1)[0]).abs() / er.abs().clamp_min(floor)
        assert float(gap.max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dim", [128, 960])
@pytest.mark.parametrize("n", [1, 127, 65_537, 200_000])
def test_kernel_matches_plain_and_float64(card, n, dim, dist):
    gen = torch.Generator(device=card).manual_seed(n + dim)
    x = torch.randn((n + 33, dim), device=card, generator=gen)
    if n > 100:
        x[n - 1] = x[5]  # an exact tie
    for B in range(1, SS.B_MAX + 1):
        q = torch.randn((B, dim), device=card, generator=gen)
        if n > 100:
            q[0] = x[5] + 1e-3
        for k in (1, 10, SS.K_MAX):
            _check_kernel(x, q, n, k, dist)


@pytest.mark.cuda
def test_launch_counter_moves_once_a_call(card):
    x = torch.randn((5000, 128), device=card)
    q = torch.randn((1, 128), device=card)
    cache = D.dist_cache(x, "cosine")
    before = SS.exact_scan_small.launches
    for j in range(1, 4):
        T.knn_scan(q, x, cache, 5000, 10, "cosine")
        assert SS.exact_scan_small.launches == before + j
    T.knn_scan(torch.randn((SS.B_MAX + 1, 128), device=card), x, cache, 5000, 10, "cosine")
    assert SS.exact_scan_small.launches == before + 3
    with pytest.raises(ValueError):
        SS.exact_scan_small(torch.randn((SS.B_MAX + 1, 128), device=card), x, cache, 5000, 10, "cosine")
