"""The exact uint8 route of `FlatIndexU8` (`models/u8.py`: the uint8 variant
of K1, the select, the rescan of the k chosen 128-row groups) on the CPU,
where every step runs its plain version:

- the route against `benchmark/reference.exact_topk`: distances equal to
  the bit, ids equal up to ties, on ragged, duplicated, heavily tied,
  planted, extreme and padded tables; a table of fewer than k * 128 rows
  takes the library path and answers the same;
- the route against the JAX package's `FlatIndexU8`;
- the uint8 K1 twin's packing against a direct integer computation;
- `from_device` against `from_numpy`: the mirror, the answers, the lazy
  host copy; the block-built mirror against `u8_channels`;
- `exact_route` on both sides of each of its conditions, and the spans.
"""

import numpy as np
import pytest
import torch

from benchmark import reference
from lab_1806_vec_db_tpu_torch.models import FlatIndexU8
from lab_1806_vec_db_tpu_torch.models import u8 as MU8
from lab_1806_vec_db_tpu_torch.models.mirror import U8Mirror
from lab_1806_vec_db_tpu_torch.ops import scan as S
from lab_1806_vec_db_tpu_torch.ops import survivors as SV
from lab_1806_vec_db_tpu_torch.ops import u8 as U8
from lab_1806_vec_db_tpu_torch.utils import profiling

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

K = 10


def _rng(seed):
    return np.random.default_rng(seed)


def _brute(rows: np.ndarray, queries: np.ndarray) -> np.ndarray:
    r, q = rows.astype(np.int64), queries.astype(np.int64)
    return ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)


def table(case: str):
    """(rows, queries) uint8 of one case."""
    rng = _rng(sum(map(ord, case)))
    if case == "ragged":  # n not a multiple of 2048
        return rng.integers(0, 256, (5000, 128), dtype=np.uint8), rng.integers(0, 256, (9, 128), dtype=np.uint8)
    if case == "duplicates":  # every row four times over
        base = rng.integers(0, 256, (1100, 128), dtype=np.uint8)
        rows = np.concatenate([base] * 4)[rng.permutation(4400)]
        return rows, np.concatenate([base[:4], rng.integers(0, 256, (4, 128), dtype=np.uint8)])
    if case == "few_values":  # distances tie heavily
        return (rng.choice(np.array([0, 1, 255], np.uint8), (3000, 128)),
                rng.choice(np.array([0, 1, 255], np.uint8), (8, 128)))
    if case == "planted":  # the 10 nearest rows in one 128-row group: c 1, s 5, levels 3..12
        rows = rng.integers(0, 256, (6000, 128), dtype=np.uint8)
        q = rng.integers(0, 256, (3, 128), dtype=np.uint8)
        for j, lvl in enumerate(range(3, 13)):
            near = q[0].astype(np.int64)
            near[j] = 255 - near[j] if near[j] < 128 else 0
            rows[2048 + 5 + 16 * lvl] = near
        return rows, q
    if case == "extreme":  # the nearest rows at d ~ 128 * 253^2, near 2^23 (at most 128 * 255^2)
        rows = np.concatenate([np.zeros((1400, 128), np.uint8), rng.integers(0, 3, (1600, 128), dtype=np.uint8)])
        return rows, np.stack([np.full(128, 255, np.uint8), np.zeros(128, np.uint8), rows[-1]])
    if case == "padding":  # just k * 128 rows: most rows of the chosen groups are padding
        return rng.integers(0, 256, (K * 128, 128), dtype=np.uint8), rng.integers(0, 256, (6, 128), dtype=np.uint8)
    raise KeyError(case)


def assert_exact(rows, queries, d, i):
    """Distances equal to the exact top-k's to the bit, each id a distinct
    valid row at its distance (ids equal the reference's up to ties)."""
    want_d, want_i = reference.exact_topk(torch.from_numpy(rows), torch.from_numpy(queries), K, "l2sqr")
    d, i = np.asarray(d), np.asarray(i)
    assert d.dtype == np.float32 and np.array_equal(d.astype(np.float64), want_d.numpy())
    assert ((i >= 0) & (i < len(rows))).all() and all(len(set(r)) == K for r in i.tolist())
    full = _brute(rows, queries)
    assert np.array_equal(np.take_along_axis(full, i.astype(np.int64), 1), d.astype(np.int64))
    assert_same_nearer(d, i, want_d.numpy(), want_i.numpy())


def assert_same_nearer(d, i, want_d, want_i):
    """The rows nearer than the k-th distance are the same set."""
    kth = want_d[:, K - 1:]
    for a, b, da, db, t in zip(i, want_i, d, want_d, kth):
        assert set(a[da < t].tolist()) == set(b[db < t].tolist())


@pytest.mark.parametrize("case", ["ragged", "duplicates", "few_values", "planted", "extreme", "padding"])
def test_route_is_exact_against_the_reference(case):
    rows, queries = table(case)
    idx = FlatIndexU8.from_numpy(rows, "l2sqr", device="cpu")
    d, i = idx._knn_exact(torch.from_numpy(queries), K)
    assert_exact(rows, queries, d.numpy(), i.numpy())
    # the library path (the CPU's route) gives the same distances, ids up to ties
    d2, i2 = idx.knn_batch(queries, K)
    assert np.array_equal(d2, d.numpy())
    assert_exact(rows, queries, d2, i2)


def test_planted_group_is_found_whole():
    """The 10 nearest rows share one group: one group's rescan returns all of them."""
    rows, queries = table("planted")
    _, i = FlatIndexU8.from_numpy(rows, "l2sqr", device="cpu")._knn_exact(torch.from_numpy(queries[:1]), K)
    assert sorted(i[0].tolist()) == [2048 + 5 + 16 * lvl for lvl in range(3, 13)]


def test_table_below_k_groups_takes_the_library_path():
    rows = _rng(3).integers(0, 256, (K * 128 - 1, 128), dtype=np.uint8)
    queries = _rng(4).integers(0, 256, (5, 128), dtype=np.uint8)
    assert not MU8.exact_route("l2sqr", torch.device("cuda"), 128, len(rows), K)
    assert MU8.exact_route("l2sqr", torch.device("cuda"), 128, len(rows) + 1, K)
    d, i = FlatIndexU8.from_numpy(rows, "l2sqr", device="cpu").knn_batch(queries, K)
    assert_exact(rows, queries, d, i)


def test_padding_rows_are_never_returned():
    rows, queries = table("padding")
    idx = FlatIndexU8.from_numpy(rows, "l2sqr", device="cpu")
    m = idx.store.mirror()
    assert m.q8.shape[0] == 2048 and (m.cache[len(rows):] == S.U8_SENTINEL).all()
    assert not m.q8[len(rows):].any()
    _, i = idx._knn_exact(torch.from_numpy(queries), K)
    assert (i < len(rows)).all()


def test_route_against_the_jax_package():
    from lab_1806_vec_db_tpu.models import FlatIndexU8 as JFlatIndexU8

    rows, queries = table("ragged")
    d, i = FlatIndexU8.from_numpy(rows, "l2sqr", device="cpu")._knn_exact(torch.from_numpy(queries), K)
    jd, ji = JFlatIndexU8.from_numpy(rows, "l2sqr").knn_batch(queries, K)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert_same_nearer(d.numpy(), i.numpy(), np.asarray(jd), np.asarray(ji))


@pytest.mark.parametrize("n,B,dim", [(4096, 7, 128), (2500, 3, 96), (2048, 1, 129)])
def test_u8_k1_twin_packs_the_direct_integer_minimum(n, B, dim):
    rng = _rng(n + B)
    rows = rng.integers(0, 256, (n, dim), dtype=np.uint8)
    queries = rng.integers(0, 256, (B, dim), dtype=np.uint8)
    m = U8Mirror.build(torch.from_numpy(rows), n, "l2sqr", "cpu")
    q8, qn8 = m.queries(torch.from_numpy(queries))
    got = S.scan_chunkmin_u8_packed(q8, qn8, m.q8, m.cache).numpy()
    full = _brute(rows, queries)  # (B, n)
    n_pad = m.q8.shape[0]
    d = np.full((B, n_pad), S.U8_SENTINEL, np.int64)
    d[:, :n] = full
    d[:, n:] += (m.queries(torch.from_numpy(queries))[1].numpy().astype(np.int64))[:, None]  # zero rows: 2^23 + |q8|^2
    packed = d.reshape(B, n_pad // 2048, 128, 16) * 128 + np.arange(128)[None, None, :, None]
    want = packed.min(axis=2).reshape(B, -1).T
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert want.max() < 2**31
    # a mirror cut to the table's rows is refused unless it is whole chunks
    cut = (m.q8[:n].contiguous(), m.cache[:n].contiguous())
    if n % 2048:
        with pytest.raises(ValueError, match="multiple of 2048"):
            S.scan_chunkmin_u8_packed(q8, qn8, *cut)
    else:
        assert np.array_equal(S.scan_chunkmin_u8_packed(q8, qn8, *cut).numpy(), got)


def test_from_device_equals_from_numpy_and_copies_to_the_host_lazily():
    rows, queries = table("ragged")
    a = FlatIndexU8.from_numpy(rows, "l2sqr", device="cpu")
    b = FlatIndexU8.from_device(torch.from_numpy(rows.copy()), "l2sqr")
    assert b.store._host is None and len(b) == len(rows) and b.dim == 128
    ma, mb = a.store.mirror(), b.store.mirror()
    assert all(torch.equal(x, y) for x, y in zip((ma.q8, ma.cache, ma.s8), (mb.q8, mb.cache, mb.s8)))
    assert all(torch.equal(x, y) for x, y in zip(a.store.device(), b.store.device()))
    for call in ("knn_batch", "_knn_exact"):
        qa = queries if call == "knn_batch" else torch.from_numpy(queries)
        ra, rb = getattr(a, call)(qa, K), getattr(b, call)(qa, K)
        assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(ra, rb))
    assert b.store._host is None  # searches need no host copy
    assert np.array_equal(b.store.numpy(), rows) and b.store._host is not None
    assert b.index_bytes() == a.index_bytes() == sum(t.numel() * t.element_size() for t in mb.tensors)


def test_mutation_after_from_device_rebuilds_the_mirror():
    rows, queries = table("ragged")
    idx = FlatIndexU8.from_device(torch.from_numpy(rows[:3000].copy()), "l2sqr")
    idx.batch_add(rows[3000:])
    assert len(idx) == len(rows) and idx.store._mirror is None
    d, i = idx._knn_exact(torch.from_numpy(queries), K)
    assert_exact(rows, queries, d.numpy(), i.numpy())
    idx.store.swap_remove(0)
    want = rows.copy()
    want[0] = rows[-1]
    assert np.array_equal(idx.store.numpy(), want[:-1])


@pytest.mark.parametrize("block", [300, 2048, 1 << 18])
def test_block_built_mirror_equals_u8_channels(block, monkeypatch):
    from lab_1806_vec_db_tpu_torch.models import mirror

    monkeypatch.setattr(mirror, "_U8_BLOCK_ROWS", block)
    rows = _rng(block).integers(0, 256, (4100, 96), dtype=np.uint8)
    n = 4000  # the last 100 rows are not the table's
    m = U8Mirror.build(torch.from_numpy(rows), n, "l2sqr", "cpu")
    x8, ip, s8 = U8.u8_channels(torch.from_numpy(rows[:n]))
    mx8, mip, ms8 = m.channels()
    assert m.q8.shape == (4096, 128) and not m.q8[:, 96:].any() and not m.q8[n:].any()
    assert torch.equal(mx8[:n], x8) and torch.equal(ms8[:n], s8) and torch.equal(mip[:n], ip)
    assert (mip[n:] == 2**30).all() and (m.cache[n:] == S.U8_SENTINEL).all()
    assert torch.equal(m.cache[:n], (x8.int() ** 2).sum(1, dtype=torch.int32))
    assert np.array_equal(m.host_rows(), rows[:n])


BASE = dict(dist="l2sqr", device=torch.device("cuda"), dim=128, n=K * 128, k=K)


@pytest.mark.parametrize("change,takes", [
    ({}, True),
    ({"dist": "cosine"}, False),
    ({"device": torch.device("cpu")}, False),
    ({"dim": 129}, True), ({"dim": 130}, False),
    ({"n": K * 128 - 1}, False),
    ({"k": SV.R_MAX, "n": SV.R_MAX * 128}, True), ({"k": SV.R_MAX + 1, "n": (SV.R_MAX + 1) * 128}, False),
    ({"k": 0}, False),
])
def test_route_rule(change, takes):
    assert MU8.exact_route(**dict(BASE, **change)) == takes
    assert S.u8_exact_width(129) and not S.u8_exact_width(130)


def test_spans_of_a_call_and_of_the_route():
    rows, queries = table("ragged")
    idx = FlatIndexU8.from_device(torch.from_numpy(rows.copy()), "l2sqr")
    with profiling.collect() as spans:
        idx.knn_batch(queries, K)  # the CPU's library path
        idx._knn_exact(torch.from_numpy(queries), K)
    c = spans.count
    assert (c["u8.knn_batch"], c["u8.upload"], c["u8.fetch"]) == (1, 1, 1)
    assert (c["u8.scan"], c["u8.rescan"]) == (1, 1)
    with profiling.collect() as spans:
        FlatIndexU8.from_device(torch.from_numpy(rows.copy()), "l2sqr")
    assert spans.count["u8.ingest"] == 1


@pytest.mark.cuda
def test_u8_k1_kernel_equals_its_twin_on_the_card():
    """The kernel against its plain version (on the card: python -m pytest
    tests/test_torch_u8_exact.py -m cuda --noconftest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the uint8 K1 variant is a CUDA kernel")
    rng = _rng(1)
    rows = torch.from_numpy(rng.integers(0, 256, (9000, 128), dtype=np.uint8)).cuda()
    m = U8Mirror.build(rows, 8500, "l2sqr", "cuda")
    for B in (1000, 129, 1):
        q8, qn8 = m.queries(torch.from_numpy(rng.integers(0, 256, (B, 128), dtype=np.uint8)).cuda())
        got = S.scan_chunkmin_u8_packed(q8, qn8, m.q8, m.cache)
        assert torch.equal(got, S.scan_chunkmin_u8_packed_ref(q8, qn8, m.q8, m.cache))


def test_k1_plan_keeps_an_items_query_tiles_together_at_100m():
    """At BIGANN-100M's rows and B 1000 the 8 query tiles of an item are 8
    CTAs of one wave (grid 8 x 16 = 128 of 132 SMs), so the rows of an item
    come from device memory once and from L2 for the 7 other tiles."""
    n_pad = -(-100_000_000 // 2048) * 2048
    plan = S.k1_plan(n_pad, 1000, 132)
    assert plan == {"qtiles": 8, "parts": 1, "ctas": 16, "items": n_pad // 2048}
    assert plan["qtiles"] * plan["ctas"] <= 132
