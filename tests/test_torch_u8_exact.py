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
- `exact_route` on both sides of each of its conditions, and the spans;
- the uint8 kernel (`csrc/scan_u8_exact.cu`): its accumulator layout
  (`u8_acc_coords`), its plan (`u8_plan`, `u8_ring`), and its schedule,
  mbarrier protocol and fold emulated on the CPU against the plain version;
  on the card, the kernel itself against the plain version.
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
    """The kernel against its plain version, element for element (on the
    card: python -m pytest tests/test_torch_u8_exact.py -m cuda
    --noconftest): B 1, 16, 63, 64, 65 and 1000 (q 1, 2 and 4 of the plan,
    the second consumer idle or not) on a mirror with 500 sentinel tail
    rows; a table of 3 chunks (parts > 1) at B 1, 129 and 1000; 256 lanes
    (width 129); all-0 and all-255 rows and queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the uint8 K1 variant is a CUDA kernel")
    rng = _rng(1)

    def rand(n, dim):
        return torch.from_numpy(rng.integers(0, 256, (n, dim), dtype=np.uint8)).cuda()

    big, three = rand(20000, 128), rand(3 * 2048, 128)
    cases = [(big, 19500, rand(B, 128)) for B in (1, 16, 63, 64, 65, 1000)]
    cases += [(three, 3 * 2048 - 100, rand(B, 128)) for B in (1, 129, 1000)]
    cases += [(rand(9000, 129), 8000, rand(B, 129)) for B in (1, 300)]
    ends = torch.cat([torch.zeros((3000, 128), dtype=torch.uint8), torch.full((3000, 128), 255, dtype=torch.uint8)])
    cases.append((ends.cuda(), 6000, ends[2968:3032].cuda()))
    for rows, n, q in cases:
        m = U8Mirror.build(rows, n, "l2sqr", "cuda")
        q8, qn8 = m.queries(q)
        got = S.scan_chunkmin_u8_packed(q8, qn8, m.q8, m.cache)
        want = S.scan_chunkmin_u8_packed_ref(q8, qn8, m.q8, m.cache)
        assert torch.equal(got, want), (tuple(rows.shape), n, q.shape[0])


def test_k1_plan_keeps_an_items_query_tiles_together_at_100m():
    """The float K1's plan (`k1_plan`) at BIGANN-100M's rows and B 1000:
    the 8 query tiles of an item are 8 CTAs of one wave (grid 8 x 16 = 128
    of 132 SMs), so the rows of an item come from device memory once and
    from L2 for the 7 other tiles (the uint8 kernel has a plan of its own,
    `u8_plan`)."""
    n_pad = -(-100_000_000 // 2048) * 2048
    plan = S.k1_plan(n_pad, 1000, 132)
    assert plan == {"qtiles": 8, "parts": 1, "ctas": 16, "items": n_pad // 2048}
    assert plan["qtiles"] * plan["ctas"] <= 132


# ---- the uint8 kernel's layout, plan and schedule (csrc/scan_u8_exact.cu) ----


def _threads():
    """(warp, lane, register) grids of a consumer warpgroup."""
    return np.meshgrid(np.arange(4), np.arange(32), np.arange(64), indexing="ij")


def test_u8_acc_coords_give_each_query_slot_to_one_thread():
    """In the (64-query tile, 128-row box) accumulator every (query, slot)
    pair is held by exactly one thread, 8 pairs a thread (2 queries x 4
    slots), so a thread's running minima are its own."""
    w, lane, i = _threads()
    query, col, slot, level = S.u8_acc_coords(w, lane, i)
    assert (col == 16 * level + slot).all() and col.min() == 0 and col.max() == 127
    owner = {}
    for wl, q, s in zip((w * 32 + lane).ravel().tolist(), query.ravel().tolist(), slot.ravel().tolist()):
        owner.setdefault((q, s), set()).add(wl)
    assert len(owner) == 64 * 16 and all(len(o) == 1 for o in owner.values())
    pairs = {(q, s) for q, s in zip(query[0, 5].tolist(), slot[0, 5].tolist())}
    assert len(pairs) == 8


def test_u8_acc_coords_cover_every_level_of_a_box():
    """Each thread holds all 8 levels of the box for each (query, slot) it
    owns, each once: the level-minimum of a box ends in its registers."""
    w, lane, i = _threads()
    query, _, slot, level = S.u8_acc_coords(w, lane, i)
    for wi in range(4):
        for li in range(32):
            seen = {}
            for q, s, lv in zip(query[wi, li].tolist(), slot[wi, li].tolist(), level[wi, li].tolist()):
                seen.setdefault((q, s), []).append(lv)
            assert len(seen) == 8 and all(sorted(v) == list(range(8)) for v in seen.values())


def _vimin3(a, b, c):
    return np.minimum(np.minimum(a, b), c)


def _fold(acc, n8_box, lvl, mins):
    """The kernel's fold of one completed group (numpy over the warpgroup's
    threads): acc (64, 128) int32 products of the tile's queries and the
    box's rows, n8_box (128,), mins (4, 32, 8) int32 -> the updated minima,
    by the kernel's registers: cl[2 nt + j] = n8 * 128 + lvl + nt // 2 of
    column 8 nt + 2 t + j, m[4 h + 2 p + j] the three-way-min chain over nt
    = p, p + 2, ..., p + 14 of cl - 256 acc, all in int32."""
    w, lane, i = _threads()
    query, col, _, _ = S.u8_acc_coords(w, lane, i)
    regs = acc[query, col].astype(np.int32)  # (4, 32, 64)
    t = np.arange(32)[None, :, None] % 4
    nt = np.arange(16)[None, None, :]
    cl = np.empty((4, 32, 32), np.int32)
    for j in range(2):
        cl[:, :, j::2] = n8_box[8 * nt + 2 * t + j].astype(np.int32) * 128 + lvl + nt // 2
    out = mins.copy()
    for h in range(2):
        for p in range(2):
            for j in range(2):
                v = out[:, :, 4 * h + 2 * p + j]
                for e in range(0, 16, 4):
                    a, b = e + p, e + 2 + p
                    v = _vimin3(v, cl[:, :, 2 * a + j] - regs[:, :, 4 * a + 2 * h + j] * np.int32(256),
                                cl[:, :, 2 * b + j] - regs[:, :, 4 * b + 2 * h + j] * np.int32(256))
                out[:, :, 4 * h + 2 * p + j] = v
    return out


def _u8_emulate(q8, qn8, base, n8, plan, ring, rng):
    """The kernel's launch on the CPU: for each CTA, its producer and its
    consumers as coroutines under the mbarrier protocol, interleaved at
    random (a wait on parity P done once the barrier's completed phases
    differ from P in parity).  The producer fills box `it` of the CTA into
    slot it % ring once both readers freed the slot's last box; a consumer
    issues each (tile, box) group, and a group's products are read, and
    checked to find its box still in its slot, when a wgmma_wait completes
    it; the row channel is read when it is loaded.  The fold and stores are
    the kernel's -> (N / 128, B) int32."""
    B, n_pad = q8.shape[0], base.shape[0]
    Q, parts = plan["q"], plan["parts"]
    boxes = S._NB // parts // 128
    out = np.full((n_pad // 128, B), S._INT32_MAX, np.int64)
    qf, bf = q8.astype(np.int64), base.astype(np.int64)
    for x in range(plan["qgroups"]):
        n0 = x * 128 * Q
        qs = np.zeros((2 * Q * 64, q8.shape[1]), np.int64)
        qs[: min(B, n0 + 128 * Q) - n0] = qf[n0 : n0 + 128 * Q]
        readers = 2 if n0 + 64 * Q < B else 1
        for y in range(plan["ctas"]):
            items = list(range(y, plan["items"], plan["ctas"]))
            held = [None] * ring  # the box a slot holds
            full, empty = [0] * ring, [0] * ring  # completed phases
            arrivals = [0] * ring

            def producer():
                it = 0
                for item in items:
                    row0 = (item // parts) * S._NB + (item % parts) * (S._NB // parts)
                    for b in range(boxes):
                        slot = it % ring
                        if it >= ring:
                            while empty[slot] % 2 == ((it // ring) - 1) % 2:
                                yield
                        yield  # the TMA in flight
                        held[slot] = row0 + b * 128
                        full[slot] += 1
                        it += 1

            def consumer(c):
                it, inflight, cl_box = 0, [], [None]

                def wait_full(slot, k):
                    while full[slot] % 2 == k % 2:
                        yield

                def issue(tile, slot):
                    inflight.append((tile, slot, held[slot]))

                def complete(keep):
                    done = []
                    while len(inflight) > keep:
                        tile, slot, row = inflight.pop(0)
                        assert held[slot] == row, "a box left its slot before its products completed"
                        tq = qs[(c * Q + tile) * 64 : (c * Q + tile + 1) * 64]
                        done.append((tq @ bf[row : row + 128].T).astype(np.int32))
                    return done

                def arrive(slot):
                    arrivals[slot] += 1
                    if arrivals[slot] == readers:
                        arrivals[slot] = 0
                        empty[slot] += 1

                def load_cl(slot):
                    cl_box[0] = (n8[held[slot] : held[slot] + 128].copy(), (held[slot] % S._NB) // 16)

                for item in items:
                    mins = np.full((Q, 4, 32, 8), S._INT32_MAX, np.int32)
                    groups = [(b, q) for b in range(boxes) for q in range(Q)]
                    prev = None
                    for gi, (b, q) in enumerate(groups):
                        if q == 0:
                            slot = it % ring
                            yield from wait_full(slot, it // ring)
                            it += 1
                        issue(q, slot)
                        yield
                        if gi > 0:
                            (acc,) = complete(1)
                            pb, pq, pslot = prev
                            mins[pq] = _fold(acc, *cl_box[0], mins[pq])
                            if pq == Q - 1:
                                arrive(pslot)
                        if q == 0:
                            load_cl(slot)
                        prev = (b, q, slot)
                        yield
                    (acc,) = complete(0)
                    pb, pq, pslot = prev
                    mins[pq] = _fold(acc, *cl_box[0], mins[pq])
                    arrive(pslot)
                    chunk = item // parts
                    w, lane = np.meshgrid(np.arange(4), np.arange(32), indexing="ij")
                    for tile in range(Q):
                        for h in range(2):
                            for p in range(2):
                                for j in range(2):
                                    ql = (c * Q + tile) * 64 + 16 * w + lane // 4 + 8 * h
                                    sl = 8 * p + 2 * (lane % 4) + j
                                    keep = n0 + ql < B
                                    v = mins[tile, :, :, 4 * h + 2 * p + j].astype(np.int64)
                                    v = v + qn8[np.minimum(n0 + ql, B - 1)].astype(np.int64) * 128
                                    r, col = chunk * 16 + sl[keep], n0 + ql[keep]
                                    out[r, col] = np.minimum(out[r, col], v[keep]) if parts > 1 else v[keep]

            runs = [producer()] + [consumer(c) for c in range(readers)]
            while runs:
                k = int(rng.integers(len(runs)))
                try:
                    next(runs[k])
                except StopIteration:
                    runs.pop(k)
            assert all(a == 0 for a in arrivals)
    return out


@pytest.mark.parametrize("n,B,dim,sms,q,ring", [
    (4096, 70, 128, 3, None, 3),       # q 1 by the plan, both consumers, two items a CTA
    (6144, 1, 96, 4, None, 3),         # one query: the second consumer idle; a small table: parts > 1
    (4096, 200, 129, 2, None, 4),      # 256 lanes
    (2048, 300, 128, 1, 2, 3),         # q 2, partial query groups, the ring wrapping
    (4096, 600, 128, 2, 4, 9),         # q 4
])
def test_u8_kernel_schedule_equals_the_twin(n, B, dim, sms, q, ring):
    """The kernel's plan, layout, mbarrier protocol and fold, emulated on
    the CPU, give the plain version's (N / 128, B) survivors bit for bit."""
    rng = _rng(n + B + dim)
    rows = rng.integers(0, 256, (n, dim), dtype=np.uint8)
    m = U8Mirror.build(torch.from_numpy(rows), n - 37, "l2sqr", "cpu")  # sentinel tail rows
    q8, qn8 = m.queries(torch.from_numpy(rng.integers(0, 256, (B, dim), dtype=np.uint8)))
    plan = S.u8_plan(m.q8.shape[0], B, m.q8.shape[1], sms)
    if q is not None:
        plan = dict(plan, q=q, qgroups=-(-B // (128 * q)))
    got = _u8_emulate(q8.numpy(), qn8.numpy(), m.q8.numpy(), m.cache.numpy(), plan, ring, rng)
    want = S.scan_chunkmin_u8_packed_ref(q8, qn8, m.q8, m.cache).numpy()
    assert np.array_equal(got, want)


def test_u8_fold_of_random_accumulators_is_the_packed_minimum():
    """The fold over int32 accumulators anywhere in the exact range (|dot|
    <= 256 x 128^2) and row channels up to the sentinel equals the direct
    minimum of (n8 - 2 dot) * 128 + level over each (query, slot)."""
    rng = _rng(7)
    acc = rng.integers(-(2**22), 2**22 + 1, (64, 128)).astype(np.int32)
    n8 = rng.integers(0, 2**23 + 1, 128).astype(np.int32)
    n8[::13] = S.U8_SENTINEL
    lvl = 40
    mins = _fold(acc, n8, lvl, np.full((4, 32, 8), S._INT32_MAX, np.int32))
    direct = (n8[None, :].astype(np.int64) - 2 * acc.astype(np.int64)) * 128 + lvl + np.arange(128)[None, :] // 16
    want = direct.reshape(64, 8, 16).min(axis=1)  # (query, slot)
    w, lane, i = _threads()
    query, _, slot, _ = S.u8_acc_coords(w, lane, i)
    for k in range(8):
        h, p, j = k // 4, (k // 2) % 2, k % 2
        ii = 4 * p + 2 * h + j  # the register of (h, p, j) at column nt = p
        assert np.array_equal(mins[:, :, k], want[query[:, :, ii], slot[:, :, ii]])


N_100M = -(-100_000_000 // 2048) * 2048


def test_u8_plan_fills_one_wave_at_100m():
    """BIGANN-100M's rows at B 1000 and 128 lanes: whole chunks, every query
    in a group, one wave of 132 CTAs, fewer query groups (L2 crossings of
    the rows) than the float K1's 8 query tiles."""
    plan = S.u8_plan(N_100M, 1000, 128, 132)
    assert plan["parts"] == 1 and plan["items"] == N_100M // 2048
    assert plan["qgroups"] * 128 * plan["q"] >= 1000 and plan["qgroups"] * plan["ctas"] <= 132
    assert plan["qgroups"] * plan["ctas"] >= 128 and plan["qgroups"] < 8


@pytest.mark.parametrize("B", [1, 16, 64, 65, 129, 1000])
def test_u8_plan_splits_a_small_table_and_takes_256_lanes(B):
    """A table of 3 chunks is split into parts (the output then starts at
    INT32_MAX); 256 lanes (width 129) get a q whose ring holds at least 3
    boxes; a batch of one tile runs one tile a consumer."""
    small = S.u8_plan(3 * 2048, B, 128, 132)
    assert small["parts"] > 1 and small["items"] == 3 * small["parts"]
    for lanes in (128, 256):
        plan = S.u8_plan(1_001_472, B, lanes, 132)
        assert S.u8_ring(lanes // 128, plan["q"]) >= 3
        assert plan["qgroups"] == -(-B // (128 * plan["q"])) and plan["qgroups"] * plan["ctas"] <= 132
    if B <= 128:
        assert S.u8_plan(N_100M, B, 128, 132)["q"] == 1
    assert S.u8_ring(2, 4) < 3 <= S.u8_ring(2, 2)  # q 4 does not fit at 256 lanes
