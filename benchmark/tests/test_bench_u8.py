"""The harness on a uint8 configuration: the maker, the exact reference with
ties at the k-th place, the tie-aware recall, and whole runs on the CPU with
the reference, the 7-bit control and the port's uint8 Flat index (served by
the test-only entry `flat_u8_system`, with planted faults) in the program's
place."""

import numpy as np
import pytest
import torch

from benchmark import check, core, reference, synth, synth_u8
from benchmark.control import Control
import faults
import flat_u8_system
from bench_cells import small_cell, u8_cell

SEED = 2**33 + 17  # larger than 32 bits hold


class Exact(Control):
    """The reference in the program's place: the control's exact formula on
    the values as drawn."""

    U8_MASK = 0xFF


def test_maker_draws_a_short_set_as_the_prefix_of_a_longer_one(monkeypatch):
    monkeypatch.setattr(synth_u8, "UNIT_ROWS", 256)  # several units, a ragged last one
    sets = [synth_u8.make_device(n, 128, SEED, "cpu") for n in (1000, 300, 256, 2)]
    assert all(torch.equal(sets[0][: len(s)], s) for s in sets[1:])


def test_maker_gives_uint8_rows_that_vary():
    rows = synth_u8.make_device(3000, 128, SEED, "cpu")
    assert rows.dtype == torch.uint8 and rows.shape == (3000, 128)
    assert torch.equal(rows, synth_u8.make_device(3000, 128, SEED, "cpu"))
    assert not torch.equal(rows, synth_u8.make_device(3000, 128, SEED + 1, "cpu"))
    assert not (rows == 0).all(1).any() and not (rows == 255).all(1).any()
    assert int(rows.min()) == 0 and 128 < int(rows.max()) <= 255
    assert 0.01 < float((rows == 0).float().mean()) < 0.2  # Gist's zeros, and the values' spread
    assert len(torch.unique(rows)) > 200


def test_scale_is_found_from_the_spectrum():
    assert synth_u8.spectrum_scale(128) == 775


def test_float32_configuration_draws_what_synth_draws():
    ctx = core.Context(small_cell("gist1m_flat.b1000"), SEED, "cpu")
    c, t = ctx.config, ctx.traffic
    assert torch.equal(ctx.make_rows(), synth.make_device(c["rows"], 960, synth.sub_seed(SEED, "rows"), "cpu"))
    pool = synth.make_device(t["pool"], 960, synth.sub_seed(SEED, "queries"), "cpu").numpy()
    assert np.array_equal(ctx.make_pool(), pool) and ctx.make_pool().dtype == np.float32


def test_uint8_configuration_draws_uint8_rows_and_pool():
    ctx = core.Context(u8_cell(), SEED, "cpu")
    rows, pool = ctx.make_rows(), ctx.make_pool()
    assert rows.dtype == torch.uint8 and rows.shape == (3000, 128)
    assert pool.dtype == np.uint8 and pool.shape == (ctx.traffic["pool"], 128)


def brute(rows: np.ndarray, queries: np.ndarray) -> np.ndarray:
    r, q = rows.astype(np.int64), queries.astype(np.int64)
    return ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)


def tied_rows(dim: int, k: int):
    """uint8 rows and queries with a tie at the k-th place of every query:
    copies of a query's k-th row are added until every query has one (a copy
    can enter another query's top-k and move its tie down)."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 256, (1500, dim), dtype=np.uint8)
    queries = rng.integers(0, 256, (12, dim), dtype=np.uint8)
    for _ in range(len(queries) * 4):
        full = brute(rows, queries)
        d = np.sort(full, axis=1)
        untied = np.flatnonzero(d[:, k - 1] != d[:, k])
        if not len(untied):
            return rows, queries
        kth = np.argsort(full[untied[0]], kind="stable")[k - 1]
        rows = np.concatenate([rows, rows[kth : kth + 1]])
    raise AssertionError("no tie planted at the k-th place of every query")


@pytest.mark.parametrize("dim", [128, 200])  # the float32 path, and float64 past its bound
def test_reference_on_uint8_is_the_int64_brute_force_with_ties(dim, monkeypatch):
    monkeypatch.setattr(reference, "_ROW_BLOCK", 400)  # several row blocks, a ragged last one
    monkeypatch.setattr(reference, "_QUERY_BLOCK", 5)
    k = 10
    rows, queries = tied_rows(dim, k)
    full = brute(rows, queries)
    want = np.sort(full, axis=1)[:, :k]
    r, q = torch.from_numpy(rows), torch.from_numpy(queries)
    assert reference._exact_in_f32(r, q, "l2sqr") == (dim == 128)
    d, i = reference.exact_topk(r, q, k, "l2sqr")
    assert np.array_equal(d.numpy(), want.astype(np.float64))
    assert np.array_equal(np.take_along_axis(full, i.numpy(), 1), want)
    assert all(len(set(a)) == k for a in i.numpy().tolist())
    got = reference.distances(r, q, torch.arange(len(queries)), i, "l2sqr")
    assert np.array_equal(got.numpy(), want.astype(np.float64))


def test_float32_path_is_exact_at_the_extremes():
    """At dim 128 the largest distance, 128 x 255^2, and |q|^2 + |x|^2 of two
    all-255 rows, 2 x 128 x 255^2 < 2^24, stay exact integers."""
    vals = np.array([[255] * 128, [0] * 128, [255, 0] * 64, [254] * 127 + [1]], np.uint8)
    r = torch.from_numpy(vals)
    assert reference._exact_in_f32(r, r, "l2sqr")
    assert not reference._exact_in_f32(torch.zeros((1, 130), dtype=torch.uint8), r[:, :1], "l2sqr")
    assert not reference._exact_in_f32(r, r, "cosine") and not reference._exact_in_f32(r.float(), r.float(), "l2sqr")
    d, i = reference.exact_topk(r, r, 4, "l2sqr")
    full = brute(vals, vals)
    assert np.array_equal(d.numpy(), np.sort(full, axis=1).astype(np.float64))
    assert np.array_equal(np.take_along_axis(full, i.numpy(), 1), np.sort(full, axis=1))
    assert full.max() == 128 * 255**2


def test_reference_cosine_on_uint8_is_float64_brute_force():
    rows, queries = tied_rows(128, 10)
    r64, q64 = rows.astype(np.float64), queries.astype(np.float64)
    full = 1.0 - (q64 @ r64.T) / (np.linalg.norm(q64, axis=1)[:, None] * np.linalg.norm(r64, axis=1)[None, :])
    d, i = reference.exact_topk(torch.from_numpy(rows), torch.from_numpy(queries), 10, "cosine")
    np.testing.assert_allclose(d.numpy(), np.sort(full, axis=1)[:, :10], rtol=1e-12, atol=1e-12)


# query (0, 0); rows at squared distances 1, 4, 9, 9 (a tie at k = 3), 10 (just
# past the third) and 162
TIE_ROWS = np.array([[1, 0], [2, 0], [3, 0], [0, 3], [3, 1], [9, 9]], np.uint8)


# a tied row counts in place of the other tied one, never in place of a
# nearer row: [1, 2, 3] and [0, 2, 3] drop row 0 or 1 for the second tie
@pytest.mark.parametrize("ids,recall", [([0, 1, 2], 1.0), ([0, 1, 3], 1.0), ([1, 2, 3], 2 / 3),
                                        ([0, 2, 3], 2 / 3), ([2, 3, 4], 1 / 3), ([0, 1, 4], 2 / 3),
                                        ([0, 4, 5], 1 / 3)])
def test_recall_counts_ties_at_the_kth_place(ids, recall):
    rows = torch.from_numpy(TIE_ROWS)
    queries = np.zeros((1, 2), np.uint8)
    ids = np.array([ids], np.int64)
    dists = brute(TIE_ROWS, queries)[0][ids].astype(np.float64)
    nums = check.judge(ids, dists, np.zeros(1, bool), np.zeros(1, np.int64), queries, rows, "l2sqr", 3)
    assert nums["recall"] == pytest.approx(recall) and nums["recall"] <= 1.0
    assert nums["dist_gap"] == 0.0 and nums["malformed"] == 0


def run(cell, setup):
    return core.run_cell(cell, SEED, 0.3, False, "cpu", setup=setup, log=lambda _: None)


def test_uint8_cell_is_correct_with_the_reference_in_the_programs_place():
    out = run(u8_cell(), Exact)
    assert out["result"]["correct"], out["numbers"]
    assert out["numbers"]["dist_gap"] == 0.0 and out["numbers"]["recall"] == 1.0
    assert out["numbers"]["answers"] >= u8_cell().traffic["pool"]


def test_uint8_cell_is_not_correct_with_the_7_bit_control():
    out = run(u8_cell(), Control)
    assert not out["result"]["correct"]
    assert out["numbers"]["dist_gap"] > 1e-3, out["numbers"]


def test_uint8_system_is_exact_and_every_call_goes_through_its_target(monkeypatch):
    cell = u8_cell()
    calls = faults.count_calls(monkeypatch, flat_u8_system.target(cell.traffic))
    out = run(cell, flat_u8_system.setup)
    assert out["result"]["correct"], out["numbers"]
    assert out["numbers"]["dist_gap"] == 0.0 and out["numbers"]["recall"] == 1.0
    assert len(calls) == faults.expected_calls(cell, out)


@pytest.mark.parametrize("fault", faults.faults_of(u8_cell().traffic))
def test_fault_makes_the_uint8_system_not_correct(fault, monkeypatch):
    cell = u8_cell()
    faults.plant(monkeypatch, flat_u8_system.target(cell.traffic), fault, cell.config["rows"])
    out = run(cell, flat_u8_system.setup)
    assert not out["result"]["correct"], (fault, out["numbers"])
