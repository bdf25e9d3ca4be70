"""The check against the program, the control and planted faults, driving
whole runs on the CPU at a cut size (the harness's look for a card is
skipped: `core.run_cell` is called with device "cpu")."""

import numpy as np
import pytest

from benchmark import core
from benchmark.control import Control
from bench_cells import CELLS, small_cell

SECONDS = 0.3
SEED = 2**33 + 17  # larger than 32 bits hold


def run(cell, setup=None):
    return core.run_cell(cell, SEED, SECONDS, False, "cpu", setup=setup, log=lambda _: None)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    out = run(small_cell(name))
    assert out["result"]["correct"], out["numbers"]
    assert out["result"]["failed"] == 0 and out["numbers"]["answers"] > 0
    assert list(out["result"])[-1] == "checks"


def test_flat_index_entry_serves_single_queries():
    """`entries/flat_index.py` answers "single" traffic through `knn`, for a
    one-query Flat cell made of data files alone."""
    cell = small_cell("gist1m_flat.b1000")
    cell.traffic.update(call="single", batch=1, pool=48)
    out = run(cell)
    assert out["result"]["correct"], out["numbers"]
    assert out["numbers"]["answers"] >= 48


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference with TF32 products in the program's place fails the
    distance check."""
    cell = small_cell(name)
    out = run(cell, setup=Control)
    assert not out["result"]["correct"]
    assert out["numbers"]["dist_gap"] > cell.limits["dist_gap"]


def _entry_target(cell):
    from lab_1806_vec_db_tpu_torch import VecDB
    from lab_1806_vec_db_tpu_torch.models import FlatIndex

    single = cell.traffic["call"] == "single"
    if cell.config["entry"] == "vecdb":
        return VecDB, "search" if single else "batch_search", single
    return FlatIndex, "knn" if single else "knn_batch", single


def _alter_first(res, entry, single, n):
    """The first hit of the first answer names another row."""
    if entry == "vecdb":
        hits = res if single else res[0]
        meta, d = hits[0]
        hits[0] = ({"id": str((int(meta["id"]) + 1) % n)}, d)
        return res
    if single:
        p = res[0]
        res[0] = type(p)((p.index + 1) % n, p.distance)
        return res
    d, i = res
    i = i.copy()
    i[0, 0] = (i[0, 0] + 1) % n
    return d, i


def _halve(res, entry):
    if entry == "vecdb":
        return res[: len(res) // 2]
    d, i = res
    return d[: len(d) // 2], i[: len(i) // 2]


# the faults each cell can have (a single-query call has no half batch; one
# card, no exchange between chips)
FAULTS = [(name, fault) for name in CELLS for fault in ("state_unchanged", "half_batch_left_out", "answer_altered")
          if not (fault == "half_batch_left_out" and small_cell(name).traffic["call"] == "single")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_makes_run_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    cls, method, single = _entry_target(cell)
    entry, n = cell.config["entry"], cell.config["rows"]
    real = getattr(cls, method)
    last = []

    def broken(self, *a, **kw):
        res = real(self, *a, **kw)
        if fault == "state_unchanged":  # every call returns the first call's answers
            last.append(res)
            return last[0]
        if fault == "half_batch_left_out":
            return _halve(res, entry)
        return _alter_first(res, entry, single, n)

    monkeypatch.setattr(cls, method, broken)
    out = run(cell)
    assert not out["result"]["correct"], (fault, out["numbers"])


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cell_size_on_the_card(name):
    """The control at the committed sizes, on the card (`python -m pytest
    benchmark -q -m chip` there); skips where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = core.Cell(name, core.load_json(f"{core.ROOT}/BENCHMARK.json"))
    out = core.run_cell(cell, SEED, 2.0, False, "cuda", setup=Control, log=lambda _: None)
    assert not out["result"]["correct"]
    assert out["numbers"]["dist_gap"] > cell.limits["dist_gap"]
