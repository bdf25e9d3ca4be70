"""The check against the program, the control and planted faults, driving
whole runs on the CPU at a cut size (the harness's look for a card is
skipped: `core.run_cell` is called with device "cpu")."""

import pytest

from benchmark import core
from benchmark.control import Control
import faults
from bench_cells import CELLS, ENTRIES, entry_cell, small_cell

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


CELL_FAULTS = [(name, fault) for name in CELLS for fault in faults.faults_of(small_cell(name).traffic)]


@pytest.mark.parametrize("name,fault", CELL_FAULTS)
def test_fault_makes_run_not_correct(name, fault, monkeypatch):
    """A fault planted in the method that the cell's entry names as its
    target makes the run not correct."""
    cell = small_cell(name)
    target = core.load_entry(cell.config["entry"]).target(cell.traffic)
    faults.plant(monkeypatch, target, fault, cell.config["rows"])
    out = run(cell)
    assert not out["result"]["correct"], (fault, out["numbers"])


@pytest.mark.parametrize("call", ["batch", "single"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_every_call_goes_through_the_entrys_target(entry, call, monkeypatch):
    """Every call a run of the entry makes, warm-up and window, goes through
    the method its `target` names, so the faults above reach the system."""
    cell = entry_cell(entry, call)
    calls = faults.count_calls(monkeypatch, core.load_entry(entry).target(cell.traffic))
    out = run(cell)
    assert out["result"]["correct"], out["numbers"]
    assert len(calls) == faults.expected_calls(cell, out) > core.WARM_CALLS


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
