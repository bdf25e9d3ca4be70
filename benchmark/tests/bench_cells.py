"""Cells of BENCHMARK.json cut to a size a CPU test run holds, a uint8 cell
at BIGANN's width built the same way, and a cut cell for each entry."""

import glob
import os

from benchmark import core

ROOT = core.ROOT
BENCH = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
# every module in entries/, by name
ENTRIES = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(core.BENCH_DIR, "entries", "*.py"))
                 if not p.endswith("__init__.py"))


def small_cell(name: str, rows: int = 3000) -> core.Cell:
    """The cell with its rows, pool and batch cut; widths, distance, k, entry
    and limits as committed."""
    cell = core.Cell(name, BENCH)
    cell.config["rows"] = rows
    single = cell.traffic["call"] == "single"
    cell.traffic["batch"] = 1 if single else min(cell.traffic["batch"], 16)
    cell.traffic["pool"] = 48 if single else 4 * cell.traffic["batch"]
    return cell


# uint8 Gist-spectrum rows (`synth_u8.py`) at BIGANN's width and distance
# (128, l2)
U8_CONFIG = {"rows": 3000, "dim": 128, "dist": "l2sqr", "dtype": "uint8", "reduced": []}
# what an exact program is held to: no gap and, ties counted, every hit
U8_LIMITS = {"dist_gap": 0.0, "recall_min": 1.0}


def u8_cell(rows: int = 3000) -> core.Cell:
    """`gist1m_flat.b1000` cut as `small_cell` cuts it, with a uint8
    configuration and an exact program's limits in place of its own."""
    cell = small_cell("gist1m_flat.b1000", rows)
    cell.config = dict(U8_CONFIG, rows=rows)
    cell.limits = dict(U8_LIMITS)
    return cell


def entry_cell(entry: str, call: str) -> core.Cell:
    """A cut cell that `entries/<entry>.py` serves, with `call` traffic: the
    first committed cell whose configuration names the entry, or, for an
    entry that no committed cell uses yet, the first cell with the entry put
    in its configuration's place."""
    cells = [small_cell(name) for name in CELLS]
    cell = next((c for c in cells if c.config["entry"] == entry), None)
    if cell is None:
        cell = cells[0]
        cell.config["entry"] = entry
    cell.traffic.update(call=call, batch=1 if call == "single" else 16)
    cell.traffic["pool"] = 4 * cell.traffic["batch"]
    return cell
