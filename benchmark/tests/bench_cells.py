"""Cells of BENCHMARK.json cut to a size a CPU test run holds."""

import os

from benchmark import core

ROOT = core.ROOT
BENCH = core.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def small_cell(name: str, rows: int = 3000) -> core.Cell:
    """The cell with its rows, pool and batch cut; widths, distance, k, entry
    and limits as committed."""
    cell = core.Cell(name, BENCH)
    cell.config["rows"] = rows
    single = cell.traffic["call"] == "single"
    cell.traffic["batch"] = 1 if single else min(cell.traffic["batch"], 16)
    cell.traffic["pool"] = 48 if single else 4 * cell.traffic["batch"]
    return cell
