"""Every file the benchmark finds by name loads, and BENCHMARK.json keeps the
shape its readers expect."""

import json
import os
import re

import pytest

from benchmark import core
from bench_cells import BENCH, CELLS, ROOT, U8_CONFIG

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_with_its_files(name):
    cell = core.Cell(name, BENCH)
    assert core.load_entry(cell.config["entry"]).setup
    assert cell.traffic["loop"] == "closed" and cell.traffic["callers"] == 1
    assert cell.traffic["call"] in ("batch", "single")
    assert cell.traffic["pool"] % cell.traffic["batch"] == 0
    assert dist_gap_limit_holds(cell.config, cell.limits["dist_gap"])
    assert 0 < cell.limits["recall_min"] <= 1
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    moved = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in moved for m in cell.per_layer)


def exact_by_construction(cfg: dict) -> bool:
    """uint8 rows under l2sqr at width <= 129: every distance an integer
    below 2^24, which float32 holds (`reference._exact_in_f32`'s condition),
    so an exact program returns the reference's distances to the bit."""
    return cfg["dtype"] == "uint8" and cfg["dist"] == "l2sqr" and 2 * cfg["dim"] * 255**2 < 2**24


def dist_gap_limit_holds(cfg: dict, limit: float) -> bool:
    """A cell's `dist_gap` limit lies between 0 and 1, or is 0 where its
    configuration is exact by construction."""
    return 0 < limit < 1 or (limit == 0 and exact_by_construction(cfg))


@pytest.mark.parametrize("change,limit,holds", [({}, 0.0, True), ({"dim": 129}, 0.0, True),
                                                ({"dtype": "float32", "dim": 960}, 0.0, False),
                                                ({"dist": "cosine"}, 0.0, False), ({"dim": 130}, 0.0, False),
                                                ({}, 1e-4, True), ({"dtype": "float32", "dim": 960}, 1e-4, True),
                                                ({}, 1.0, False), ({}, -1e-4, False)])
def test_dist_gap_limit_rules(change, limit, holds):
    assert dist_gap_limit_holds(dict(U8_CONFIG, **change), limit) == holds


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_loads(metric):
    assert callable(core.load_reader(metric).read)


# the published width of each dtype's source, which a configuration never
# cuts: Gist's for float32, BIGANN's for uint8
PUBLISHED_DIM = {"float32": 960, "uint8": 128}


def config_rules_hold(cfg: dict) -> bool:
    """A configuration's distance and dtype are ones the harness draws and
    checks, and its width is its dtype's published one."""
    return (cfg["dist"] in ("l2sqr", "cosine") and all(k in cfg for k in cfg["reduced"])
            and cfg["dim"] == PUBLISHED_DIM.get(cfg["dtype"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    cfg = core.load_json(os.path.join(ROOT, config["file"]))
    assert config["file"].startswith("benchmark/")
    assert cfg["reduced"] == config["reduced"]
    assert config_rules_hold(cfg)


@pytest.mark.parametrize("change,holds", [({}, True), ({"dim": 96}, False), ({"dist": "ip"}, False),
                                          ({"dtype": "int8"}, False), ({"dtype": "float32"}, False)])
def test_config_rules_for_uint8(change, holds):
    assert config_rules_hold(dict(U8_CONFIG, **change)) == holds


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p)) and not p.endswith("_torch")
    assert os.path.exists(os.path.join(ROOT, BENCH["command"][1]))
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(1 <= len(c[k]) <= 200 for k in ("source", "why"))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    for name in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2, name


def test_traffic_files_are_data_with_a_source():
    tdir = os.path.join(core.BENCH_DIR, "traffic")
    for f in os.listdir(tdir):
        assert f.endswith(".json")
        assert json.load(open(os.path.join(tdir, f)))["source"]


@pytest.mark.parametrize("key,value", [("loop", "open"), ("callers", 4), ("call", "mixed")])
def test_traffic_the_driver_cannot_run_is_refused(key, value, tmp_path, monkeypatch):
    """A mix that asks for an open loop, several callers or another call is
    refused by name, not run as one closed-loop caller."""
    traffic = dict(core.load_json(os.path.join(core.BENCH_DIR, "traffic", "single.json")), **{key: value})
    real = core.load_json

    def load(path):
        return traffic if path.endswith(os.path.join("traffic", "single.json")) else real(path)

    monkeypatch.setattr(core, "load_json", load)
    with pytest.raises(ValueError, match=key):
        core.Cell("vecdb_cos200k.single", BENCH)
