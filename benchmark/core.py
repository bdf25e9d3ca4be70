"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own, found by the names in `BENCHMARK.json`:

- `configs/<config>.json`: the deployment (rows, width, distance, `dtype`
  "float32" or "uint8", the entry that serves it, what was assumed or cut);
- `entries/<entry>.py`: how the program under test is built and called
  (`setup(ctx) -> system` with `call(q)`, `answers(raw, k)`, `close()`, and
  optionally `ready()` at the end of set-up), and `target(traffic) ->
  (class, method name)`, the program's method that every `call` of that
  traffic goes through (the benchmark's tests plant their faults there);
  an entry serves both calls, and imports the program only when called;
- `traffic/<traffic>.json`: the mix (`call` "batch" or "single", `batch`,
  `k`, `pool` queries, its `source`); `loop` "closed" and `callers` 1 are the
  only driver there is, and any other mix is refused;
- `cells/<cell>.json`: the cell's limits for the check (`dist_gap`,
  `recall_min`) and the readings they were set from;
- `metrics/<metric>.py`: a reader, `read(run) -> number | None` (None where
  it finds nothing to read, and the metric is left out of the line).

A run: rows and a pool of queries are drawn from `--seed` on the card; the
entry builds the system; `WARM_CALLS` calls of the window's shape warm it up
(so everything the window uses is built, loaded and compiled), then the
window calls the batches in an order shuffled from the seed, one caller in a
closed loop, for `--seconds`.  Set-up is counted from process start to the
first timed call.  The window keeps every answer of its first pass over the
pool and of the first call after each of `SAMPLE_INSTANTS` instants drawn
from the seed, as arrays; the rest are dropped as they come (holding the
program's answer objects would load the measured process's garbage
collector).  After the window the
program is closed and its memory freed, and the plain reference judges the
kept answers (`check.py`).  With `--trace 1` the window (at most
`TRACE_SECONDS`) runs under `torch.profiler` and the result carries the
cell's per-layer metrics, otherwise its end-to-end metrics.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

from . import check, synth, synth_u8
from .trace import CALL_SPAN, WINDOW_SPAN, Trace

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that must not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "lab_1806_vec_db_tpu")
SAMPLE_INSTANTS = 8
# calls before the window; the first builds the int8 mirror and loads the kernels
WARM_CALLS = 3
# the traced window's length at most: the profiler's cost grows with the events
# it keeps (a 20 s trace of the B = 32 cell took 260 s to stop and read)
TRACE_SECONDS = 5.0
NAME_CHARS = 160  # of an operation's name in the breakdown (C++ kernel names run to thousands)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


# what `drive` can run: the traffic's keys and the values it honours
DRIVEN = {"loop": ("closed",), "callers": (1,), "call": ("batch", "single")}


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


class Cell:
    """A cell of `BENCHMARK.json` with its configuration, traffic, limits
    and metrics, loaded from their files."""

    def __init__(self, name: str, bench: dict, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(root, configs[self.workload["config"]]["file"]))
        self.traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{self.workload['traffic']}.json"))
        for key, allowed in DRIVEN.items():
            if self.traffic.get(key) not in allowed:
                raise ValueError(f"traffic {self.workload['traffic']!r}: {key} {self.traffic.get(key)!r} is not "
                                 f"driven by this harness (it runs {key} in {allowed})")
        self.limits = load_json(os.path.join(BENCH_DIR, "cells", f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]


def load_entry(name: str):
    return importlib.import_module(f"{__package__}.entries.{name}")


def load_reader(metric: str):
    """The reader module of a metric: `metrics/<metric>.py` (names may hold
    dots, so it is loaded from its path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What an entry needs to build the system: the configuration, the
    traffic, the device and the data drawn from the run's seed."""

    def __init__(self, cell: Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic

    def _make(self, n: int, tag: str):
        c = self.config
        seed = synth.sub_seed(self.seed, tag)
        if c["dtype"] == "uint8":
            return synth_u8.make_device(n, c["dim"], seed, self.device)
        return synth.make_device(n, c["dim"], seed, self.device)

    def make_rows(self):
        """The configuration's rows on the device, (rows, dim) of its dtype
        (float32 or uint8): the same bits every time for one seed."""
        return self._make(self.config["rows"], "rows")

    def make_pool(self) -> np.ndarray:
        """The traffic's pool of queries, (pool, dim) of the configuration's
        dtype on the host."""
        return self._make(self.traffic["pool"], "queries").cpu().numpy()

    def batches(self, pool: np.ndarray):
        """The pool cut into calls in an order shuffled from the seed ->
        (list of query arrays, list of their pool indices).  A "single"
        call takes one (dim,) query."""
        t = self.traffic
        b = 1 if t["call"] == "single" else t["batch"]
        if len(pool) % b:
            raise ValueError(f"pool of {len(pool)} queries is not a whole number of batches of {b}")
        order = np.random.default_rng(synth.sub_seed(self.seed, "order")).permutation(len(pool))
        idx = [order[j : j + b] for j in range(0, len(pool), b)]
        qs = [pool[i[0]].copy() if t["call"] == "single" else pool[i] for i in idx]
        return qs, idx


class Run:
    """What a metric reader reads: the cell's configuration and traffic, the
    window's counts and times, the trace and the check's numbers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def drive(system, batches, seconds: float, seed: int, trace: bool, k: int):
    """The closed loop: call the batches in turn until `seconds` of calls
    have passed; the last call started before the end finishes.  A kept
    call's answers are turned into arrays at once (`system.answers`), so the
    harness holds no Python objects for the program's garbage collector to
    walk; the window's length leaves that conversion out.  Returns the
    window's counts, its length, the calls' durations and the kept (batch,
    answers) pairs."""
    from torch.profiler import record_function

    nb = len(batches)
    rng = np.random.default_rng(synth.sub_seed(seed, "sample"))
    instants = sorted(rng.uniform(0.0, seconds, SAMPLE_INSTANTS))
    kept, durations, errors = [], [], []
    calls = queries = failed = 0
    nxt = 0
    excluded = 0.0
    t_start = time.perf_counter()
    t1 = t_start
    while True:
        t0 = time.perf_counter()
        if t0 - t_start - excluded >= seconds:
            break
        j = calls % nb
        q = batches[j]
        size = 1 if q.ndim == 1 else len(q)
        try:
            if trace:
                with record_function(CALL_SPAN):
                    raw = system.call(q)
            else:
                raw = system.call(q)
        except Exception as e:  # a search that raises is a failed answer, counted
            raw = None
            failed += size
            if len(errors) < 5:
                errors.append(repr(e))
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        keep = calls < nb
        while nxt < len(instants) and t0 - t_start - excluded >= instants[nxt]:
            keep, nxt = True, nxt + 1
        if keep and raw is not None:
            kept.append((j, system.answers(raw, k)))
            raw = None
            t2 = time.perf_counter()
            excluded += t2 - t1
            t1 = t2
        calls += 1
        queries += size
    return {"calls": calls, "queries": queries, "failed": failed,
            "window_s": t1 - t_start - excluded, "durations": np.asarray(durations), "kept": kept,
            "errors": errors}


def _answers(kept, idx, k: int):
    """The kept answers as arrays: ids (A, k), distances (A, k), malformed
    (A,) and the pool index of each answer's query (A,)."""
    ids, dists, bad, q_of = [], [], [], []
    for j, (i, d, b) in kept:
        want = len(idx[j])
        if len(i) < want:  # answers that never came are malformed
            miss = want - len(i)
            i = np.concatenate([i, np.full((miss, k), -1, np.int64)])
            d = np.concatenate([d, np.full((miss, k), np.inf)])
            b = np.concatenate([b, np.ones(miss, bool)])
        ids.append(i[:want])
        dists.append(d[:want])
        bad.append(b[:want])
        q_of.append(idx[j])
    return (np.concatenate(ids).astype(np.int64), np.concatenate(dists).astype(np.float64),
            np.concatenate(bad).astype(bool), np.concatenate(q_of).astype(np.int64))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float | None = None, setup=None, log=None) -> dict:
    """One run of `cell` -> {"result": the result line's object, "checks":
    [(name, value, limit, sense)], "numbers": the check's numbers}.  `setup`
    replaces the configuration's entry (the control does so); `t0` is the
    process's start on `time.perf_counter`'s clock."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = device.startswith("cuda")
    ctx = Context(cell, seed, device)
    k = cell.traffic["k"]
    marks = [("imports", time.perf_counter())]
    pool = ctx.make_pool()
    batches, idx = ctx.batches(pool)
    marks.append(("queries", time.perf_counter()))
    system = (setup or load_entry(cell.config["entry"]).setup)(ctx)
    marks.append(("build", time.perf_counter()))
    for i, q in enumerate(batches[:WARM_CALLS]):  # warm-up: the window's shapes, built and loaded
        system.call(q)
        marks.append(("first call" if i == 0 else "warm calls", time.perf_counter()))
    if hasattr(system, "ready"):
        system.ready()
        marks.append(("ready", time.perf_counter()))
    _sync(device)
    gc.collect()  # the window starts with set-up's garbage gone
    marks.append(("collect", time.perf_counter()))
    parts, prev = {}, t0
    for name, t in marks:
        parts[name] = parts.get(name, 0.0) + t - prev
        prev = t
    log("setup parts s: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW_SPAN):
                win = drive(system, batches, min(seconds, TRACE_SECONDS), seed, True, k)
                _sync(device)
        t_read = time.perf_counter()
        tr = Trace.from_profiler(prof)
        del prof
        log(f"trace: {len(tr.device)} device operations, {len(tr.host)} host events, "
            f"read in {time.perf_counter() - t_read:.1f} s; device-side events by kind {tr.device_kinds}")
    else:
        gc0 = gc.get_stats()[2]["collections"]
        win = drive(system, batches, seconds, seed, False, k)
        _sync(device)
        tr = None
        log(f"window: {gc.get_stats()[2]['collections'] - gc0} full garbage collections")
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    run = Run(config=cell.config, traffic=cell.traffic, trace=tr, calls=win["calls"],
              queries=win["queries"], window_s=win["window_s"], setup_s=setup_s,
              peak_window_bytes=peak_window, numbers=None)
    readers = {m["name"]: load_reader(m["name"]) for m in (cell.per_layer if trace else cell.end_to_end)}

    ids, dists, bad, q_of = _answers(win["kept"], idx, k)
    win["kept"] = None
    system.close()
    system = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rows = ctx.make_rows()
    numbers = check.judge(ids, dists, bad, q_of, pool, rows, cell.config["dist"], k)
    del rows
    run.numbers = numbers
    correct, checks = check.verdict(numbers, win["failed"], cell.limits)

    metrics = {}
    units = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    dur = win["durations"]
    log(f"window: {win['calls']} calls, {win['queries']} queries in {win['window_s']:.3f} s; call ms "
        f"p50 {np.percentile(dur, 50) * 1e3:.3f} p95 {np.percentile(dur, 95) * 1e3:.3f} "
        f"max {dur.max() * 1e3:.3f}; setup {setup_s:.2f} s (peak {peak_setup}); reference "
        f"{time.perf_counter() - t_ref:.2f} s over {numbers['answers']} answers")
    for e in win["errors"]:
        log(f"a call raised: {e}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.workload["chips"],
           "memory_peak_bytes": int(max(peak_setup, peak_window))}
    result = {"correct": bool(correct), "attempted": win["queries"], "failed": win["failed"],
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {key: [[name[:NAME_CHARS], sec] for name, sec in rows] for key, rows in
                               (("device_ops", tr.top_device_ops()), ("idle_gaps", tr.idle_gaps()))}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim, _ in checks}
    return {"result": result, "checks": checks, "numbers": numbers}


def forbidden_loaded() -> list[str]:
    """Forbidden top-level modules present in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))
