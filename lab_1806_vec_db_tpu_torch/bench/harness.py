"""Benchmark harness: TOML-driven ef sweeps with recall@k and ms/query (port
of lab_1806_vec_db_tpu/bench/harness.py; the reference's examples/bench.rs).

Load the base and test sets and the exact ground truth, build or load the
index (and PQ table) with timing and a disk cache, sweep ef (for IVF it is
n_probes), measure ms/query and recall@k, merge the results into a
cumulative `ResultList` TOML and write a recall-vs-QPS HTML plot beside it:

    python -m lab_1806_vec_db_tpu_torch.bench.harness cfg.toml [--chained] [--device cuda]

The caches are the `utils/serde.py` npz files and the TOML the same format
as the JAX package's, so either package reads what the other wrote.

Timing: by default the wall clock of the public batched search (host
conversion included), averaged over `repeat` runs.  With `chained = true`
(TOML or `--chained`) the device-resident search step runs in chained
batches, linked through a scalar data dependency, and the row carries the
best of 4 rounds with the median beside it and the flag `chained = true`.

`mesh = N` (N > 0) runs the sweep on the sharded indexes
(`parallel/sharded.py`) over `make_mesh(N, device=device)`: Flat, HNSW
and IVF, Flat + PQ (`ShardedPQFlatIndex`) and IVF + PQ (the sharded codes
tier, `ShardedIVFPQIndex`, ef as n_probes); the cache holds the sharded
checkpoint, which loads on any mesh size.  The mesh path times the wall
clock (no chained mode).
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from ..models import FlatIndex, HNSWIndex, IVFIndex, PQTable
from ..utils import io
from ..utils.candidates import GroundTruth
from ..utils.config import BenchConfig
from ..utils.serde import atomic_write_bytes


def _fmt_floats(xs) -> str:
    inner = ",\n    ".join(repr(float(x)) for x in xs)
    return "[\n    " + inner + ",\n]"


class ResultList:
    """Cumulative results TOML (bench.rs:312-368): one [[results]] block per
    label, replaced wholesale when re-run."""

    def __init__(self, title: str = ""):
        self.title = title
        self.results: dict[str, dict] = {}

    @classmethod
    def load(cls, path: str) -> "ResultList":
        import tomllib

        self = cls()
        if os.path.exists(path):
            with open(path, "rb") as f:
                d = tomllib.load(f)
            self.title = d.get("title", "")
            for r in d.get("results", []):
                self.results[r["label"]] = r
        return self

    def update(self, label: str, ef: list[int], search_time: list[float], recall: list[float],
               search_time_median: list[float] | None = None, build_seconds: float | None = None,
               index_device_bytes: int | None = None, chained: bool = False):
        """One row per label: ef, ms/query and recall (bench.rs), with the
        median ms/query, the build seconds, the index's device bytes and the
        `chained` timing flag where given."""
        row = {
            "label": label,
            "ef": list(ef),
            "search_time": [float(x) for x in search_time],
            "recall": [float(x) for x in recall],
        }
        if search_time_median is not None:
            row["search_time_median"] = [float(x) for x in search_time_median]
        if build_seconds is not None:
            row["build_seconds"] = round(float(build_seconds), 2)
        if index_device_bytes is not None:
            row["index_device_bytes"] = int(index_device_bytes)
        if chained:
            row["chained"] = True
        self.results[label] = row

    def save(self, path: str) -> None:
        lines = [f'title = "{self.title}"', ""]
        for r in self.results.values():
            lines.append("[[results]]")
            lines.append(f'label = "{r["label"]}"')
            lines.append(f'ef = {list(r["ef"])}')
            if r.get("chained"):
                lines.append("chained = true")
            if "build_seconds" in r:
                lines.append(f'build_seconds = {r["build_seconds"]!r}')
            if "index_device_bytes" in r:
                lines.append(f'index_device_bytes = {r["index_device_bytes"]}')
            lines.append(f'search_time = {_fmt_floats(r["search_time"])}')
            if "search_time_median" in r:
                lines.append(f'search_time_median = {_fmt_floats(r["search_time_median"])}')
            lines.append(f'recall = {_fmt_floats(r["recall"])}')
            lines.append("")
        atomic_write_bytes(path, "\n".join(lines).encode())

    def plot_html(self, path: str) -> None:
        """Recall-vs-QPS plot (bench.rs:334-358) as self-contained HTML with
        an inline SVG, one polyline per label, QPS on a log axis."""
        colors = ["#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951", "#ff8ab7"]
        series = [(r["label"], r["recall"], [1000.0 / max(t, 1e-9) for t in r["search_time"]],
                   colors[i % len(colors)]) for i, r in enumerate(self.results.values())]
        if not series:
            atomic_write_bytes(path, b"<html><body>No results</body></html>")
            return
        all_q = [q for _, _, qs, _ in series for q in qs]
        all_r = [x for _, rs, _, _ in series for x in rs]
        qmin, qmax = min(all_q) * 0.8, max(all_q) * 1.2
        rmin, rmax = min(all_r) - 0.02, min(1.0, max(all_r) + 0.02)
        W, H, PAD = 720, 480, 60

        def sx(r):
            return PAD + (r - rmin) / max(rmax - rmin, 1e-9) * (W - 2 * PAD)

        def sy(q):
            lo, hi = math.log10(qmin), math.log10(qmax)
            return H - PAD - (math.log10(q) - lo) / max(hi - lo, 1e-9) * (H - 2 * PAD)

        parts = [
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{W}" height="{H}" font-family="sans-serif">',
            f'<text x="{W/2}" y="20" text-anchor="middle" font-size="14">{self.title}</text>',
            f'<text x="{W/2}" y="{H-10}" text-anchor="middle" font-size="12">recall@10</text>',
            f'<text x="15" y="{H/2}" transform="rotate(-90 15 {H/2})" text-anchor="middle" '
            'font-size="12">QPS (log)</text>',
        ]
        for li, (label, rs, qs, color) in enumerate(series):
            pts = " ".join(f"{sx(r):.1f},{sy(q):.1f}" for r, q in zip(rs, qs))
            parts.append(f'<polyline fill="none" stroke="{color}" stroke-width="2" points="{pts}"/>')
            parts += [f'<circle cx="{sx(r):.1f}" cy="{sy(q):.1f}" r="3" fill="{color}"/>'
                      for r, q in zip(rs, qs)]
            parts.append(f'<text x="{W-PAD}" y="{PAD + 16*li}" text-anchor="end" fill="{color}" '
                         f'font-size="12">{label}</text>')
        parts.append("</svg>")
        atomic_write_bytes(path, ("<html><body>" + "".join(parts) + "</body></html>").encode())


def load_or_build_index(config: BenchConfig, base: np.ndarray, seed: int = 42, device="cuda"):
    """Disk-cached index build with timing (bench.rs:208-266) -> (index,
    build seconds or None when loaded).  Flat has no cache: it is the rows."""
    algo = config.algorithm.name
    cache = config.index_cache
    if cache and os.path.exists(cache):
        t0 = time.perf_counter()
        if algo == "Flat":
            index = FlatIndex.from_numpy(base, config.dist, device=device)
        else:
            cls = {"HNSW": HNSWIndex, "IVF": IVFIndex}[algo]
            index = cls.load(cache, external_vectors=base, device=device)
        print(f"Loaded index from {cache} in {time.perf_counter()-t0:.2f}s")
        return index, None
    t0 = time.perf_counter()
    if algo == "Flat":
        index = FlatIndex.from_numpy(base, config.dist, device=device)
    elif algo == "HNSW":
        index = HNSWIndex.build(base, config.dist, config.algorithm.hnsw, seed=seed, device=device)
    elif algo == "IVF":
        index = IVFIndex.from_numpy(base, config.dist, config.algorithm.ivf, seed=seed, device=device)
    else:
        raise ValueError(algo)
    build_s = time.perf_counter() - t0
    print(f"Built {algo} index in {build_s:.2f}s")
    if cache and algo != "Flat":
        index.save(cache, include_vectors=False)
    return index, build_s


def load_or_build_pq(config: BenchConfig, base: np.ndarray, seed: int = 42, device="cuda"):
    """Disk-cached PQ training -> (table or None, train seconds or None)."""
    if config.pq is None:
        return None, None
    cache = config.pq_cache
    if cache and os.path.exists(cache):
        t0 = time.perf_counter()
        pq = PQTable.load(cache, device=device)
        print(f"Loaded PQ table from {cache} in {time.perf_counter()-t0:.2f}s")
        return pq, None
    t0 = time.perf_counter()
    pq = PQTable.train(base, config.pq, seed=seed, device=device)
    build_s = time.perf_counter() - t0
    print(f"Trained PQ table in {build_s:.2f}s")
    if cache:
        pq.save(cache)
    return pq, build_s


def load_or_build_sharded(config: BenchConfig, base: np.ndarray, seed: int = 42, device="cuda"):
    """The `mesh = N` counterpart of `load_or_build_index` (the JAX
    harness's load_or_build_sharded): the sharded class of the algorithm
    (with PQ: ShardedPQFlatIndex on Flat, ShardedIVFPQIndex on IVF), built
    or loaded from the cache -> (index, build seconds or None when loaded)."""
    from ..parallel import sharded as S

    mesh = S.make_mesh(config.mesh, device=device)
    algo = config.algorithm.name
    cache = config.index_cache
    cls = {"Flat": S.ShardedFlatIndex, "HNSW": S.ShardedHNSWIndex, "IVF": S.ShardedIVFIndex}[algo]
    if config.pq is not None:
        if algo == "IVF":
            cls = S.ShardedIVFPQIndex
        elif algo == "Flat":
            cls = S.ShardedPQFlatIndex
        else:
            raise ValueError("mesh sweeps support PQ on Flat or IVF")
    if cache and os.path.exists(cache):
        t0 = time.perf_counter()
        index = cls.load(cache, mesh, external_base=base)
        print(f"Loaded sharded {cls.__name__} from {cache} onto {mesh} in "
              f"{time.perf_counter()-t0:.2f}s")
        return index, None
    t0 = time.perf_counter()
    if cls is S.ShardedIVFPQIndex:
        nlist = config.algorithm.ivf.k if config.algorithm.ivf else 64
        index = cls(mesh, base, config.dist, nlist=nlist, pq_config=config.pq, seed=seed)
    elif cls is S.ShardedPQFlatIndex:
        pq, _ = load_or_build_pq(config, base, seed, device=mesh.lead)
        index = cls(mesh, base, pq, config.dist)
    elif algo == "Flat":
        index = cls(mesh, base, config.dist)
    elif algo == "HNSW":
        index = cls(mesh, base, config.dist, config.algorithm.hnsw, seed=seed)
    else:
        index = cls(mesh, base, config.dist, config.algorithm.ivf, seed=seed)
    build_s = time.perf_counter() - t0
    print(f"Built sharded {cls.__name__} over {mesh} in {build_s:.2f}s")
    if cache:
        index.save(cache, include_vectors=False)
    return index, build_s


def _sharded_search(index, q, k: int, ef: int):
    """One batch of the mesh sweep: ef is HNSW's ef, the IVF tiers'
    n_probes, PQFlat's ADC pool; the exact Flat scan ignores it."""
    from ..parallel import sharded as S

    if isinstance(index, S.ShardedHNSWIndex):
        return index.knn_with_ef_batch(q, k, ef)
    if isinstance(index, (S.ShardedIVFPQIndex, S.ShardedIVFIndex)):
        return index.knn_batch(q, k, n_probes=ef)
    if isinstance(index, S.ShardedPQFlatIndex):
        return index.knn_batch(q, k, ef=ef)
    return index.knn_batch(q, k)


def _on_card(index) -> bool:
    return index.store.torch_device.type == "cuda"


def _device_step(index, pq, k: int):
    """The device-in / device-out search step of the chained timing mode:
    the computation the public batched call runs for this (index, pq) on
    its device, minus the host conversion and the per-call sync.  Returns
    `step(q, ef) -> (d, ids)` on tensors, or None where no such step exists
    (the graph routes and the CPU's HNSW routes return host arrays; the
    caller then times the wall clock)."""
    on_cuda = _on_card(index)
    if isinstance(index, HNSWIndex):
        if on_cuda and index.store.mirror_layout == "scan":
            # the auto route of knn_with_ef_batch and knn_pq_batch on CUDA:
            # the Flat two-stage plan with ef as its stage-1 depth
            flat = FlatIndex.from_store(index.store)
            return lambda q, ef: flat._knn_device(q, k, rerank_depth=ef)
        return None
    if pq is not None:
        if isinstance(index, FlatIndex):
            # the ADC scan + exact rerank (flat_index.rs:84-104)
            return (lambda q, ef: index._knn_pq_device(q, k, ef, pq)) if on_cuda else None
        return None
    if isinstance(index, IVFIndex):
        return lambda q, ef: index._knn_device_binned(q, k, n_probes=ef)
    if isinstance(index, FlatIndex):
        return lambda q, ef: index._knn_device(q, k)
    return None


def _chained_times(step, q: torch.Tensor, ef: int, repeat: int) -> list[float]:
    """Seconds a batch in each of 4 rounds of max(repeat, 4) chained
    batches; each round ends on a device synchronize."""
    reps = max(repeat, 4)
    out = []
    for _ in range(4):
        if q.is_cuda:
            torch.cuda.synchronize(q.device)
        t0 = time.perf_counter()
        s = torch.zeros((), device=q.device)
        for _ in range(reps):
            d_out, _ = step(q + s * 1e-30, ef)
            s = s + d_out[0, 0] * 1e-30
        if q.is_cuda:
            torch.cuda.synchronize(q.device)
        else:
            float(s)
        out.append((time.perf_counter() - t0) / reps)
    return out


def run_bench(config: BenchConfig, repeat: int = 1, batch: int = 0, out_title: str | None = None,
              device="cuda") -> dict:
    """Run one sweep of `config` on `device`; merge its row into
    `config.bench_output` (and its `.html`) when set.  Returns the row."""
    base = io.load_raw(config.base.data_path, config.base.dim, config.base.data_type,
                       config.base.limit).astype(np.float32)
    test = io.load_raw(config.test.data_path, config.test.dim, config.test.data_type,
                       config.test.limit).astype(np.float32)
    print(f"Loaded base ({len(base)}) and test ({len(test)}) sets.")
    gt = GroundTruth.load(config.gnd_path)
    k = gt.k

    if config.mesh > 0:
        index, build_s = load_or_build_sharded(config, base, device=device)
        pq = None  # the sharded PQ classes carry their tables
    else:
        index, build_s = load_or_build_index(config, base, device=device)
        pq, pq_build_s = load_or_build_pq(config, base, device=device)
        if pq_build_s is not None:
            build_s = (build_s or 0.0) + pq_build_s

    def search_all(ef: int) -> np.ndarray:
        B = batch or len(test)
        out = []
        for s in range(0, len(test), B):
            q = test[s : s + B]
            if config.mesh > 0:
                _, ids = _sharded_search(index, q, k, ef)
            elif pq is not None:
                _, ids = index.knn_pq_batch(q, k, ef, pq)
            elif isinstance(index, HNSWIndex):
                _, ids = index.knn_with_ef_batch(q, k, ef)
            elif isinstance(index, IVFIndex):
                _, ids = index.knn_batch(q, k, n_probes=ef)
            else:
                _, ids = index.knn_batch(q, k)
            out.append(ids)
        return np.concatenate(out, axis=0)

    step = None
    if config.chained and config.mesh == 0:
        step = _device_step(index, pq, k)
        if step is None:
            print("chained = true requested but no device-resident step exists for this "
                  "configuration; timing the wall clock instead (the row will NOT carry the flag)")

    efs, times, medians, recalls = [], [], [], []
    scale = 1000.0 / len(test)
    for ef in config.ef:
        if step is not None:
            q_dev = torch.from_numpy(test).to(index.store.torch_device)
            _, ids_dev = step(q_dev, ef)  # warm-up + the recall ids
            ids = ids_dev.cpu().numpy()
            rep_times = _chained_times(step, q_dev, ef, repeat)
            ms_per_query = min(rep_times) * scale
        else:
            search_all(ef)  # warm-up
            rep_times = []
            for _ in range(repeat):
                t0 = time.perf_counter()
                ids = search_all(ef)
                rep_times.append(time.perf_counter() - t0)
            ms_per_query = sum(rep_times) / len(rep_times) * scale
        ms_median = float(np.median(rep_times)) * scale
        recall = gt.batch_recall(ids)
        print(f"ef: {ef}, Average Search Time: {ms_per_query:.4f}ms, Average recall: {recall:.4f}")
        efs.append(ef)
        times.append(ms_per_query)
        medians.append(ms_median)
        recalls.append(recall)

    # the device footprint after the sweep (mirrors build on first search)
    index_bytes = int(index.index_bytes()) + (int(pq.device_bytes()) if pq is not None else 0)

    if config.bench_output:
        rl = ResultList.load(config.bench_output)
        if out_title:
            rl.title = out_title
        elif not rl.title:
            rl.title = f"Bench (N={len(base)}, dim={base.shape[1]}, {device})"
        rl.update(config.label, efs, times, recalls, search_time_median=medians,
                  build_seconds=build_s, index_device_bytes=index_bytes, chained=step is not None)
        rl.save(config.bench_output)
        rl.plot_html(os.path.splitext(config.bench_output)[0] + ".html")
        print(f"Results merged into {config.bench_output}")
    return {"label": config.label, "ef": efs, "search_time": times, "search_time_median": medians,
            "recall": recalls, "build_seconds": build_s, "index_device_bytes": index_bytes,
            "chained": step is not None}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Index benchmark (examples/bench.rs parity)")
    ap.add_argument("config", help="Path to the bench TOML config")
    ap.add_argument("-r", "--repeat", type=int, default=1)
    ap.add_argument("-b", "--batch", type=int, default=0, help="query batch size (0 = all)")
    ap.add_argument("--chained", action="store_true",
                    help="device-resident chained timing (see BenchConfig.chained)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = BenchConfig.load_from_toml_file(args.config)
    if args.chained:
        config.chained = True
    run_bench(config, repeat=args.repeat, batch=args.batch, device=args.device)


if __name__ == "__main__":
    main()
