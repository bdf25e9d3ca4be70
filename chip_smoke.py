#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (the quickest proof that
the port still starts on the card).

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — build the CUDA kernels of `lab_1806_vec_db_tpu_torch/csrc/`;
  3. K1      — the packed int8 scan kernel against its plain PyTorch version
               at the main path's shapes (dim 960 -> 1024, B = 1000, a ragged
               mirror with sentinel rows), both metrics: equal element for
               element;
  4. K2      — the rerank gather kernel against its plain version (B = 1000,
               r = 40, dim 960, some -1 ids), both metrics: rtol 1e-5,
               atol 1e-6, +inf exactly where the id is -1;
  5. VecDB   — the user's entry points on two 200,000 x 960 Gist-spectrum
               tables (l2sqr, cosine): batch_add, batch_search (B = 1000,
               k = 10) through both kernels, recall@10 against the exact scan,
               search, the upper_bound filter, delete, close and reopen;
  6. 1M      — FlatIndex at 1,000,000 x 960 (device-born): recall@10 against
               the exact scan, QPS of chained batches (best and median of 5
               rounds of 8), a per-stage split timed with CUDA events, each
               kernel against its plain version, and index_device_bytes.

The last line of standard output is `{"ok": true, "device": {...}}`; the
line before it lists each kernel with its launch count in the VecDB
batch_search run, its error against the plain version and both times.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "lab_1806_vec_db_tpu_torch"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    log(f"chip_smoke: FAIL: {msg}")
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` calls, after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def recall_at_k(gt_ids, ids, k: int) -> float:
    return sum(len(set(g[:k]) & set(r[:k])) / k for g, r in zip(gt_ids, ids)) / len(gt_ids)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    print(card, flush=True)
    log(f"[1/6] device: {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvidia-smi: {card}")
    torch.cuda.set_device(0)
    return card


def phase_build():
    from lab_1806_vec_db_tpu_torch.ops import _build

    _build.library()
    info = _build.build_info
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    log(f"[2/6] build: {info['seconds']:.1f} s -> {os.path.relpath(info['path'], HERE)}")
    for ln in regs:
        log(f"      ptxas: {ln}")
    return info["seconds"]


def phase_k1(x, queries):
    """K1 against its plain version on a ragged 67,536-row slice of a real
    mirror whose last 500 rows are sentinels."""
    import torch
    from lab_1806_vec_db_tpu_torch.models.store import VecStore
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    n3 = 65536 + 2000
    worst = 0
    for dist in ("l2sqr", "cosine"):
        q8b, sc, ca, _ = VecStore.from_device(x[:n3], dist).device_int8()
        q8b, sc, ca = q8b[:n3], sc[:n3].clone(), ca[:n3].clone()
        sc[-500:] = 0.0
        ca[-500:] = S._BIG
        q8, qs2, qc = S.quantize_queries(queries, q8b.shape[1], dist)
        out = S.scan_chunkmin_int8_packed(q8, qs2, qc, q8b, sc, ca)
        ref = S.scan_chunkmin_int8_packed_ref(q8, qs2, qc, *S._pad_rows(q8b, sc, ca, S._NB))
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (-(-n3 // S._NB) * S._SB, 1000), f"K1 shape {tuple(out.shape)}")
        err = int((out.long() - ref.long()).abs().max())
        worst = max(worst, err)
        check(torch.equal(out, ref), f"K1 {dist}: {int((out != ref).sum())} packed values differ")
        log(f"[3/6] K1 {dist}: ({n3} rows -> {out.shape[0]} survivors) x {out.shape[1]} "
            "queries equal to the plain version element for element")
    return worst


def phase_k2(x, queries):
    import torch
    from lab_1806_vec_db_tpu_torch.ops import gather as G

    gen = torch.Generator(device="cuda").manual_seed(7)
    ids = torch.randint(0, x.shape[0], (1000, 40), generator=gen, device="cuda", dtype=torch.int32)
    ids[torch.rand((1000, 40), generator=gen, device="cuda") < 0.1] = -1
    worst = 0.0
    for dist in ("l2sqr", "cosine"):
        d = G.gather_dists(queries, x, ids, dist)
        ref = G.gather_dists_ref(queries, x, ids, dist)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(d), ids < 0), f"K2 {dist}: +inf not exactly at id -1")
        fin = ids >= 0
        torch.testing.assert_close(d[fin], ref[fin], rtol=1e-5, atol=1e-6)
        err = float((d[fin] - ref[fin]).abs().max())
        worst = max(worst, err)
        log(f"[4/6] K2 {dist}: (1000, 40) within rtol 1e-5 / atol 1e-6 (max abs err {err:.3g})")
    return worst


def phase_vecdb(x_host, q_host):
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch import VecDB
    from lab_1806_vec_db_tpu_torch.models import FlatIndex
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    n, k = len(x_host), 10
    db_dir = os.path.join(HERE, "tmp", "chip_smoke_db")
    shutil.rmtree(db_dir, ignore_errors=True)
    meta = [{"id": str(i)} for i in range(n)]
    out = {"rows": n, "dim": x_host.shape[1], "batch": len(q_host), "k": k}
    launches = {}
    db = VecDB(db_dir)
    try:
        for key, dist in (("gist_l2", "l2sqr"), ("gist_cos", "cosine")):
            check(db.create_table_if_not_exists(key, x_host.shape[1], dist), "create table")
            t0 = time.perf_counter()
            db.batch_add(key, x_host, meta)
            t_add = time.perf_counter() - t0
            exact = FlatIndex.from_numpy(x_host, dist)
            _, gt = exact.knn_batch(q_host, k, exact=True)
            # the main path: counters from 0 around one user batch_search
            S.scan_chunkmin_int8_packed.launches = 0
            G.gather_dists.launches = 0
            t0 = time.perf_counter()
            res = db.batch_search(key, q_host, k)
            t_first = time.perf_counter() - t0
            launches[key] = (S.scan_chunkmin_int8_packed.launches, G.gather_dists.launches)
            check(min(launches[key]) > 0, f"{key}: batch_search launched K1/K2 {launches[key]} times")
            # end-to-end batch_search on the host clock (query upload, both
            # stages, result fetch, metadata join): 7 warm calls
            calls = []
            for _ in range(7):
                t0 = time.perf_counter()
                res = db.batch_search(key, q_host, k)
                calls.append(time.perf_counter() - t0)
            t_warm = float(np.median(calls))
            ids = [[int(m["id"]) for m, _ in row] for row in res]
            check(all(len(r) == k for r in ids), f"{key}: short result rows")
            rec = recall_at_k(gt.tolist(), ids, k)
            check(rec >= 0.99, f"{key}: recall@10 {rec:.4f} < 0.99")
            # single-query search is exact
            one = db.search(key, q_host[0], k)
            _, gt1 = exact.knn_batch(q_host[:1], k, exact=True)
            check([int(m["id"]) for m, _ in one] == gt1[0].tolist(), f"{key}: search != exact top-10")
            ub = one[4][1]
            flt = db.search(key, q_host[0], k, None, ub)
            check(len(flt) >= 5 and all(d <= ub for _, d in flt) and flt == one[: len(flt)],
                  f"{key}: upper_bound filter")
            del exact
            torch.cuda.empty_cache()
            out[key] = {"dist": dist, "recall_at_10": rec, "batch_add_s": t_add,
                        "batch_search_first_s": t_first, "batch_search_median_s": t_warm,
                        "batch_search_min_s": min(calls), "batch_search_max_s": max(calls),
                        "launches": {"k1": launches[key][0], "k2": launches[key][1]}}
            log(f"[5/6] VecDB {key}: recall@10 {rec:.4f}, batch_search {t_warm*1e3:.1f} ms "
                f"(first {t_first:.2f} s), K1/K2 launches {launches[key]}")
        # delete by pattern: row 7 is its own nearest neighbour until deleted
        key = "gist_l2"
        check(db.search(key, x_host[7], 1)[0][0] == {"id": "7"}, "self-query before delete")
        check(db.delete(key, {"id": "7"}) == 1, "delete count")
        check(db.get_len(key) == n - 1, "length after delete")
        check(all(m["id"] != "7" for m, _ in db.search(key, x_host[7], k)), "deleted row returned")
        before = db.batch_search(key, q_host, k)
    finally:
        db.close()
    db = VecDB(db_dir)
    try:
        check(sorted(db.get_all_keys()) == ["gist_cos", "gist_l2"], "keys after reopen")
        check(db.get_len(key) == n - 1, "length after reopen")
        check(db.batch_search(key, q_host, k) == before, "batch_search differs after reopen")
    finally:
        db.close()
    shutil.rmtree(db_dir, ignore_errors=True)
    log("[5/6] VecDB delete / close / reopen: identical results")
    return out, launches


def profile_round(flat, q, k: int, reps: int) -> dict:
    """One chained round of `reps` batches under torch.profiler: device busy
    share (kernel time summed over the round's host wall time, profiler
    overhead included) and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = torch.zeros((), device="cuda")
        for _ in range(reps):
            d_out, _ = flat._knn_device(q + s * 1e-30, k)
            s = s + d_out[0, 0] * 1e-30
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    # device-side entries only (kernels, memcpy, memset): each once
    rows = sorted(((e.key, e.self_device_time_total) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda x: -x[1])
    busy_us = sum(us for _, us in rows)
    if busy_us <= 0:
        return {"device_busy_share": "not measured (the profiler saw no device time)"}
    return {
        "wall_ms_per_batch": wall_us / reps / 1e3,
        "device_busy_share": busy_us / wall_us,
        "top_device_ms_per_batch": {name[:60]: us / reps / 1e3 for name, us in rows[:8] if us > 0},
    }


def phase_1m(card):
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.bench import synth
    from lab_1806_vec_db_tpu_torch.models import FlatIndex, VecStore
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    n, dim, B, k, dist = 1_000_000, 960, 1000, 10, "l2sqr"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = VecStore.from_device(synth.make_device(n, dim, 4, "cuda"), dist)
    flat = FlatIndex.from_store(store)
    q = synth.make_device(B, dim, 5, "cuda")
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, gt = flat._knn_device(q, k, exact=True)
    gt = gt.cpu().numpy()
    t_gt = time.perf_counter() - t0

    S.scan_chunkmin_int8_packed.launches = 0
    G.gather_dists.launches = 0
    t0 = time.perf_counter()
    d, ids = flat._knn_device(q, k)
    ids = ids.cpu().numpy()
    t_first = time.perf_counter() - t0
    launches = (S.scan_chunkmin_int8_packed.launches, G.gather_dists.launches)
    check(min(launches) > 0, f"1M: two-stage path launched K1/K2 {launches} times")
    check(bool(torch.isfinite(d).all()) and d.shape == (B, k), "1M: non-finite or misshapen result")
    rec = recall_at_k(gt.tolist(), ids.tolist(), k)
    check(rec >= 0.99, f"1M: recall@10 {rec:.4f} < 0.99")

    # QPS the reference's way: batches chained through a scalar data
    # dependency, best and median of 5 rounds of 8
    reps, rounds = 8, 5
    round_s = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = torch.zeros((), device="cuda")
        for _ in range(reps):
            d_out, _ = flat._knn_device(q + s * 1e-30, k)
            s = s + d_out[0, 0] * 1e-30
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
    qps_best = reps * B / min(round_s)
    qps_median = reps * B / float(np.median(round_s))
    profile = profile_round(flat, q, k, reps)

    # per-stage split with CUDA events (mean of 10 passes)
    r = flat.rerank_depth(k)
    base_i8, scales, cache8, perm = store.device_int8()
    rows = store.device_rerank()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = {"quantize_k1": 0.0, "topr_decode": 0.0, "k2_topk": 0.0}
    passes = 10
    for i in range(passes + 1):
        ev[0].record()
        q8, qs2, qc = S.quantize_queries(q, base_i8.shape[1], dist)
        packed = S.scan_chunkmin_int8_packed(q8, qs2, qc, base_i8, scales, cache8)
        ev[1].record()
        _, cand = S.select_survivors(packed, r)
        cand = T.decode_perm(cand, perm, n)
        ev[2].record()
        G.rerank_topk(q, rows, cand, k, dist)
        ev[3].record()
        torch.cuda.synchronize()
        if i:  # first pass is warm-up
            for name, a, b in zip(split, ev, ev[1:]):
                split[name] += a.elapsed_time(b) / passes

    # each kernel against its plain version at these shapes
    k1 = lambda: S.scan_chunkmin_int8_packed(q8, qs2, qc, base_i8, scales, cache8)
    k1_ref = lambda: S.scan_chunkmin_int8_packed_ref(q8, qs2, qc, base_i8, scales, cache8)
    k2 = lambda: G.gather_dists(q, rows, cand, dist)
    k2_ref = lambda: G.gather_dists_ref(q, rows, cand, dist)
    # in turns (plain, kernel, kernel, plain), each entry the mean of its two
    times = {}
    for name, kern, plain, reps_k, reps_p in (("k1", k1, k1_ref, 10, 2), ("k2", k2, k2_ref, 20, 5)):
        p0, t0_, t1_, p1 = (cuda_ms(plain, reps_p), cuda_ms(kern, reps_k),
                            cuda_ms(kern, reps_k), cuda_ms(plain, reps_p))
        times[f"{name}_ms"] = (t0_ + t1_) / 2
        times[f"{name}_plain_ms"] = (p0 + p1) / 2
    k1_equal = torch.equal(k1(), k1_ref())
    check(k1_equal, "1M: K1 differs from its plain version")
    k2_err = float((k2() - k2_ref()).abs()[cand >= 0].max())
    out = {
        "phase": "flat_1m", "card": card, "n": n, "dim": dim, "batch": B, "k": k, "dist": dist,
        "rerank_depth": r, "recall_at_10": rec, "qps_best": qps_best, "qps_median": qps_median,
        "ms_per_batch_rounds": [t / reps * 1e3 for t in round_s],
        "first_call_s": t_first, "ingest_s": t_ingest, "exact_gt_s": t_gt,
        "stage_ms": split, **times, "k1_equal_at_1m": k1_equal, "k2_max_abs_err_at_1m": k2_err,
        "profile": profile,
        "index_device_bytes": flat.index_bytes(),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches_first_call": {"k1": launches[0], "k2": launches[1]},
    }
    log(f"[6/6] 1M x 960: recall@10 {rec:.4f}, QPS best {qps_best:.0f} median {qps_median:.0f}, "
        f"stages {split}, {times}")
    return out


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"{PKG}/ not found beside {os.path.basename(__file__)}: run it from a checkout")
    sys.path.insert(0, HERE)
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    build_s = phase_build()

    from lab_1806_vec_db_tpu_torch.bench import synth

    x = synth.make_device(200_000, 960, 2, "cuda")
    queries = synth.make_device(1000, 960, 3, "cuda")
    k1_err = phase_k1(x, queries)
    k2_err = phase_k2(x, queries)
    x_host, q_host = x.cpu().numpy(), queries.cpu().numpy()
    del x, queries
    torch.cuda.empty_cache()
    db_out, launches = phase_vecdb(x_host, q_host)
    del x_host
    print(json.dumps({"phase": "vecdb", "card": card, **db_out}), flush=True)
    torch.cuda.empty_cache()
    m = phase_1m(card)
    print(json.dumps(m), flush=True)

    main_launches = launches["gist_l2"]
    kernels = [
        {"name": "scan_chunkmin_int8_packed", "route": "cuda",
         "source": f"{PKG}/csrc/scan_int8_packed.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_scan.py:542",
         "launches": main_launches[0], "max_abs_err": k1_err,
         "ms": m["k1_ms"], "plain_ms": m["k1_plain_ms"]},
        {"name": "gather_dists", "route": "cuda",
         "source": f"{PKG}/csrc/gather_dists.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_gather.py:261",
         "launches": main_launches[1], "max_abs_err": k2_err,
         "ms": m["k2_ms"], "plain_ms": m["k2_plain_ms"]},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s (build {build_s:.1f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
