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
     hnsw    — inside phase 5, on the l2sqr table: build_hnsw_index (M = 16,
               ef_construction = 200), batch_search with ef (the scan route,
               K1 + K2), the graph route (K3) at ef 120 / 200 / 360 with
               recall and QPS beside the scan route's, traversal_stats at
               ef 120 (the K4 -> K2 -> K5 loop), K4 / K5 against their
               plain versions (B = 1000, W 128 and 256), K3 against its
               plain version on the route's B = 1000 queries at every ef,
               index_bytes, and close / reopen as HNSW;
     pq      — inside phase 5, after hnsw (the reference's PQ settings: 4-bit
               codes, m = 320, 10,000 k-means samples, 20 iterations):
               vecdb_pq_cos_200k, VecDB.build_pq_table on the cosine table
               and batch_search(ef=200) (K7 with the cosine column, K2);
               hnsw_pq_200k, a PQ table on the l2sqr HNSW table and
               knn_pq_batch at ef 180 / 360 / 600 on route auto (mirror:
               K1 + K2), scan (K7 + K2), graph (K8 ids in K4 -> K8 -> K5)
               and graph with fused=False (K8 ids + K6); an n_bits = 8
               table on the scan (K9 dense) and graph (K9 ids) routes; a
               60,000-row Flat+PQ table at ef 600 (K8 dense, int8 LUT);
               each route's recall against the exact scan and its QPS, and
               on 128 queries its recall with the kernels and with their
               plain versions (must agree within 0.005, with every kernel
               count still 0 after the plain run); K6 against its plain
               version at B = 1000, EL = 128 and ef 180 / 360 / 600, K8 and
               K9 ids at widths 1 / 16 / 128, K8 / K9 dense on one block;
  6. 1M      — FlatIndex at 1,000,000 x 960 (device-born): recall@10 against
               the exact scan, QPS of chained batches (best and median of 5
               rounds of 8), a per-stage split timed with CUDA events, each
               kernel against its plain version, and index_device_bytes;
     pq      — flat_pq_1m: PQTable.train from the store's device tensor,
               FlatIndex.knn_pq_batch at ef 100 / 200 (K7 + K2), and K7
               against its plain version on all 1,000,000 rows, bit for bit;
     ivf     — ivf_1m: IVFIndex.from_store on the same store (nlist 256, 10
               k-means iterations), knn_batch's binned route (K10 + K1 on the
               overflow + K2) at n_probes 4 / 8 / 16 / 32 / 64 with recall,
               QPS and dropped pairs (recall must not fall with n_probes),
               the 16-query route (posting union + rerank_topk_blocked on
               K2), K10 against its plain version on the route's own inputs
               and on a small cosine index (equal element for element), the
               kernels-vs-plain recall gate on 128 queries;
               K1 on the overflow segment and f32 K2 on the binned
               rerank's candidates against their plain versions;
               ivf_lean_4m: IVFIndex.from_device_blocks at 4,000,000 x 960
               (nlist 1024, the ingest-sorted mirror), exact ground truth by
               block regeneration, the same sweep and gate, Flat refusing
               the sorted store, K10 on the store read in place, K1 on its
               overflow and bf16 K2 against their plain versions;
               lean_scan_1m: a 1M lean store (random-permutation mirror):
               Flat's two-stage search with refined distances (within rtol
               1e-5 of exact), its K1 and bf16 K2 against their plain
               versions on its own inputs, the binned IVF through the
               gathered sorted copy.
  7. codes   — the codes-resident tiers at 10,000,000 x 960 on one
               `make_fill(0, 960)` source (rows regenerated by id), 1000
               queries and one exact ground truth by blocked regeneration:
               codes_ivfpq_10m, IVFPQIndex (nlist 2048, m 320, chunk 16, qb
               auto) at (n_probes, ef) 32/256, 48/256, 64/256, 96/320 (K11,
               K7 on the overflow segment) with recall, QPS, dropped pairs
               (recall must not fall with n_probes); codes_pq_10m,
               PQCodesIndex (m 320, coarse_m 32) at (ef, c0) 200/2048 and
               400/4096 (K7 at stage 0, K8 ids) with its stage split; per
               index build s, lpad, overflow rows, index_bytes, peak
               allocated; each tier's kernels-vs-plain gate on 128 queries
               and its returned distances within rtol 1e-5 of float64 exact;
               K11 against its plain version on every list (equal on filled
               columns), K7 at stage 0 (all 10M coarse rows) and on the
               overflow segment (equal), K8 ids at the (1000, c0) pool
               (rtol 1e-5); a 200,000-row cosine IVF-PQ index for K11's and
               K7's cosine columns.

The last line of standard output is `{"ok": true, "device": {...}}`; the
line before it lists each kernel with its launch count on its path (K1 / K2:
the VecDB batch_search run; K3: the graph-route searches; K4 / K5: the
traversal_stats run; K6-K9: the first call of the PQ route that takes each;
K10: ivf_1m's binned search at n_probes 16; bf16 K2: ivf_lean_4m's; K11:
codes_ivfpq_10m's search at n_probes 48; K7 at stage 0: codes_pq_10m's
first search),
its error against the plain version, both times, the least time the card
could take (`bound_ms`) and a library call's time where one PyTorch call
computes the same function (K6: a stable torch.sort and a gather; else null).
"""

from __future__ import annotations

import contextlib
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


# NVIDIA H100 SXM data sheet peaks (700 W): HBM bytes/s, dense int8 ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15


def bound_ms(bytes_moved: float, ops: float = 0.0, ops_rate: float = INT8_OPS_S):
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate -> (ms, "bytes" | "operations")."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def in_turns(kern, plain, reps_k: int, reps_p: int):
    """Kernel and plain-version ms, timed in turns (plain, kernel, kernel,
    plain), each the mean of its two."""
    p0, k0, k1, p1 = cuda_ms(plain, reps_p), cuda_ms(kern, reps_k), cuda_ms(kern, reps_k), cuda_ms(plain, reps_p)
    return (k0 + k1) / 2, (p0 + p1) / 2


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the lanes where both are finite; inf where the
    non-finite lanes of the two differ."""
    import torch

    if not a.is_floating_point():
        return float((a.long() - b.long()).abs().max())
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(a[~fin], b[~fin]):
        return float("inf")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def profile_call(fn) -> dict:
    """One call of `fn` under torch.profiler: host wall ms, device busy ms
    (kernels, copies, memsets) and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if busy_us <= 0:
        return {"wall_ms": wall_us / 1e3, "device_busy_share": "not measured (no device time seen)"}
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us}


def chained_qps(step, q, rounds: int, reps: int) -> dict:
    """QPS the reference's way (bench.py:196-221): `reps` batches chained
    through a scalar data dependency (`step(q) -> (dists, ids)` on the
    card), best and median of `rounds` rounds."""
    import numpy as np
    import torch

    round_s = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = torch.zeros((), device=q.device)
        for _ in range(reps):
            d_out, _ = step(q + s * 1e-30)
            s = s + d_out[0, 0] * 1e-30
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
    B = q.shape[0]
    return {"qps_best": reps * B / min(round_s), "qps_median": reps * B / float(np.median(round_s)),
            "ms_per_batch_rounds": [t / reps * 1e3 for t in round_s]}


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


def _rand_beam_state(rng, B, W, R, EL, E, ef, N):
    """K4 / K5 inputs shaped like a lock-step iteration's: a sorted beam
    with a -1 tail past ef, a ring, the selection, a neighbor tile with
    duplicates of beam / ring / tile entries, and a scored tile."""
    import numpy as np

    beam_i = rng.integers(0, N, (B, W)).astype(np.int32)
    beam_i[:, ef:] = -1
    beam_d = np.sort(rng.random((B, W)).astype(np.float32), axis=1)
    beam_d[beam_i < 0] = np.inf
    beam_e = (rng.random((B, W)) < 0.5).astype(np.int32)
    beam_e[beam_i < 0] = 0
    ring = rng.integers(-1, N, (B, R)).astype(np.int32)
    selq = np.full((B, 128), -1, np.int32)
    selq[:, :E] = rng.integers(-1, N, (B, E))
    nbrs = rng.integers(-1, N, (B, EL)).astype(np.int32)
    nbrs[:, 3], nbrs[:, 5], nbrs[:, 7] = beam_i[:, 0], ring[:, 2], nbrs[:, 1]
    nids = rng.integers(-1, N, (B, W)).astype(np.int32)
    nd = rng.random((B, W)).astype(np.float32)
    nd[nids < 0] = np.inf
    nd[:, 10] = beam_d[:, 2]  # an exact tie with the beam
    return beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids


def phase_hnsw(db, db_dir, key, q_host, gt):
    """HNSW on the l2sqr table of phase 5.  Returns (results, launches per
    kernel on its path, per-kernel measurements, the reopened db)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch import VecDB
    from lab_1806_vec_db_tpu_torch.models.hnsw import _budgets
    from lab_1806_vec_db_tpu_torch.ops import beam as BM
    from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import traverse as TR

    k, B = 10, len(q_host)
    out = {"table": key, "M": 16, "ef_construction": 200}
    t0 = time.perf_counter()
    db.build_hnsw_index(key)
    out["build_s"] = time.perf_counter() - t0
    check(db.has_hnsw_index(key), "hnsw: has_hnsw_index is False after the build")
    log(f"[hnsw] build_hnsw_index: {out['build_s']:.1f} s")

    # the user entry point: batch_search with ef -> route auto -> the scan
    S.scan_chunkmin_int8_packed.launches = 0
    G.gather_dists.launches = 0
    res = db.batch_search(key, q_host, k, ef=200)
    scan_launches = (S.scan_chunkmin_int8_packed.launches, G.gather_dists.launches)
    check(min(scan_launches) > 0, f"hnsw: batch_search(ef=200) launched K1/K2 {scan_launches} times")
    ids = [[int(m["id"]) for m, _ in row] for row in res]
    out["batch_search_ef200_recall_at_10"] = recall_at_k(gt, ids, k)
    check(out["batch_search_ef200_recall_at_10"] >= 0.99,
          f"hnsw: batch_search(ef=200) recall@10 {out['batch_search_ef200_recall_at_10']:.4f} < 0.99")

    index = db._inner._table_mgr(key).obj.inner.inner
    out["index_bytes"] = index.index_bytes()
    out["levels"] = (index.enter_level or 0) + 1

    # the graph route (K3) and the scan route at the same ef, B = 1000
    TR.traverse.launches = 0
    out["graph"], out["scan"] = {}, {}
    for route in ("graph", "scan"):
        for ef in (120, 200, 360):
            _, ids = index.knn_with_ef_batch(q_host, k, ef, route=route)
            rounds = []
            for _ in range(3):  # rounds of 4 chained (synchronous) batches
                t0 = time.perf_counter()
                for _ in range(4):
                    index.knn_with_ef_batch(q_host, k, ef, route=route)
                rounds.append(time.perf_counter() - t0)
            out[route][ef] = {"recall_at_10": recall_at_k(gt, ids.tolist(), k),
                              "qps_best": 4 * B / min(rounds),
                              "qps_median": 4 * B / float(np.median(rounds)),
                              "ms_per_batch_rounds": [r / 4 * 1e3 for r in rounds]}
        if route == "graph":
            k3_launches = TR.traverse.launches
            check(k3_launches > 0, "hnsw: the graph route launched K3 no time")
    g = out["graph"]
    log("[hnsw] graph route: " + ", ".join(
        f"ef {ef} recall {g[ef]['recall_at_10']:.4f} QPS {g[ef]['qps_best']:.0f}" for ef in g)
        + " | scan route: " + ", ".join(
        f"ef {ef} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f}" for ef, v in out["scan"].items()))
    check(g[120]["recall_at_10"] < g[200]["recall_at_10"] < g[360]["recall_at_10"],
          "hnsw: graph-route recall does not rise with ef")
    check(g[360]["recall_at_10"] >= 0.80, f"hnsw: graph recall@10 {g[360]['recall_at_10']:.4f} < 0.80 at ef 360")
    check(out["scan"][200]["recall_at_10"] >= 0.99, "hnsw: scan-route recall@10 < 0.99 at ef 200")

    # traversal_stats at ef 120: the K4 -> K2 -> K5 loop
    BF.beam_pre.launches = BF.beam_post.launches = 0
    BM.host_syncs.update(beam=0, greedy=0)
    t0 = time.perf_counter()
    _, ids, rows = index.traversal_stats(q_host, k, 120)
    stats_s = time.perf_counter() - t0
    k45_launches = (BF.beam_pre.launches, BF.beam_post.launches)
    check(min(k45_launches) > 0, f"hnsw: traversal_stats launched K4/K5 {k45_launches} times")
    out["traversal_stats_ef120"] = {
        "recall_at_10": recall_at_k(gt, ids.tolist(), k), "rows_scored_mean": float(rows.mean()),
        "rows_scored_max": int(rows.max()), "wall_s": stats_s, "host_syncs": dict(BM.host_syncs),
        "profile": profile_call(lambda: index.traversal_stats(q_host, k, 120)),
    }
    out["graph_ef120_profile"] = profile_call(lambda: index.knn_with_ef_batch(q_host, k, 120, route="graph"))
    log(f"[hnsw] traversal_stats ef 120: rows/query {rows.mean():.1f}, recall "
        f"{out['traversal_stats_ef120']['recall_at_10']:.4f}, {stats_s*1e3:.0f} ms, "
        f"host syncs {out['traversal_stats_ef120']['host_syncs']}, K4/K5 launches {k45_launches}")

    # each kernel against its plain version, on the card
    dev = torch.device("cuda")
    meas = {"k4_err": 0.0, "k5_err": 0.0}
    E, EL, R = 4, 128, 256
    for W in (128, 256):
        rng = np.random.default_rng(W)
        st = [torch.from_numpy(a).to(dev) for a in _rand_beam_state(rng, B, W, R, EL, E, 100, len(index))]
        beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids = st
        pre, pre_ref = BF.beam_pre(beam_i, ring, selq, nbrs, E), BF.beam_pre_ref(beam_i, ring, selq, nbrs, E)
        post = BF.beam_post(beam_d, beam_i, beam_e, nd, nids, 120, E)
        post_ref = BF.beam_post_ref(beam_d, beam_i, beam_e, nd, nids, 120, E)
        torch.cuda.synchronize()
        meas["k4_err"] = max(meas["k4_err"], *(max_abs_err(a, b) for a, b in zip(pre, pre_ref)))
        meas["k5_err"] = max(meas["k5_err"], *(max_abs_err(a, b) for a, b in zip(post, post_ref)))
        for name, a, b in zip(("comp", "ring", "cnt"), pre, pre_ref):
            check(torch.equal(a, b), f"K4 W={W}: {name} differs from the plain version")
        for name, a, b in zip(("d", "i", "e", "sel"), post, post_ref):
            check(torch.equal(a, b), f"K5 W={W}: {name} differs from the plain version")
        if W == 128:  # the traversal_stats shape at ef 120: W 128, R 256, EL 128
            meas["k4"] = in_turns(lambda: BF.beam_pre(beam_i, ring, selq, nbrs, E),
                                  lambda: BF.beam_pre_ref(beam_i, ring, selq, nbrs, E), 20, 5)
            meas["k5"] = in_turns(lambda: BF.beam_post(beam_d, beam_i, beam_e, nd, nids, 120, E),
                                  lambda: BF.beam_post_ref(beam_d, beam_i, beam_e, nd, nids, 120, E), 20, 5)
            # K4 reads beam_i, ring, nbrs and selq's E lanes; writes comp, ring', cnt
            meas["k4_bytes"] = B * 4 * ((W + R + EL + E) + (W + R + 128))
            # K5 reads beam d / i / e and the scored tile's d / i; writes d / i / e, sel
            meas["k5_bytes"] = B * 4 * (5 * W + 3 * W + 128)
    log(f"[hnsw] K4 / K5 at B = {B}, W = 128 and 256: equal to their plain versions")

    # K3 against its plain version on the graph route's own inputs: all B
    # queries from the greedy descent's entries, at every ef the route ran
    q = torch.from_numpy(q_host).to(dev)
    base = index.store.device_rerank()
    links0 = index._links0_device()
    cur = index._descend(q, lambda ids: G.gather_dists(q, base, ids, index.dist))
    out["k3_vs_plain"], k3_err = {}, 0.0
    for ef in (120, 200, 360):
        iters, ring_n = _budgets(ef)
        kw = dict(E=4, R=min(ring_n, 256), max_iters=iters, dist=index.dist)
        k3 = lambda ef=ef, kw=kw: TR.traverse(q, base, links0, cur, ef, links0.shape[1], **kw)
        k3_ref = lambda ef=ef, kw=kw: TR.traverse_ref(q, base, links0, cur, ef, links0.shape[1], **kw)
        (dk, ik), (dr, ir) = k3(), k3_ref()
        torch.cuda.synchronize()
        same = ik == ir
        frac = float(same.float().mean())
        check(frac >= 0.99, f"K3 ef {ef}: ids equal on {frac:.4f} of entries (< 0.99)")
        fin = same & (ik >= 0)
        torch.testing.assert_close(dk[fin], dr[fin], rtol=1e-5, atol=0.0)
        err = float((dk[fin] - dr[fin]).abs().max())
        k3_err = max(k3_err, err)
        # K3's distances are K2's bits (one row_dist, beam_body.cuh)
        d2 = G.gather_dists(q, base, ik, index.dist)
        check(torch.equal(d2[ik >= 0], dk[ik >= 0]), f"K3 ef {ef}: distances differ from K2's for the same rows")
        out["k3_vs_plain"][ef] = {"ids_equal_share": frac, "max_abs_err": err}
        if ef == 120:
            meas["k3"] = in_turns(k3, k3_ref, 5, 1)
    meas["k3_err"] = k3_err
    meas["k3_bytes"] = B * out["traversal_stats_ef120"]["rows_scored_mean"] * 4 * index.dim
    log(f"[hnsw] K3 at B = {B} against its plain version: {out['k3_vs_plain']}; "
        f"times (kernel, plain) K3 {meas['k3']}, K4 {meas['k4']}, K5 {meas['k5']} ms")

    # close and reopen: still HNSW, identical results
    before = db.batch_search(key, q_host, k, ef=200)
    db.close()
    db = VecDB(db_dir)
    check(db.has_hnsw_index(key), "hnsw: the table is not HNSW after reopen")
    check(db.batch_search(key, q_host, k, ef=200) == before, "hnsw: batch_search differs after reopen")
    log("[hnsw] close / reopen: still HNSW, identical results")
    launches = {"k3": k3_launches, "k4": k45_launches[0], "k5": k45_launches[1]}
    return out, launches, meas, db


# ---------------------------------------------------------------- pq ----
# The reference's PQ settings (config/bench_pq_hnsw.toml,
# config/bench_10000_pq_flat.toml): 4-bit codes, m = 320, 10,000 k-means
# samples, 20 iterations, tol 1e-6.
PQ_M, PQ_SAMPLES = 320, 10_000
GATE_Q = 128  # queries of the kernel-vs-plain recall gate


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper a search route reaches swapped for its plain
    PyTorch version (the callers look the wrappers up as module attributes
    at call time), so a route runs on the card without its kernels."""
    from lab_1806_vec_db_tpu_torch.ops import adc as A
    from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import merge as M
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import scan_binned as SB

    swaps = [
        (S, "scan_chunkmin_int8_packed", lambda q8, qs2, qc, b, s, c:
            S.scan_chunkmin_int8_packed_ref(q8, qs2, qc, *S._pad_rows(b, s, c, S._NB))),
        (SB, "scan_chunkmin_int8_binned", SB.scan_chunkmin_int8_binned_ref),
        (G, "gather_dists", G.gather_dists_ref),
        (BF, "beam_pre", BF.beam_pre_ref),
        (BF, "beam_post", BF.beam_post_ref),
        (M, "merge_sorted", M.merge_sorted_ref),
        (A, "adc_chunkmin", A.adc_chunkmin_ref),
        (A, "adc_chunkmin_binned", A.adc_chunkmin_binned_ref),
        (A, "adc_sums_dense", A.adc_sums_dense_ref),
        (A, "adc_sums_ids", lambda codes, lut, ids, m, packed, shared=False:
            A.adc_sums_ids_ref(codes, lut, ids, m, packed, shared)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def pq_counts(reset: bool = False) -> dict:
    """The launch count of every kernel a PQ, IVF or codes route can reach; with
    `reset` the counts are set to 0 (and the zeros returned)."""
    from lab_1806_vec_db_tpu_torch.ops import adc as A
    from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import merge as M
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import scan_binned as SB

    plain = {"k1": S.scan_chunkmin_int8_packed, "k2": G.gather_dists, "k4": BF.beam_pre,
             "k5": BF.beam_post, "k6": M.merge_sorted, "k7": A.adc_chunkmin,
             "k10": SB.scan_chunkmin_int8_binned, "k11": A.adc_chunkmin_binned}
    by_k = {"k8_dense": (A.adc_sums_dense, 16), "k8_ids": (A.adc_sums_ids, 16),
            "k9_dense": (A.adc_sums_dense, 256), "k9_ids": (A.adc_sums_ids, 256)}
    if reset:
        for fn in plain.values():
            fn.launches = 0
        for fn, k in by_k.values():
            fn.launches[k] = 0
    return {**{name: fn.launches for name, fn in plain.items()},
            **{name: fn.launches[k] for name, (fn, k) in by_k.items()}}


def run_route(name, search, gt, need, B, rounds, per_round):
    """One route of a PQ cell: the counts set to 0 just before its first
    call and read just after (each kernel in `need` must have launched),
    recall@10 against the exact scan, QPS of `rounds` rounds of `per_round`
    synchronous calls (best and median), one call under torch.profiler
    (device busy share), and the same route on the first
    GATE_Q queries with the kernels and with their plain versions, whose
    recalls must agree within 0.005.  `search(n_queries)` returns (B, 10)
    host ids for the first n queries."""
    import numpy as np

    pq_counts(reset=True)
    ids = search(B)
    launches = pq_counts()
    missing = [k for k in need if launches[k] == 0]
    check(not missing, f"pq {name}: kernels {missing} launched no time ({launches})")
    ids = np.asarray(ids)
    check(ids.shape == (B, 10) and bool((ids >= 0).all()), f"pq {name}: malformed ids {ids.shape}")
    rec = recall_at_k(gt, ids.tolist(), 10)
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(per_round):
            search(B)
        times.append(time.perf_counter() - t0)
    profile = profile_call(lambda: search(B))
    rec_k = recall_at_k(gt[:GATE_Q], np.asarray(search(GATE_Q)).tolist(), 10)
    pq_counts(reset=True)
    with plain_kernels():
        rec_p = recall_at_k(gt[:GATE_Q], np.asarray(search(GATE_Q)).tolist(), 10)
    # the gate compared kernels with plain versions only if no kernel ran
    stray = {k: v for k, v in pq_counts().items() if v}
    check(not stray, f"pq {name}: kernels {stray} launched under plain_kernels()")
    check(abs(rec_k - rec_p) <= 0.005,
          f"pq {name}: recall@10 on {GATE_Q} queries {rec_k:.4f} with kernels, {rec_p:.4f} plain")
    return {"recall_at_10": rec, "qps_best": per_round * B / min(times),
            "qps_median": per_round * B / float(np.median(times)),
            "ms_per_call_rounds": [t / per_round * 1e3 for t in times],
            "gate_recall_kernels": rec_k, "gate_recall_plain": rec_p, "profile": profile,
            "launches": launches}


def _rand_merge_state(rng, B, ef, EL, N):
    """K6 inputs shaped like a classic-loop iteration's: a sorted (B, ef)
    beam with an inf / -1 tail and expansion flags, an unsorted (B, EL)
    scored tile with stale (inf, -1) lanes and exact ties with the beam."""
    import numpy as np

    beam_d = np.sort(rng.random((B, ef)).astype(np.float32), axis=1)
    beam_i = rng.integers(0, N, (B, ef)).astype(np.int32)
    fill = rng.integers(ef // 2, ef + 1, B)
    tail = np.arange(ef)[None, :] >= fill[:, None]
    beam_d[tail], beam_i[tail] = np.inf, -1
    beam_e = (rng.random((B, ef)) < 0.5) & ~tail
    nids = rng.integers(-1, N, (B, EL)).astype(np.int32)
    nd = rng.random((B, EL)).astype(np.float32)
    nd[:, 5] = beam_d[:, 3]  # exact ties with the beam
    nd[:, 9] = nd[:, 7]      # and within the tile
    nd[nids < 0] = np.inf
    return beam_d, beam_i, beam_e, nd, nids


def check_k6(B, ef, EL, N):
    """K6 against its plain version at one of the classic loop's shapes
    (ef 180 / 360 sort 512 keys with 204 / 24 padding keys, ef 600 sorts
    1024): all three outputs equal; times, bound and the library line (one
    stable torch.sort of the (B, ef + EL) concatenation + the id gather)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.ops import merge as M

    st = [torch.from_numpy(a).cuda() for a in _rand_merge_state(np.random.default_rng(6), B, ef, EL, N)]
    got, ref = M.merge_sorted(*st), M.merge_sorted_ref(*st)
    torch.cuda.synchronize()
    for name, a, b in zip(("d", "i", "e"), got, ref):
        check(torch.equal(a, b), f"K6 (B {B}, ef {ef}, EL {EL}): {name} differs from the plain version")
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    bd, bi, _, nd, ni = st

    def library():
        d, pos = torch.sort(torch.cat([bd, nd], 1), dim=1, stable=True)
        return d[:, :ef], torch.gather(torch.cat([bi, ni], 1), 1, pos[:, :ef])

    ms, plain_ms = in_turns(lambda: M.merge_sorted(*st), lambda: M.merge_sorted_ref(*st), 50, 20)
    lib_ms = cuda_ms(library, 20)
    # reads beam d / i / e (1 byte) and the tile's d / i; writes d / i / e
    bound = bound_ms(B * (9 * ef + 8 * EL) + B * 9 * ef)
    log(f"[pq] K6 (B {B}, ef {ef}, EL {EL}) equal to its plain version; {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sort+gather {lib_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound, "library_ms": lib_ms,
            "shape": [B, ef, EL]}


def check_sums_ids(codes, lookup, m, packed, N, tag):
    """K8 / K9's ids shape against its plain version at each width the
    graph route gives it: C 1 (a descent's entry), 16 (an upper level's
    links) and 128 (the fused loop's tile: E 4 x L 32), 10% of the ids -1,
    with the route's bf16 LUT: rtol 1e-5 (only the summation order may
    differ).  Timed and bounded at C 128."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    B, k = lookup.shape[0], lookup.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(8)
    lut = lookup.to(torch.bfloat16)
    err = 0.0
    for C in (1, 16, 128):
        ids = torch.randint(0, N, (B, C), generator=gen, device="cuda", dtype=torch.int32)
        ids[torch.rand((B, C), generator=gen, device="cuda") < 0.1] = -1
        got, ref = A.adc_sums_ids(codes, lut, ids, m, packed), A.adc_sums_ids_ref(codes, lut, ids, m, packed, False)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(got), ids < 0), f"{tag} ids (C {C}): +inf not exactly at id -1")
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
        err = max(err, max_abs_err(got, ref))
    ms, plain_ms = in_turns(lambda: A.adc_sums_ids(codes, lut, ids, m, packed),
                            lambda: A.adc_sums_ids_ref(codes, lut, ids, m, packed, False), 20, 3)
    cw = codes.shape[1]
    # ids, the gathered code rows, the bf16 LUT; the (B, 128) f32 output
    bound = bound_ms(B * 128 * 4 + B * 128 * cw + B * m * k * 2 + B * 128 * 4)
    log(f"[pq] {tag} ids (B {B}, C 1 / 16 / 128, m {m}, k {k}) within rtol 1e-5 of its plain "
        f"version (max abs err {err:.3g}); at C 128 {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound,
            "shape": [B, 128, m, k], "widths_checked": [1, 16, 128]}


def check_sums_dense(codes, lookup, m, packed, tag, lut_dtype):
    """K8 / K9's dense shape against its plain version on one scan block
    of `adc_scan_pallas` with the route's LUT rounding: int8 bit for bit,
    bf16 rtol 1e-5."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    codes = codes[:131072]
    lut, scales = A.round_lut(lookup, lut_dtype)
    got, ref = A.adc_sums_dense(codes, lut, scales, m, packed), A.adc_sums_dense_ref(codes, lut, scales, m, packed)
    torch.cuda.synchronize()
    if lut.dtype == torch.int8:
        check(torch.equal(got, ref), f"{tag} dense: differs from its plain version (int8 LUT)")
    else:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
    ms, plain_ms = in_turns(lambda: A.adc_sums_dense(codes, lut, scales, m, packed),
                            lambda: A.adc_sums_dense_ref(codes, lut, scales, m, packed), 5, 1)
    R, k, N = lut.shape[0], lut.shape[2], codes.shape[0]
    # the codes, the LUT (+ int8 scales); the (R, N) f32 output
    bound = bound_ms(N * codes.shape[1] + lut.numel() * lut.element_size() + 4 * R + 4 * R * N)
    log(f"[pq] {tag} dense (R {R}, N {N}, m {m}, k {k}, {lut.dtype}) agrees with its plain version "
        f"(max abs err {max_abs_err(got, ref):.3g}); {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": max_abs_err(got, ref), "ms": ms, "plain_ms": plain_ms, "bound": bound,
            "shape": [R, N, m, k]}


def check_k7(pq, q, tag):
    """K7 against its plain version on the whole scan (every row of the
    table, all B queries): survivors and positions equal bit for bit.
    Bound: the permuted codes, the int8 LUT and the survivors against the
    2 N B m 16 int8 operations of the one-hot product.  That operation
    bound is the method's, not the function's (which needs N B m lookup-adds,
    1/16 of them); the byte bound is reported beside it as the floor a
    rewrite of K7 is held to."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    lookup, q_norms = pq.create_lookup(q)
    _, _, cb_sq = pq.device()
    codes_s, _ = pq.device_scan()
    N, cw = codes_s.shape
    S = -(-N // A._NT) * A._NT // A.CHUNK
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(lookup, cb_sq, pq.config.dist, pq.packed, cw)
    args = (codes_s, lut_q, scales, q_norms, cs_q, cs_scale, len(pq), pq.packed, S)
    t0 = time.perf_counter()
    ref = A.adc_chunkmin_ref(*args)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got = A.adc_chunkmin(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
          f"K7 {tag}: {int((got[1] != ref[1]).sum())} survivors differ from the plain version")
    ms, plain_ms = in_turns(lambda: A.adc_chunkmin(*args), lambda: A.adc_chunkmin_ref(*args), 5, 1)
    B, m = lut_q.shape[0], pq.config.m
    moved = (N * cw + lut_q.numel() + 8 * B + (0 if cs_q is None else cs_q.numel())
             + 8 * B * S)
    bound = bound_ms(moved, 2.0 * len(pq) * B * m * 16)
    bytes_bound = bound_ms(moved)[0]
    log(f"[pq] K7 {tag} (N {N}, B {B}, m {m}): equal to its plain version bit for bit "
        f"(plain {plain_s:.1f} s); {ms:.3f} ms, plain {plain_ms:.1f} ms, bound of the one-hot "
        f"method {bound}, byte bound of the function {bytes_bound:.4f} ms")
    return {"max_abs_err": max(max_abs_err(got[0], ref[0]), max_abs_err(got[1], ref[1])),
            "ms": ms, "plain_ms": plain_ms, "bound": bound, "shape": [N, B, m],
            "extra": {"bound_ms_is_of": "the one-hot int8 product (2 N B m 16 operations), "
                                        "not the ADC function (N B m lookup-adds)",
                      "bytes_bound_ms": bytes_bound}}


def pq_train(vecs, n_valid, n_bits, dist="l2sqr"):
    import torch
    from lab_1806_vec_db_tpu_torch.models import PQTable
    from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

    cfg = PQConfig(n_bits=n_bits, m=PQ_M, dist=dist, k_means_size=PQ_SAMPLES, k_means_max_iter=20,
                   k_means_tol=1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq = PQTable.train(vecs, cfg, seed=0, n_valid=n_valid)
    torch.cuda.synchronize()
    return pq, time.perf_counter() - t0


def phase_pq_1m(store, flat, q, gt):
    """flat_pq_1m: Flat+PQ at 1,000,000 x 960 on the flat_1m store (K7 +
    K2), the PQ table trained from the device tensor with n_valid."""
    import numpy as np
    import torch

    n, B = len(store), q.shape[0]
    pq, train_s = pq_train(store.device()[0], n, 4)
    out = {"cell": "flat_pq_1m", "n": n, "batch": B, "m": PQ_M, "n_bits": 4, "train_s": train_s,
           "adc_quality": pq.adc_quality}
    log(f"[pq] flat_pq_1m: trained in {train_s:.1f} s, adc_quality {pq.adc_quality:.3f}")
    for ef in (100, 200):
        out[ef] = run_route(f"flat_pq_1m ef {ef}",
                            lambda nq, ef=ef: flat._knn_pq_device(q[:nq], 10, ef, pq)[1].cpu().numpy(),
                            gt, ("k7", "k2"), B, 5, 4)
        log(f"[pq] flat_pq_1m ef {ef}: {out[ef]}")
    out["device_bytes"] = pq.device_bytes()
    k7 = check_k7(pq, q, "flat_pq_1m")
    out["k7_vs_plain"] = "equal bit for bit, all 1000 queries x 1,000,000 rows"
    return out, k7


def phase_pq_200k(db, q_host, gts, x_host):
    """vecdb_pq_cos_200k (Flat+PQ through VecDB on the cosine table),
    hnsw_pq_200k (the l2sqr HNSW table with a PQ table built through VecDB:
    the auto, scan, graph and classic graph routes at ef 180 / 360 / 600,
    then an n_bits = 8 table on the scan and graph routes) and the 60,000-row
    Flat+PQ table that takes K8's dense shape."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.models import FlatIndex

    B, k = len(q_host), 10
    q = torch.from_numpy(q_host).cuda()
    out, meas, launches = {}, {}, {}

    # cosine Flat+PQ through VecDB: K7 with the centroid-sqnorm column
    key = "gist_cos"
    t0 = time.perf_counter()
    db.build_pq_table(key, 0.05, 4, PQ_M)
    cos = {"cell": "vecdb_pq_cos_200k", "build_pq_table_s": time.perf_counter() - t0}
    check(db.has_pq_table(key), "pq: has_pq_table is False after build_pq_table")
    tbl = db._inner._table_mgr(key).obj
    check(tbl.pq.config.k_means_size == PQ_SAMPLES, "pq: 0.05 of 200,000 rows is not 10,000 samples")
    flat = tbl.inner.inner
    cos["adc_quality"] = tbl.pq.adc_quality
    cos["batch_search_ef200"] = run_route(
        "vecdb_pq_cos_200k", lambda nq: [[int(m["id"]) for m, _ in r]
                                         for r in db.batch_search(key, q_host[:nq], k, ef=200)],
        gts[key], ("k7", "k2"), B, 3, 1)
    meas["k7_cos"] = check_k7(tbl.pq, q, "vecdb_pq_cos_200k (cosine)")
    cos["device_bytes"] = tbl.pq.device_bytes()
    out["vecdb_pq_cos_200k"] = cos
    log(f"[pq] vecdb_pq_cos_200k: {cos}")

    # HNSW+PQ on the l2sqr HNSW table
    key = "gist_l2"
    t0 = time.perf_counter()
    db.build_pq_table(key, 0.05, 4, PQ_M)
    h = {"cell": "hnsw_pq_200k", "build_pq_table_s": time.perf_counter() - t0}
    tbl = db._inner._table_mgr(key).obj
    index, pq = tbl.inner.inner, tbl.pq
    check(db.has_hnsw_index(key), "pq: the l2sqr table is not HNSW")
    h["adc_quality"] = pq.adc_quality
    gt = gts[key]
    routes = (("auto", {}, ("k1", "k2")), ("scan", {"route": "scan"}, ("k7", "k2")),
              ("graph", {"route": "graph"}, ("k8_ids", "k4", "k5", "k2")),
              ("graph_classic", {"route": "graph", "fused": False}, ("k8_ids", "k6", "k2")))
    for name, kw, need in routes:
        h[name] = {}
        for ef in (180, 360, 600):
            if name == "auto":  # the user's entry point: VecDB.batch_search -> mirror
                search = lambda nq, ef=ef: [[int(m["id"]) for m, _ in r]
                                            for r in db.batch_search(key, q_host[:nq], k, ef=ef)]
            else:
                search = lambda nq, ef=ef, kw=kw: index.knn_pq_batch(q_host[:nq], k, ef, pq, **kw)[1]
            h[name][ef] = run_route(f"hnsw_pq_200k {name} ef {ef}", search, gt, need, B,
                                    2 if name == "graph_classic" else 3, 1)
            if ef == 180 and name in ("graph", "graph_classic"):
                launches[name] = h[name][ef]["launches"]
        log(f"[pq] hnsw_pq_200k {name}: " + ", ".join(
            f"ef {ef} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f}" for ef, v in h[name].items()))
    h["device_bytes"] = pq.device_bytes()
    codes, _, _ = pq.device()
    lookup, _ = pq.create_lookup(q)
    meas["k8_ids"] = check_sums_ids(codes, lookup, PQ_M, True, len(pq), "K8")
    # K6 at every ef the classic loop ran (EL = E 4 x L 32)
    meas["k6"] = {ef: check_k6(B, ef, 128, len(index)) for ef in (180, 360, 600)}
    out["hnsw_pq_200k"] = h

    # n_bits = 8 on the same store: K9's dense (scan) and ids (graph) shapes
    pq8, train_s = pq_train(index.store.device()[0], len(index), 8)
    h8 = {"cell": "hnsw_pq_200k_nbits8", "train_s": train_s, "adc_quality": pq8.adc_quality}
    for name, kw, need in (("scan", {"route": "scan"}, ("k9_dense", "k2")),
                           ("graph", {"route": "graph"}, ("k9_ids", "k4", "k5", "k2"))):
        h8[name] = {}
        for ef in (180, 600):
            h8[name][ef] = run_route(f"hnsw_pq_200k n_bits 8 {name} ef {ef}",
                                     lambda nq, ef=ef, kw=kw: index.knn_pq_batch(q_host[:nq], k, ef, pq8, **kw)[1],
                                     gt, need, B, 2, 1)
            if ef == 180:
                launches[f"nbits8_{name}"] = h8[name][ef]["launches"]
        log(f"[pq] hnsw_pq_200k n_bits 8 {name}: " + ", ".join(
            f"ef {ef} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f}" for ef, v in h8[name].items()))
    h8["device_bytes"] = pq8.device_bytes()
    codes8, _, _ = pq8.device()
    lookup8, _ = pq8.create_lookup(q)
    meas["k9_ids"] = check_sums_ids(codes8, lookup8, PQ_M, False, len(pq8), "K9")
    meas["k9_dense"] = check_sums_dense(codes8, lookup8, PQ_M, False, "K9", "bf16")
    out["hnsw_pq_200k_nbits8"] = h8
    del pq8, codes8, lookup8

    # K8's dense shape: 60,000 rows hold 1,875 chunks of 32, fewer than
    # 4 * ef at ef 600, so the scan is adc_scan_pallas's int8 dense sums
    n60 = 60_000
    f60 = FlatIndex.from_numpy(x_host[:n60], "l2sqr")
    pq60, train_s = pq_train(x_host[:n60], None, 4)
    _, gt60 = f60.knn_batch(q_host, k, exact=True)
    d60 = {"cell": "flat_pq_60k", "train_s": train_s, "adc_quality": pq60.adc_quality}
    d60[600] = run_route("flat_pq_60k ef 600", lambda nq: f60.knn_pq_batch(q_host[:nq], k, 600, pq60)[1],
                         gt60.tolist(), ("k8_dense", "k2"), B, 3, 1)
    check(d60[600]["launches"]["k7"] == 0, "flat_pq_60k: K7 ran where the dense sums belong")
    launches["k8_dense"] = d60[600]["launches"]["k8_dense"]
    codes60, _, _ = pq60.device()
    lookup60, _ = pq60.create_lookup(q)
    meas["k8_dense"] = check_sums_dense(codes60, lookup60, PQ_M, True, "K8", "int8")
    out["flat_pq_60k"] = d60
    log(f"[pq] flat_pq_60k ef 600: {d60[600]}")
    del f60, pq60
    torch.cuda.empty_cache()
    return out, launches, meas



# --------------------------------------------------------------- ivf ----
# The reference's IVF records: data/t_bench_1M_tpu.toml:73 (the full tier
# at 1M, nlist 256), data/t_bench_1M_lean_tpu.toml:25 and
# data/t_bench_4M_lean_tpu.toml (the lean tier; nlist 1024 and the
# ingest-sorted mirror at 4M), all from bench.py:335-414: nlist 256 per 1M
# rows, 10 k-means iterations, B = 1000, k = 10.
IVF_PROBES = (4, 8, 16, 32, 64)
IVF_GATE_PROBES = 16  # n_probes of the launch counts, the gate and the K10 check


def ivf_sweep(idx, q, gt, tag, rounds=3, reps=4):
    """The binned route through `knn_batch` at every n_probes: recall@10
    against `gt`, QPS of chained rounds (best and median), the dropped
    (query, list) pairs; the launch counts of the IVF_GATE_PROBES call (set
    to 0 just before it, read just after).  Recall must not fall as n_probes
    grows."""
    import numpy as np
    import torch

    B, out, launches = q.shape[0], {}, None
    for p in IVF_PROBES:
        if p == IVF_GATE_PROBES:
            pq_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, ids = idx.knn_batch(q, 10, p)
        first_s = time.perf_counter() - t0
        if p == IVF_GATE_PROBES:
            launches = pq_counts()
        check(ids.shape == (B, 10) and bool(np.isfinite(d).all()) and bool((ids >= 0).all()),
              f"{tag} n_probes {p}: malformed result")
        out[p] = {"recall_at_10": recall_at_k(gt, ids.tolist(), 10), "dropped_pairs": idx.last_dropped_pairs,
                  "first_call_s": first_s,
                  **chained_qps(lambda qq, p=p: idx._knn_device_binned(qq, 10, p), q, rounds, reps)}
        idx._note_drops()
    recs = [out[p]["recall_at_10"] for p in IVF_PROBES]
    log(f"[ivf] {tag}: " + ", ".join(f"n_probes {p} recall {out[p]['recall_at_10']:.4f} QPS "
                                     f"{out[p]['qps_best']:.0f} dropped {out[p]['dropped_pairs']}"
                                     for p in IVF_PROBES))
    check(all(b >= a for a, b in zip(recs, recs[1:])), f"{tag}: recall@10 falls as n_probes grows: {recs}")
    check(launches["k10"] > 0 and launches["k2"] > 0, f"{tag}: the binned route launched {launches}")
    return out, launches


def ivf_gate(idx, q, gt, tag):
    """The binned route on the first GATE_Q queries at IVF_GATE_PROBES, with
    the kernels and with their plain versions: recalls within 0.005, and no
    kernel count moves under the plain versions."""
    rec_k = recall_at_k(gt[:GATE_Q], idx.knn_batch(q[:GATE_Q], 10, IVF_GATE_PROBES)[1].tolist(), 10)
    pq_counts(reset=True)
    with plain_kernels():
        rec_p = recall_at_k(gt[:GATE_Q], idx.knn_batch(q[:GATE_Q], 10, IVF_GATE_PROBES)[1].tolist(), 10)
    stray = {k: v for k, v in pq_counts().items() if v}
    check(not stray, f"{tag}: kernels {stray} launched under plain_kernels()")
    check(abs(rec_k - rec_p) <= 0.005, f"{tag}: recall@10 on {GATE_Q} queries {rec_k:.4f} with kernels, "
                                       f"{rec_p:.4f} plain")
    return {"gate_recall_kernels": rec_k, "gate_recall_plain": rec_p}


def check_k10(idx, q, tag, timed=True):
    """K10 against its plain version on the binned route's own inputs at
    IVF_GATE_PROBES (every list of the sorted mirror, all of q): equal
    element for element.  Timed in turns; bound priced from the run's
    R = nlist * lpad rows: the mirror rows and their two channels, the
    nlist * 128 gathered query rows with theirs, the (R/4, 128) int32 output
    against 2 R 128 D int8 operations."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import scan_binned as SB

    _, _, args = idx._scan_inputs(q, IVF_GATE_PROBES)
    got, ref = SB.scan_chunkmin_int8_binned(*args), SB.scan_chunkmin_int8_binned_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"K10 {tag}: {int((got != ref).sum())} packed values differ from the plain version")
    nlist, lpad, D = args[3].shape[0], args[7], idx.dim
    R = nlist * lpad
    out = {"max_abs_err": max_abs_err(got, ref), "shape": [nlist, lpad, SB.QB, D], "rows": R}
    if timed:
        out["ms"], out["plain_ms"] = in_turns(lambda: SB.scan_chunkmin_int8_binned(*args),
                                              lambda: SB.scan_chunkmin_int8_binned_ref(*args), 10, 1)
        out["bound"] = bound_ms(R * (D + 8) + nlist * SB.QB * (D + 8) + R * SB.QB, 2.0 * R * SB.QB * D)
    log(f"[ivf] K10 {tag} (nlist {nlist}, lpad {lpad}, {R} rows): equal to its plain version"
        + (f"; {out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, bound {out['bound']}" if timed else ""))
    return out


def check_k1_path(q, q8b, sc, ca, dist, tag):
    """K1 against its plain version on a mirror that the path scans (the
    IVF overflow segment, the lean store's mirror), the same queries: equal
    element for element.  Returns (packed output, max abs error)."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    q8, qs2, qc = S.quantize_queries(q, q8b.shape[1], dist)
    got = S.scan_chunkmin_int8_packed(q8, qs2, qc, q8b, sc, ca)
    ref = S.scan_chunkmin_int8_packed_ref(q8, qs2, qc, *S._pad_rows(q8b, sc, ca, S._NB))
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"K1 {tag}: {int((got != ref).sum())} packed values differ from the plain version")
    log(f"[ivf] K1 {tag} ({q8b.shape[0]} rows x {q.shape[0]} queries): equal to its plain version")
    return got, max_abs_err(got, ref)


def check_k2_path(q, rows, ids, dist, tag):
    """K2 against its plain version on the path's candidates and rows (f32
    or bf16): rtol 1e-5 / atol 1e-6, +inf exactly where the id is -1."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import gather as G

    got, ref = G.gather_dists(q, rows, ids, dist), G.gather_dists_ref(q, rows, ids, dist)
    torch.cuda.synchronize()
    check(torch.equal(torch.isinf(got), ids < 0), f"K2 {tag}: +inf not exactly at id -1")
    fin = ids >= 0
    torch.testing.assert_close(got[fin], ref[fin], rtol=1e-5, atol=1e-6)
    err = max_abs_err(got, ref)
    log(f"[ivf] K2 {tag} ({tuple(ids.shape)}, {str(rows.dtype).replace('torch.', '')} rows): within "
        f"rtol 1e-5 of its plain version (max abs err {err:.3g})")
    return err


def check_overflow_k1(idx, q, tag):
    """K1 on the index's overflow segment (the rows spilled past lpad that
    every query scans), as `_binned_candidates` gives it."""
    ov = idx._device_sorted()[5]
    if ov is None:
        return 0.0
    return check_k1_path(q, *ov[:3], idx.dist, f"{tag} overflow segment")[1]


def phase_ivf_1m(store, q, gt, nlist=256):
    """ivf_1m: IVFIndex.from_store on phase 6's store (nlist 256, 10
    iterations), the n_probes sweep on the binned route, the small-batch
    route (posting union + rerank_topk_blocked on K2), K10 against its plain
    version (and on a small cosine index), the kernels-vs-plain gate."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.models import IVFIndex, VecStore
    from lab_1806_vec_db_tpu_torch.utils.config import IVFConfig

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = IVFIndex.from_store(store, IVFConfig(k=nlist, k_means_max_iter=10), seed=0)
    torch.cuda.synchronize()
    out = {"cell": "ivf_1m", "n": len(store), "nlist": nlist, "build_s": time.perf_counter() - t0}
    lens = idx.posting_len
    out["list_len"] = {"min": int(lens.min()), "median": float(np.median(lens)), "max": int(lens.max())}
    out["sweep"], launches = ivf_sweep(idx, q, gt, "ivf_1m")
    _, _, _, _, lpad, ov = idx._device_sorted()
    out.update(lpad=lpad, overflow_rows=0 if ov is None else int(ov[0].shape[0]),
               index_bytes=idx.index_bytes(), launches=launches)
    # the small-batch route: 16 queries take the posting union through K2
    small = {}
    for p in (IVF_GATE_PROBES, IVF_PROBES[-1]):
        pq_counts(reset=True)
        _, ids_s = idx.knn_batch(q[:16], 10, p)
        k2_blocks = pq_counts()["k2"]
        _, ids_b = idx.knn_batch(q, 10, p)
        rec_s = recall_at_k(gt[:16], ids_s.tolist(), 10)
        rec_b = recall_at_k(gt[:16], ids_b[:16].tolist(), 10)
        small[p] = {"recall_small_batch": rec_s, "recall_binned": rec_b, "k2_launches": k2_blocks}
        check(k2_blocks > 0, "ivf_1m: the small-batch route launched K2 no time")
        check(abs(rec_s - rec_b) <= 0.02, f"ivf_1m n_probes {p}: small-batch recall {rec_s:.4f} vs binned {rec_b:.4f}")
    out["small_batch"] = small
    out.update(ivf_gate(idx, q, gt, "ivf_1m"))
    out["profile_n_probes_16"] = profile_call(lambda: idx.knn_batch(q, 10, IVF_GATE_PROBES))
    k10 = check_k10(idx, q, "ivf_1m l2sqr")
    # the path's other launches, each against its plain version on its own
    # inputs: K1 on the overflow segment, f32 K2 at the binned rerank's shape
    out["k1_overflow_err"] = check_overflow_k1(idx, q, "ivf_1m")
    cand, _ = idx._binned_candidates(q, 10, IVF_GATE_PROBES)
    out["k2_binned_rerank_err"] = check_k2_path(q, store.device_rerank(), cand, store.dist,
                                                "ivf_1m binned rerank")
    # K10's cosine form on a small cosine index over the same rows
    cos = IVFIndex.from_store(VecStore.from_device(store.device()[0][:65536], "cosine"),
                              IVFConfig(k=16, k_means_max_iter=10), seed=0)
    check_k10(cos, q, "cosine, 65,536 rows", timed=False)
    out["k10_cosine_equal"] = True
    log(f"[ivf] ivf_1m: build {out['build_s']:.1f} s, lpad {lpad}, overflow {out['overflow_rows']} rows, "
        f"index_bytes {out['index_bytes']}, small batch {small}, gate {out['gate_recall_kernels']:.4f} / "
        f"{out['gate_recall_plain']:.4f}")
    del idx, cos
    torch.cuda.empty_cache()
    return out, k10


def exact_l2_f64(fill, n, q, ids, block_rows=131072):
    """Exact l2sqr distances of q[b] to rows ids[b, j] (all valid) in
    float64, each row regenerated from `fill`: the yardstick of returned
    distances."""
    import torch

    out = torch.empty(ids.shape, dtype=torch.float64, device=q.device)
    qd = q.double()
    for row0 in range(0, n, block_rows):
        rows = min(block_rows, n - row0)
        sel = (ids >= row0) & (ids < row0 + rows)
        if not bool(sel.any()):
            continue
        v = fill(row0, rows).double()[(ids[sel] - row0).long()]
        out[sel] = ((v - qd[torch.nonzero(sel)[:, 0]]) ** 2).sum(-1)
    return out


def phase_lean(card, n_lean=4_000_000, nlist_lean=1024, n_scan=1_000_000, nlist_scan=256,
               device="cuda"):
    """ivf_lean_4m (the lean tier with the ingest-sorted mirror: K10 + bf16
    K2) and lean_scan_1m (the lean tier with the random-permutation mirror:
    Flat's K1 + bf16 K2 + exact refinement, and the binned IVF through the
    sorted copy that `_device_sorted` gathers)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.bench import synth
    from lab_1806_vec_db_tpu_torch.models import FlatIndex, IVFIndex
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import topk as T
    from lab_1806_vec_db_tpu_torch.utils.config import IVFConfig

    dim, B, k = 960, 1000, 10
    # ---- ivf_lean_4m ----
    n = n_lean
    fill, queries = synth.make_fill(0, dim, device)
    q = queries(B)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = IVFIndex.from_device_blocks(fill, n, dim, "l2sqr", IVFConfig(k=nlist_lean, k_means_max_iter=10),
                                      seed=0, mirror="sorted", device=device)
    torch.cuda.synchronize()
    lean = {"cell": "ivf_lean_4m", "n": n, "nlist": nlist_lean, "mirror": "sorted",
            "build_s": time.perf_counter() - t0, "int8_reliable": idx.store.int8_reliable()}
    t0 = time.perf_counter()
    gt = synth.exact_gt_blocked(fill, n, q, k, "l2sqr").cpu().numpy().tolist()
    lean["exact_gt_s"] = time.perf_counter() - t0
    try:
        FlatIndex.from_store(idx.store)
        fail("ivf_lean_4m: FlatIndex accepted the cluster-sorted store")
    except ValueError:
        lean["flat_refuses_sorted_store"] = True
    lean["sweep"], lean["launches"] = ivf_sweep(idx, q, gt, "ivf_lean_4m")
    _, _, _, _, lpad, ov = idx._device_sorted()
    lean.update(lpad=lpad, overflow_rows=0 if ov is None else int(ov[0].shape[0]),
                index_bytes=idx.index_bytes(), store_capacity=idx.store.capacity)
    lean.update(ivf_gate(idx, q, gt, "ivf_lean_4m"))
    # K10 reading the ingest-sorted store in place (its mirror runs on past
    # nlist * lpad with the overflow and capacity rows), K1 on that overflow
    lean["k10_err"] = check_k10(idx, q, "ivf_lean_4m (ingest-sorted store)", timed=False)["max_abs_err"]
    lean["k1_overflow_err"] = check_overflow_k1(idx, q, "ivf_lean_4m")
    lean["profile_n_probes_16"] = profile_call(lambda: idx.knn_batch(q, 10, IVF_GATE_PROBES))
    # bf16 K2 against its plain version on this path's candidates, every
    # 7th one set to -1 (the path itself may hold none)
    orig, _ = idx._binned_candidates(q, k, IVF_GATE_PROBES)
    orig[:, ::7] = -1
    rows = idx.store.device_rerank()
    fin = orig >= 0
    r = orig.shape[1]
    k2 = {"max_abs_err": check_k2_path(q, rows, orig, "l2sqr", "ivf_lean_4m binned rerank"),
          "shape": [B, r, dim, "bfloat16"]}
    k2["ms"], k2["plain_ms"] = in_turns(lambda: G.gather_dists(q, rows, orig, "l2sqr"),
                                        lambda: G.gather_dists_ref(q, rows, orig, "l2sqr"), 20, 5)
    # bf16 rows of the valid candidates, the ids, the f32 queries; the output
    k2["bound"] = bound_ms(int(fin.sum()) * dim * 2 + B * r * 4 + B * dim * 4 + B * r * 4)
    lean["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(f"[ivf] ivf_lean_4m: build {lean['build_s']:.1f} s, gt {lean['exact_gt_s']:.1f} s, lpad {lpad}, "
        f"index_bytes {lean['index_bytes']}, peak {lean['peak_allocated_bytes']}; bf16 K2 (B {B}, r {r}) "
        f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.4f} ms, err {k2['max_abs_err']:.3g}")
    del idx, rows, orig
    torch.cuda.empty_cache()

    # ---- lean_scan_1m ----
    n = n_scan
    fill, queries = synth.make_fill(1, dim, device)
    q = queries(B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = IVFIndex.from_device_blocks(fill, n, dim, "l2sqr", IVFConfig(k=nlist_scan, k_means_max_iter=10),
                                      seed=0, mirror="scan", device=device)
    torch.cuda.synchronize()
    scan = {"cell": "lean_scan_1m", "n": n, "nlist": nlist_scan, "mirror": "scan",
            "build_s": time.perf_counter() - t0, "store_device_bytes": idx.store.device_bytes()}
    gt = synth.exact_gt_blocked(fill, n, q, k, "l2sqr")
    flat = FlatIndex.from_store(idx.store)
    pq_counts(reset=True)
    t0 = time.perf_counter()
    d, ids = flat.knn_batch(q, k)
    scan["flat_first_call_s"] = time.perf_counter() - t0
    scan["flat_launches"] = pq_counts()
    check(scan["flat_launches"]["k1"] > 0 and scan["flat_launches"]["k2"] > 0,
          f"lean_scan_1m: Flat launched {scan['flat_launches']}")
    scan["flat_recall_at_10"] = recall_at_k(gt.tolist(), ids.tolist(), k)
    # the lean Flat's launches against their plain versions on its own
    # inputs: K1 over the store's permuted mirror, bf16 K2 on the
    # candidates that K1's survivors decode to
    base_i8, scales, cache8, perm = idx.store.device_int8()
    packed, scan["flat_k1_err"] = check_k1_path(q, base_i8, scales, cache8, "l2sqr", "lean_scan_1m Flat")
    _, cand = S.select_survivors(packed, flat.rerank_depth(k))
    cand = T.decode_perm(cand, perm, n)
    scan["flat_k2_bf16_err"] = check_k2_path(q, idx.store.device_rerank(), cand, "l2sqr",
                                             "lean_scan_1m Flat rerank")
    del packed, cand
    exact = exact_l2_f64(fill, n, q, torch.from_numpy(ids).to(q.device)).cpu().numpy()
    rel = float(np.max(np.abs(d - exact) / np.maximum(np.abs(exact), 1e-30)))
    scan["flat_returned_dist_max_rel_err"] = rel
    check(rel <= 1e-5, f"lean_scan_1m: returned distances off exact f32 by {rel:.3g} (> rtol 1e-5)")
    calls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat.knn_batch(q, k)
        calls.append(time.perf_counter() - t0)
    scan["flat_knn_batch_s"] = calls
    # the two searches on this store, like for like: device results, no
    # refinement, chained batches
    scan["flat_two_stage"] = chained_qps(lambda qq: flat._knn_device(qq, k), q, 3, 4)
    scan["ivf_binned_n_probes_16"] = chained_qps(lambda qq: idx._knn_device_binned(qq, k, IVF_GATE_PROBES),
                                                 q, 3, 4)
    idx._note_drops()
    pq_counts(reset=True)
    t0 = time.perf_counter()
    _, ids_i = idx.knn_batch(q, k, IVF_GATE_PROBES)
    scan["ivf_first_call_s"] = time.perf_counter() - t0
    scan["ivf_launches"] = pq_counts()
    check(scan["ivf_launches"]["k10"] > 0, "lean_scan_1m: the binned IVF launched K10 no time")
    scan["ivf_recall_at_10_n_probes_16"] = recall_at_k(gt.tolist(), ids_i.tolist(), k)
    scan["index_bytes"] = idx.index_bytes()
    log(f"[ivf] lean_scan_1m: build {scan['build_s']:.1f} s, Flat recall {scan['flat_recall_at_10']:.4f} "
        f"(returned distances within {rel:.3g} of exact), binned IVF n_probes 16 recall "
        f"{scan['ivf_recall_at_10_n_probes_16']:.4f}, index_bytes {scan['index_bytes']}; QPS best Flat "
        f"{scan['flat_two_stage']['qps_best']:.0f}, IVF {scan['ivf_binned_n_probes_16']['qps_best']:.0f}")
    check(scan["flat_recall_at_10"] >= 0.99, f"lean_scan_1m: Flat recall@10 {scan['flat_recall_at_10']:.4f} < 0.99")
    del idx, flat
    torch.cuda.empty_cache()
    return lean, scan, k2


CODES_POINTS = ((32, 256), (48, 256), (64, 256), (96, 320))  # (n_probes, ef), bench.py:746
CODES_GATE_PROBES = 48  # n_probes of the launch counts, the gates and the K11 check
CODES_PQ_POINTS = ((200, 2048), (400, 4096))  # (ef, c0) of PQCodesIndex.knn_batch


def codes_point(step, q, gt, tag, dropped=None):
    """One search point of a codes cell: recall@10 of `step(q)` against `gt`,
    QPS of chained rounds (best and median), the dropped pairs."""
    import numpy as np

    B = q.shape[0]
    d, ids = step(q)
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    check(ids.shape == (B, 10) and bool(np.isfinite(d).all()) and bool((ids >= 0).all()),
          f"{tag}: malformed result")
    out = {"recall_at_10": recall_at_k(gt, ids.tolist(), 10)}
    if dropped is not None:
        out["dropped_pairs"] = dropped()
    return {**out, **chained_qps(step, q, 3, 4)}


def codes_gates(search, fill, n, q, gt, tag):
    """The kernels-vs-plain recall gate on GATE_Q queries (no kernel count
    moves under the plain versions) and the returned distances of those
    queries against float64 exact distances of their ids (rtol 1e-5)."""
    import numpy as np

    d, ids = search(q[:GATE_Q])
    rec_k = recall_at_k(gt[:GATE_Q], ids.cpu().numpy().tolist(), 10)
    pq_counts(reset=True)
    with plain_kernels():
        rec_p = recall_at_k(gt[:GATE_Q], search(q[:GATE_Q])[1].cpu().numpy().tolist(), 10)
    stray = {k: v for k, v in pq_counts().items() if v}
    check(not stray, f"{tag}: kernels {stray} launched under plain_kernels()")
    check(abs(rec_k - rec_p) <= 0.005, f"{tag}: recall@10 on {GATE_Q} queries {rec_k:.4f} with kernels, "
                                       f"{rec_p:.4f} plain")
    exact = exact_l2_f64(fill, n, q[:GATE_Q], ids).cpu().numpy()
    rel = float(np.max(np.abs(d.cpu().numpy() - exact) / np.maximum(np.abs(exact), 1e-30)))
    check(rel <= 1e-5, f"{tag}: returned distances off exact by {rel:.3g} (> rtol 1e-5)")
    return {"gate_recall_kernels": rec_k, "gate_recall_plain": rec_p, "returned_dist_max_rel_err": rel}


def check_k11(idx, q, n_probes, tag, timed=True):
    """K11 against its plain version on the index's own inputs at n_probes
    (every list, all of q; its auto bin width, chunk 16): survivors and
    slots equal on every filled column.  Bound priced from this run's data:
    the codes of every list, the int8 LUT with scales and norms, lens and
    bins, the survivors; 2 m 16 int8 operations for each (valid row, filled
    column) pair of a list."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    lookup, q_norms = idx.pq.create_lookup(q)
    n_probes = min(n_probes, idx.nlist)
    qb = idx._auto_qb(q.shape[0], n_probes)
    _, bins, _ = idx.probe_and_bin(q, n_probes, qb)
    args = idx.k11_inputs(lookup, q_norms, bins, 16)
    got, ref = A.adc_chunkmin_binned(*args), A.adc_chunkmin_binned_ref(*args)
    torch.cuda.synchronize()
    filled = bins >= 0
    for a, b, what in zip(got, ref, ("minima", "slots")):
        check(torch.equal(a[filled], b[filled]),
              f"K11 {tag}: {int((a[filled] != b[filled]).sum())} survivor {what} differ from the plain version")
    codes, lut_q = args[0], args[1]
    nlist, lpad, m = bins.shape[0], idx.lpad, idx.pq.config.m
    out = {"max_abs_err": max(max_abs_err(got[0][filled], ref[0][filled]),
                              max_abs_err(got[1][filled], ref[1][filled])),
           "shape": [nlist, lpad, qb, m], "filled_columns": int(filled.sum())}
    if timed:
        out["ms"], out["plain_ms"] = in_turns(lambda: A.adc_chunkmin_binned(*args),
                                              lambda: A.adc_chunkmin_binned_ref(*args), 10, 1)
        lens = torch.from_numpy(idx.lens).to(bins.device).long()
        pairs = float((lens * filled.sum(1)).sum())  # (valid row, filled column) pairs
        moved = (nlist * lpad * codes.shape[1] + lut_q.numel() + 8 * lut_q.shape[0]
                 + 4 * nlist * (1 + qb) + 8 * got[0].numel())
        out["bound"] = bound_ms(moved, 2.0 * pairs * m * 16)
        out["extra"] = {"bound_ms_every_slot_and_column": bound_ms(moved, 2.0 * nlist * lpad * qb * m * 16)[0],
                        "valid_row_filled_column_pairs": pairs}
    log(f"[codes] K11 {tag} (nlist {nlist}, lpad {lpad}, qb {qb}, {out['filled_columns']} filled columns): "
        "equal to its plain version on every filled column"
        + (f"; {out['ms']:.3f} ms, plain {out['plain_ms']:.1f} ms, bound {out['bound']}" if timed else ""))
    return out


def check_k7_codes(codes, lookup, cb_sq, q_norms, n_valid, chunk, dist, tag, timed=False):
    """K7 against its plain version at one launch of the codes path (the
    coarse stage-0 scan over every row, the overflow segment): survivors and
    positions equal; timed and bounded like flat_pq_1m's K7, plus the time
    of the top-c0 stable selection over the survivors when `timed` is the
    pool size."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    N, cw = codes.shape
    S = -(-N // A._NT) * A._NT // chunk
    lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(lookup, cb_sq, dist, True, cw)
    args = (codes, lut_q, scales, q_norms.float(), cs_q, cs_scale, n_valid, True, S, chunk)
    got, ref = A.adc_chunkmin(*args), A.adc_chunkmin_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
          f"K7 {tag}: {int((got[1] != ref[1]).sum())} survivors differ from the plain version")
    B, m = lut_q.shape[0], lookup.shape[1]
    out = {"max_abs_err": max(max_abs_err(got[0], ref[0]), max_abs_err(got[1], ref[1])),
           "shape": [N, B, m, chunk]}
    if timed:
        out["ms"], out["plain_ms"] = in_turns(lambda: A.adc_chunkmin(*args), lambda: A.adc_chunkmin_ref(*args), 5, 1)
        moved = N * cw + lut_q.numel() + 8 * B + (0 if cs_q is None else cs_q.numel()) + 8 * B * S
        out["bound"] = bound_ms(moved, 2.0 * n_valid * B * m * 16)
        out["extra"] = {"topc0_select_ms": cuda_ms(lambda: T.topk_smallest(got[0], got[1], timed), 3),
                        "survivors_per_query": S, "c0": timed}
    log(f"[codes] K7 {tag} ({N} rows, m {m}, chunk {chunk}, {B} queries): equal to its plain version"
        + (f"; {out['ms']:.3f} ms, plain {out['plain_ms']:.1f} ms, bound {out['bound']}, top-{timed} "
           f"selection over {S} survivors {out['extra']['topc0_select_ms']:.2f} ms" if timed else ""))
    return out


def phase_codes(card, n=10_000_000, nlist=2048, n_cos=200_000, nlist_cos=128, B=1000, device="cuda"):
    """codes_ivfpq_10m and codes_pq_10m (the codes-resident tiers at the
    reference's flagship 10,000,000 x 960, bench.py:672-759) on one
    `make_fill(0, 960)` source, its 1000 queries and one exact ground truth
    by blocked regeneration; then a 200,000-row cosine IVF-PQ index for the
    cosine columns of K11 and K7."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.bench import synth
    from lab_1806_vec_db_tpu_torch.models import IVFPQIndex, PQCodesIndex
    from lab_1806_vec_db_tpu_torch.ops import adc as A
    from lab_1806_vec_db_tpu_torch.ops import topk as T
    from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

    dim, k = 960, 10
    t_phase = time.perf_counter()
    fill, queries = synth.make_fill(0, dim, device)
    q = queries(B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gt = synth.exact_gt_blocked(fill, n, q, k, "l2sqr").cpu().numpy().tolist()
    out = {"n": n, "dim": dim, "batch": B, "exact_gt_s": time.perf_counter() - t0}
    log(f"[codes] exact ground truth over {n} regenerated rows: {out['exact_gt_s']:.1f} s")

    # ---- codes_ivfpq_10m ----
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = IVFPQIndex.build_from_fill(fill, n, dim, "l2sqr", nlist=nlist,
                                     pq_config=PQConfig(n_bits=4, m=320, dist="l2sqr", k_means_size=25_000),
                                     row_gen=fill.row_gen, block_rows=131072, device=device)
    torch.cuda.synchronize()
    ivf = {"cell": "codes_ivfpq_10m", "nlist": nlist, "m": 320, "chunk": 16, "build_s": time.perf_counter() - t0,
           "lpad": idx.lpad, "overflow_rows": idx.ov_count, "index_bytes": idx.index_bytes(),
           "adc_quality": idx.pq.adc_quality}
    ivf["bytes_per_row"] = ivf["index_bytes"] / n
    log(f"[codes] codes_ivfpq_10m: build {ivf['build_s']:.1f} s, lpad {idx.lpad}, overflow {idx.ov_count}, "
        f"index_bytes {ivf['index_bytes']} ({ivf['bytes_per_row']:.1f} B/row)")
    sweep, launches = {}, None
    for p, ef in CODES_POINTS:
        if p == CODES_GATE_PROBES:
            pq_counts(reset=True)
            idx.knn_batch(q, k, n_probes=p, ef=ef)
            launches = pq_counts()
        sweep[f"{p}/{ef}"] = {"qb": idx._auto_qb(B, p), **codes_point(
            lambda qq, p=p, ef=ef: idx.knn_batch(qq, k, n_probes=p, ef=ef), q, gt,
            f"codes_ivfpq_10m n_probes {p}", dropped=lambda: int(idx.last_dropped))}
    ivf["sweep"], ivf["launches"] = sweep, launches
    ivf["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    recs = [v["recall_at_10"] for v in sweep.values()]
    log("[codes] codes_ivfpq_10m: " + ", ".join(f"{key} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f} "
                                                f"dropped {v['dropped_pairs']}" for key, v in sweep.items()))
    check(all(b >= a for a, b in zip(recs, recs[1:])), f"codes_ivfpq_10m: recall falls as n_probes grows: {recs}")
    check(launches["k11"] > 0 and (idx.ov_count == 0 or launches["k7"] > 0),
          f"codes_ivfpq_10m: the search launched {launches}")
    ivf.update(codes_gates(lambda qq: idx.knn_batch(qq, k, n_probes=CODES_GATE_PROBES, ef=256), fill, n, q, gt,
                           "codes_ivfpq_10m"))
    ivf["profile_n_probes_48"] = profile_call(lambda: idx.knn_batch(q, k, n_probes=CODES_GATE_PROBES, ef=256))
    k11 = check_k11(idx, q, CODES_GATE_PROBES, "codes_ivfpq_10m")
    lookup, q_norms = idx.pq.create_lookup(q)
    if idx.ov_count:
        k_ov, ch = idx.overflow_chunk(k)
        ivf["k7_overflow"] = check_k7_codes(idx._codes_ov, lookup, idx.pq.device()[2], q_norms, idx.ov_count,
                                            ch, "l2sqr", "codes_ivfpq_10m overflow segment")
    del idx, lookup, q_norms
    torch.cuda.empty_cache()

    # ---- codes_pq_10m ----
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pqc = PQCodesIndex.build_from_fill(fill, n, dim, "l2sqr", row_gen=fill.row_gen, device=device)
    torch.cuda.synchronize()
    pqo = {"cell": "codes_pq_10m", "m": 320, "coarse_m": 32, "build_s": time.perf_counter() - t0,
           "index_bytes": pqc.index_bytes(), "adc_quality": pqc.pq.adc_quality,
           "coarse_adc_quality": pqc.coarse.adc_quality}
    pqo["bytes_per_row"] = pqo["index_bytes"] / n
    log(f"[codes] codes_pq_10m: build {pqo['build_s']:.1f} s, index_bytes {pqo['index_bytes']} "
        f"({pqo['bytes_per_row']:.1f} B/row)")
    points, pq_launches = {}, None
    for ef, c0 in CODES_PQ_POINTS:
        if pq_launches is None:
            pq_counts(reset=True)
            pqc.knn_batch(q, k, ef=ef, c0=c0)
            pq_launches = pq_counts()
        points[f"{ef}/{c0}"] = {"chunk": pqc.stage0_chunk(c0), **codes_point(
            lambda qq, ef=ef, c0=c0: pqc.knn_batch(qq, k, ef=ef, c0=c0), q, gt, f"codes_pq_10m ef {ef}")}
    pqo["points"], pqo["launches"] = points, pq_launches
    pqo["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    check(pq_launches["k7"] > 0 and pq_launches["k8_ids"] > 0, f"codes_pq_10m: the search launched {pq_launches}")
    log("[codes] codes_pq_10m: " + ", ".join(f"{key} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f}"
                                             for key, v in points.items()))
    # stage split at the defaults with CUDA events (mean of 5 passes)
    ef, c0 = CODES_PQ_POINTS[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    split = dict.fromkeys(("stage0_k7_and_topc0", "stage1_k8_and_topef", "refine", "exact_topk"), 0.0)
    for i in range(6):
        ev[0].record()
        ids0 = pqc.stage0(q, c0)
        ev[1].record()
        td1, ti1 = pqc.stage1(q, ids0, ef)
        ev[2].record()
        d_ex = pqc.refine(q, ti1)
        ev[3].record()
        T.topk_smallest(torch.where(torch.isfinite(d_ex), d_ex, td1), ti1, k)
        ev[4].record()
        torch.cuda.synchronize()
        if i:
            for name, a, b in zip(split, ev, ev[1:]):
                split[name] += a.elapsed_time(b) / 5
    pqo["stage_ms"] = split
    pqo.update(codes_gates(lambda qq: pqc.knn_batch(qq, k, ef=ef, c0=c0), fill, n, q, gt, "codes_pq_10m"))
    pqo["profile_defaults"] = profile_call(lambda: pqc.knn_batch(q, k, ef=ef, c0=c0))
    lut_c, qn_c = pqc.coarse.create_lookup(q)
    k7s0 = check_k7_codes(pqc._codes_c, lut_c, pqc.coarse.device()[2], qn_c, n, pqc.stage0_chunk(c0), "l2sqr",
                          "codes_pq_10m stage 0", timed=c0)
    # K8's ids shape at the pool's (1000, c0) positions against its plain
    # version (bf16 LUT): rtol 1e-5, as check_sums_ids holds it
    lut_m, _ = pqc.pq.create_lookup(q)
    pos = pqc._inv[ids0.clamp_min(0).long()]
    lut_b = lut_m.to(torch.bfloat16)
    got = A.adc_sums_ids(pqc._codes, lut_b, pos, 320, True)
    ref = A.adc_sums_ids_ref(pqc._codes, lut_b, pos, 320, True, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0.0)
    pqo["k8_ids_pool_max_abs_err"] = max_abs_err(got, ref)
    log(f"[codes] K8 ids at the pool (B {B}, C {c0}) within rtol 1e-5 of its plain version; "
        f"stages {split}")
    del pqc, lut_c, qn_c, lut_m, pos, lut_b, got, ref, ids0, td1, ti1, d_ex
    torch.cuda.empty_cache()

    # ---- the cosine columns: a small cosine IVF-PQ index ----
    cos = IVFPQIndex.build_from_fill(fill, n_cos, dim, "cosine", nlist=nlist_cos,
                                     pq_config=PQConfig(n_bits=4, m=320, dist="cosine", k_means_size=25_000),
                                     row_gen=fill.row_gen, device=device)
    cos_out = {"n": n_cos, "nlist": nlist_cos, "lpad": cos.lpad, "overflow_rows": cos.ov_count}
    cos_out["k11_max_abs_err"] = check_k11(cos, q, CODES_GATE_PROBES, "cosine, 200,000 rows", timed=False)["max_abs_err"]
    lookup, q_norms = cos.pq.create_lookup(q)
    # K7's cosine column on the index's real codes (its first 131,072 list
    # slots, chunk 16), and on its overflow segment where lists spilled
    k7_errs = [check_k7_codes(cos._codes[:131072], lookup, cos.pq.device()[2], q_norms, 131072, 16,
                              "cosine", "cosine, 131,072 list slots")["max_abs_err"]]
    if cos.ov_count:
        k7_errs.append(check_k7_codes(cos._codes_ov, lookup, cos.pq.device()[2], q_norms, cos.ov_count,
                                      cos.overflow_chunk(k)[1], "cosine", "cosine overflow segment")["max_abs_err"])
    cos_out["k7_cosine_max_abs_err"] = max(k7_errs)
    d, ids = cos.knn_batch(q, k, n_probes=16, ef=256)
    check(bool(torch.isfinite(d).all()) and bool((ids >= 0).all()), "codes cosine: malformed result")
    del cos, lookup, q_norms
    torch.cuda.empty_cache()
    out.update(codes_ivfpq_10m=ivf, codes_pq_10m=pqo, cosine_200k=cos_out, phase_s=time.perf_counter() - t_phase)
    log(f"[codes] phase: {out['phase_s']:.1f} s")
    return out, k11, k7s0


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
    launches, gts = {}, {}
    db = VecDB(db_dir)
    try:
        for key, dist in (("gist_l2", "l2sqr"), ("gist_cos", "cosine")):
            check(db.create_table_if_not_exists(key, x_host.shape[1], dist), "create table")
            t0 = time.perf_counter()
            db.batch_add(key, x_host, meta)
            t_add = time.perf_counter() - t0
            exact = FlatIndex.from_numpy(x_host, dist)
            _, gt = exact.knn_batch(q_host, k, exact=True)
            gts[key] = gt.tolist()
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
        key = "gist_l2"
        out["hnsw"], hnsw_launches, hnsw_meas, db = phase_hnsw(db, db_dir, key, q_host, gts[key])
        pq_out, pq_launches, pq_meas = phase_pq_200k(db, q_host, gts, x_host)
        cos_before = db.batch_search("gist_cos", q_host, k, ef=200)
        # delete by pattern (it downgrades the table to Flat): row 7 is its
        # own nearest neighbour until deleted
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
        # the cosine table's PQ table rides its checkpoint (the l2sqr one
        # was dropped by the delete, the reference's rule)
        check(db.has_pq_table("gist_cos") and not db.has_pq_table(key), "PQ tables after reopen")
        check(db.batch_search("gist_cos", q_host, k, ef=200) == cos_before,
              "PQ batch_search differs after reopen")
    finally:
        db.close()
    shutil.rmtree(db_dir, ignore_errors=True)
    log("[5/6] VecDB delete / close / reopen: identical results (PQ table included)")
    return out, launches, hnsw_launches, hnsw_meas, (pq_out, pq_launches, pq_meas)


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

    # QPS the reference's way: best and median of 5 rounds of 8 chained batches
    reps = 8
    qps = chained_qps(lambda qq: flat._knn_device(qq, k), q, 5, reps)
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
    times = {}
    for name, kern, plain, reps_k, reps_p in (("k1", k1, k1_ref, 10, 2), ("k2", k2, k2_ref, 20, 5)):
        times[f"{name}_ms"], times[f"{name}_plain_ms"] = in_turns(kern, plain, reps_k, reps_p)
    k1_equal = torch.equal(k1(), k1_ref())
    check(k1_equal, "1M: K1 differs from its plain version")
    k2_err = float((k2() - k2_ref()).abs()[cand >= 0].max())
    # the int8 product alone, as one library call: not the same function (no
    # epilogue, no chunk-min; it writes the whole (B, N) int32 matrix)
    times["int_mm_gemm_alone_ms"] = cuda_ms(lambda: torch._int_mm(q8, base_i8.T), 3)
    # priced on the function's own inputs: n int8 rows of dim lanes with a
    # scale and a cached term each (not the mirror's lane padding to 1024 or
    # its sentinel rows), B int8 queries, one int32 per (128 rows, query)
    times["k1_bound"] = bound_ms(n * dim + 8 * n + B * (dim + 8) + -(-n // 128) * B * 4,
                                 2.0 * n * B * dim)
    times["k2_bound"] = bound_ms(B * r * dim * 4 + B * r * 4 + B * dim * 4 + B * r * 4)
    out = {
        "phase": "flat_1m", "card": card, "n": n, "dim": dim, "batch": B, "k": k, "dist": dist,
        "rerank_depth": r, "recall_at_10": rec, **qps,
        "first_call_s": t_first, "ingest_s": t_ingest, "exact_gt_s": t_gt,
        "stage_ms": split, **times, "k1_equal_at_1m": k1_equal, "k2_max_abs_err_at_1m": k2_err,
        "profile": profile,
        "index_device_bytes": flat.index_bytes(),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "launches_first_call": {"k1": launches[0], "k2": launches[1]},
    }
    log(f"[6/6] 1M x 960: recall@10 {rec:.4f}, QPS best {qps['qps_best']:.0f} median {qps['qps_median']:.0f}, "
        f"stages {split}, {times}")
    pq_out, k7 = phase_pq_1m(store, flat, q, gt.tolist())
    ivf_out, k10 = phase_ivf_1m(store, q, gt.tolist())
    return out, pq_out, k7, ivf_out, k10


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
    db_out, launches, hnsw_launches, hm, (pq_out, pq_launches, pm) = phase_vecdb(x_host, q_host)
    del x_host
    print(json.dumps({"phase": "vecdb", "card": card, **db_out}), flush=True)
    torch.cuda.empty_cache()
    m, pq_1m, k7, ivf_1m, k10 = phase_1m(card)
    print(json.dumps(m), flush=True)
    print(json.dumps({"phase": "pq", "card": card, "flat_pq_1m": pq_1m, **pq_out,
                      "kernels_vs_plain": {"k7_1m": k7, **pm}}, default=str), flush=True)
    torch.cuda.empty_cache()
    ivf_lean, lean_scan, k2_bf16 = phase_lean(card)
    print(json.dumps({"phase": "ivf", "card": card, "ivf_1m": ivf_1m, "ivf_lean_4m": ivf_lean,
                      "lean_scan_1m": lean_scan,
                      "kernels_vs_plain": {"k10_ivf_1m": k10, "k2_bf16_ivf_lean_4m": k2_bf16}},
                     default=str), flush=True)
    torch.cuda.empty_cache()
    codes, k11, k7s0 = phase_codes(card)
    print(json.dumps({"phase": "codes", "card": card, **codes,
                      "kernels_vs_plain": {"k11_codes_ivfpq_10m": k11, "k7_codes_pq_10m_stage0": k7s0}},
                     default=str), flush=True)

    main_launches = launches["gist_l2"]
    # each error is the largest over every comparison of that kernel with its
    # plain version, the IVF path's own inputs included
    k1_err = max(k1_err, ivf_1m["k1_overflow_err"], ivf_lean["k1_overflow_err"], lean_scan["flat_k1_err"])
    k2_err = max(k2_err, ivf_1m["k2_binned_rerank_err"])
    k10 = {**k10, "max_abs_err": max(k10["max_abs_err"], ivf_lean["k10_err"])}
    k2_bf16 = {**k2_bf16, "max_abs_err": max(k2_bf16["max_abs_err"], lean_scan["flat_k2_bf16_err"])}
    k3b, k4b, k5b = bound_ms(hm["k3_bytes"]), bound_ms(hm["k4_bytes"]), bound_ms(hm["k5_bytes"])
    kernels = [
        {"name": "scan_chunkmin_int8_packed", "route": "cuda",
         "source": f"{PKG}/csrc/scan_int8_packed.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_scan.py:542",
         "launches": main_launches[0], "max_abs_err": k1_err,
         "ms": m["k1_ms"], "plain_ms": m["k1_plain_ms"], "bound_ms": m["k1_bound"][0],
         "bound_by": m["k1_bound"][1], "library_ms": None},
        {"name": "gather_dists", "route": "cuda",
         "source": f"{PKG}/csrc/gather_dists.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_gather.py:261",
         "launches": main_launches[1], "max_abs_err": k2_err,
         "ms": m["k2_ms"], "plain_ms": m["k2_plain_ms"], "bound_ms": m["k2_bound"][0],
         "bound_by": m["k2_bound"][1], "library_ms": None},
        {"name": "traverse", "route": "cuda", "source": f"{PKG}/csrc/traverse.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_traverse.py:251",
         "launches": hnsw_launches["k3"], "max_abs_err": hm["k3_err"],
         "ms": hm["k3"][0], "plain_ms": hm["k3"][1], "bound_ms": k3b[0], "bound_by": k3b[1],
         "library_ms": None},
        {"name": "beam_pre", "route": "cuda", "source": f"{PKG}/csrc/beam_pre.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_beam.py:148",
         "launches": hnsw_launches["k4"], "max_abs_err": hm["k4_err"],
         "ms": hm["k4"][0], "plain_ms": hm["k4"][1], "bound_ms": k4b[0], "bound_by": k4b[1],
         "library_ms": None},
        {"name": "beam_post", "route": "cuda", "source": f"{PKG}/csrc/beam_post.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_beam.py:257",
         "launches": hnsw_launches["k5"], "max_abs_err": hm["k5_err"],
         "ms": hm["k5"][0], "plain_ms": hm["k5"][1], "bound_ms": k5b[0], "bound_by": k5b[1],
         "library_ms": None},
    ]

    def pq_kernel(name, src, replaces, launches, meas, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                "replaces": f"lab_1806_vec_db_tpu/ops/{replaces}", "launches": launches,
                "max_abs_err": meas["max_abs_err"], "ms": meas["ms"], "plain_ms": meas["plain_ms"],
                "bound_ms": meas["bound"][0], "bound_by": meas["bound"][1], "library_ms": library_ms,
                **meas.get("extra", {})}

    k6 = pm["k6"][180]
    kernels += [
        # K6 on the classic loop (hnsw_pq_200k graph, fused=False, ef 180);
        # the error is the largest over ef 180 / 360 / 600
        pq_kernel("merge_sorted", "merge_sorted.cu", "pallas_merge.py:128",
                  pq_launches["graph_classic"]["k6"],
                  {**k6, "max_abs_err": max(v["max_abs_err"] for v in pm["k6"].values())},
                  k6["library_ms"]),
        # K7 on flat_pq_1m's first search (ef 100); measured there at 1M rows
        pq_kernel("adc_chunkmin", "adc_scan_chunkmin.cu", "pallas_adc.py:415",
                  pq_1m[100]["launches"]["k7"], k7),
        # K8 ids inside the fused loop (hnsw_pq_200k graph, ef 180)
        pq_kernel("adc_sums_ids_k16", "adc_sums.cu", "pallas_adc.py:253",
                  pq_launches["graph"]["k8_ids"], pm["k8_ids"]),
        # K8 dense on the 60,000-row Flat+PQ table at ef 600
        pq_kernel("adc_sums_dense_k16", "adc_sums.cu", "pallas_adc.py:253",
                  pq_launches["k8_dense"], pm["k8_dense"]),
        # K9 ids / dense on the n_bits = 8 table's graph / scan routes (ef 180)
        pq_kernel("adc_sums_ids_k256", "adc_sums.cu", "pallas_adc.py:119",
                  pq_launches["nbits8_graph"]["k9_ids"], pm["k9_ids"]),
        pq_kernel("adc_sums_dense_k256", "adc_sums.cu", "pallas_adc.py:119",
                  pq_launches["nbits8_scan"]["k9_dense"], pm["k9_dense"]),
        # K10 on ivf_1m's binned knn_batch at n_probes 16; checked and timed
        # there on the whole sorted mirror
        pq_kernel("scan_chunkmin_int8_binned", "scan_int8_binned.cu", "pallas_scan.py:726",
                  ivf_1m["launches"]["k10"], k10),
        # K2 on bf16 rows: ivf_lean_4m's binned knn_batch at n_probes 16
        pq_kernel("gather_dists_bf16", "gather_dists.cu", "pallas_gather.py:261",
                  ivf_lean["launches"]["k2"], k2_bf16),
        # K11 on codes_ivfpq_10m's knn_batch at n_probes 48; checked and
        # timed there on every list (the error also over the cosine index)
        pq_kernel("adc_chunkmin_binned", "adc_chunkmin_binned.cu", "pallas_adc.py:629",
                  codes["codes_ivfpq_10m"]["launches"]["k11"],
                  {**k11, "max_abs_err": max(k11["max_abs_err"], codes["cosine_200k"]["k11_max_abs_err"])}),
        # K7 at stage 0 of codes_pq_10m's first knn_batch (10M coarse rows,
        # m 32); the error also over the overflow segment and the cosine codes
        pq_kernel("adc_chunkmin_codes_stage0", "adc_scan_chunkmin.cu", "pallas_adc.py:415",
                  codes["codes_pq_10m"]["launches"]["k7"],
                  {**k7s0, "max_abs_err": max(k7s0["max_abs_err"], codes["cosine_200k"]["k7_cosine_max_abs_err"],
                                              codes["codes_ivfpq_10m"].get("k7_overflow", {}).get("max_abs_err", 0.0))}),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s (build {build_s:.1f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
