#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (the quickest proof that
the port still starts on the card).

    python3 chip_smoke.py [--parent DIR]

`--parent DIR` names a checkout of an earlier commit (say `git archive` of
it unpacked under tmp/): the u8 phase then times that checkout's uint8
stage 1 in turns with this tree's, and compares the float K1's SASS.

Phases, in order; any failure ends the run with a non-zero exit code:
  1. device  — require CUDA; print the card's name and power limit;
  2. build   — build the CUDA kernels of `lab_1806_vec_db_tpu_torch/csrc/`;
               read ptxas's registers, spills and wgmma serialization notes
               of the K1, K3-K5, K8, K10 and K12-K14 kernels from the
               build's report (none found, a spill, or a note on K1, K13 or
               K14 fails; K10's is recorded); K3's CTAs per SM and waves at B = 1000 from
               CUDA's occupancy calculator at ef 120 / 200 / 360, both row
               types (more than one wave fails);
  3. K1      — the packed int8 scan kernel against its plain PyTorch version
               at B = 1000, 16 and 1 (one partial query tile), both
               metrics, on ragged mirrors with sentinel rows at the main
               path's 1024 lanes (dim 960), the "pca" route's 256 and 1152
               (the query tile streamed, not resident), and on the whole
               200,000-row mirror: equal element for element;
  4. K2      — the rerank gather kernel against its plain version (B = 1000,
               r = 40, dim 960, some -1 ids), both metrics: rtol 1e-5,
               atol 1e-6, +inf exactly where the id is -1;
               then the exact small-batch scan (`scan_exact_small.cu`) on
               the same 200,000 rows, cosine: against its plain version and
               float64 at B 1 / 4 / 16, k 1 / 10 / 32, timed at one query in
               turns with the plain version, beside its byte bound and the
               library's GEMV + `torch.topk`;
               then the cosine columns of K12-K14 on the same 200,000 rows
               against their plain versions (K13 / K14 equal element for
               element, K12 within rtol 1e-5 / atol 1e-6 with ids equal
               except between rows within that of each other); K13 / K14
               also, untimed and on both metrics, on a ragged base (70,000
               rows, n_valid 69,500, B 50), at widths 96 and 1040 (the
               second streams its query boxes) and on channels across
               f32's range (`time_adc.int8_edge_case`), all equal;
  5. VecDB   — the user's entry points on two 200,000 x 960 Gist-spectrum
               tables (l2sqr, cosine) of a VecDB seeded with DB_SEED (so
               the HNSW graph, the PQ table and every route's ids repeat
               from run to run and tree to tree): batch_add, batch_search (B = 1000,
               k = 10) through both kernels, recall@10 against the exact scan,
               search on the card (50 queries, a batch of one each: ids
               equal to the exact scan's) and through the native engine on
               the host rows (distances within rtol 1e-5 / atol 1e-6 of
               float64, no row farther than the exact scan's at its rank,
               rtol 1e-6), µs a search each way, the upper_bound filter,
               delete, close and reopen;
     hnsw    — inside phase 5, on the l2sqr table: build_hnsw_index (M = 16,
               ef_construction = 200), batch_search with ef (the scan route,
               K1 + K2), the graph route (K3) at ef 120 / 200 / 360 with
               recall, QPS and a hash of its ids beside the scan route's, traversal_stats at
               ef 120 (the K4 -> K2 -> K5 loop), K4 / K5 against their
               plain versions (B = 1000, W 128 and 256 on random states;
               edge-case states at W 128, 256, 512 and 1024, B = 1000, at W
               2048, B = 100, and at W 4096, B = 64: ties, -inf keys, +inf beam lanes with ids,
               finite tile lanes with id -1 and past lane 128, empty tiles,
               dup-heavy tiles, ring holes, E 1 / 4 / 8, ef < W and ef = W;
               all equal element for element), K3 against its
               plain version on the route's B = 1000 queries at every ef
               (ids, distances, K2's bits, and bit for bit the plain loop
               on K2's distances), then untimed on random graphs
               (`time_adc.k3_edge_checks`: both metrics and row types, E /
               L 1 / 128 to 8 / 16, ef 1 to 4096, R from E to 256,
               duplicate-heavy and -1 links, padding queries, dims 100
               and 98), index_bytes, and close / reopen as HNSW;
     lean_graph — inside phase 5, after hnsw: that graph attached to a
               lean store of the same rows (from_device_blocks: int8
               mirror + bf16 rows), the graph route at ef 120 / 200 (K2's
               descent and K3 over the bf16 rows, then the exact refinement
               of the top k): recall@10 within 0.01 of the full store's on
               the same graph, returned distances within rtol 1e-5 of
               float64, QPS and a hash of the ids; K3 on the bf16 rows
               against its plain version on those queries;
     native  — inside phase 5, on the reopened HNSW table, 200 single
               queries at ef 120 / 200 both ways: VecDB.search on the card
               (the scan route, K1 + K2 once a query, recall@10 >= 0.99) and
               the native engine on the host rows and links (no kernel may
               launch; recall@10 within 0.08 of the graph route's on the
               same queries); µs a search each way;
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
               count still 0 after the plain run), the graph routes' device
               busy ms and a hash of its ids at each ef; K4 / K5 on the
               arguments of one of their launches in the graph route at ef
               180 and 600 (equal), timed back to back beside their plain
               versions and replayed from a CUDA graph; K6 against its plain
               version at B = 1000, EL = 128 and ef 180 / 360 / 600, and on
               the arguments of one of its launches in the classic loop at
               ef 180 and 600 (equal), timed back to back and replayed from
               a CUDA graph beside its library line, and bit for bit on the
               CPU tests' edge inputs and at ef + EL = 8,192, K8 and
               K9 ids at widths 1 / 16 / 128 (equal; K8 also at code widths
               7 and 20, its byte-wise reads), K8 / K9 dense on one
               block (equal; also at the cosine route's R = 1001, K9 on the
               scan's last partial block; K8's bf16 lookup body too), K8 / K9
               with their lookup bounds beside the byte bounds (K7 and K8
               int8 dense also their one-hot method's operation bound,
               `method_ops_bound_ms`, beside the byte floor `bound_ms`);
  6. 1M      — FlatIndex at 1,000,000 x 960 (device-born): recall@10 against
               the exact scan, QPS of chained batches (best and median of 5
               rounds of 8), a per-stage split timed with CUDA events, each
               kernel against its plain version, and index_device_bytes;
               the exact small-batch scan at one query, l2sqr, on the same
               rows (checked and timed as in phase 4); `FlatIndex.knn`'s
               operations on the card and kernel launches a search;
     select  — inside phase 6, on K1's survivors of that batch (S 7,936, B
               1000): the survivor select kernel (`select_survivors.cu`)
               against its plain version (the stable sort), distances and
               ids bit for bit, at r 40 (the cell), 160 (pca), 120 / 600
               (HNSW's scan route on 1,568 survivors), 1024 (the kernel's
               largest), on an IVF overflow
               segment's 80 and 560, at B 1 and 1001, r past S, and on
               heavy ties (four keys, -0.0 and +0.0 among them) and on one
               key; each timed in turns with the plain version, beside its
               byte bound, its CUDA-graph replay and a keyed `torch.topk`
               (the yardstick); where
               the shape rule sends a shape to the kernel, the kernel may
               not be slower than the sort;
     resident — on the same rows (l2sqr, B = 1000): the three q-resident
               stage-1 entry points (K12 on the store's bf16 copy, K13 and
               K14 on int8 rows with raw channels) each feeding r = 40
               candidates to K2, recall@10 and QPS, the launch counts from 0
               around the three; each kernel against its plain version,
               timed in turns, with its bound (K13 / K14 also replayed from
               a CUDA graph);
     pq      — flat_pq_1m: PQTable.train from the store's device tensor
               through the table's defaults (`table_config`: 100,000
               samples, the benchmark cell gist1m_pq's table),
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
     pca     — pca_1m: the same store in the "pca" scan mode
               (`store.scan_mode = ScanMode("pca", 256)`, then restored): fit and mirror build s, K1 / K2 launches from 0
               around one batch, recall@10, ids with the kernels = ids with
               the plain versions (128 queries), chained QPS beside the int8
               route's, a stage split, index_bytes with the projected
               mirror, K1 at D 256 against its plain version (equal, timed
               in turns, bound); the "bf16" and "exact" modes on one batch
               each (exact = knn_scan's ids); pca_cos_200k (the cosine
               200,000-row cut: recall, K1 equal), a swap_remove + push after
               the fit found at distance < 1e-5; K1 at D 128 on a 69,500-row
               ragged mirror (B 1000, 37), equal; pca_lowrank_1m: 1,000,000 x
               960 of rank 64 drawn on the card, recall@10 >= 0.95;
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
               columns; its bound the byte floor, the one-hot method's
               operations beside it) at 48 probes (qb 64, timed), 32 (qb 32) and 96 (qb
               96: two column blocks), with the wgmma N of each (list, block);
               codes_ivfpq_10m's stage split at 48/256; K7 at stage 0 (all 10M coarse rows) and on the
               overflow segment (equal), K8 ids at the (1000, c0) pool
               (equal, timed); a 300,000-row cosine IVF-PQ index (64 lists, some
               spilling) for K11's and K7's cosine columns, K7's also on its
               overflow segment; index_bytes again after the first search
               (IVF-PQ uploads its centroids and lens then);
  8. u8      — u8_1m: FlatIndexU8 at 1,000,000 x 128 uint8 rows (BIGANN's
               shape; Gist-spectrum rows scaled and clipped to 0-255), B =
               1000, k = 10, QPS of chained batches, the returned distances
               of 64 queries equal to float64 exact and to the exact top-10,
               the exact route against the library path (`knn_scan_u8`) on
               every query, both timed; K1's uint8 variant against its plain
               version at 8 shapes (`k1_u8_twins`); u8_100m (`u8_100m`):
               from_device over 100,000,000 rows (build s, peaks), the uint8
               stage 1 and the select (S 781,264, r 10) each equal to its
               plain version on the route's tensors and timed in turns with
               it, the rescan, one launch of each in a knn_batch call,
               knn_batch, one library-path call, 100 queries equal to the
               exact reference; the ptxas figures of the uint8 kernel's
               instantiations; with `--parent`, the parent's uint8 stage 1
               in turns with this tree's at 1M x 128 (B 1, 16, 1000) and at
               u8_100m, equal to it, and the float K1's SASS (instructions,
               registers) beside the parent's;
               vecdb_u8_100k: a uint8 VecDB table of 100,000 rows through the
               API (batch_add, batch_search against the index, the 200.7 ->
               200 cast, HNSW and PQ refused with RuntimeError, reopen).
  9. harness — harness_200k, in a temporary directory: the synth CLI
               (200,000 x 960, 1,000 queries, --gnd), gen_gnd (equal to
               synth's), convert_fvecs on a small file, the bench harness on
               two chained TOMLs (Flat: K1 + K2; IVF nlist 256, n_probes 8 /
               16 / 32: K10), launches from 0 around each; results.toml loads
               in ResultList with chained = true and a recall per point, its
               .html beside it; ms/query and recall per point.
 10. examples — the four examples/*.py against the port, each in a
               subprocess (a copy importing the port's VecDB, in a temporary
               working directory): exit 0 and "Test passed".
     sharded — the sharded indexes (`parallel/`), every shard on cuda:0
               (`make_mesh(devices=["cuda:0"] * n)`), run beside the phases
               whose data they reuse and printed as one JSON line
               `{"phase": "sharded", ...}` before the kernel line: after
               phase 5, sharded_hnsw_200k (4 graphs of vecdb_200k's rows, ef
               120 / 200, recall >= 0.95 at 200, K4 / K5 launches > 0, ids
               with the kernels = with the plain versions on 128 queries, a
               4 -> 2 load that rebuilds with its warning),
               sharded_pq_flat_200k (m 320, B 1000, exact returned
               distances) and vecdb_mesh (`VecDB(dir, mesh=4)`: batch_search
               ids = the exact scan's, a pushed row found at distance 0);
               inside phase 6, sharded_flat_1m (flat_1m's rows viewed in
               place, 1 / 2 / 4 shards: exact ids = `knn_scan`'s, distances
               within rtol 1e-5; two-stage recall >= the single-chip "bf16"
               mode's - 0.01; chained QPS) and sharded_ivf_1m (nlist 256, 2
               sharded Lloyd steps, one step within 1e-4 of the
               single-device step, recall at 16 / 32 probes, all probes =
               the exact scan's ids); inside phase 7, sharded_ivfpq_4m (the
               codes phase's source cut to its first 4,000,000 rows, which
               at 10M took the smoke past 420 s; nlist 2048, 48 / 256: K11 /
               K7 launches > 0, ids with the
               kernels = with the plain versions on 128 queries, recall >=
               codes_ivfpq_10m's - 0.05, a 4 -> 2 re-place within 0.01);
               Flat and IVF re-place 4 -> 2 with equal results; in phase 9,
               harness_mesh (`mesh = 4` TOMLs: Flat, HNSW on 50,000 rows,
               IVF + PQ).

The last line of standard output is `{"ok": true, "device": {...}}`; the
line before it lists each kernel with its launch count on its path (K1 / K2:
the VecDB batch_search run; K1 at 256 lanes, `..._pca256`: pca_1m's batch; K3: the graph-route searches;
K3 on bf16 rows, `traverse_bf16`: lean_graph's route at ef 120; K4 / K5: the
traversal_stats run, `ms` back to back as every kernel's, `graph_ms`
replayed from a CUDA graph beside it; K6-K9: the first call of the PQ route that takes each,
K6's `graph_ms` and `library_graph_ms` replayed on its captured classic-loop arguments;
K10: ivf_1m's binned search at n_probes 16; bf16 K2: ivf_lean_4m's; K11:
codes_ivfpq_10m's search at n_probes 48; K7 at stage 0: codes_pq_10m's
first search; K12-K14: the resident phase's three entry points, K13 / K14
with `graph_ms` too; K4 / K5 / K7 / K11 also carry `sharded_launches`, the
sharded HNSW's at ef 200 and the sharded IVF-PQ's at 48 probes; K1's uint8
variant, `scan_u8_exact`: one knn_batch call of u8_100m, timed there),
its error against the plain version, both times, the least time the card
could take (`bound_ms`) and a library call's time where one PyTorch call
computes the same function (K6: a stable torch.sort and a gather;
`scan_u8_exact`: one call of the uint8 library path; else null).
"""

from __future__ import annotations

import contextlib
import hashlib
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


# NVIDIA H100 SXM data sheet peaks (700 W): HBM bytes/s, dense int8 and
# bf16 ops/s
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1.979e15
BF16_OPS_S = 989.4e12


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


def ids_hash(ids) -> str:
    """A short hash of an id array, to compare two trees' results."""
    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(np.asarray(ids, dtype=np.int64)).tobytes()).hexdigest()[:16]


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
    return info["seconds"], info["log"]


def ptxas_of(log: str, fragment: str) -> dict:
    """ptxas's report (-Xptxas -v) for the kernels whose mangled names hold
    `fragment`: the most registers a thread and spill bytes any of them
    uses, how many instantiations matched, and how many of ptxas's notes
    that it serialized a kernel's wgmma.mma_async instructions name one of
    them (`serialized`: each wgmma then waits for the one before)."""
    import re

    lines = log.splitlines()
    regs, stores, loads, n = 0, 0, 0, 0
    serialized = sum("wgmma.mma_async instructions are serialized" in ln and fragment in ln for ln in lines)
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and fragment in ln:
            n += 1
            for nxt in lines[i + 1 : i + 4]:
                if sp := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt):
                    stores, loads = max(stores, int(sp[1])), max(loads, int(sp[2]))
                if used := re.search(r"Used (\d+) registers", nxt):
                    regs = max(regs, int(used[1]))
    if n == 0:  # no report read (an empty log, or a renamed kernel): no figures
        return {"registers": None, "spill_store_bytes": None, "spill_load_bytes": None, "instantiations": 0,
                "serialized": None}
    return {"registers": regs, "spill_store_bytes": stores, "spill_load_bytes": loads, "instantiations": n,
            "serialized": serialized}


def phase_k1(x, queries):
    """K1 against its plain version, element for element, on both metrics at
    B 1000, 16 and 1 (one partial query tile) and three widths, each on a
    ragged mirror whose last 500 rows are sentinels: the main path's 1024
    lanes (a 67,536-row slice of the real mirror), the "pca" route's 256
    (the same rows' first 256 columns) and 1152, where the query tile no
    longer stays resident and each ring stage streams its query box beside
    the mirror box (6,100 random rows); then B 1000 on the whole
    200,000-row mirror (the hnsw_200k scan route's).  Returns the largest
    packed difference (0 when equal)."""
    import torch
    from lab_1806_vec_db_tpu_torch.models.store import VecStore
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    def ragged(rows, dist):
        b8, sc, ca, _ = VecStore.from_device(rows, dist).device_int8()
        n = rows.shape[0]  # the store rounds its capacity up
        b8, sc, ca = b8[:n], sc[:n].clone(), ca[:n].clone()
        sc[-500:] = 0.0
        ca[-500:] = S._BIG
        return b8, sc, ca

    def equal(q, b8, sc, ca, dist, batches):
        worst = 0
        q8, qs2, qc = S.quantize_queries(q, b8.shape[1], dist)
        padded = S._pad_rows(b8, sc, ca, S._NB)
        for nb in batches:
            out = S.scan_chunkmin_int8_packed(q8[:nb], qs2[:nb], qc[:nb], b8, sc, ca)
            ref = S.scan_chunkmin_int8_packed_ref(q8[:nb], qs2[:nb], qc[:nb], *padded)
            torch.cuda.synchronize()
            check(out.shape == ref.shape == (padded[0].shape[0] // S._CHUNK, nb), f"K1 shape {tuple(out.shape)}")
            worst = max(worst, int((out.long() - ref.long()).abs().max()))
            check(torch.equal(out, ref), f"K1 {dist} D {b8.shape[1]} ({b8.shape[0]} rows) B {nb}: "
                  f"{int((out != ref).sum())} packed values differ")
        log(f"[3/6] K1 {dist}: {b8.shape[0]} rows x {b8.shape[1]} lanes, equal to the plain version element "
            f"for element at B {', '.join(map(str, batches))}")
        return worst

    gen = torch.Generator(device="cuda").manual_seed(11)
    xw = torch.randn((6100, 1152), generator=gen, device="cuda")
    qw = torch.randn((1000, 1152), generator=gen, device="cuda")
    n3 = 65536 + 2000
    worst = 0
    for dist in ("l2sqr", "cosine"):
        for rows, q in ((x[:n3], queries), (x[:n3, :256].contiguous(), queries[:, :256].contiguous()), (xw, qw)):
            worst = max(worst, equal(q, *ragged(rows, dist), dist, (1000, 16, 1)))
        # the hnsw_200k scan route's shape: the whole 200,000-row mirror
        f8, fsc, fca, _ = VecStore.from_device(x, dist).device_int8()
        worst = max(worst, equal(queries, f8, fsc, fca, dist, (1000,)))
        del f8, fsc, fca
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


def exact_small_row(x, n, dist, seed):
    """The exact small-batch scan (csrc/scan_exact_small.cu) at one query
    over n rows of x: checked against its plain version and float64 at B
    1 / 4 / 16 and k 1 / 10 / 32 (distances within 1e-5, cosine against its
    range; ids equal but for float64 near-ties within 1e-6), then timed at B
    1, k 10 in turns with the plain version, beside its byte bound and the
    library's GEMV + `torch.topk`."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import scan_small as SS

    dim = x.shape[1]
    cache = D.dist_cache(x[:n], dist)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    floor = 1.0 if dist == "cosine" else 1e-30
    worst, ids_differ = 0.0, 0
    for B in (1, 4, SS.B_MAX):
        q = torch.randn((B, dim), generator=gen, device="cuda")
        for k in (1, 10, SS.K_MAX):
            d, i = SS.exact_scan_small(q, x, cache, n, k, dist)
            rd, ri = SS.exact_scan_small_ref(q, x, cache, n, k, dist)
            own, ref = (dist64_rows(x, q, ids, dist) for ids in (i, ri))
            err = float(((d.double() - own).abs() / own.abs().clamp_min(floor)).max())
            gap = float(((own.sort(1)[0] - ref.sort(1)[0]).abs() / ref.abs().clamp_min(floor)).max())
            check(err < 1e-5, f"exact_small {dist} B {B} k {k}: {err:.3g} off float64")
            check(gap <= 1e-6, f"exact_small {dist} B {B} k {k}: ids differ beyond near-ties ({gap:.3g})")
            worst, ids_differ = max(worst, err), ids_differ + int((i != ri).sum())
    q = torch.randn((1, dim), generator=gen, device="cuda")
    launches = SS.exact_scan_small.launches
    kern = lambda: SS.exact_scan_small(q, x, cache, n, 10, dist)
    plain = lambda: SS.exact_scan_small_ref(q, x, cache, n, 10, dist)

    def library():  # one GEMV and torch.topk (no tie order): the yardstick
        dots = (x[:n] @ q[0])
        if dist == "l2sqr":
            dd = cache + (q[0] @ q[0]) - 2 * dots
        else:
            dd = 1 - dots / (cache * q[0].norm()).clamp_min(1e-10)
        return torch.topk(dd, 10, largest=False)

    ms, plain_ms = in_turns(kern, plain, 200, 3)
    calls = 200 * 2 + 2
    check(SS.exact_scan_small.launches - launches == calls,
          f"exact_small: {SS.exact_scan_small.launches - launches} launches for {calls} calls")
    bound = bound_ms(n * dim * 4 + n * 4 * (dist == "cosine") + dim * 4 + 10 * 8)
    out = {"n": n, "dim": dim, "dist": dist, "batch": 1, "k": 10, "ms": ms, "plain_ms": plain_ms,
           "library_ms": cuda_ms(library, 50), "bound": bound, "roofline_pct": 100 * bound[0] / ms,
           "max_rel_err_f64": worst, "ids_differ_near_ties": ids_differ}
    log(f"[exact_small] {n} x {dim} {dist}: {ms:.4f} ms (bound {bound[0]:.4f}, {out['roofline_pct']:.1f}%), "
        f"plain {plain_ms:.3f}, library {out['library_ms']:.4f}; checks at B 1 / 4 / {SS.B_MAX} pass")
    return out


def select_row(packed):
    """The survivor select kernel (csrc/select_survivors.cu) on K1's (S, B)
    survivors `packed` and shapes cut from them: bit for bit against its
    plain version (`scan.select_survivors_ref`), then timed in turns with
    it, beside its byte bound (one read of the survivors, one write of the
    results), its time replayed from a CUDA graph (`graph_ms`: without the
    wrapper's host work, which small shapes time otherwise) and a keyed
    `torch.topk` over the transposed survivors (the yardstick: a select
    only, no decode, which the port never calls).  Where
    `survivors.takes_kernel` sends the shape to the kernel, the kernel must
    not be slower than the sort.  The empty shapes (S 0, B 0, r 0) are
    checked, not timed."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench.time_adc import graph_ms
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import survivors as SV

    S_, B = packed.shape
    gen = torch.Generator(device="cuda").manual_seed(26)
    # four keys, -0.0 and +0.0 among them; and one key everywhere
    four = torch.tensor([0, -(2**31), 0x3F400000, 0x3F400001], dtype=torch.int32, device="cuda")
    ties = four[torch.randint(0, 4, (S_, B), generator=gen, device="cuda")]
    one_key = torch.full((S_, B), 0x3F400005, dtype=torch.int32, device="cuda")
    hnsw = packed[:1568].contiguous()
    shapes = [("cell", packed, 40), ("pca", packed, 160), ("hnsw_ef120", hnsw, 120), ("hnsw_ef600", hnsw, 600),
              ("r_max", packed, SV.R_MAX),
              ("ivf_overflow_s80", packed[:80].contiguous(), 40),
              ("ivf_overflow_s560", packed[:560].contiguous(), 40),
              ("b1", packed[:, :1].contiguous(), 40), ("b1001", torch.cat([packed, packed[:, :1]], 1), 40),
              ("r_past_s", packed[:16].contiguous(), 40), ("heavy_ties", ties, 40), ("one_key", one_key, 40)]
    out = {}

    def equal(name, p, r):
        d, i = SV.select_top_r(p, r)
        rd, ri = S.select_survivors_ref(p, r)
        torch.cuda.synchronize()
        d_equal = torch.equal(d.view(torch.int32), rd.view(torch.int32))
        check(d_equal and torch.equal(i, ri),
              f"select {name} (S {p.shape[0]}, B {p.shape[1]}, r {r}): {int((d.view(torch.int32) != rd.view(torch.int32)).sum())} "
              f"distances and {int((i != ri).sum())} ids differ from the plain version")
        return max_abs_err(d, rd)

    for name, p, r in (("empty_s", packed[:0].contiguous(), 40), ("empty_b", packed[:, :0].contiguous(), 40),
                       ("r0", packed, 0)):
        equal(name, p, r)
        log(f"[select] {name} S {p.shape[0]} B {p.shape[1]} r {r}: equal")
    for name, p, r in shapes:
        launches = SV.select_top_r.launches
        err = equal(name, p, r)
        pos = torch.arange(p.shape[0], dtype=torch.int64, device="cuda")

        def library(p=p, r=r, pos=pos):
            bits = (p.T.view(torch.float32) + 0.0).view(torch.int32)
            key = (torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64) << 32) | pos
            return torch.topk(key, min(r, p.shape[0]), dim=1, largest=False, sorted=True)

        reps = 50 if p.numel() > 10**6 else 200
        ms, plain_ms = in_turns(lambda p=p, r=r: SV.select_top_r(p, r), lambda p=p, r=r: S.select_survivors_ref(p, r),
                                reps, max(3, reps // 10))
        taken = SV.takes_kernel(p, r)
        bound = bound_ms(p.numel() * 4 + p.shape[1] * r * 8)
        out[name] = {"S": p.shape[0], "B": p.shape[1], "r": r, "ms": ms, "plain_ms": plain_ms,
                     "graph_ms": graph_ms(lambda p=p, r=r: SV.select_top_r(p, r)),
                     "library_ms": cuda_ms(library, reps), "bound": bound, "roofline_pct": 100 * bound[0] / ms,
                     "taken_by_rule": taken, "launches": SV.select_top_r.launches - launches, "max_abs_err": err}
        log(f"[select] {name} S {p.shape[0]} B {p.shape[1]} r {r}: equal; {ms:.4f} ms, graph "
            f"{out[name]['graph_ms']:.4f} (bound {bound[0]:.4f}), plain {plain_ms:.4f}, "
            f"library {out[name]['library_ms']:.4f}, rule {'kernel' if taken else 'sort'}")
        check(not taken or ms <= plain_ms, f"select {name}: the rule takes the kernel, which is slower "
              f"({ms:.4f} ms) than the sort ({plain_ms:.4f} ms)")
    return out


def dist64_rows(x, q, ids, dist):
    """float64 distances (B, k) of the rows ids names (+inf at -1)."""
    import torch

    v = x[ids.clamp_min(0).long()].double()
    qq = q.double()[:, None, :]
    if dist == "l2sqr":
        d = ((v - qq) ** 2).sum(-1)
    else:
        d = 1 - (v * qq).sum(-1) / (v.norm(dim=-1) * qq.norm(dim=-1)).clamp_min(1e-10)
    return torch.where(ids >= 0, d, float("inf"))


def k5_bytes(nd, ef: int) -> int:
    """Bytes K5's function must move for this tile: beam d / i / e of lanes
    < min(ef, W) (later lanes cannot stay in the beam), the tile's d and
    the ids of its live (d < +inf) lanes in; d / i / e and sel out."""
    B, W = nd.shape
    return 4 * (B * (3 * min(ef, W) + 4 * W + 128) + int((nd < float("inf")).sum()))


def k3_vs_plain(q, base, links0, cur, dist, efs, tag):
    """K3 against its plain version on a graph route's own inputs (all B
    queries from the greedy descent's entries `cur`) at each ef
    (`time_adc.k3_check`): ids equal on >= 0.99 of the entries, the
    distances of equal ids within rtol 1e-5 (the two sum in different
    orders), K3's distances K2's bits for the same rows (one row distance,
    beam_body.cuh), and K3 equal bit for bit to the plain loop run on K2's
    distances.  Returns (per-ef results, the largest error, (kernel ms,
    plain ms) at the first ef, timed in turns)."""
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA

    res, err, times = {}, 0.0, None
    for ef in efs:
        r, k3, k3_ref = TA.k3_check(q, base, links0, cur, ef, dist)
        check(r["ids_equal_share"] >= 0.99, f"{tag} ef {ef}: ids equal on {r['ids_equal_share']:.4f} of entries (< 0.99)")
        check(r["rtol_1e-5"], f"{tag} ef {ef}: equal ids' distances apart by {r['max_rel_err']:.3g} (> rtol 1e-5)")
        check(r["k2_bits"], f"{tag} ef {ef}: distances differ from K2's for the same rows")
        check(r["equal_to_loop_on_k2"], f"{tag} ef {ef}: K3 differs from the plain loop on K2's distances")
        res[ef] = r
        err = max(err, r["max_abs_err"])
        if times is None:
            times = in_turns(k3, k3_ref, 5, 1)
    return res, err, times


def k3_occupancy(B=1000):
    """K3's CTAs per SM (CUDA's occupancy calculator at `k3_plan`'s shared
    memory, R 256, dim 960) and waves at B queries, at the graph routes'
    ef 120 / 200 / 360 on both row types; more than one wave fails."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import traverse as TR

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for rows in ("f32", "bf16"):
        for ef in (120, 200, 360):
            smem = TR.k3_plan(ef, 256, 960)[1]
            ctas = TR.ctas_per_sm(smem, rows == "bf16")
            out[f"{rows}_ef{ef}"] = {"smem_bytes": smem, "ctas_per_sm": ctas, "waves": -(-B // max(ctas * sms, 1))}
    log(f"[2/6] K3 occupancy at B = {B} on {sms} SMs: {out}")
    check(all(v["waves"] == 1 for v in out.values()), f"K3: B = {B} takes more than one wave: {out}")
    return out


def phase_hnsw(db, db_dir, key, q_host, gt):
    """HNSW on the l2sqr table of phase 5.  Returns (results, launches per
    kernel on its path, per-kernel measurements, the reopened db)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch import VecDB
    from lab_1806_vec_db_tpu_torch.bench import beam_states as BS
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA
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
            out[route][ef] = {"recall_at_10": recall_at_k(gt, ids.tolist(), k), "ids_sha1": ids_hash(ids),
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
        "ids_sha1": ids_hash(ids),
        "profile": profile_call(lambda: index.traversal_stats(q_host, k, 120)),
    }
    out["graph_ef120_profile"] = profile_call(lambda: index.knn_with_ef_batch(q_host, k, 120, route="graph"))
    log(f"[hnsw] traversal_stats ef 120: rows/query {rows.mean():.1f}, recall "
        f"{out['traversal_stats_ef120']['recall_at_10']:.4f}, {stats_s*1e3:.0f} ms, "
        f"host syncs {out['traversal_stats_ef120']['host_syncs']}, K4/K5 launches {k45_launches}")

    # each kernel against its plain version, on the card: random states at
    # W 128 / 256 (ef 120), then the edge-case states
    dev = torch.device("cuda")
    meas = {"k4_err": 0.0, "k5_err": 0.0}
    R = 256
    cases = [(BS.random_state, W, 128, 4, 100, 120, B) for W in (128, 256)]
    cases += [(BS.edge_state, W, EL, E, ef, ef, b) for W, EL, E, ef, b in (
        (128, 128, 1, 100, B), (256, 128, 8, 256, B), (512, 128, 4, 300, B), (1024, 128, 4, 600, B),
        (1024, 128, 8, 1024, B), (2048, 512, 4, 2000, 100), (4096, 1024, 8, 3000, 64),
        (4096, 256, 1, 4096, 64))]
    for make, W, EL, E, state_ef, ef, b in cases:
        rng = np.random.default_rng(W + E)
        st = [torch.from_numpy(a).to(dev) for a in make(rng, b, W, R, EL, E, state_ef, len(index))]
        beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids = st
        pre, pre_ref = BF.beam_pre(beam_i, ring, selq, nbrs, E), BF.beam_pre_ref(beam_i, ring, selq, nbrs, E)
        post = BF.beam_post(beam_d, beam_i, beam_e, nd, nids, ef, E)
        post_ref = BF.beam_post_ref(beam_d, beam_i, beam_e, nd, nids, ef, E)
        torch.cuda.synchronize()
        meas["k4_err"] = max(meas["k4_err"], *(max_abs_err(a, b) for a, b in zip(pre, pre_ref)))
        meas["k5_err"] = max(meas["k5_err"], *(max_abs_err(a, b) for a, b in zip(post, post_ref)))
        case = f"{make.__name__} W={W} EL={EL} E={E} ef={ef} B={b}"
        for name, a, b_ in zip(("comp", "ring", "cnt"), pre, pre_ref):
            check(torch.equal(a, b_), f"K4 {case}: {name} differs from the plain version")
        for name, a, b_ in zip(("d", "i", "e", "sel"), post, post_ref):
            check(torch.equal(a, b_), f"K5 {case}: {name} differs from the plain version")
        if make is BS.random_state and W == 128:  # the traversal_stats shape at ef 120: W 128, R 256, EL 128
            k4 = lambda: BF.beam_pre(beam_i, ring, selq, nbrs, E)
            k5 = lambda: BF.beam_post(beam_d, beam_i, beam_e, nd, nids, ef, E)
            g4, g5 = TA.graph_ms(k4, 50), TA.graph_ms(k5, 50)
            meas["k4"] = in_turns(k4, lambda: BF.beam_pre_ref(beam_i, ring, selq, nbrs, E), 20, 5)
            meas["k5"] = in_turns(k5, lambda: BF.beam_post_ref(beam_d, beam_i, beam_e, nd, nids, ef, E), 20, 5)
            meas["k4_graph_ms"] = (g4 + TA.graph_ms(k4, 50)) / 2  # before and after the launches in turns
            meas["k5_graph_ms"] = (g5 + TA.graph_ms(k5, 50)) / 2
            # K4 reads beam_i, ring, nbrs and selq's E lanes; writes comp, ring', cnt
            meas["k4_bytes"] = B * 4 * ((W + R + EL + E) + (W + R + 128))
            meas["k5_bytes"] = k5_bytes(nd, ef)
    log(f"[hnsw] K4 / K5 equal to their plain versions on {len(cases)} states (W 128-4096); at W 128 "
        f"(back to back, plain; graph replay) K4 {meas['k4']}; {meas['k4_graph_ms']:.4f}, "
        f"K5 {meas['k5']}; {meas['k5_graph_ms']:.4f} ms")

    # K3 against its plain version on the graph route's own inputs, at every
    # ef the route ran
    q = torch.from_numpy(q_host).to(dev)
    base = index.store.device_rerank()
    links0 = index._links0_device()
    cur = index._descend(q, lambda ids: G.gather_dists(q, base, ids, index.dist))
    out["k3_vs_plain"], meas["k3_err"], meas["k3"] = k3_vs_plain(q, base, links0, cur, index.dist,
                                                                 (120, 200, 360), "K3")
    meas["k3_bytes"] = B * out["traversal_stats_ef120"]["rows_scored_mean"] * 4 * index.dim
    t0 = time.perf_counter()
    edge = TA.k3_edge_checks()
    out["k3_edge_cases"] = {"s": time.perf_counter() - t0, **edge}
    bad = {name: r for name, r in edge.items() if not r["ok"]}
    check(not bad, f"K3 differs from its plain version on random graphs: {bad}")
    log(f"[hnsw] K3 on {len(edge)} random graphs (time_adc.k3_edge_checks) equal to the plain loop on K2's "
        f"distances in {out['k3_edge_cases']['s']:.1f} s; ids equal to the plain version's on "
        f"{min(r['ids_equal_share'] for r in edge.values()):.4f}-1 of entries")
    log(f"[hnsw] K3 at B = {B} against its plain version: {out['k3_vs_plain']}; "
        f"times (kernel, plain) K3 {meas['k3']}, K4 {meas['k4']}, K5 {meas['k5']} ms")

    out["lean_graph"], meas["k3_bf16"] = lean_graph(index, q_host, gt, out["graph"])

    # close and reopen: still HNSW, identical results
    before = db.batch_search(key, q_host, k, ef=200)
    db.close()
    db = VecDB(db_dir, seed=DB_SEED)
    check(db.has_hnsw_index(key), "hnsw: the table is not HNSW after reopen")
    check(db.batch_search(key, q_host, k, ef=200) == before, "hnsw: batch_search differs after reopen")
    log("[hnsw] close / reopen: still HNSW, identical results")
    launches = {"k3": k3_launches, "k4": k45_launches[0], "k5": k45_launches[1]}
    return out, launches, meas, db


def lean_graph(index, q_host, gt, full_graph):
    """lean_graph: the graph that `phase_hnsw` built (M = 16, K3's route)
    attached to a lean store of the same 200,000 x 960 rows
    (`VecStore.from_device_blocks`, filled from the full store's f32 rows on
    the card, the generator kept), searched through the user's entry point
    `knn_with_ef_batch(route="graph")` at ef 120 / 200 on the B = 1000
    queries: K2's descent and K3 over the bf16 rows, then the exact
    refinement of the top k.  Returns (results, K3-bf16 measurements); the
    full store is attached again before it returns."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.models import VecStore
    from lab_1806_vec_db_tpu_torch.models.hnsw import links_rows
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import traverse as TR

    k, B = 10, len(q_host)
    full = index.store
    rows = full.device()[0]
    n, dim = len(full), full.dim
    fill = lambda row0, r: rows[row0 : row0 + r]
    t0 = time.perf_counter()
    lean = VecStore.from_device_blocks(fill, n, dim, index.dist, device=full.torch_device)
    out = {"rows": n, "dim": dim, "ingest_s": time.perf_counter() - t0,
           "slab": [list(lean.device_rerank().shape), str(lean.device_rerank().dtype)],
           "links0_rows": int(index._links0_device().shape[0]), "ef": {}}
    check(lean.device_rerank().dtype == torch.bfloat16, "lean_graph: the lean rows are not bf16")
    q = torch.from_numpy(q_host).to(rows.device)
    index.store = lean
    try:
        # the main path: counters from 0 around the route's first call at each ef
        for ef in (120, 200):
            TR.traverse.launches = G.gather_dists.launches = 0
            d, ids = index.knn_with_ef_batch(q_host, k, ef, route="graph")
            launched = {"k3": TR.traverse.launches, "k2": G.gather_dists.launches}
            check(launched["k3"] > 0 and launched["k2"] > 0,
                  f"lean_graph ef {ef}: launches {launched}: K3 and K2 must both run")
            rounds = []
            for _ in range(3):  # rounds of 4 chained (synchronous) batches
                t0 = time.perf_counter()
                for _ in range(4):
                    index.knn_with_ef_batch(q_host, k, ef, route="graph")
                rounds.append(time.perf_counter() - t0)
            ids_t = torch.from_numpy(ids).to(rows.device)
            check(bool((ids_t >= 0).all()), f"lean_graph ef {ef}: short result rows")
            exact = exact_l2_f64(fill, n, q, ids_t)
            rel = float(((torch.from_numpy(d).to(rows.device).double() - exact).abs()
                         / exact.abs().clamp_min(1e-30)).max())
            check(rel <= 1e-5, f"lean_graph ef {ef}: returned distances off float64 exact by {rel:.3g} (> 1e-5)")
            check(bool((np.diff(d, axis=1) >= 0).all()), f"lean_graph ef {ef}: distances not ascending")
            rec = recall_at_k(gt, ids.tolist(), k)
            full_rec = full_graph[ef]["recall_at_10"]
            check(abs(rec - full_rec) <= 0.01,
                  f"lean_graph ef {ef}: recall@10 {rec:.4f} vs the full store's {full_rec:.4f} (> 0.01 apart)")
            out["ef"][ef] = {"recall_at_10": rec, "full_store_recall_at_10": full_rec,
                             "ids_sha1": ids_hash(ids), "max_rel_err_vs_f64": rel, "launches": launched,
                             "qps_best": 4 * B / min(rounds), "qps_median": 4 * B / float(np.median(rounds)),
                             "ms_per_batch_rounds": [r / 4 * 1e3 for r in rounds],
                             "full_store_qps_best": full_graph[ef]["qps_best"]}
        # K3 on the bf16 rows against its plain version on the route's own
        # inputs: all B queries from the greedy descent's entries
        base = lean.device_rerank()
        links0 = links_rows(index._links0_device(), base.shape[0])
        cur = index._descend(q, lambda i: G.gather_dists(q, base, i, index.dist))
        meas = {"launches": out["ef"][120]["launches"]["k3"]}
        meas["k3_vs_plain"], meas["max_abs_err"], (meas["ms"], meas["plain_ms"]) = k3_vs_plain(
            q, base, links0, cur, index.dist, (120, 200), "K3 bf16")
        # the rows K3 scores at ef 120 on this data: the same loop, counted
        _, _, scored = index.traversal_stats(q_host, k, 120)
        meas["rows_scored_mean"] = float(scored.mean())
        # each novel row read once as bf16 (2 bytes a lane)
        meas["bound"] = bound_ms(B * meas["rows_scored_mean"] * 2 * dim)
    finally:
        index.store = full
    del lean
    torch.cuda.empty_cache()
    log(f"[lean_graph] ingest {out['ingest_s']:.1f} s; " + ", ".join(
        f"ef {ef} recall {v['recall_at_10']:.4f} (full {v['full_store_recall_at_10']:.4f}) QPS "
        f"{v['qps_best']:.0f} rel err {v['max_rel_err_vs_f64']:.2e}" for ef, v in out["ef"].items())
        + f"; K3 bf16 (kernel, plain) {meas['ms']:.3f} / {meas['plain_ms']:.3f} ms, bound {meas['bound']}, "
        f"vs plain {meas['k3_vs_plain']}")
    out["k3_bf16"] = meas
    return out, meas


# ---------------------------------------------------------------- pq ----
# The reference's PQ settings (config/bench_pq_hnsw.toml,
# config/bench_10000_pq_flat.toml): 4-bit codes, m = 320, 10,000 k-means
# samples, 20 iterations, tol 1e-6.
PQ_M, PQ_SAMPLES = 320, 10_000
GATE_Q = 128  # queries of the kernel-vs-plain recall gate
DB_SEED = 0  # VecDB(seed=): the HNSW levels and the PQ training of phase 5's tables


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
    """The launch count of every kernel a PQ, IVF, codes or resident route can
    reach; with `reset` the counts are set to 0 (and the zeros returned)."""
    from lab_1806_vec_db_tpu_torch.ops import adc as A
    from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import merge as M
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import scan_binned as SB
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR

    plain = {"k1": S.scan_chunkmin_int8_packed, "k2": G.gather_dists, "k4": BF.beam_pre,
             "k5": BF.beam_post, "k6": M.merge_sorted, "k7": A.adc_chunkmin,
             "k10": SB.scan_chunkmin_int8_binned, "k11": A.adc_chunkmin_binned,
             "k12": SR.scan_chunkmin, "k13": SR.scan_dist_int8, "k14": SR.scan_chunkmin_int8_t}
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
    return {"recall_at_10": rec, "ids_sha1": ids_hash(ids), "qps_best": per_round * B / min(times),
            "qps_median": per_round * B / float(np.median(times)),
            "ms_per_call_rounds": [t / per_round * 1e3 for t in times],
            "gate_recall_kernels": rec_k, "gate_recall_plain": rec_p, "profile": profile,
            "launches": launches}


def check_k6(B, ef, EL, N):
    """K6 against its plain version at one of the classic loop's shapes
    (ef 180 / 360 / 600): all three outputs equal; times, bound and the
    library line (`time_adc.k6_library`: one stable torch.sort of the (B,
    ef + EL) concatenation + the id gather)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.bench import beam_states as BS
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA
    from lab_1806_vec_db_tpu_torch.ops import merge as M

    st = [torch.from_numpy(a).cuda() for a in BS.merge_state(np.random.default_rng(6), B, ef, EL, N)]
    got, ref = M.merge_sorted(*st), M.merge_sorted_ref(*st)
    torch.cuda.synchronize()
    for name, a, b in zip(("d", "i", "e"), got, ref):
        check(torch.equal(a, b), f"K6 (B {B}, ef {ef}, EL {EL}): {name} differs from the plain version")
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    ms, plain_ms = in_turns(lambda: M.merge_sorted(*st), lambda: M.merge_sorted_ref(*st), 50, 20)
    lib_ms = cuda_ms(lambda: TA.k6_library(*st), 20)
    # reads beam d / i / e (1 byte) and the tile's d / i; writes d / i / e
    bound = bound_ms(B * (9 * ef + 8 * EL) + B * 9 * ef)
    log(f"[pq] K6 (B {B}, ef {ef}, EL {EL}) equal to its plain version; {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sort+gather {lib_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound, "library_ms": lib_ms,
            "shape": [B, ef, EL]}


def check_k6_graph(index, pq, q_host, ef, launches, nth=8):
    """K6 at the shape the classic loop gives it (the PQ graph route with
    fused=False): the arguments of its `nth` launch in one batch at `ef`
    (`captured_args`), equal to its plain version on them; timed back to
    back beside it in turns and replayed from a CUDA graph (before and after
    those); bound as `check_k6`'s; score = launches a batch x (graph ms -
    bound)."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA
    from lab_1806_vec_db_tpu_torch.ops import merge as M

    args = captured_args(M, ("merge_sorted",), nth,
                         lambda: index.knn_pq_batch(q_host, 10, ef, pq, route="graph", fused=False))["merge_sorted"]
    got, want = M.merge_sorted(*args), M.merge_sorted_ref(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)), f"K6 at the classic loop's ef {ef}: differs")
    (B, W), EL = args[0].shape, args[3].shape[1]
    kern = lambda: M.merge_sorted(*args)
    g0 = TA.graph_ms(kern, 50)
    ms, plain_ms = in_turns(kern, lambda: M.merge_sorted_ref(*args), 20, 5)
    graph = (g0 + TA.graph_ms(kern, 50)) / 2
    lib_graph = TA.graph_ms(lambda: TA.k6_library(*args), 20)
    bound = bound_ms(B * (9 * W + 8 * EL) + B * 9 * W)
    out = {"W": W, "EL": EL, "ms": ms, "graph_ms": graph, "plain_ms": plain_ms, "library_graph_ms": lib_graph,
           "bound": bound, "launches": launches, "score_ms": launches * (graph - bound[0])}
    log(f"[pq] K6 at hnsw_pq_200k classic graph ef {ef} (beam {W}, tile {EL}): equal to its plain version; "
        f"{ms:.4f} ms (graph replay {graph:.4f}), plain {plain_ms:.4f}, library graph replay {lib_graph:.4f}, "
        f"bound {bound[0]:.5f}, {launches} launches, score {out['score_ms']:.2f} ms")
    return out


def check_k6_edges():
    """K6 against its plain version on the CPU tests' edge cases, at ef + EL
    = 8,192 and on unaligned operands (`time_adc.k6_edge_checks`)."""
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA

    eq = TA.k6_edge_checks()
    check(all(eq.values()), f"K6 differs from its plain version on edge inputs: {eq}")
    log(f"[pq] K6 equal to its plain version bit for bit on {len(eq)} edge inputs: {sorted(eq)}")
    return eq


def lookup_bound_ms(lookups: float) -> float:
    """Shared-memory lookups at 32 a clock per SM (one 4-byte word per bank)
    on 132 SMs at 1.98 GHz: the floor of a table-lookup kernel (K8 / K9),
    which no byte or tensor-core bound sees."""
    return lookups / (32 * 132 * 1.98e9) * 1e3


def check_sums_ids(codes, lookup, m, packed, N, tag):
    """K8 / K9's ids shape against its plain version at each width the
    graph route gives it: C 1 (a descent's entry), 16 (an upper level's
    links) and 128 (the fused loop's tile: E 4 x L 32), 10% of the ids -1,
    with the route's bf16 LUT: equal bit for bit (both add the groups in
    order).  Timed and bounded at C 128."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    B, k = lookup.shape[0], lookup.shape[2]
    gen = torch.Generator(device="cuda").manual_seed(8)
    lut = lookup.to(torch.bfloat16).contiguous()  # as the graph route rounds it, once a batch
    err = 0.0
    for C in (1, 16, 128):
        ids = torch.randint(0, N, (B, C), generator=gen, device="cuda", dtype=torch.int32)
        ids[torch.rand((B, C), generator=gen, device="cuda") < 0.1] = -1
        got, ref = A.adc_sums_ids(codes, lut, ids, m, packed), A.adc_sums_ids_ref(codes, lut, ids, m, packed, False)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(got), ids < 0), f"{tag} ids (C {C}): +inf not exactly at id -1")
        check(torch.equal(got, ref), f"{tag} ids (C {C}): differs from its plain version")
        err = max(err, max_abs_err(got, ref))
    if k == 16:
        # K8 reads a code row in 16-byte words only where cw % 16 == 0; the
        # byte-wise path at code widths 7 (m 13 packed) and 20 (m 20 one
        # code a byte), ids past the table's end included
        for mu, pk in ((13, True), (20, False)):
            cw_u = -(-mu // 2) if pk else mu
            cu = torch.randint(0, 256 if pk else 16, (5000, cw_u), generator=gen, device="cuda").to(torch.uint8)
            lu = torch.randn((B, mu, 16), generator=gen, device="cuda").to(torch.bfloat16)
            iu = torch.randint(-1, 5100, (B, 128), generator=gen, device="cuda", dtype=torch.int32)
            got, ref = A.adc_sums_ids(cu, lu, iu, mu, pk), A.adc_sums_ids_ref(cu, lu, iu, mu, pk, False)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"{tag} ids (m {mu}, code width {cw_u}): differs from its plain version")
        log(f"[pq] {tag} ids equal to its plain version at code widths 7 and 20 too")
        del cu, lu, iu
    ms, plain_ms = in_turns(lambda: A.adc_sums_ids(codes, lut, ids, m, packed),
                            lambda: A.adc_sums_ids_ref(codes, lut, ids, m, packed, False), 20, 3)
    cw = codes.shape[1]
    # ids, the gathered code rows, the bf16 LUT; the (B, 128) f32 output
    bound = bound_ms(B * 128 * 4 + B * 128 * cw + B * m * k * 2 + B * 128 * 4)
    lookups = lookup_bound_ms(B * 128 * m)
    log(f"[pq] {tag} ids (B {B}, C 1 / 16 / 128, m {m}, k {k}) equal to its plain version (max abs "
        f"err {err:.3g}); at C 128 {ms:.4f} ms, plain {plain_ms:.4f} ms, byte bound {bound[0]:.4f} ms, "
        f"lookup bound {lookups:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound,
            "shape": [B, 128, m, k], "widths_checked": [1, 16, 128],
            "extra": {"lookup_bound_ms": lookups}}


def check_sums_dense(codes, lookup, m, packed, tag, lut_dtype, cb_sq=None, bf16_body=False):
    """K8 / K9's dense shape against its plain version on one scan block
    of `adc_scan_pallas` with the route's LUT rounding, bit for bit (int8
    sums are exact; bf16 / f32 sums add the groups in order on both sides).
    With `cb_sq` it is also held with the cosine route's R = B + 1 rows
    (the centroid-sqnorm row appended: a partial last LUT-row tile), on the
    scan's last, partial block where there is one.  With `bf16_body`, K8's
    lookup body for a bf16 LUT (the `adc_sums` API's) is held too."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    if cb_sq is not None:
        lut1, sc1 = A.round_lut(torch.cat([lookup, cb_sq[None]], 0), lut_dtype)
        tail = codes[131072:] if codes.shape[0] > 131072 else codes
        got = A.adc_sums_dense(tail, lut1, sc1, m, packed)
        check(torch.equal(got, A.adc_sums_dense_ref(tail, lut1, sc1, m, packed)),
              f"{tag} dense (R {lut1.shape[0]}, N {tail.shape[0]}): differs from its plain version")
        del got
    codes = codes[:131072]
    if bf16_body:
        lut_b, _ = A.round_lut(lookup, "bf16")
        check(torch.equal(A.adc_sums_dense(codes, lut_b, None, m, packed),
                          A.adc_sums_dense_ref(codes, lut_b, None, m, packed)),
              f"{tag} dense: differs from its plain version (bf16 LUT)")
        del lut_b
    lut, scales = A.round_lut(lookup, lut_dtype)
    got, ref = A.adc_sums_dense(codes, lut, scales, m, packed), A.adc_sums_dense_ref(codes, lut, scales, m, packed)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"{tag} dense: differs from its plain version ({lut.dtype} LUT)")
    ms, plain_ms = in_turns(lambda: A.adc_sums_dense(codes, lut, scales, m, packed),
                            lambda: A.adc_sums_dense_ref(codes, lut, scales, m, packed), 5, 1)
    R, k, N = lut.shape[0], lut.shape[2], codes.shape[0]
    # the function's floor: the codes, the LUT (+ int8 scales) and the
    # (R, N) f32 output; it needs R N m adds, no tensor-core operations
    bound = bound_ms(N * codes.shape[1] + lut.numel() * lut.element_size() + 4 * R + 4 * R * N)
    extra = {"lookup_bound_ms": lookup_bound_ms(R * N * m)}
    if lut.dtype == torch.int8 and packed:
        # K8's int8 method, not the function: a one-hot product over 32
        # columns a code byte (cw padded to 4), reported beside the bound
        extra["method_ops_bound_ms"] = 2.0 * R * N * 32 * (-(-codes.shape[1] // 4) * 4) / INT8_OPS_S * 1e3
    log(f"[pq] {tag} dense (R {R}, N {N}, m {m}, k {k}, {lut.dtype}) equal to its plain version "
        f"(max abs err {max_abs_err(got, ref):.3g}); {ms:.3f} ms, plain {plain_ms:.3f} ms, byte bound "
        f"{bound[0]:.4f} ms, {extra}")
    return {"max_abs_err": max_abs_err(got, ref), "ms": ms, "plain_ms": plain_ms, "bound": bound,
            "shape": [R, N, m, k], "extra": extra}


def check_k7(pq, q, tag):
    """K7 against its plain version on the whole scan (every row of the
    table, all B queries): survivors and positions equal bit for bit.
    Bound: the function's byte floor (the permuted codes, the int8 LUT and
    the survivors; its N B m lookup-adds are far below the int8 peak).  The
    one-hot product's 2 N B m 16 int8 operations, the method's own floor,
    are reported beside it as `method_ops_bound_ms`."""
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
    bound = bound_ms(moved)
    method = bound_ms(moved, 2.0 * len(pq) * B * m * 16)[0]
    log(f"[pq] K7 {tag} (N {N}, B {B}, m {m}): equal to its plain version bit for bit "
        f"(plain {plain_s:.1f} s); {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound}, "
        f"the one-hot method's operations {method:.3f} ms")
    return {"max_abs_err": max(max_abs_err(got[0], ref[0]), max_abs_err(got[1], ref[1])),
            "ms": ms, "plain_ms": plain_ms, "bound": bound, "shape": [N, B, m],
            "extra": {"method_ops_bound_ms": method}}


def pq_train(vecs, n_valid, n_bits, dist="l2sqr", cfg=None):
    """A table trained on `vecs` with `cfg`, by default the reference's PQ
    settings above -> (table, seconds)."""
    import torch
    from lab_1806_vec_db_tpu_torch.models import PQTable
    from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

    if cfg is None:
        cfg = PQConfig(n_bits=n_bits, m=PQ_M, dist=dist, k_means_size=PQ_SAMPLES, k_means_max_iter=20,
                       k_means_tol=1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq = PQTable.train(vecs, cfg, seed=0, n_valid=n_valid)
    torch.cuda.synchronize()
    return pq, time.perf_counter() - t0


def phase_pq_1m(store, flat, q, gt):
    """flat_pq_1m: Flat+PQ at 1,000,000 x 960 on the flat_1m store (K7 +
    K2), the PQ table trained from the device tensor with n_valid through
    the table's defaults (`table_config`, the benchmark cell's table)."""
    import numpy as np
    import torch

    from lab_1806_vec_db_tpu_torch.models.pq_table import table_config

    n, B = len(store), q.shape[0]
    cfg = table_config(n, store.dim, "l2sqr")  # build_pq_table's table: 100,000 samples at 1M
    check(cfg.m == PQ_M and cfg.n_bits == 4, f"pq: the table's defaults give {cfg}")
    pq, train_s = pq_train(store.device()[0], n, 4, cfg=cfg)
    out = {"cell": "flat_pq_1m", "n": n, "batch": B, "m": PQ_M, "n_bits": 4, "samples": cfg.k_means_size,
           "train_s": train_s, "adc_quality": pq.adc_quality}
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


def captured_args(module, names, nth, run):
    """The arguments (cloned) of the `nth` call of each of `module`'s
    functions `names` while `run()` runs, each swapped for a wrapper that
    keeps them (as `plain_kernels` swaps them), then restored -> {name:
    args}."""
    import torch

    kept, seen = {}, dict.fromkeys(names, 0)
    orig = {name: getattr(module, name) for name in names}

    def capture(name):
        def fn(*args):
            seen[name] += 1
            if seen[name] == nth:
                kept[name] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            return orig[name](*args)
        fn.launches = 0  # the wrapper counts its launches in the module's binding of its name
        return fn

    try:
        for name in names:
            setattr(module, name, capture(name))
        run()
    finally:
        for name in names:
            setattr(module, name, orig[name])
    return kept


def check_k45_graph(index, pq, q_host, ef, launches, nth=8):
    """K4 and K5 at the shape the PQ graph route gives them: the arguments
    of the `nth` launch of each in one batch at `ef` (`captured_args`),
    each kernel against its plain version on them (equal); timed back to
    back beside the plain version in turns (`ms`, `plain_ms`) and replayed
    from a CUDA graph (`graph_ms`, before and after those); bound from their
    shapes (the formulas of `phase_hnsw`); score = launches a batch x (graph
    ms - bound)."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA
    from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF

    orig = {"beam_pre": BF.beam_pre, "beam_post": BF.beam_post}
    kept = captured_args(BF, tuple(orig), nth, lambda: index.knn_pq_batch(q_host, 10, ef, pq, route="graph"))
    out = {}
    for key, name, ref in (("k4", "beam_pre", BF.beam_pre_ref), ("k5", "beam_post", BF.beam_post_ref)):
        args = kept[name]
        got, want = orig[name](*args), ref(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{key.upper()} at PQ graph ef {ef}: differs")
        B, W = args[0].shape
        if key == "k4":  # beam_i, ring, nbrs, selq's E lanes in; comp, ring', cnt out
            R, EL, E = args[1].shape[1], args[3].shape[1], args[4]
            nbytes = B * 4 * ((W + R + EL + E) + (W + R + 128))
        else:
            nbytes = k5_bytes(args[3], args[5])
        kern = lambda: orig[name](*args)
        g0 = TA.graph_ms(kern, 50)
        ms, plain_ms = in_turns(kern, lambda: ref(*args), 20, 5)
        graph = (g0 + TA.graph_ms(kern, 50)) / 2
        bound = bound_ms(nbytes)
        out[key] = {"W": W, "ms": ms, "graph_ms": graph, "plain_ms": plain_ms, "bound": bound,
                    "launches": launches[key], "score_ms": launches[key] * (graph - bound[0])}
    log(f"[pq] K4 / K5 at hnsw_pq_200k graph ef {ef} (W {out['k4']['W']}): equal to their plain versions; "
        + ", ".join(f"{key.upper()} {v['ms']:.4f} ms (graph replay {v['graph_ms']:.4f}), plain "
                    f"{v['plain_ms']:.4f}, bound {v['bound'][0]:.5f}, {v['launches']} launches, score "
                    f"{v['score_ms']:.2f} ms" for key, v in out.items()))
    return out


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
    for name in ("graph", "graph_classic"):
        log(f"[pq] hnsw_pq_200k {name}: device busy ms a batch " + ", ".join(
            f"ef {ef} {v['profile'].get('device_busy_ms')} (wall {v['profile']['wall_ms']:.1f})"
            for ef, v in h[name].items()))
    h["device_bytes"] = pq.device_bytes()
    k45 = {ef: check_k45_graph(index, pq, q_host, ef, h["graph"][ef]["launches"]) for ef in (180, 600)}
    for key in ("k4", "k5"):  # for the kernels line: ms, bound, launches and score at each ef
        meas[f"k45_graph_{key}"] = {ef: {f: v[key][f] for f in ("ms", "graph_ms", "bound", "launches", "score_ms")}
                                    for ef, v in k45.items()}
    meas["k45_graph"] = k45
    codes, _, _ = pq.device()
    lookup, _ = pq.create_lookup(q)
    meas["k8_ids"] = check_sums_ids(codes, lookup, PQ_M, True, len(pq), "K8")
    # K6 at every ef the classic loop ran (EL = E 4 x L 32)
    meas["k6"] = {ef: check_k6(B, ef, 128, len(index)) for ef in (180, 360, 600)}
    meas["k6_graph"] = {ef: check_k6_graph(index, pq, q_host, ef, h["graph_classic"][ef]["launches"]["k6"])
                        for ef in (180, 600)}
    meas["k6_edges"] = check_k6_edges()
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
        k9 = "k9_dense" if name == "scan" else "k9_ids"
        log(f"[pq] hnsw_pq_200k n_bits 8 {name}: " + ", ".join(
            f"ef {ef} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f} ({k9} launches "
            f"{v['launches'][k9]})" for ef, v in h8[name].items()))
    h8["device_bytes"] = pq8.device_bytes()
    codes8, _, cb_sq8 = pq8.device()
    lookup8, _ = pq8.create_lookup(q)
    meas["k9_ids"] = check_sums_ids(codes8, lookup8, PQ_M, False, len(pq8), "K9")
    meas["k9_dense"] = check_sums_dense(codes8, lookup8, PQ_M, False, "K9", "bf16", cb_sq8)
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
    codes60, _, cb_sq60 = pq60.device()
    lookup60, _ = pq60.create_lookup(q)
    meas["k8_dense"] = check_sums_dense(codes60, lookup60, PQ_M, True, "K8", "int8", cb_sq60, bf16_body=True)
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


def check_k10_ragged(B=300, nlist=8, lpad=1024):
    """K10 against its plain version at mirror widths that are not a
    multiple of 128 bytes (96: one box read past the tensor map's width as
    zeros; 1040: nine boxes, the gathered query boxes streamed beside the
    mirror's), on random int8 rows with 10% sentinel pad rows, bins with
    empty slots and one list no query probes: equal element for element."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import scan_binned as SB

    g = torch.Generator(device="cuda").manual_seed(10)
    err = 0.0
    for dim in (96, 1040):
        rows = nlist * lpad
        q8 = torch.randint(-127, 128, (B, dim), generator=g, device="cuda", dtype=torch.int8)
        qs2, qc = torch.rand(B, generator=g, device="cuda") * 1e-2, torch.rand(B, generator=g, device="cuda") * 100
        base = torch.randint(-127, 128, (rows + 700, dim), generator=g, device="cuda", dtype=torch.int8)
        pad = torch.rand(rows + 700, generator=g, device="cuda") < 0.1
        sc = torch.where(pad, 0.0, torch.rand(rows + 700, generator=g, device="cuda") * 1e-3)
        ca = torch.where(pad, 3.0e38, torch.rand(rows + 700, generator=g, device="cuda") * 100)
        bins = torch.randint(0, B, (nlist, SB.QB), generator=g, device="cuda", dtype=torch.int32)
        bins[torch.rand((nlist, SB.QB), generator=g, device="cuda") < 0.3] = -1
        bins[1] = -1
        args = (q8, qs2, qc, bins, base, sc, ca, lpad)
        got, ref = SB.scan_chunkmin_int8_binned(*args), SB.scan_chunkmin_int8_binned_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"K10 width {dim}: {int((got != ref).sum())} packed values differ from the plain version")
        err = max(err, max_abs_err(got, ref))
    log(f"[ivf] K10 at widths 96 and 1040 ({nlist} x {lpad} rows, {B} queries): equal to its plain version")
    return err


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
    out["k10_ragged_err"] = check_k10_ragged()
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
    lean["k10"] = check_k10(idx, q, "ivf_lean_4m (ingest-sorted store)")
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
    slots equal on every filled column.  Bound: the function's byte floor
    (the codes of every list, the int8 LUT with scales and norms, lens and
    bins, the survivors).  The one-hot method's 2 m 16 int8 operations for
    each (valid row, filled column) pair of a list, priced from this run's
    bins, are reported beside it as `method_ops_bound_ms`."""
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
    n_plan, _ = A.k11_plan(args[6], bins, lpad)
    out = {"max_abs_err": max(max_abs_err(got[0][filled], ref[0][filled]),
                              max_abs_err(got[1][filled], ref[1][filled])),
           "shape": [nlist, lpad, qb, m], "filled_columns": int(filled.sum()),
           "blocks_by_n": {str(v): int((n_plan == v).sum()) for v in (0, 32, 64)}}
    if timed:
        out["ms"], out["plain_ms"] = in_turns(lambda: A.adc_chunkmin_binned(*args),
                                              lambda: A.adc_chunkmin_binned_ref(*args), 10, 1)
        lens = torch.from_numpy(idx.lens).to(bins.device).long()
        pairs = float((lens * filled.sum(1)).sum())  # (valid row, filled column) pairs
        moved = (nlist * lpad * codes.shape[1] + lut_q.numel() + 8 * lut_q.shape[0]
                 + 4 * nlist * (1 + qb) + 8 * got[0].numel())
        out["bound"] = bound_ms(moved)
        out["extra"] = {"method_ops_bound_ms": bound_ms(moved, 2.0 * pairs * m * 16)[0],
                        "bound_ms_every_slot_and_column": bound_ms(moved, 2.0 * nlist * lpad * qb * m * 16)[0],
                        "valid_row_filled_column_pairs": pairs}
    log(f"[codes] K11 {tag} (nlist {nlist}, lpad {lpad}, qb {qb}, {out['filled_columns']} filled columns, "
        f"blocks by wgmma N {out['blocks_by_n']}): "
        "equal to its plain version on every filled column"
        + (f"; {out['ms']:.3f} ms, plain {out['plain_ms']:.1f} ms, bound {out['bound']}" if timed else ""))
    return out


def ivfpq_stage_split(idx, q, k, n_probes, ef, reps=5):
    """A knn_batch of IVFPQIndex in its steps, timed with CUDA events (mean
    of `reps` passes after one warm-up): the lookup, probe, bins and K11's
    LUT quantization; K11; the survivor gather, the overflow K7 and the
    top-ef; the refine; the exact top-k."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    names = ("lookup_probe_bin", "k11", "gather_overflow_k7_topef", "refine", "exact_topk")
    split = dict.fromkeys(names, 0.0)
    qb = idx._auto_qb(q.shape[0], n_probes)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    for i in range(reps + 1):
        ev[0].record()
        lookup, q_norms = idx.pq.create_lookup(q)
        probe, bins, slots = idx.probe_and_bin(q, n_probes, qb)
        args = idx.k11_inputs(lookup, q_norms, bins, 16)
        ev[1].record()
        outd, outi = A.adc_chunkmin_binned(*args)
        ev[2].record()
        td1, ti1 = idx.select_candidates(lookup, q_norms, k, ef, probe, slots, outd, outi)
        ev[3].record()
        d_ex = idx.refine(q, ti1)
        ev[4].record()
        T.topk_smallest(torch.where(torch.isfinite(d_ex), d_ex, td1), ti1, k)
        ev[5].record()
        torch.cuda.synchronize()
        if i:
            for name, a, b in zip(names, ev, ev[1:]):
                split[name] += a.elapsed_time(b) / reps
    return split


def check_k7_codes(codes, lookup, cb_sq, q_norms, n_valid, chunk, dist, tag, timed=False):
    """K7 against its plain version at one launch of the codes path (the
    coarse stage-0 scan over every row, the overflow segment): survivors and
    positions equal; timed and bounded like flat_pq_1m's K7 (the byte
    floor, the one-hot method's operations beside it), plus the time of the
    top-c0 stable selection over the survivors when `timed` is the pool
    size."""
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
        out["bound"] = bound_ms(moved)
        out["extra"] = {"method_ops_bound_ms": bound_ms(moved, 2.0 * n_valid * B * m * 16)[0],
                        "topc0_select_ms": cuda_ms(lambda: T.topk_smallest(got[0], got[1], timed), 3),
                        "survivors_per_query": S, "c0": timed}
    log(f"[codes] K7 {tag} ({N} rows, m {m}, chunk {chunk}, {B} queries): equal to its plain version"
        + (f"; {out['ms']:.3f} ms, plain {out['plain_ms']:.1f} ms, bound {out['bound']}, top-{timed} "
           f"selection over {S} survivors {out['extra']['topc0_select_ms']:.2f} ms" if timed else ""))
    return out


def phase_codes(card, n=10_000_000, nlist=2048, n_cos=300_000, nlist_cos=64, B=1000, device="cuda"):
    """codes_ivfpq_10m and codes_pq_10m (the codes-resident tiers at the
    reference's flagship 10,000,000 x 960, bench.py:672-759) on one
    `make_fill(0, 960)` source, its 1000 queries and one exact ground truth
    by blocked regeneration; then a 300,000-row cosine IVF-PQ index with 64
    lists for the cosine columns of K11 and K7 (sized so that lists spill:
    K7's cosine column is held on an overflow segment of real rows)."""
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
    ivf["index_bytes_after_search"] = idx.index_bytes()  # + the centroids and lens the first search uploads
    recs = [v["recall_at_10"] for v in sweep.values()]
    log("[codes] codes_ivfpq_10m: " + ", ".join(f"{key} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f} "
                                                f"dropped {v['dropped_pairs']}" for key, v in sweep.items())
        + f"; index_bytes after the first search {ivf['index_bytes_after_search']}")
    check(all(b >= a for a, b in zip(recs, recs[1:])), f"codes_ivfpq_10m: recall falls as n_probes grows: {recs}")
    check(launches["k11"] > 0 and (idx.ov_count == 0 or launches["k7"] > 0),
          f"codes_ivfpq_10m: the search launched {launches}")
    ivf.update(codes_gates(lambda qq: idx.knn_batch(qq, k, n_probes=CODES_GATE_PROBES, ef=256), fill, n, q, gt,
                           "codes_ivfpq_10m"))
    ivf["profile_n_probes_48"] = profile_call(lambda: idx.knn_batch(q, k, n_probes=CODES_GATE_PROBES, ef=256))
    k11 = check_k11(idx, q, CODES_GATE_PROBES, "codes_ivfpq_10m")
    # K11's other N variant and a two-block qb, untimed
    ivf["k11_variants"] = {f"n_probes_{p}": check_k11(idx, q, p, f"codes_ivfpq_10m n_probes {p}", timed=False)
                           for p in (32, 96)}
    check(ivf["k11_variants"]["n_probes_96"]["shape"][2] > 64, "codes_ivfpq_10m: qb 96 gave one column block")
    ivf["stage_ms"] = ivfpq_stage_split(idx, q, k, CODES_GATE_PROBES, 256)
    log(f"[codes] codes_ivfpq_10m stages at {CODES_GATE_PROBES}/256: {ivf['stage_ms']}")
    lookup, q_norms = idx.pq.create_lookup(q)
    if idx.ov_count:
        k_ov, ch = idx.overflow_chunk(k)
        ivf["k7_overflow"] = check_k7_codes(idx._codes_ov, lookup, idx.pq.device()[2], q_norms, idx.ov_count,
                                            ch, "l2sqr", "codes_ivfpq_10m overflow segment")
    del idx, lookup, q_norms
    torch.cuda.empty_cache()
    # the sharded tier on the first SHARDED_IVFPQ_ROWS rows of the same
    # source: at 10M its cell (49 s) took the smoke past 420 s of script
    t0 = time.perf_counter()
    n_s = min(n, SHARDED_IVFPQ_ROWS)
    gt_s = gt if n_s == n else synth.exact_gt_blocked(fill, n_s, q, k, "l2sqr").cpu().numpy().tolist()
    sharded = sharded_ivfpq(fill, n_s, dim, q, gt_s, sweep[f"{CODES_GATE_PROBES}/256"]["recall_at_10"],
                            nlist=nlist, device=device)
    sharded.update(cut_from_rows=n, cell_s=time.perf_counter() - t0)
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
    pqo["index_bytes_after_search"] = pqc.index_bytes()
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
    # version (bf16 LUT): equal, as check_sums_ids holds it
    lut_m, _ = pqc.pq.create_lookup(q)
    pos = pqc._inv[ids0.clamp_min(0).long()]
    lut_b = lut_m.to(torch.bfloat16)
    got = A.adc_sums_ids(pqc._codes, lut_b, pos, 320, True)
    ref = A.adc_sums_ids_ref(pqc._codes, lut_b, pos, 320, True, False)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"codes_pq_10m: K8 ids at the pool (C {c0}) differs from its plain version")
    pqo["k8_ids_pool_max_abs_err"] = max_abs_err(got, ref)
    pqo["k8_ids_pool_ms"], pqo["k8_ids_pool_plain_ms"] = in_turns(
        lambda: A.adc_sums_ids(pqc._codes, lut_b, pos, 320, True),
        lambda: A.adc_sums_ids_ref(pqc._codes, lut_b, pos, 320, True, False), 10, 1)
    log(f"[codes] K8 ids at the pool (B {B}, C {c0}) equal to its plain version, "
        f"{pqo['k8_ids_pool_ms']:.4f} ms (plain {pqo['k8_ids_pool_plain_ms']:.3f}); stages {split}")
    del pqc, lut_c, qn_c, lut_m, pos, lut_b, got, ref, ids0, td1, ti1, d_ex
    torch.cuda.empty_cache()

    # ---- the cosine columns: a small cosine IVF-PQ index whose lists spill ----
    cos = IVFPQIndex.build_from_fill(fill, n_cos, dim, "cosine", nlist=nlist_cos,
                                     pq_config=PQConfig(n_bits=4, m=320, dist="cosine", k_means_size=25_000),
                                     row_gen=fill.row_gen, device=device)
    cos_out = {"n": n_cos, "nlist": nlist_cos, "lpad": cos.lpad, "overflow_rows": cos.ov_count}
    check(cos.ov_count > 0, f"codes cosine: no list of the {n_cos}-row index spilled (lpad {cos.lpad})")
    cos_out["k11_max_abs_err"] = check_k11(cos, q, CODES_GATE_PROBES, f"cosine, {n_cos} rows", timed=False)["max_abs_err"]
    lookup, q_norms = cos.pq.create_lookup(q)
    # K7's cosine column on the index's real codes (its first 131,072 list
    # slots, chunk 16), and on its overflow segment of spilled rows
    k7_errs = [check_k7_codes(cos._codes[:131072], lookup, cos.pq.device()[2], q_norms, 131072, 16,
                              "cosine", "cosine, 131,072 list slots")["max_abs_err"],
               check_k7_codes(cos._codes_ov, lookup, cos.pq.device()[2], q_norms, cos.ov_count,
                              cos.overflow_chunk(k)[1], "cosine",
                              f"cosine overflow segment ({cos.ov_count} rows)")["max_abs_err"]]
    cos_out["k7_cosine_max_abs_err"] = max(k7_errs)
    d, ids = cos.knn_batch(q, k, n_probes=16, ef=256)
    check(bool(torch.isfinite(d).all()) and bool((ids >= 0).all()), "codes cosine: malformed result")
    del cos, lookup, q_norms
    torch.cuda.empty_cache()
    out.update(codes_ivfpq_10m=ivf, codes_pq_10m=pqo, cosine_300k=cos_out, phase_s=time.perf_counter() - t_phase)
    log(f"[codes] phase: {out['phase_s']:.1f} s ({sharded['cell']} {sharded['cell_s']:.1f} s of it)")
    return out, k11, k7s0, sharded


def phase_vecdb(x_host, q_host):
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch import VecDB
    from lab_1806_vec_db_tpu_torch.models import FlatIndex
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import survivors as SV

    n, k = len(x_host), 10
    db_dir = os.path.join(HERE, "tmp", "chip_smoke_db")
    shutil.rmtree(db_dir, ignore_errors=True)
    meta = [{"id": str(i)} for i in range(n)]
    out = {"rows": n, "dim": x_host.shape[1], "batch": len(q_host), "k": k}
    launches, gts = {}, {}
    db = VecDB(db_dir, seed=DB_SEED)
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
            SV.select_top_r.launches = 0
            t0 = time.perf_counter()
            res = db.batch_search(key, q_host, k)
            t_first = time.perf_counter() - t0
            launches[key] = (S.scan_chunkmin_int8_packed.launches, G.gather_dists.launches,
                             SV.select_top_r.launches)
            check(min(launches[key]) > 0, f"{key}: batch_search launched K1/K2/select {launches[key]} times")
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
            # single-query search: on the card, and through the native engine
            single_us = check_single_query(db, key, exact, x_host, q_host)
            one = db.search(key, q_host[0], k)
            ub = one[4][1]
            flt = db.search(key, q_host[0], k, None, ub)
            check(len(flt) >= 5 and all(d <= ub for _, d in flt) and flt == one[: len(flt)],
                  f"{key}: upper_bound filter")
            del exact
            torch.cuda.empty_cache()
            out[key] = {"dist": dist, "recall_at_10": rec, "batch_add_s": t_add,
                        "batch_search_first_s": t_first, "batch_search_median_s": t_warm,
                        "batch_search_min_s": min(calls), "batch_search_max_s": max(calls),
                        "single_query_us": {"device": single_us[0], "native": single_us[1]},
                        "launches": {"k1": launches[key][0], "k2": launches[key][1], "select": launches[key][2]}}
            log(f"[5/6] VecDB {key}: recall@10 {rec:.4f}, batch_search {t_warm*1e3:.1f} ms "
                f"(first {t_first:.2f} s), K1/K2 launches {launches[key]}; one query on the card "
                f"{single_us[0]:.0f} µs, native {single_us[1]:.0f} µs")
        key = "gist_l2"
        out["hnsw"], hnsw_launches, hnsw_meas, db = phase_hnsw(db, db_dir, key, q_host, gts[key])
        out["native"] = phase_native(db, key, q_host, gts[key])
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
    db = VecDB(db_dir, seed=DB_SEED)
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


# ---------------------------------------------------------- resident ----
RESIDENT_R = 40  # stage-1 candidates of each q-resident entry point, reranked by K2


def check_k12(q, base_bf, cache, n_valid, dist, tag, timed=False):
    """K12 against its plain version: survivors within rtol 1e-5 / atol 1e-6
    (+inf at the same places); where the ids differ, the two rows' float64
    distances lie within that tolerance of each other."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR

    qb, qc = q.to(torch.bfloat16), D.dist_cache(q, dist)
    args = (qb, qc, base_bf, cache, n_valid, dist)
    got = SR.scan_chunkmin(*args)
    ref = SR.scan_chunkmin_ref(qb, qc, *SR._pad_rows(SR._NB, base_bf, cache), n_valid, dist)
    torch.cuda.synchronize()
    check(got[0].shape == ref[0].shape == (q.shape[0], -(-base_bf.shape[0] // SR._NB) * 8), f"K12 {tag} shape")
    fin = torch.isfinite(ref[0])
    check(torch.equal(fin, torch.isfinite(got[0])) and torch.equal(got[0][~fin], ref[0][~fin]),
          f"K12 {tag}: +inf survivors differ from the plain version's")
    err = (got[0] - ref[0]).abs()[fin]
    over = int((err > 1e-6 + 1e-5 * ref[0].abs()[fin]).sum())
    max_rel = float((err / ref[0].abs()[fin].clamp_min(1e-30)).max())
    log(f"[resident] K12 {tag}: max abs err {float(err.max()):.3g}, max rel err {max_rel:.3g}, "
        f"{over} of {int(fin.sum())} survivors outside rtol 1e-5 / atol 1e-6")
    check(over == 0, f"K12 {tag}: {over} survivors outside rtol 1e-5 / atol 1e-6 of the plain version")
    diff = got[1] != ref[1]
    b = torch.nonzero(diff)[:, 0]
    rows_k, rows_r = got[1][diff].long(), ref[1][diff].long()
    qd = qb[b].double()

    def d64(rows):
        dot = (qd * base_bf[rows].double()).sum(-1)
        if dist == "l2sqr":
            return qc[b].double() + cache[rows].double() - 2.0 * dot
        return 1.0 - dot / (qc[b].double() * cache[rows].double()).clamp_min(1e-10)

    dk, dr = d64(rows_k), d64(rows_r)
    check(bool((torch.abs(dk - dr) <= 1e-5 * torch.abs(dr) + 1e-6).all()),
          f"K12 {tag}: ids differ between rows farther apart than rtol 1e-5")
    out = {"max_abs_err": max_abs_err(got[0], ref[0]), "max_rel_err": max_rel, "ids_differ": int(diff.sum()),
           "survivors": got[0].numel()}
    if timed:
        out["ms"], out["plain_ms"] = in_turns(lambda: SR.scan_chunkmin(*args), lambda: SR.scan_chunkmin_ref(
            qb, qc, *SR._pad_rows(SR._NB, base_bf, cache), n_valid, dist), 5, 1)
        n, dim, B = n_valid, base_bf.shape[1], q.shape[0]
        # bf16 rows and their cache, the bf16 queries and their cache, the
        # (B, S) f32 + int32 survivors; 2 B n dim bf16 operations
        out["bound"] = bound_ms(n * (2 * dim + 4) + B * (2 * dim + 4) + 8 * got[0].numel(),
                                2.0 * B * n * dim, BF16_OPS_S)
    log(f"[resident] K12 {tag} ({base_bf.shape[0]} rows x {q.shape[0]} queries): within rtol 1e-5 of its plain "
        f"version (max rel err {out['max_rel_err']:.3g}, ids differ at {out['ids_differ']} of "
        f"{out['survivors']} survivors, all between near-equal rows)"
        + (f"; {out['ms']:.3f} ms, plain {out['plain_ms']:.2f} ms, bound {out['bound']}" if timed else ""))
    return out


def check_int8_resident(q, b8, bsc, cache, n_valid, dist, tag, timed=False):
    """K13 and K14 against their plain versions on the same raw int8
    operands (the kernels read the base in place, the plain versions take
    it zero-padded to N_pad): equal element for element (K14's ids too).
    K14 takes the queries padded to a multiple of 128 as its entry point
    pads them.  Timed: in turns with the plain version (back to back) and
    replayed from a CUDA graph before and after those."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    out = {}
    for name, fn, ref, mult, qq in (
            ("k13", SR.scan_dist_int8, SR.scan_dist_int8_ref, SR._NB, q),
            ("k14", SR.scan_chunkmin_int8_t, SR.scan_chunkmin_int8_t_ref, SR._NB_T,
             torch.cat([q, q.new_zeros((-q.shape[0] % 128, q.shape[1]))]))):
        q8, qsc = T.quantize_rows_int8(qq)
        qc = D.dist_cache(qq, dist)
        args = (q8, qsc, qc, b8, bsc, cache, n_valid, dist)
        pargs = (q8, qsc, qc, *SR._pad_rows(mult, b8, bsc, cache), n_valid, dist)
        got, want = fn(*args), ref(*pargs)
        torch.cuda.synchronize()
        got, want = (got, want) if name == "k14" else ((got,), (want,))
        for a, b in zip(got, want):
            check(a.shape == b.shape and torch.equal(a, b),
                  f"{name.upper()} {tag}: {int((a != b).sum())} values differ from the plain version")
        o = {"max_abs_err": max(max_abs_err(a.float(), b.float()) for a, b in zip(got, want)),
             "shape": [qq.shape[0], b8.shape[0], b8.shape[1]]}
        del got, want
        if timed:
            g0 = TA.graph_ms(lambda: fn(*args), 5)
            o["ms"], o["plain_ms"] = in_turns(lambda: fn(*args), lambda: ref(*pargs), 5, 1)
            o["graph_ms"] = (g0 + TA.graph_ms(lambda: fn(*args), 5)) / 2  # before and after the turns
            Bq, n, dim = qq.shape[0], n_valid, b8.shape[1]
            n_pad = -(-b8.shape[0] // mult) * mult
            # int8 rows with scale and cache, int8 queries with theirs; K13's
            # (B, N_pad) bf16 matrix or K14's (N_pad/128, B) f32 + int32
            written = Bq * n_pad * 2 if name == "k13" else n_pad // 128 * Bq * 8
            o["bound"] = bound_ms(n * (dim + 8) + Bq * (dim + 8) + written, 2.0 * Bq * n * dim)
        out[name] = o
        log(f"[resident] {name.upper()} {tag} ({b8.shape[0]} rows x {qq.shape[0]} queries): equal to its plain "
            "version element for element"
            + (f"; {o['ms']:.3f} ms (graph replay {o['graph_ms']:.3f}), plain {o['plain_ms']:.2f} ms, "
               f"bound {o['bound']}" if timed else ""))
    return out


def phase_resident(store, q, gt):
    """The three q-resident scans on flat_1m's rows (l2sqr, B = 1000): each
    entry point's r = 40 candidates reranked exactly by K2 (recall@10, QPS
    of chained batches, the launch counts from 0 around the three), then
    each kernel against its plain version, timed in turns, with its bound."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    n, dist, k = len(store), store.dist, 10
    t0 = time.perf_counter()
    vecs, cache = store.device()  # cache: the raw |x|^2 that K12-K14 take
    base_bf, _ = store.device_traversal()
    b8, bsc = T.quantize_rows_int8(vecs)
    torch.cuda.synchronize()
    out = {"cell": "resident_1m", "n": n, "rows": vecs.shape[0], "batch": q.shape[0], "r": RESIDENT_R,
           "inputs_s": time.perf_counter() - t0}
    entries = {
        "k12": lambda qq: SR.scan_candidates_pallas(qq, base_bf, cache, n, RESIDENT_R, dist),
        "k13": lambda qq: SR.scan_candidates_int8_pallas(qq, b8, bsc, cache, n, RESIDENT_R, dist),
        "k14": lambda qq: SR.scan_candidates_int8_chunkmin(qq, b8, bsc, cache, n, RESIDENT_R, dist),
    }
    search = {name: (lambda qq, e=e: G.rerank_topk(qq, vecs, e(qq)[1], k, dist)) for name, e in entries.items()}
    pq_counts(reset=True)
    results = {name: s(q) for name, s in search.items()}
    torch.cuda.synchronize()
    out["launches"] = {name: v for name, v in pq_counts().items() if name in entries}
    check(min(out["launches"].values()) > 0, f"resident: the entry points launched {out['launches']}")
    for name, (d, ids) in results.items():
        check(bool(torch.isfinite(d).all()) and bool((ids >= 0).all()) and ids.shape == (q.shape[0], k),
              f"resident {name}: malformed result")
        out[name] = {"recall_at_10": recall_at_k(gt, ids.cpu().numpy().tolist(), k),
                     **chained_qps(search[name], q, 3, 4)}
    log("[resident] " + ", ".join(f"{name} stage 1 + K2: recall@10 {out[name]['recall_at_10']:.4f} QPS "
                                  f"{out[name]['qps_best']:.0f}" for name in entries) + f"; launches {out['launches']}")
    del results
    # K12's f32 survivors keep flat_1m's Flat bar; K13 / K14 select on bf16
    # distances (3 significant digits, many ties among 1M rows): 0.90
    for name, bar in (("k12", 0.99), ("k13", 0.90), ("k14", 0.90)):
        check(out[name]["recall_at_10"] >= bar, f"resident: {name} recall@10 {out[name]['recall_at_10']:.4f} < {bar}")
    k12 = check_k12(q, base_bf, cache, n, dist, "resident_1m", timed=True)
    k1314 = check_int8_resident(q, b8, bsc, cache, n, dist, "resident_1m", timed=True)
    del b8, bsc, base_bf
    store._dev_bf16 = None  # the traversal copy serves no later phase
    torch.cuda.empty_cache()
    return out, {"k12": k12, **k1314}


def phase_resident_cosine(x, queries):
    """The cosine columns of K12-K14 on the 200,000 x 960 rows of phases
    3-4, each kernel against its plain version; K13 / K14 also on a ragged
    base, at widths 96 and 1040 and on channels across f32's range, both
    metrics."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench import time_adc as TA
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    cache = D.dist_cache(x, "cosine")
    b8, bsc = T.quantize_rows_int8(x)
    base_bf = x.to(torch.bfloat16)
    k12 = check_k12(queries, base_bf, cache, x.shape[0], "cosine", "cosine 200,000")
    # a small base for B <= 64 (one query tile, its streamed half all past
    # B), with rows past n_valid
    small = check_k12(queries[:50], base_bf[:70_000], cache[:70_000], 69_500, "cosine", "cosine 70,000 x 50 queries")
    k12["max_abs_err"] = max(k12["max_abs_err"], small["max_abs_err"])
    k1314 = check_int8_resident(queries, b8, bsc, cache, x.shape[0], "cosine", "cosine 200,000")
    # K13 / K14 untimed on both metrics: a ragged base (70,000 rows, n_valid
    # 69,500, B 50: one partial query tile) and widths 96 and 1040 (the
    # second streams its query boxes beside the rows), uniform rows there
    gen = torch.Generator(device="cuda").manual_seed(12)
    shapes = [("ragged 70,000 x 50 queries", x[:70_000], queries[:50], 69_500)]
    for dim in (96, 1040):
        shapes.append((f"width {dim}", torch.rand((20_000, dim), generator=gen, device="cuda"),
                       torch.rand((300, dim), generator=gen, device="cuda"), 20_000))
    for tag, rows, qq, n_valid in shapes:
        r8, rsc = T.quantize_rows_int8(rows)
        for dist in ("l2sqr", "cosine"):
            more = check_int8_resident(qq, r8, rsc, D.dist_cache(rows, dist), n_valid, dist, f"{dist} {tag}")
            for key in k1314:
                k1314[key]["max_abs_err"] = max(k1314[key]["max_abs_err"], more[key]["max_abs_err"])
    # and on channels spread over f32's range (bf16 subnormals, overflow to
    # +-inf, zero scales), where the kernels' bf16x2 steps meet edge cases
    for dist in ("l2sqr", "cosine"):
        for key, fn, ref, mult in (("k13", SR.scan_dist_int8, SR.scan_dist_int8_ref, SR._NB),
                                   ("k14", SR.scan_chunkmin_int8_t, SR.scan_chunkmin_int8_t_ref, SR._NB_T)):
            args = TA.int8_edge_case(20_000, 96, 300, 13, key == "k14")
            got, want = fn(*args, 19_990, dist), ref(*args[:3], *SR._pad_rows(mult, *args[3:]), 19_990, dist)
            torch.cuda.synchronize()
            got, want = (got, want) if key == "k14" else ((got,), (want,))
            check(all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want)),
                  f"{key.upper()} {dist} edge channels: differs from the plain version")
    log("[resident] K13 / K14 on channels across f32's range (20,000 x 96, B 300): equal to their plain versions")
    return {"k12": k12, **k1314}


# ---------------------------------------------------------------- u8 ----
U8_DIM = 128  # BIGANN's (SIFT1B's) uint8 base vectors, cut to 1M rows


def u8_rows(n, seed, device, scale=None):
    """(n, 128) uint8 rows on `device`: Gist-spectrum rows (`make_device`)
    scaled so that the 99.9% quantile of the first 4096 rows maps to 255,
    truncated and clipped to 0-255 (the table's `as u8` cast).  Returns the
    rows and the scale, which the queries reuse."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench import synth

    x = synth.make_device(n, U8_DIM, seed, device)
    if scale is None:
        scale = 255.0 / float(torch.quantile(x[:4096].flatten(), 0.999))
    return (x * scale).trunc_().clamp_(0.0, 255.0).to(torch.uint8), scale


PARENT = None  # `--parent DIR`: a checkout of an earlier commit to compare the uint8 stage 1 with


def u8_launcher(lib, n_int: int):
    """A bare launch of a library's `vecdb_scan_u8_exact` -> run(q8, qn8,
    x8, n8) -> (N / 128, B) int32 on the plan its signature implies
    (`k1_plan` for the 5-int form, `u8_plan` with q for the 6-int one): the
    same host work for two trees' kernels, so that their times in turns
    compare the kernels."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(q8, qn8, x8, n8):
        B, (n_pad, lanes) = q8.shape[0], x8.shape
        plan = S.k1_plan(n_pad, B, sms) if n_int == 5 else S.u8_plan(n_pad, B, lanes, sms)
        shape = (n_pad // 128, B)
        out = (torch.full(shape, 2**31 - 1, dtype=torch.int32, device=x8.device) if plan["parts"] > 1
               else torch.empty(shape, dtype=torch.int32, device=x8.device))
        tail = [plan["parts"], plan["ctas"]] + ([plan["q"]] if n_int == 6 else [])
        status = lib.vecdb_scan_u8_exact(q8.data_ptr(), qn8.data_ptr(), x8.data_ptr(), n8.data_ptr(), out.data_ptr(),
                                         B, n_pad, lanes, *tail, torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"u8: vecdb_scan_u8_exact returned status {status}")
        return out

    return run


def parent_u8():
    """The uint8 stage 1 of the `--parent` checkout, built alone from the
    source that defines its `vecdb_scan_u8_exact`, as `u8_launcher`'s run,
    or None without `--parent`."""
    import ctypes
    import re

    from lab_1806_vec_db_tpu_torch.ops import _build

    if PARENT is None:
        return None
    csrc = os.path.join(PARENT, PKG, "csrc")
    src = [p for p in sorted(os.listdir(csrc)) if p.endswith(".cu")
           and 'extern "C" int vecdb_scan_u8_exact(' in open(os.path.join(csrc, p)).read()]
    check(len(src) == 1, f"--parent: no single source defines vecdb_scan_u8_exact in {csrc}")
    decl = re.search(r"vecdb_scan_u8_exact\.argtypes = \[P\] \* 5 \+ \[I\] \* (\d)",
                     open(os.path.join(PARENT, PKG, "ops", "_build.py")).read())
    n_int = int(decl.group(1))
    out_dir = os.path.join(HERE, "tmp", "parent_u8_build")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libparent_u8.so")
    res = subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                          "-o", so, os.path.join(csrc, src[0])], capture_output=True, text=True)
    check(res.returncode == 0, f"--parent: nvcc failed on {src[0]}:\n{res.stderr[-2000:]}")
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.vecdb_scan_u8_exact.argtypes = [P] * 5 + [I] * n_int + [P]
    lib.vecdb_scan_u8_exact.restype = I
    log(f"[u8] --parent {PARENT}: its uint8 stage 1 from {src[0]} ({n_int}-int launcher)")
    return u8_launcher(lib, n_int)


def u8_against_parent(run_parent, m, q, batches, reps) -> dict:
    """This tree's uint8 stage 1 and the parent's, both by `u8_launcher`, on
    the mirror `m` at each batch of `q`: equal element for element, then
    timed in turns (parent, tree, tree, parent) -> {B: {"ms", "parent_ms",
    "turns"}}."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import _build

    run_tree = u8_launcher(_build.library(), 6)
    out = {}
    for B in batches:
        q8, qn8 = m.queries(q[:B])
        tree = lambda: run_tree(q8, qn8, m.q8, m.cache)  # noqa: E731
        parent = lambda: run_parent(q8, qn8, m.q8, m.cache)  # noqa: E731
        check(torch.equal(tree(), parent()), f"u8: the tree's and the parent's uint8 stage 1 differ at B {B}")
        turns = [cuda_ms(parent, reps), cuda_ms(tree, reps), cuda_ms(tree, reps), cuda_ms(parent, reps)]
        out[B] = {"ms": (turns[1] + turns[2]) / 2, "parent_ms": (turns[0] + turns[3]) / 2, "turns": turns}
        log(f"[u8] rows {m.q8.shape[0]}, B {B}: uint8 stage 1 {out[B]['ms']:.4f} ms, the parent's "
            f"{out[B]['parent_ms']:.4f} (in turns {', '.join(f'{t:.4f}' for t in turns)}; equal)")
    return out


def k1_sass() -> dict:
    """The float K1 (`scan_int8_packed_kernel`) as nvcc builds it alone
    from this tree's source and, with `--parent`, from the parent's: SASS
    instructions (cuobjdump -sass) and registers (cuobjdump -res-usage),
    and whether the two instruction streams are identical."""
    import re

    from lab_1806_vec_db_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out_dir = os.path.join(HERE, "tmp", "k1_sass")
    os.makedirs(out_dir, exist_ok=True)

    def one(root, tag):
        cubin = os.path.join(out_dir, f"{tag}.cubin")
        res = subprocess.run([nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-cubin", "-o", cubin,
                              os.path.join(root, PKG, "csrc", "scan_int8_packed.cu")], capture_output=True, text=True)
        check(res.returncode == 0, f"k1_sass: nvcc -cubin failed ({tag}):\n{res.stderr[-2000:]}")
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True, check=True).stdout
        usage = subprocess.run([cuobjdump, "-res-usage", cubin], capture_output=True, text=True, check=True).stdout
        instr, inside = [], False
        for ln in sass.splitlines():
            if "Function :" in ln:
                inside = "scan_int8_packed_kernel" in ln
            elif inside and (m := re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?);", ln)):
                instr.append(m.group(1).strip())
        regs = None
        lines = usage.splitlines()
        for i, ln in enumerate(lines):
            if "scan_int8_packed_kernel" in ln:
                for nxt in lines[i : i + 3]:
                    if r := re.search(r"REG:(\d+)", nxt):
                        regs = int(r.group(1))
                        break
        return {"instructions": len(instr), "registers": regs}, instr

    tree, ti = one(HERE, "tree")
    out = {"tree": tree, "parent": None, "identical": None}
    if PARENT is not None:
        out["parent"], pi = one(PARENT, "parent")
        out["identical"] = ti == pi
    log(f"[u8] the float K1's SASS: {out}")
    return out


def phase_u8(n=1_000_000, n_db=100_000, B=1000, device="cuda"):
    """u8_1m: FlatIndexU8 at 1,000,000 x 128 uint8 rows, B = 1000, k = 10
    (QPS of chained batches; on 64 queries the returned distances and the
    exact top-10 distances of a float64 brute force on the card must be
    equal); vecdb_u8_100k: a uint8 VecDB table of 100,000 x 128 through the
    API (batch_add, batch_search against the index, the 200.7 -> 200 cast,
    RuntimeError naming float32 for HNSW and PQ, close and reopen)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch import VecDB
    from lab_1806_vec_db_tpu_torch.models import FlatIndexU8
    from lab_1806_vec_db_tpu_torch.models import u8 as MU8
    from lab_1806_vec_db_tpu_torch.ops import u8 as U8

    k = 10
    x, scale = u8_rows(n, 6, device)
    q, _ = u8_rows(B, 7, device, scale)
    x_host, q_host = x.cpu().numpy(), q.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = FlatIndexU8.from_numpy(x_host, "l2sqr", device=device)
    idx.store.device()
    torch.cuda.synchronize()
    out = {"cell": "u8_1m", "n": n, "dim": U8_DIM, "batch": B, "k": k, "scale": scale,
           "build_s": time.perf_counter() - t0, "index_bytes": idx.index_bytes()}
    t0 = time.perf_counter()
    d, ids = idx.knn_batch(q_host, k)
    out["first_call_s"] = time.perf_counter() - t0
    check(d.shape == ids.shape == (B, k) and bool((ids >= 0).all()) and bool(np.isfinite(d).all()),
          "u8_1m: malformed result")
    # the returned distances and the exact top-10 of a float64 brute force
    qd = q[:64].double()
    d64 = (qd.square().sum(1, keepdim=True) + x.double().square().sum(1)[None, :]
           - 2.0 * qd @ x.double().T)
    top64 = torch.topk(d64, k, dim=1, largest=False).values
    got = torch.from_numpy(d[:64]).to(device).double()
    rows = x[torch.from_numpy(ids[:64]).to(device).long()].double()
    exact = ((rows - qd[:, None, :]) ** 2).sum(-1)
    check(torch.equal(got, exact), f"u8_1m: returned distances differ from float64 exact by "
                                   f"{float((got - exact).abs().max())}")
    check(torch.equal(got, top64), "u8_1m: the returned top-10 distances are not the exact top-10")
    out["distances_equal_float64_exact_64_queries"] = True
    del d64, qd, rows
    qf = q.float()
    out.update(chained_qps(lambda qq: idx._knn_device(qq.to(torch.uint8), k), qf, 3, 4))
    out["profile"] = profile_call(lambda: idx._knn_device(q, k))
    log(f"[u8] u8_1m: build {out['build_s']:.2f} s, QPS best {out['qps_best']:.0f} median "
        f"{out['qps_median']:.0f}, distances equal float64 exact, index_bytes {out['index_bytes']}")
    # the exact route against the library path (knn_scan_u8) on every query
    check(MU8.exact_route(idx.dist, idx.device, idx.dim, len(idx), k), "u8_1m: the call does not take the exact route")
    rd, ri = idx._knn_exact(q, k)
    ld, li = U8.knn_scan_u8(q, *idx.store.device(), len(idx), k, "l2sqr")
    check(torch.equal(rd, ld), "u8_1m: the exact route's distances differ from the library path's")
    kth = ld[:, k - 1 :]
    check(all(set(a[da < t].tolist()) == set(b[db < t].tolist()) for a, b, da, db, t in zip(ri, li, rd, ld, kth)),
          "u8_1m: the exact route's ids differ from the library path's below the k-th distance")
    out["route_equals_library"] = {"distances": True, "ids_differing_at_ties": int((ri != li).sum())}
    out["route_ms"] = cuda_ms(lambda: idx._knn_exact(q, k), 5)
    out["library_ms"] = cuda_ms(lambda: U8.knn_scan_u8(q, *idx.store.device(), len(idx), k, "l2sqr"), 2)
    log(f"[u8] u8_1m: the exact route equals the library path ({out['route_equals_library']['ids_differing_at_ties']} "
        f"ids differ at ties); route {out['route_ms']:.3f} ms, library {out['library_ms']:.3f} ms a batch")
    run_parent = parent_u8()
    if run_parent is not None:
        out["k1_u8_vs_parent"] = u8_against_parent(run_parent, idx.store.mirror(), q, (1, 16, 1000), 20)
    del idx, x, q, rd, ri, ld, li
    torch.cuda.empty_cache()
    out["k1_u8"] = k1_u8_twins(device)
    out["k1_sass"] = k1_sass()
    big = u8_100m(device=device, run_parent=run_parent)

    # ---- vecdb_u8_100k ----
    db_dir = os.path.join(HERE, "tmp", "chip_smoke_u8_db")
    shutil.rmtree(db_dir, ignore_errors=True)
    rows = x_host[:n_db]
    vd = {"cell": "vecdb_u8_100k", "rows": n_db}
    db = VecDB(db_dir, device=device)
    try:
        check(db.create_table_if_not_exists("u8", U8_DIM, "l2sqr", data_type="uint8"), "u8: create table")
        t0 = time.perf_counter()
        db.batch_add("u8", rows, [{"id": str(i)} for i in range(n_db)])
        vd["batch_add_s"] = time.perf_counter() - t0
        db.add("u8", [200.7] * U8_DIM, {"id": "cast"})
        t0 = time.perf_counter()
        res = db.batch_search("u8", q_host, k)
        vd["batch_search_first_s"] = time.perf_counter() - t0
        calls = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = db.batch_search("u8", q_host, k)
            calls.append(time.perf_counter() - t0)
        vd["batch_search_median_s"] = float(np.median(calls))
        _, ref = FlatIndexU8.from_numpy(rows, "l2sqr", device=device).knn_batch(q_host, k)
        check([[int(m["id"]) for m, _ in r] for r in res] == ref.tolist(),
              "vecdb_u8_100k: batch_search differs from FlatIndexU8")
        hit = db.search("u8", [201] * U8_DIM, 1)
        check(hit == [({"id": "cast"}, float(U8_DIM))], f"vecdb_u8_100k: the 200.7 -> 200 cast: {hit}")
        for name, call in (("build_hnsw_index", lambda: db.build_hnsw_index("u8")),
                           ("build_pq_table", lambda: db.build_pq_table("u8"))):
            try:
                call()
                fail(f"vecdb_u8_100k: {name} accepted a uint8 table")
            except RuntimeError as e:
                check("float32" in str(e), f"vecdb_u8_100k: {name} raised {e!r}")
        before = db.batch_search("u8", q_host, k)
    finally:
        db.close()
    db = VecDB(db_dir, device=device)
    try:
        check(db.get_len("u8") == n_db + 1, "vecdb_u8_100k: length after reopen")
        check(db.batch_search("u8", q_host, k) == before, "vecdb_u8_100k: batch_search differs after reopen")
    finally:
        db.close()
    shutil.rmtree(db_dir, ignore_errors=True)
    vd["checks"] = ["batch_search == FlatIndexU8", "200.7 -> 200", "HNSW / PQ raise RuntimeError (float32)",
                    "close / reopen identical"]
    log(f"[u8] vecdb_u8_100k: batch_add {vd['batch_add_s']:.2f} s, batch_search {vd['batch_search_median_s']*1e3:.1f} "
        "ms, cast / refusals / reopen checked")
    return {"u8_1m": out, "vecdb_u8_100k": vd, "u8_100m": big}


def k1_u8_twins(device="cuda") -> dict:
    """K1's uint8 variant against its plain version, element for element: a
    70,000-row mirror with 500 sentinel rows at B 1000, 129, 16 and 1; 6,000
    rows (parts > 1); all-0 and all-255 rows and queries (d up to 128 x
    255^2); widths 96 and 129 (256 lanes)."""
    import torch
    from lab_1806_vec_db_tpu_torch.models.mirror import U8Mirror
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    g = torch.Generator(device=device).manual_seed(5)

    def rand(n, dim):
        return torch.randint(0, 256, (n, dim), generator=g, device=device, dtype=torch.uint8)

    def full(n, v):
        return torch.full((n, U8_DIM), v, dtype=torch.uint8, device=device)

    r, qq = rand(70000, U8_DIM), rand(1000, U8_DIM)
    cases = [(f"70000 rows, B {b}", r, 500, qq[:b]) for b in (1000, 129, 16, 1)]
    cases += [("6000 rows", r[:6000], 0, qq), ("extremes", torch.cat([full(3000, 0), full(3000, 255)]), 0,
                                              torch.cat([full(64, 0), full(64, 255)]))]
    cases += [(f"dim {d}", rand(9000, d), 0, rand(300, d)) for d in (96, 129)]
    shapes = []
    for tag, rows, tail, q in cases:
        m = U8Mirror.build(rows, rows.shape[0] - tail, "l2sqr", device)
        q8, qn8 = m.queries(q)
        out = S.scan_chunkmin_u8_packed(q8, qn8, m.q8, m.cache)
        ref = S.scan_chunkmin_u8_packed_ref(q8, qn8, m.q8, m.cache)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K1 u8 {tag}: {int((out != ref).sum())} packed values differ from the plain version")
        shapes.append(tag)
    log(f"[u8] K1's uint8 variant equal to its plain version element for element: {'; '.join(shapes)}")
    return {"equal": shapes, "max_abs_err": 0}


def u8_100m(n=100_000_000, B=1000, n_check=100, device="cuda", run_parent=None) -> dict:
    """gist_u8_100m's shape: FlatIndexU8.from_device over 100,000,000 x 128
    Gist-derived uint8 rows (`benchmark/synth_u8.py`): build time and peak;
    the uint8 stage 1 (K1's variant) equal to its plain version element for
    element on the route's own card tensors (one part, 48,829 chunks), and
    both timed in turns against the bound; the select on its survivors
    (S 781,264, r 10) equal to its plain version (the stable sort) bit for
    bit, both timed; the rescan; the launches of both kernels in one
    knn_batch call; knn_batch's time; one call of the library path; and the
    answers of `n_check` queries against the exact reference
    (`benchmark/reference.py`): distances equal, ids equal below the k-th
    distance; with `run_parent`, the parent's uint8 stage 1 in turns with
    this tree's (`u8_against_parent`)."""
    import numpy as np
    import torch
    from benchmark import reference, synth_u8
    from lab_1806_vec_db_tpu_torch.models import FlatIndexU8
    from lab_1806_vec_db_tpu_torch.ops import scan as S
    from lab_1806_vec_db_tpu_torch.ops import survivors as SV
    from lab_1806_vec_db_tpu_torch.ops import u8 as U8

    k = 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x = synth_u8.make_device(n, U8_DIM, 27, device)
    q = synth_u8.make_device(B, U8_DIM, 28, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = FlatIndexU8.from_device(x, "l2sqr")
    torch.cuda.synchronize()
    out = {"cell": "u8_100m", "n": n, "batch": B, "k": k, "build_s": time.perf_counter() - t0,
           "index_bytes": idx.index_bytes(), "build_peak_bytes": torch.cuda.max_memory_allocated()}
    m = idx.store.mirror()
    q8, qn8 = m.queries(q)
    out["plan"] = S.k1_plan(m.q8.shape[0], B, torch.cuda.get_device_properties(0).multi_processor_count)
    packed = S.scan_chunkmin_u8_packed(q8, qn8, m.q8, m.cache)
    ref = S.scan_chunkmin_u8_packed_ref(q8, qn8, m.q8, m.cache)
    check(torch.equal(packed, ref), f"u8_100m: {int((packed != ref).sum())} of K1 u8's packed values differ from "
                                    "the plain version")
    del ref
    out["k1_u8_max_abs_err"] = 0
    out["k1_u8_ms"], out["k1_u8_plain_ms"] = in_turns(
        lambda: S.scan_chunkmin_u8_packed(q8, qn8, m.q8, m.cache),
        lambda: S.scan_chunkmin_u8_packed_ref(q8, qn8, m.q8, m.cache), 5, 1)
    out["k1_u8_bound_ms"], out["k1_u8_bound_by"] = bound_ms(
        n * U8_DIM + 4 * n + B * (U8_DIM + 8) + -(-n // 128) * B * 4, 2 * n * B * U8_DIM)
    if run_parent is not None:
        del packed
        out["k1_u8_vs_parent"] = u8_against_parent(run_parent, m, q, (B,), 3)[B]
        packed = S.scan_chunkmin_u8_packed(q8, qn8, m.q8, m.cache)
    # the select at the route's shape: the kernel equals the stable sort bit for bit
    check(SV.takes_kernel(packed, k), "u8_100m: the select does not take its kernel")
    (sd, si), (rd, ri) = S.select_survivors(packed, k), S.select_survivors_ref(packed, k)
    check(torch.equal(sd.view(torch.int32), rd.view(torch.int32)) and torch.equal(si, ri),
          f"u8_100m: the select differs from its plain version at S {packed.shape[0]}, r {k}")
    del rd, ri
    sel_ms, sel_plain_ms = in_turns(lambda: S.select_survivors(packed, k), lambda: S.select_survivors_ref(packed, k),
                                    5, 1)
    out["select"] = {"S": packed.shape[0], "B": B, "r": k, "max_abs_err": 0, "ms": sel_ms, "plain_ms": sel_plain_ms,
                     "bound": bound_ms(packed.numel() * 4 + B * k * 8), "library_ms": None}
    out["select_ms"] = sel_ms
    cand = si
    del packed, sd
    out["rescan_ms"] = cuda_ms(lambda: m.rescan(q8, qn8, cand, k), 5)
    q_host = q.cpu().numpy()
    torch.cuda.reset_peak_memory_stats()
    S.scan_chunkmin_u8_packed.launches = SV.select_top_r.launches = 0
    idx.knn_batch(q_host, k)
    out["launches"] = {"scan_u8_exact": S.scan_chunkmin_u8_packed.launches,
                       "select_survivors": SV.select_top_r.launches}
    check(out["launches"] == {"scan_u8_exact": 1, "select_survivors": 1},
          f"u8_100m: one knn_batch call launched {out['launches']}, not one of each kernel")
    calls = []
    for _ in range(5):
        t0 = time.perf_counter()
        idx.knn_batch(q_host, k)
        calls.append(time.perf_counter() - t0)
    out["knn_batch_s"] = sorted(calls)
    out["qps_median"] = B / float(np.median(calls))
    out["search_peak_bytes"] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    U8.knn_scan_u8(q, *idx.store.device(), n, k, "l2sqr")
    torch.cuda.synchronize()
    out["library_s"] = time.perf_counter() - t0
    d, i = idx.knn_batch(q_host[:n_check], k)
    del m, q8, qn8, cand
    ed, ei = reference.exact_topk(x, q[:n_check], k, "l2sqr")
    got = torch.from_numpy(d).to(device).double()
    check(torch.equal(got, ed), f"u8_100m: distances differ from the exact reference by {float((got - ed).abs().max())}")
    kth = ed[:, k - 1 :]
    ids = torch.from_numpy(i).to(device).long()
    check(all(set(a[da < t].tolist()) == set(b[db < t].tolist()) for a, b, da, db, t in zip(ids, ei, got, ed, kth)),
          "u8_100m: ids differ from the exact reference's below the k-th distance")
    out["equal_exact_reference_queries"] = n_check
    log(f"[u8] u8_100m: build {out['build_s']:.2f} s (peak {out['build_peak_bytes'] / 1e9:.2f} GB), K1 u8 "
        f"{out['k1_u8_ms']:.3f} ms (plain {out['k1_u8_plain_ms']:.3f}, bound {out['k1_u8_bound_ms']:.3f}; equal), "
        f"select {out['select_ms']:.3f} (plain {sel_plain_ms:.3f}; equal), rescan "
        f"{out['rescan_ms']:.3f}, knn_batch median {1e3 * float(np.median(calls)):.2f} ms ({out['qps_median']:.0f} "
        f"QPS), library path {out['library_s']:.2f} s; {n_check} queries equal the exact reference")
    del idx, x, q
    torch.cuda.empty_cache()
    return out


def u8_kernel(u8: dict, ptxas: dict) -> dict:
    """The kernels line's entry for K1's uint8 variant (`phase_u8`): no TPU
    kernel behind it (the JAX package's uint8 scan is plain XLA); launches:
    one knn_batch call at 100M; timed at gist_u8_100m's shape against its
    plain version; library_ms: one call of the library path
    (`ops/u8.py:knn_scan_u8`) at that shape; the smaller shapes' twins
    under "shapes"."""
    big = u8["u8_100m"]
    return {"name": "scan_u8_exact", "route": "cuda", "source": f"{PKG}/csrc/scan_u8_exact.cu",
            "replaces": None, "launches": big["launches"]["scan_u8_exact"],
            "max_abs_err": max(big["k1_u8_max_abs_err"], u8["u8_1m"]["k1_u8"]["max_abs_err"]),
            "ms": big["k1_u8_ms"], "plain_ms": big["k1_u8_plain_ms"], "bound_ms": big["k1_u8_bound_ms"],
            "bound_by": big["k1_u8_bound_by"], "library_ms": big["library_s"] * 1e3, "ptxas": ptxas,
            "shapes": u8["u8_1m"]["k1_u8"]["equal"], "float_k1_sass": u8["u8_1m"]["k1_sass"],
            "vs_parent": {"1m": u8["u8_1m"].get("k1_u8_vs_parent"), "100m": big.get("k1_u8_vs_parent")}}


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
    out["select"] = select_row(packed)
    del packed
    vecs, _ = store.device()
    out["exact_small"] = exact_small_row(vecs, n, dist, 22)
    out["knn_single"] = knn_single_ops(flat, q, k)
    resident = phase_resident(store, q, gt.tolist())
    pq_out, k7 = phase_pq_1m(store, flat, q, gt.tolist())
    ivf_out, k10 = phase_ivf_1m(store, q, gt.tolist())
    pca = phase_pca(store, q, gt.tolist())
    t0 = time.perf_counter()
    sharded = sharded_flat_ivf_1m(store, q, gt.tolist())
    log(f"[sharded] flat_1m + ivf_1m: {time.perf_counter() - t0:.1f} s")
    return out, resident, pq_out, k7, ivf_out, k10, pca, sharded


def knn_single_ops(flat, q, k, calls=100):
    """`FlatIndex.knn` (one query, the exact scan) at flat_1m: operations on
    the card a search (the profiler's device events, by name), the exact
    small-batch kernel's launches a search, and host ms a search."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lab_1806_vec_db_tpu_torch.ops import scan_small as SS

    qs = q[:calls].cpu().numpy()
    flat.knn(qs[0], k)
    torch.cuda.synchronize()
    launches = SS.exact_scan_small.launches
    t0 = time.perf_counter()
    for row in qs:
        flat.knn(row, k)
    ms = (time.perf_counter() - t0) / calls * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for row in qs:
            flat.knn(row, k)
        torch.cuda.synchronize()
    ops = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = "scan" if "scan_kernel" in e.name else "merge" if "merge_kernel" in e.name else e.name[:40]
            ops[name] = ops.get(name, 0) + 1
    out = {"device_ops_per_search": sum(ops.values()) / calls, "device_ops": ops,
           "exact_small_launches_per_search": (SS.exact_scan_small.launches - launches) / (2 * calls),
           "host_ms": ms}
    log(f"[6/6] FlatIndex.knn at 1M: {out}")
    return out


# --------------------------------------------------------------- pca ----
PCA_DIM = 256  # the "pca" scan mode's projected width (the reference's VECDB_TPU_PCA_DIM default)


@contextlib.contextmanager
def scan_mode(store, scan, pca_dim=PCA_DIM):
    """The Flat planner over `store` in a scan mode (the planners read the
    store's `ScanMode`); the store's mode is restored on exit."""
    from lab_1806_vec_db_tpu_torch.models import FlatIndex, ScanMode

    old = store.scan_mode
    store.scan_mode = ScanMode(scan, pca_dim)
    try:
        yield FlatIndex.from_store(store)
    finally:
        store.scan_mode = old


def lowrank_device(n, dim, rank, seed, n_queries):
    """tests/test_project.py's `_lowrank` drawn on the card from a seeded
    torch.Generator: rows z * scales @ basis.T + 0.01 noise, z Gaussian,
    scales 1 / sqrt(1 + i), basis orthonormal (dim, rank) (a QR of a
    Gaussian); the queries are further draws."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    basis = torch.linalg.qr(torch.randn((dim, rank), generator=gen, device="cuda"))[0]
    scales = 1.0 / torch.sqrt(1.0 + torch.arange(rank, device="cuda", dtype=torch.float32))

    def draw(m):
        out = torch.empty((m, dim), device="cuda")
        for r0 in range(0, m, 131072):
            rows = min(131072, m - r0)
            z = torch.randn((rows, rank), generator=gen, device="cuda") * scales
            out[r0 : r0 + rows] = z @ basis.T + 0.01 * torch.randn((rows, dim), generator=gen, device="cuda")
        return out

    return draw(n), draw(n_queries)


def k1_bound(n, B, lanes):
    """K1's least time on its own inputs: n int8 rows of `lanes` with a
    scale and a cached term each, B int8 queries, one int32 per (128 rows,
    query); 2 n B lanes int8 operations."""
    return bound_ms(n * lanes + 8 * n + B * (lanes + 8) + -(-n // 128) * B * 4, 2.0 * n * B * lanes)


def check_k1_proj(store, q, d_red, tag, n_rows=None, timed=False):
    """K1 on the store's PCA mirror (d_red lanes, padded to 128) with the
    projected queries against its plain version: equal element for
    element.  `n_rows` cuts the mirror to a ragged length whose last 500
    rows are turned into sentinels.  Returns (lanes, the largest absolute
    difference, timing dict)."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import project as PJ
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    m = store.device_proj_int8(d_red)
    proj, mu, p8, psc, pca = m.proj, m.mu, m.q8, m.scale, m.cache
    if n_rows is not None:
        p8, psc, pca = p8[:n_rows], psc[:n_rows].clone(), pca[:n_rows].clone()
        psc[-500:] = 0.0
        pca[-500:] = S._BIG
    q8, qs2, qc = S.quantize_queries(PJ.project(q, proj, mu), p8.shape[1], store.dist)
    k1 = lambda: S.scan_chunkmin_int8_packed(q8, qs2, qc, p8, psc, pca)
    k1_ref = lambda: S.scan_chunkmin_int8_packed_ref(q8, qs2, qc, *S._pad_rows(p8, psc, pca, S._NB))
    out, ref = k1(), k1_ref()
    torch.cuda.synchronize()
    check(out.shape == ref.shape, f"K1 {tag}: shape {tuple(out.shape)} vs {tuple(ref.shape)}")
    err = int((out.long() - ref.long()).abs().max())
    check(torch.equal(out, ref), f"K1 {tag}: {int((out != ref).sum())} packed values differ (max {err})")
    log(f"[pca] K1 {tag}: D {p8.shape[1]} ({p8.shape[0]} rows, B {q.shape[0]}) equal to the plain "
        "version element for element")
    if not timed:
        return p8.shape[1], err, None
    ms, plain_ms = in_turns(k1, k1_ref, 10, 2)
    return p8.shape[1], err, {"ms": ms, "plain_ms": plain_ms, "bound": k1_bound(len(store), q.shape[0], d_red)}


def pca_stage_ms(pflat, q, k, passes=10):
    """The PCA route's stages with CUDA events (mean of `passes` after one
    warm-up): project + quantize + K1, the top-r over the survivors, K2 +
    top-k."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import project as PJ
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    store = pflat.store
    m = store.device_proj_int8(store.scan_mode.pca_dim)
    proj, mu, p8, psc, pca = m.proj, m.mu, m.q8, m.scale, m.cache
    r = pflat.rerank_depth(k)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = {"project_quantize_k1": 0.0, "topr": 0.0, "k2_topk": 0.0}
    for i in range(passes + 1):
        ev[0].record()
        q8, qs2, qc = S.quantize_queries(PJ.project(q, proj, mu), p8.shape[1], store.dist)
        packed = S.scan_chunkmin_int8_packed(q8, qs2, qc, p8, psc, pca)
        ev[1].record()
        _, cand = S.select_survivors(packed, r)
        ev[2].record()
        G.rerank_topk(q, store.device_rerank(), cand, k, store.dist)
        ev[3].record()
        torch.cuda.synchronize()
        if i:
            for name, a, b in zip(split, ev, ev[1:]):
                split[name] += a.elapsed_time(b) / passes
    return split


def pca_route(store, q, gt, tag, timed=False, gate=None):
    """The "pca" scan mode on `store` (pca_dim 256): fit and mirror build
    times, the route's K1 / K2 launches from 0 around one batch, recall@10
    against the exact scan (gated at `gate` when given), its ids with the
    kernels against its ids with their plain versions on GATE_Q queries
    (equal), and with `timed` the chained QPS beside the int8 route's, a
    stage split, K1 in turns with its plain version and index_bytes."""
    k = 10
    if timed:
        with scan_mode(store, "int8") as flat:
            int8 = {"ids": flat._knn_device(q, k)[1].cpu().numpy().tolist(),
                    "qps": chained_qps(lambda qq: flat._knn_device(qq, k), q, 5, 8)}
    with scan_mode(store, "pca") as pflat:
        out = pca_route_in_mode(pflat, q, gt, tag, timed, gate)
    if timed:
        out["int8_recall_at_10"] = recall_at_k(gt, int8["ids"], k)
        out["int8"] = int8["qps"]
    log(f"[pca] {tag}: fit {out['fit_s']:.2f} s, fit + mirror {out['fit_and_mirror_build_s']:.2f} s, "
        f"recall@10 {out['recall_at_10']:.4f}" + (f", QPS best {out['pca']['qps_best']:.0f} (int8 "
                                                  f"{out['int8']['qps_best']:.0f})" if timed else ""))
    return out


def pca_route_in_mode(pflat, q, gt, tag, timed, gate):
    """`pca_route`'s body, with the store in the "pca" mode."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import project as PJ
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    store = pflat.store
    k, n = 10, len(store)
    check(pflat.uses_pca, f"pca {tag}: the mode did not take the PCA route")
    vecs, _ = store.device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PJ.pca_fit(vecs, n, PCA_DIM, store.dist)
    fit_s = time.perf_counter() - t0
    store._pca_mirror = None  # the mirror below fits again, then builds
    t0 = time.perf_counter()
    store.device_proj_int8(PCA_DIM)
    torch.cuda.synchronize()
    out = {"cell": tag, "n": n, "dist": store.dist, "pca_dim": PCA_DIM, "rerank_depth": pflat.rerank_depth(k),
           "fit_s": fit_s, "fit_and_mirror_build_s": time.perf_counter() - t0}
    S.scan_chunkmin_int8_packed.launches = 0
    G.gather_dists.launches = 0
    d, ids = pflat._knn_device(q, k)
    launches = {"k1": S.scan_chunkmin_int8_packed.launches, "k2": G.gather_dists.launches}
    check(min(launches.values()) > 0, f"pca {tag}: the route launched K1/K2 {launches}")
    check(bool(torch.isfinite(d).all()) and d.shape == (q.shape[0], k), f"pca {tag}: malformed result")
    ids = ids.cpu().numpy()
    out.update(launches=launches, recall_at_10=recall_at_k(gt, ids.tolist(), k), ids_sha1=ids_hash(ids))
    ids_k = pflat._knn_device(q[:GATE_Q], k)[1].cpu().numpy()
    with plain_kernels():
        ids_p = pflat._knn_device(q[:GATE_Q], k)[1].cpu().numpy()
    check(ids_hash(ids_k) == ids_hash(ids_p), f"pca {tag}: ids with the kernels differ from the plain versions'")
    out["gate_ids_sha1"] = ids_hash(ids_k)
    if gate is not None:
        check(out["recall_at_10"] >= gate, f"pca {tag}: recall@10 {out['recall_at_10']:.4f} < {gate}")
    if timed:
        out["pca"] = chained_qps(lambda qq: pflat._knn_device(qq, k), q, 5, 8)
        out["stage_ms"] = pca_stage_ms(pflat, q, k)
        out["index_device_bytes"] = pflat.index_bytes()
        out["pca_mirror_bytes"] = store._pca_mirror.nbytes
    return out


def phase_pca(store, q, gt):
    """pca_1m, pca_lowrank_1m and the cosine / mode checks (see the module
    doc).  Returns (results, K1 at D 256 timed, the D 256 route's K1
    launches)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.models import FlatIndex, VecStore
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    k, B = 10, q.shape[0]
    res = {"pca_1m": pca_route(store, q, gt, "pca_1m", timed=True)}
    _, k1_err, k1 = check_k1_proj(store, q, PCA_DIM, "pca_1m", timed=True)
    k1["launches"] = res["pca_1m"]["launches"]["k1"]
    res["pca_1m"]["k1"] = k1
    # the other modes on the same store: each answers one batch
    vecs, cache = store.device()
    with scan_mode(store, "bf16") as bflat:
        _, ids_b = bflat._knn_device(q, k)
    res["bf16_recall_at_10"] = recall_at_k(gt, ids_b.cpu().numpy().tolist(), k)
    store._dev_bf16 = None
    with scan_mode(store, "exact") as eflat:
        _, ids_e = eflat._knn_device(q, k)
    _, ids_s = T.knn_scan(q, vecs, cache, len(store), k, store.dist)
    check(torch.equal(ids_e, ids_s), "pca: the exact mode's ids differ from knn_scan's")
    res["exact_recall_at_10"] = recall_at_k(gt, ids_e.cpu().numpy().tolist(), k)
    store._pca_mirror = None
    torch.cuda.empty_cache()

    # cosine on the 200,000-row cut; then an incremental write after the fit
    cstore = VecStore.from_device(vecs[: min(200_000, len(store))], "cosine")
    _, gt_c = FlatIndex.from_store(cstore)._knn_device(q, k, exact=True)
    res["pca_cos_200k"] = pca_route(cstore, q, gt_c.cpu().numpy().tolist(), "pca_cos_200k")
    k1_err = max(k1_err, check_k1_proj(cstore, q, PCA_DIM, "pca_cos_200k")[1])
    v_new = np.random.default_rng(14).random(cstore.dim, dtype=np.float32)
    cstore.swap_remove(0)
    new_id = cstore.push(v_new)
    with scan_mode(cstore, "pca") as cflat:
        d_new, i_new = cflat._knn_device(v_new[None, :], 1)
    check(int(i_new[0, 0]) == new_id and float(d_new[0, 0]) < 1e-5,
          f"pca: the row pushed after the fit came back as {int(i_new[0, 0])} at {float(d_new[0, 0])}")
    res["incremental_write"] = {"row": new_id, "distance": float(d_new[0, 0])}
    # K1 at 128 lanes: a 70,000-row store projected to 100 lanes, cut to a
    # ragged 69,500 rows (the last 500 sentinels), B 1000 and 37
    sstore = VecStore.from_device(vecs[: min(70_000, len(store))], "l2sqr")
    lanes, err, _ = check_k1_proj(sstore, q, 100, "d128_ragged", n_rows=69_500)
    k1["max_abs_err"] = max(k1_err, err, check_k1_proj(sstore, q[:37], 100, "d128_ragged_b37", n_rows=69_500)[1])
    check(lanes == 128, f"pca: the 100-lane mirror has {lanes} lanes")
    del cstore, sstore
    torch.cuda.empty_cache()

    # the rank-64 set at 1M x 960: the regime the mode exists for
    t0 = time.perf_counter()
    x_low, q_low = lowrank_device(1_000_000, 960, 64, 21, B)
    lstore = VecStore.from_device(x_low, "l2sqr")
    del x_low
    _, gt_l = FlatIndex.from_store(lstore)._knn_device(q_low, k, exact=True)
    gt_l = gt_l.cpu().numpy().tolist()
    res["lowrank_make_s"] = time.perf_counter() - t0
    res["pca_lowrank_1m"] = pca_route(lstore, q_low, gt_l, "pca_lowrank_1m", gate=0.95)
    _, ids8 = FlatIndex.from_store(lstore)._knn_device(q_low, k)
    res["pca_lowrank_1m"]["int8_recall_at_10"] = recall_at_k(gt_l, ids8.cpu().numpy().tolist(), k)
    del lstore
    torch.cuda.empty_cache()
    log(f"[pca] bf16 recall@10 {res['bf16_recall_at_10']:.4f}, exact {res['exact_recall_at_10']:.4f}; "
        f"incremental write {res['incremental_write']}; low-rank {res['pca_lowrank_1m']['recall_at_10']:.4f} "
        f"(int8 {res['pca_lowrank_1m']['int8_recall_at_10']:.4f})")
    return res, k1


# ----------------------------------------------------------- harness ----
HARNESS_ROWS, HARNESS_QUERIES = 200_000, 1000


def harness_toml(d, label, algo_body, ef_list):
    path = os.path.join(d, f"{label}.toml")
    with open(path, "w") as f:
        f.write(f'label = "{label}"\ndist = "L2Sqr"\ngnd_path = "{d}/gnd_synth.local.npz"\n'
                f'index_cache = ""\nbench_output = "{d}/results.toml"\nchained = true\n\n'
                f"[ef]\nlist = {list(ef_list)}\n\n{algo_body}\n"
                f'[base]\ndim = 960\ndata_path = "{d}/gist.local.bin"\n\n'
                f'[test]\ndim = 960\ndata_path = "{d}/gist_test.local.bin"\n')
    return path


def phase_harness():
    """harness_200k: the port's tools at the vecdb_200k cut, in a temporary
    directory: the synth CLI (base, 1,000 queries, --gnd), gen_gnd (its ids
    must equal synth's), convert_fvecs on a small file, and the bench harness
    on two chained TOMLs (Flat: K1 + K2; IVF nlist 256, n_probes 8-32: K10),
    the launch counts from 0 around each; results.toml must load in
    ResultList with chained = true and a recall per point, its .html beside
    it."""
    import numpy as np
    from lab_1806_vec_db_tpu_torch.bench import harness, synth
    from lab_1806_vec_db_tpu_torch.cli import convert_fvecs, gen_gnd
    from lab_1806_vec_db_tpu_torch.utils import io
    from lab_1806_vec_db_tpu_torch.utils.candidates import GroundTruth

    d = os.path.join(HERE, "tmp", "chip_smoke_harness")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    out = {"cell": "harness_200k", "rows": HARNESS_ROWS, "queries": HARNESS_QUERIES}
    try:
        with contextlib.redirect_stdout(sys.stderr):  # the tools' prints go to the log
            t0 = time.perf_counter()
            synth.main(["-n", str(HARNESS_ROWS), "--prefix", f"{d}/gist", "-q", str(HARNESS_QUERIES),
                        "--gnd", f"{d}/gist_test.local.bin", "--gnd-out", f"{d}/gnd_synth.local.npz"])
            out["synth_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            gen_gnd.main(["--base", f"{d}/gist.local.bin", "--test", f"{d}/gist_test.local.bin",
                          "-o", f"{d}/gnd.local.npz"])
            out["gen_gnd_s"] = time.perf_counter() - t0
            g1 = GroundTruth.load(f"{d}/gnd.local.npz").rows
            g2 = GroundTruth.load(f"{d}/gnd_synth.local.npz").rows
            check(g1.shape == (HARNESS_QUERIES, 10) and np.array_equal(g1, g2),
                  "harness: gen_gnd's ground truth differs from synth's --gnd")
            small = np.random.default_rng(0).random((50, 960), dtype=np.float32)
            with open(f"{d}/small.fvecs", "wb") as f:
                for row in small:
                    f.write(np.uint32(960).tobytes() + row.tobytes())
            convert_fvecs.main([f"{d}/small.fvecs", "-o", f"{d}/small.local.bin", "-l", "40"])
            check(np.array_equal(io.load_raw(f"{d}/small.local.bin", 960), small[:40]),
                  "harness: convert_fvecs output differs from its input rows")
            sweeps = {"Flat": ("[algorithm.Flat]\n", [10], ("k1", "k2")),
                      "IVF": ("[algorithm.IVF]\nk = 256\nk_means_size = 20000\nk_means_max_iter = 10\n",
                              [8, 16, 32], ("k10", "k2"))}
            for label, (body, efs, need) in sweeps.items():
                pq_counts(reset=True)
                t0 = time.perf_counter()
                harness.main([harness_toml(d, label, body, efs)])
                launches = pq_counts()
                missing = [kk for kk in need if launches[kk] == 0]
                check(not missing, f"harness {label}: kernels {missing} launched no time ({launches})")
                out[label] = {"wall_s": time.perf_counter() - t0,
                              "launches": {kk: v for kk, v in launches.items() if v}}
        rl = harness.ResultList.load(f"{d}/results.toml")
        check(set(rl.results) == {"Flat", "IVF"}, f"harness: results.toml holds {list(rl.results)}")
        check(os.path.exists(f"{d}/results.html"), "harness: no results.html beside results.toml")
        for label, row in rl.results.items():
            check(row.get("chained") is True, f"harness {label}: the row is not chained")
            check(len(row["recall"]) == len(row["ef"]) == len(row["search_time"]), f"harness {label}: ragged row")
            out[label]["points"] = [{"ef": ef, "ms_per_query": t, "ms_per_query_median": m, "recall": r}
                                    for ef, t, m, r in zip(row["ef"], row["search_time"],
                                                           row["search_time_median"], row["recall"])]
            out[label].update(build_seconds=row.get("build_seconds"),
                              index_device_bytes=row.get("index_device_bytes"))
            for p in out[label]["points"]:
                log(f"[harness] {label} ef {p['ef']}: {p['ms_per_query']:.5f} ms/query, "
                    f"recall {p['recall']:.4f}")
        check(out["Flat"]["points"][0]["recall"] >= 0.99, f"harness: Flat recall {out['Flat']['points']}")
        ivf_rec = [p["recall"] for p in out["IVF"]["points"]]
        check(ivf_rec == sorted(ivf_rec), f"harness: IVF recall falls with n_probes {ivf_rec}")
        out["mesh"] = harness_mesh(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


HARNESS_MESH_HNSW_ROWS = 50_000  # the mesh HNSW sweep's base: the first rows of the synth base


def harness_mesh(d):
    """harness_mesh: `mesh = 4` TOMLs through run_bench on harness_200k's
    synth data (Flat and IVF + PQ on the 200,000 rows; HNSW on the first
    50,000 with their own ground truth), launches from 0 around each."""
    from lab_1806_vec_db_tpu_torch.bench import harness
    from lab_1806_vec_db_tpu_torch.cli import gen_gnd
    from lab_1806_vec_db_tpu_torch.utils import io

    base = io.load_raw(f"{d}/gist.local.bin", 960)
    io.save_raw(f"{d}/gist50k.local.bin", base[:HARNESS_MESH_HNSW_ROWS])
    gen_gnd.main(["--base", f"{d}/gist50k.local.bin", "--test", f"{d}/gist_test.local.bin",
                  "-o", f"{d}/gnd50k.local.npz"])
    runs = {"Flat": ("[algorithm.Flat]\n", [10], "gist", "gnd_synth", ()),
            "HNSW": ("[algorithm.HNSW]\nM = 16\nef_construction = 100\n", [40, 120], "gist50k", "gnd50k",
                     ("k4", "k5")),
            "IVF_PQ": ("[algorithm.IVF]\nk = 256\n\n[PQ]\nn_bits = 4\nm = 320\nk_means_size = 10000\n",
                       [16, 32], "gist", "gnd_synth", ("k11", "k7"))}
    out = {"shards": SHARDS}
    for label, (body, efs, base_name, gnd, need) in runs.items():
        path = os.path.join(d, f"mesh_{label}.toml")
        with open(path, "w") as f:
            f.write(f'label = "mesh4-{label}"\ndist = "L2Sqr"\nmesh = {SHARDS}\n'
                    f'gnd_path = "{d}/{gnd}.local.npz"\nindex_cache = ""\n'
                    f'bench_output = "{d}/mesh_results.toml"\n\n[ef]\nlist = {efs}\n\n{body}\n'
                    f'[base]\ndim = 960\ndata_path = "{d}/{base_name}.local.bin"\n\n'
                    f'[test]\ndim = 960\ndata_path = "{d}/gist_test.local.bin"\n')
        pq_counts(reset=True)
        t0 = time.perf_counter()
        harness.main([path])
        launches = pq_counts()
        missing = [kk for kk in need if launches[kk] == 0]
        check(not missing, f"harness mesh {label}: kernels {missing} launched no time ({launches})")
        out[label] = {"wall_s": time.perf_counter() - t0, "launches": {kk: v for kk, v in launches.items() if v}}
    rl = harness.ResultList.load(f"{d}/mesh_results.toml")
    for label in runs:
        row = rl.results[f"mesh4-{label}"]
        out[label]["points"] = [{"ef": ef, "ms_per_query": t, "recall": r}
                                for ef, t, r in zip(row["ef"], row["search_time"], row["recall"])]
        out[label]["build_seconds"] = row.get("build_seconds")
        log(f"[harness] mesh {SHARDS} {label}: " + ", ".join(
            f"ef {p['ef']} {p['ms_per_query']:.5f} ms/query recall {p['recall']:.4f}" for p in out[label]["points"]))
    check(out["Flat"]["points"][0]["recall"] >= 0.99, f"harness mesh: Flat recall {out['Flat']['points']}")
    return out


# ------------------------------------------------------------ native ----
@contextlib.contextmanager
def no_host_engine():
    """Any call into the native engine's searches fails inside this block."""
    from lab_1806_vec_db_tpu_torch.models import native

    real = native.flat_knn_single, native.hnsw_knn_single

    def refuse(*_):
        fail("a single query on a CUDA table ran on the host engine")

    native.flat_knn_single = native.hnsw_knn_single = refuse
    try:
        yield
    finally:
        native.flat_knn_single, native.hnsw_knn_single = real


def dist64(rows, q, dist):
    """float64 distances of `rows` (m, dim) to one query."""
    import numpy as np

    rows, q = np.asarray(rows, np.float64), np.asarray(q, np.float64)
    if dist == "l2sqr":
        return ((rows - q) ** 2).sum(axis=1)
    return 1.0 - rows @ q / np.maximum(np.linalg.norm(rows, axis=1) * np.linalg.norm(q), 1e-30)


def phase_native(db, key, q_host, gt, n_q=200):
    """Single queries on the seeded l2sqr HNSW table of phase 5, at ef 120 /
    200, both ways: `VecDB.search` on the card (a batch of one through the
    scan route: K1 and K2 launch once a query, the host engine never runs;
    recall@10 >= 0.99, the scan route's gate) and the native engine on the
    table's host rows and links (`native.hnsw_knn_single`: no kernel
    launches; recall@10 within 0.08 of the graph route's on the same
    queries, the CPU test's margin).  µs a search each way."""
    import numpy as np
    from lab_1806_vec_db_tpu_torch.models import native
    from lab_1806_vec_db_tpu_torch.ops import traverse as TR

    index = db._inner._table_mgr(key).obj.inner.inner
    t0 = time.perf_counter()
    native.module()
    out = {"queries": n_q, "engine_load_s": time.perf_counter() - t0}
    for ef in (120, 200):
        db.search(key, q_host[0], 10, ef)  # warm-up
        pq_counts(reset=True)
        with no_host_engine():
            t0 = time.perf_counter()
            res = [db.search(key, q_host[i], 10, ef) for i in range(n_q)]
            t_dev = time.perf_counter() - t0
        dev_launches = pq_counts()
        check(dev_launches["k1"] == n_q and dev_launches["k2"] >= n_q,
              f"single queries on the card: K1 / K2 launched {dev_launches['k1']} / {dev_launches['k2']} "
              f"times for {n_q} queries")
        dev_ids = [[int(m["id"]) for m, _ in row] for row in res]
        check(all(len(r) == 10 for r in dev_ids), "single queries on the card: short result rows")
        pq_counts(reset=True)
        TR.traverse.launches = 0
        t0 = time.perf_counter()
        nat = [native.hnsw_knn_single(index, q_host[i], 10, ef) for i in range(n_q)]
        t_nat = time.perf_counter() - t0
        launched = {kk: v for kk, v in pq_counts().items() if v}
        check(not launched and TR.traverse.launches == 0, f"native: the engine launched kernels {launched}")
        ids = [list(i_) for i_, _ in nat]
        check(all(len(r) == 10 for r in ids), "native: short result rows")
        _, gids = index.knn_with_ef_batch(q_host[:n_q], 10, ef, route="graph")
        rec, grec = recall_at_k(gt[:n_q], ids, 10), recall_at_k(gt[:n_q], gids.tolist(), 10)
        drec = recall_at_k(gt[:n_q], dev_ids, 10)
        check(drec >= 0.99, f"single queries on the card, ef {ef}: recall@10 {drec:.4f} < 0.99")
        check(abs(rec - grec) <= 0.08, f"native ef {ef}: recall@10 {rec:.4f} vs the graph route's {grec:.4f}")
        out[ef] = {"device_us_per_search": t_dev / n_q * 1e6, "device_recall_at_10": drec,
                   "native_us_per_search": t_nat / n_q * 1e6, "native_recall_at_10": rec,
                   "graph_route_recall_at_10": grec, "native_ids_sha1": ids_hash(np.asarray(ids))}
        log(f"[native] ef {ef}: VecDB.search on the card {out[ef]['device_us_per_search']:.0f} µs a search "
            f"(recall@10 {drec:.4f}); native engine {out[ef]['native_us_per_search']:.0f} µs "
            f"(recall@10 {rec:.4f}, graph route {grec:.4f})")
    return out


def check_single_query(db, key, exact, x_host, q_host, n_q=50):
    """Single queries on a Flat table of phase 5, both ways:
    - `VecDB.search` on the card (the exact scan, a batch of one; the host
      engine never runs): its ids equal the exact scan's of the same query,
      element for element;
    - the native engine (`native.flat_knn_single`) on the table's host rows:
      each returned distance within rtol 1e-5 / atol 1e-6 of the float64
      distance of the row it names (f32 sums), and, sorted by float64 distance, its i-th row
      no farther than the i-th of the exact scan's top k + 1 (rtol 1e-6), so
      an id that differs from the exact scan's passes only where the two
      rows' exact distances tie.
    Returns µs a search each way."""
    import numpy as np
    from lab_1806_vec_db_tpu_torch.models import native

    k, dist = 10, exact.dist
    db.search(key, q_host[0], k)  # warm-up
    with no_host_engine():
        t0 = time.perf_counter()
        res = [db.search(key, q_host[i], k) for i in range(n_q)]
        dev_us = (time.perf_counter() - t0) / n_q * 1e6
    for r, row in enumerate(res):
        _, ref = exact.knn_batch(q_host[r : r + 1], k, exact=True)
        check([int(m["id"]) for m, _ in row] == ref[0].tolist(),
              f"{key}: search of query {r} on the card != the exact scan's top-10")
    store = db._inner._table_mgr(key).obj.inner.inner.store
    t0 = time.perf_counter()
    nat = [native.flat_knn_single(store, q_host[i], k) for i in range(n_q)]
    nat_us = (time.perf_counter() - t0) / n_q * 1e6
    _, ref = exact.knn_batch(q_host[:n_q], k + 1, exact=True)
    for r, (ids, d) in enumerate(nat):
        check(len(ids) == k == len(set(ids)), f"{key}: native search of query {r} returned {ids}")
        d_own = dist64(x_host[ids], q_host[r], dist)
        check(np.allclose(d, d_own, rtol=1e-5, atol=1e-6),
              f"{key}: native distances of query {r} {d} vs float64 {d_own.tolist()}")
        mine, best = np.sort(d_own), np.sort(dist64(x_host[ref[r]], q_host[r], dist))[:k]
        bad = np.nonzero(mine > best + 1e-6 * np.abs(best))[0]
        check(len(bad) == 0, f"{key}: native search of query {r} is farther than the exact scan at {bad}: "
                             f"ids {ids} vs {ref[r].tolist()}")
    return dev_us, nat_us


# ---------------------------------------------------------- examples ----
def phase_examples():
    """Each examples/*.py against the port, in a subprocess of its own (all
    four at once): a copy whose `from lab_1806_vec_db_tpu import VecDB`
    names the port, run in a temporary working directory (they write
    ./tmp/...).  Each must exit 0 and print its "Test passed" line."""
    import glob
    import tempfile

    srcs = sorted(glob.glob(os.path.join(HERE, "examples", "*.py")))
    check(len(srcs) == 4, f"examples: found {len(srcs)} scripts")
    work = tempfile.mkdtemp(prefix="vecdb_examples_")
    env = {**os.environ, "PYTHONPATH": HERE}
    procs = {}
    try:
        for src in srcs:
            name = os.path.basename(src)
            with open(src) as f:
                text = f.read()
            check("from lab_1806_vec_db_tpu import VecDB" in text, f"examples: {name} imports no VecDB")
            cwd = os.path.join(work, name[:-3])
            os.makedirs(cwd)
            path = os.path.join(cwd, name)
            with open(path, "w") as f:
                f.write(text.replace("from lab_1806_vec_db_tpu import VecDB", f"from {PKG} import VecDB"))
            procs[name] = subprocess.Popen([sys.executable, path], cwd=cwd, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        out = {}
        for name, proc in procs.items():
            t0 = time.perf_counter()
            text, _ = proc.communicate(timeout=300)
            check(proc.returncode == 0 and "Test passed" in text,
                  f"examples: {name} exited {proc.returncode}:\n{text[-2000:]}")
            out[name] = {"exit": proc.returncode, "wait_s": time.perf_counter() - t0}
            log(f"[examples] {name}: Test passed")
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


# ----------------------------------------------------------- sharded ----
SHARDS = 4  # shards of the sharded cells, every one on cuda:0
SHARDED_PQ_B = 1000  # queries of sharded_pq_flat_200k (its per-shard ADC scan is plain)
SHARDED_IVFPQ_ROWS = 4_000_000  # sharded IVF-PQ rows: the codes phase's 10M cut to keep the smoke short


def card_mesh(n, device="cuda"):
    """A mesh of n shards on one device (`make_mesh(devices=[cuda:0] * n)`)."""
    from lab_1806_vec_db_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cuda:0" if device == "cuda" else device] * n)


def sync(device="cuda"):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def knn_agree(d, i, d_ref, i_ref, tag, rtol=1e-5) -> int:
    """Distances within rtol of the reference's, ids equal except a swap
    between rows whose distances agree within rtol (a tie two computations
    may order apart, or one at the last rank) -> the swaps."""
    import numpy as np

    d, i, d_ref, i_ref = (np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)
                          for x in (d, i, d_ref, i_ref))
    check(d.shape == d_ref.shape and np.allclose(d, d_ref, rtol=rtol, atol=1e-6),
          f"{tag}: distances differ from the reference's beyond rtol {rtol} (largest relative "
          f"difference {float(np.max(np.abs(d - d_ref) / np.maximum(np.abs(d_ref), 1e-30)))})")
    swaps = 0
    for r, c in zip(*np.nonzero(i != i_ref)):
        tie = np.isclose(d_ref[r], d[r, c], rtol=rtol, atol=1e-6)
        check(i[r, c] in i_ref[r][tie] or bool(tie[-1]),
              f"{tag}: id {i[r, c]} at ({r}, {c}) is no tie of the reference's {i_ref[r].tolist()}")
        swaps += 1
    return int(swaps)


def rel_err_f64(rows, q, ids, d) -> float:
    """Largest relative error of returned l2sqr distances d (B, k) against
    the float64 exact distances of q[b] to rows[ids[b, j]] (ids >= 0)."""
    ok = ids >= 0
    v = rows[ids.clamp_min(0).long()].double()
    exact = ((v - q.double()[:, None, :]) ** 2).sum(-1)
    return float(((d.double() - exact).abs() / exact.abs().clamp_min(1e-30))[ok].max())


def sharded_flat_ivf_1m(store, q, gt, nlist=256, device="cuda"):
    """sharded_flat_1m and sharded_ivf_1m on flat_1m's rows (the store's f32
    rows, which the shards view in place), with their 4 -> 2 resize."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import kmeans as KM
    from lab_1806_vec_db_tpu_torch.ops import topk as T
    from lab_1806_vec_db_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, kmeans_step_sharded
    from lab_1806_vec_db_tpu_torch.utils.config import IVFConfig

    n, k, dist = len(store), 10, "l2sqr"
    vecs, cache = store.device()
    rows = vecs[:n]
    d_ref, i_ref = T.knn_scan(q, vecs, cache, n, k, dist)  # the unsharded exact scan
    with scan_mode(store, "bf16") as flat_bf16:
        rec_bf16 = recall_at_k(gt, flat_bf16._knn_device(q, k)[1].cpu().numpy().tolist(), k)
    d_dir = os.path.join(HERE, "tmp", "chip_smoke_sharded")
    shutil.rmtree(d_dir, ignore_errors=True)
    os.makedirs(d_dir)
    flat_out = {"cell": "sharded_flat_1m", "n": n, "batch": q.shape[0], "k": k,
                "single_chip_bf16_recall_at_10": rec_bf16, "meshes": {}}
    try:
        for size in (1, 2, SHARDS):
            t0 = time.perf_counter()
            idx = ShardedFlatIndex(card_mesh(size, device), rows, dist)
            sync(device)
            m = {"place_s": time.perf_counter() - t0,
                 "shard_is_view": idx.base[0].untyped_storage().data_ptr() == vecs.untyped_storage().data_ptr()}
            check(m["shard_is_view"] or device != "cuda", f"sharded_flat_1m {size}: shard 0 is a copy")
            d, i = idx._knn_device(q, k, exact=True)
            m["exact_swaps"] = knn_agree(d, i, d_ref, i_ref, f"sharded_flat_1m {size} exact")
            m["exact"] = chained_qps(lambda qq: idx._knn_device(qq, k, True), q, 3, 3)
            d2, i2 = idx._knn_device(q, k, exact=False)
            m["two_stage_recall_at_10"] = recall_at_k(gt, i2.cpu().numpy().tolist(), k)
            check(m["two_stage_recall_at_10"] >= rec_bf16 - 0.01,
                  f"sharded_flat_1m {size}: two-stage recall {m['two_stage_recall_at_10']:.4f} < "
                  f"single-chip bf16 {rec_bf16:.4f} - 0.01")
            m["two_stage"] = chained_qps(lambda qq: idx._knn_device(qq, k, False), q, 3, 3)
            m["index_bytes"] = idx.index_bytes()
            flat_out["meshes"][size] = m
            log(f"[sharded] flat_1m on {size} shards: exact swaps {m['exact_swaps']}, QPS exact "
                f"{m['exact']['qps_best']:.0f}, two-stage recall {m['two_stage_recall_at_10']:.4f} "
                f"(bf16 single {rec_bf16:.4f}) QPS {m['two_stage']['qps_best']:.0f}")
            if size == SHARDS:
                # resize: a checkpoint without vectors, loaded on 2 shards over the same rows
                path = os.path.join(d_dir, "flat.npz")
                idx.save(path, include_vectors=False)
                idx2 = ShardedFlatIndex.load(path, card_mesh(2, device), external_base=rows)
                d4, i4 = idx._knn_device(q, k)
                flat_out["resize_4_to_2_swaps"] = knn_agree(*idx2._knn_device(q, k), d4, i4,
                                                             "sharded_flat_1m resize 4 -> 2")
                del idx2
            del idx
            torch.cuda.empty_cache() if device == "cuda" else None

        # ---- sharded_ivf_1m ----
        mesh = card_mesh(SHARDS, device)
        t0 = time.perf_counter()
        ivf = ShardedIVFIndex(mesh, rows, dist, IVFConfig(k=nlist, k_means_max_iter=10), seed=0,
                              refine_steps=2)
        sync(device)
        ivf_out = {"cell": "sharded_ivf_1m", "nlist": nlist, "shards": SHARDS, "refine_steps": 2,
                   "build_s": time.perf_counter() - t0}
        # one sharded Lloyd step against the single-device step (the same
        # assignment blocks, partial sums added on one device)
        c = ivf.centroids
        got = kmeans_step_sharded(ivf.base, ivf.n_local, c, dist, mesh)
        a = torch.cat([KM.find_nearest(rows[r0 : r0 + ivf.shard], c, dist)
                       for r0 in range(0, n, ivf.shard)]).long()
        counts = torch.zeros(nlist, device=rows.device).index_add_(0, a, torch.ones(n, device=rows.device))
        sums = torch.zeros((nlist, rows.shape[1]), device=rows.device).index_add_(0, a, rows)
        want = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], c)
        ivf_out["kmeans_step_max_abs_err"] = float((got - want).abs().max())
        check(ivf_out["kmeans_step_max_abs_err"] <= 1e-4,
              f"sharded_ivf_1m: kmeans_step_sharded differs from the single-device step by "
              f"{ivf_out['kmeans_step_max_abs_err']}")
        lmax = [int(p.shape[1]) for p in ivf.posting]
        ivf_out["posting_lmax"] = lmax[0]
        ivf_out["probes"] = {}
        for p in (16, 32):
            t0 = time.perf_counter()
            d, i = ivf._knn_device(q, k, p)
            sync(device)
            first_s = time.perf_counter() - t0
            rec = recall_at_k(gt, i.cpu().numpy().tolist(), k)
            ivf_out["probes"][p] = {"recall_at_10": rec, "first_call_s": first_s,
                                    **chained_qps(lambda qq, p=p: ivf._knn_device(qq, k, p), q, 2, 2)}
        t0 = time.perf_counter()
        d_all, i_all = ivf._knn_device(q, k, nlist)
        sync(device)
        ivf_out["all_probes_s"] = time.perf_counter() - t0
        # both sides against float64 exact on the card: the all-probes
        # distances (list by list), the exact scan's (65,536-row blocks), and
        # the reference's cached-norm formula (`knn_gathered`) on the scan's ids
        d_g, i_g = T.knn_gathered(q, vecs, i_ref, k, dist, cache)
        f64 = {"all_probes": rel_err_f64(rows, q, i_all, d_all), "exact_scan": rel_err_f64(rows, q, i_ref, d_ref),
               "knn_gathered": rel_err_f64(rows, q, i_g, d_g)}
        ivf_out["max_rel_err_vs_f64"] = f64
        log(f"[sharded] ivf_1m: largest relative error against float64 exact: {f64}")
        # list-by-list products round apart from the scan's 65,536-row blocks
        # (q^2 + x^2 - 2 q.x cancels): ties and distances at rtol 1e-4
        ivf_out["all_probes_swaps"] = knn_agree(d_all, i_all, d_ref, i_ref, "sharded_ivf_1m all probes",
                                                rtol=1e-4)
        path = os.path.join(d_dir, "ivf.npz")
        ivf.save(path, include_vectors=False)
        ivf2 = ShardedIVFIndex.load(path, card_mesh(2, device), external_base=rows)
        d16, i16 = ivf._knn_device(q, k, 16)
        ivf_out["resize_4_to_2_swaps"] = knn_agree(*ivf2._knn_device(q, k, 16), d16, i16,
                                                   "sharded_ivf_1m resize 4 -> 2", rtol=1e-4)
        ivf_out["index_bytes"] = ivf.index_bytes()
        log(f"[sharded] ivf_1m: build {ivf_out['build_s']:.1f} s, lmax {lmax}, k-means step err "
            f"{ivf_out['kmeans_step_max_abs_err']:.2e}, " + ", ".join(
                f"{p} probes recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f}"
                for p, v in ivf_out["probes"].items()) + f", all probes exact in {ivf_out['all_probes_s']:.2f} s")
        del ivf, ivf2
    finally:
        shutil.rmtree(d_dir, ignore_errors=True)
    return flat_out, ivf_out


def sharded_200k(x_host, q_host, device="cuda", pq_b=SHARDED_PQ_B, m=320):
    """sharded_hnsw_200k (with its 4 -> 2 rebuild), sharded_pq_flat_200k and
    vecdb_mesh on the hnsw phase's 200,000 rows and queries."""
    import warnings

    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch import VecDB
    from lab_1806_vec_db_tpu_torch.models import PQTable
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import topk as T
    from lab_1806_vec_db_tpu_torch.parallel import ShardedHNSWIndex, ShardedPQFlatIndex
    from lab_1806_vec_db_tpu_torch.utils.config import HNSWConfig, PQConfig

    n, k, dist = len(x_host), 10, "l2sqr"
    x = torch.from_numpy(x_host).to(device)
    q = torch.from_numpy(q_host).to(device)
    cache = D.dist_cache(x, dist)
    d_ref, i_ref = T.knn_scan(q, x, cache, n, k, dist)
    gt = i_ref.cpu().numpy().tolist()
    d_dir = os.path.join(HERE, "tmp", "chip_smoke_sharded200k")
    shutil.rmtree(d_dir, ignore_errors=True)
    os.makedirs(d_dir)
    out = {}
    try:
        # ---- sharded_hnsw_200k ----
        t0 = time.perf_counter()
        hnsw = ShardedHNSWIndex(card_mesh(SHARDS, device), x_host, dist, HNSWConfig(M=16, ef_construction=200),
                                seed=DB_SEED, parallel=True)
        sync(device)
        h = {"cell": "sharded_hnsw_200k", "shards": SHARDS, "M": 16, "ef_construction": 200,
             "build_s": time.perf_counter() - t0, "ef": {}}
        for ef in (120, 200):
            pq_counts(reset=True)
            d, i = hnsw._knn_device(q, k, ef)
            sync(device)
            c = pq_counts()
            rec = recall_at_k(gt, i.cpu().numpy().tolist(), k)
            h["ef"][ef] = {"recall_at_10": rec, "launches": {"k4": c["k4"], "k5": c["k5"]},
                           "ids_sha1": ids_hash(i.cpu().numpy()),
                           **chained_qps(lambda qq, ef=ef: hnsw._knn_device(qq, k, ef), q, 2, 2)}
            check(device != "cuda" or (c["k4"] > 0 and c["k5"] > 0),
                  f"sharded_hnsw_200k ef {ef}: K4 / K5 launched {c['k4']} / {c['k5']} times")
        check(h["ef"][200]["recall_at_10"] >= 0.95,
              f"sharded_hnsw_200k: recall@10 {h['ef'][200]['recall_at_10']:.4f} < 0.95 at ef 200")
        q128 = q[:GATE_Q]
        _, ik = hnsw._knn_device(q128, k, 200)
        pq_counts(reset=True)
        with plain_kernels():
            _, ip = hnsw._knn_device(q128, k, 200)
        plain_counts = pq_counts()
        check(plain_counts["k4"] == 0 == plain_counts["k5"], f"sharded_hnsw_200k: plain run launched {plain_counts}")
        h["kernels_vs_plain_ids_equal"] = bool(torch.equal(ik, ip))
        check(h["kernels_vs_plain_ids_equal"], "sharded_hnsw_200k: ids with K4 / K5 differ from the plain versions'")
        h["profile_ef_200"] = profile_call(lambda: hnsw._knn_device(q, k, 200)) if device == "cuda" else {}
        h["index_bytes"] = hnsw.index_bytes()
        path = os.path.join(d_dir, "hnsw.npz")
        hnsw.save(path, include_vectors=False)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            hnsw2 = ShardedHNSWIndex.load(path, card_mesh(2, device), external_base=x)
        sync(device)
        check(any("rebuild" in str(w.message) for w in caught), "sharded_hnsw_200k: 4 -> 2 load gave no warning")
        check(hnsw2.default_ef == hnsw.default_ef, "sharded_hnsw_200k: the rebuild lost default_ef")
        h["resize_4_to_2"] = {"rebuild_s": time.perf_counter() - t0, "warning": str(caught[0].message),
                              "recall_at_10_ef_200": recall_at_k(gt, hnsw2.knn_with_ef_batch(q, k, 200)[1].tolist(), k)}
        log(f"[sharded] hnsw_200k: build {h['build_s']:.1f} s, " + ", ".join(
            f"ef {ef} recall {v['recall_at_10']:.4f} QPS {v['qps_best']:.0f} K4/K5 {v['launches']}"
            for ef, v in h["ef"].items()) + f"; 4 -> 2 rebuild {h['resize_4_to_2']['rebuild_s']:.1f} s")
        out["sharded_hnsw_200k"] = h
        del hnsw, hnsw2

        # ---- sharded_pq_flat_200k ----
        t0 = time.perf_counter()
        pq = PQTable.train(x, PQConfig(n_bits=4, m=m, dist=dist, k_means_size=10_000, k_means_max_iter=20),
                           seed=DB_SEED)
        sync(device)
        p = {"cell": "sharded_pq_flat_200k", "shards": SHARDS, "m": m, "batch": pq_b, "ef": 200,
             "train_s": time.perf_counter() - t0}
        pqf = ShardedPQFlatIndex(card_mesh(SHARDS, device), x, pq, dist)
        t0 = time.perf_counter()
        d, i = pqf._knn_device(q[:pq_b], k, ef=200)
        sync(device)
        p["search_s"] = time.perf_counter() - t0
        p["recall_at_10"] = recall_at_k(gt[:pq_b], i.cpu().numpy().tolist(), k)
        true = ((x[i.long()] - q[:pq_b, None, :]) ** 2).sum(-1)
        check(bool((i >= 0).all()) and torch.allclose(d, true, rtol=1e-4, atol=1e-3),
              "sharded_pq_flat_200k: returned distances are not the exact ones")
        log(f"[sharded] pq_flat_200k: B {pq_b}, train {p['train_s']:.1f} s, search {p['search_s']:.2f} s, "
            f"recall@10 {p['recall_at_10']:.4f}")
        out["sharded_pq_flat_200k"] = p
        del pqf, pq

        # ---- vecdb_mesh ----
        meta = [{"id": str(r)} for r in range(n)]
        db = VecDB(os.path.join(d_dir, "db"), device=device, seed=DB_SEED, mesh=SHARDS)
        v = {"cell": "vecdb_mesh", "shards": SHARDS, "mesh": str(db._inner.mesh)}
        try:
            db.create_table_if_not_exists("t", x_host.shape[1], dist)
            db.batch_add("t", x_host, meta)
            t0 = time.perf_counter()
            res = db.batch_search("t", q_host, k)
            v["first_batch_search_s"] = time.perf_counter() - t0
            calls = []
            for _ in range(5):
                t0 = time.perf_counter()
                res = db.batch_search("t", q_host, k)
                calls.append(time.perf_counter() - t0)
            v["batch_search_ms_median"] = float(np.median(calls)) * 1e3
            ids = np.array([[int(mm["id"]) for mm, _ in row] for row in res])
            dists = np.array([[dd for _, dd in row] for row in res], np.float32)
            v["swaps_vs_exact"] = knn_agree(dists, ids, d_ref, i_ref, "vecdb_mesh batch_search")
            new = (x_host[7] + 0.5).astype(np.float32)
            db.add("t", new, {"id": "new"})
            found = db.search("t", new, 1)
            check(found == [({"id": "new"}, 0.0)], f"vecdb_mesh: the pushed row came back as {found}")
            v["pushed_row_found_at_0"] = True
        finally:
            db.close()
        log(f"[sharded] vecdb_mesh: batch_search {v['batch_search_ms_median']:.1f} ms (first "
            f"{v['first_batch_search_s']:.2f} s), ids as the exact scan's ({v['swaps_vs_exact']} tie swaps)")
        out["vecdb_mesh"] = v
    finally:
        shutil.rmtree(d_dir, ignore_errors=True)
    return out


def sharded_ivfpq(fill, n, dim, q, gt, single_recall, nlist=2048, device="cuda", n_probes=48, ef=256,
                  sample_rows=25_000, m=320):
    """sharded_ivfpq on the codes phase's row source and queries (its first
    n rows, their exact ground truth `gt`): 4 shards, n_probes 48, ef 256;
    K11 / K7 launches, ids with the kernels = ids with the plain versions
    (128 queries), recall no lower than codes_ivfpq_10m's - 0.05; a 4 -> 2
    re-place within 0.01 of its recall."""
    import torch
    from lab_1806_vec_db_tpu_torch.parallel import ShardedIVFPQIndex
    from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

    k = 10
    t0 = time.perf_counter()
    idx = ShardedIVFPQIndex.from_fill(card_mesh(SHARDS, device), fill, n, dim, "l2sqr", nlist=nlist,
                                      pq_config=PQConfig(n_bits=4, m=m, dist="l2sqr", k_means_size=sample_rows),
                                      sample_rows=sample_rows, seed=0, block_rows=131072, row_gen=fill.row_gen)
    sync(device)
    tag = f"sharded_ivfpq_{n // 1_000_000}m"
    out = {"cell": tag, "n": n, "shards": SHARDS, "nlist": nlist, "n_probes": n_probes,
           "ef": ef, "build_s": time.perf_counter() - t0, "lpad": idx.lpad, "ov_cap": idx.ov_cap,
           "ov_valid": [s.ov_valid for s in idx._subs], "index_bytes": idx.index_bytes()}
    pq_counts(reset=True)
    _, ids = idx._knn_device(q, k, n_probes, ef)
    sync(device)
    c = pq_counts()
    out["launches"] = {"k11": c["k11"], "k7": c["k7"]}
    check(device != "cuda" or (c["k11"] > 0 and c["k7"] > 0), f"{tag}: K11 / K7 launched {c}")
    out.update(codes_point(lambda qq: idx._knn_device(qq, k, n_probes, ef), q, gt, tag,
                           dropped=lambda: sum(int(x) for x in idx.last_dropped)))
    out["single_index_recall_at_10"] = single_recall
    check(out["recall_at_10"] >= single_recall - 0.05,
          f"{tag}: recall {out['recall_at_10']:.4f} < codes_ivfpq_10m's {single_recall:.4f} - 0.05")
    q128 = q[:GATE_Q]
    _, ik = idx._knn_device(q128, k, n_probes, ef)
    pq_counts(reset=True)
    with plain_kernels():
        _, ip = idx._knn_device(q128, k, n_probes, ef)
    plain_counts = pq_counts()
    check(plain_counts["k11"] == 0 == plain_counts["k7"], f"{tag}: plain run launched {plain_counts}")
    out["kernels_vs_plain_ids_equal"] = bool(torch.equal(ik, ip))
    check(out["kernels_vs_plain_ids_equal"], f"{tag}: ids with K11 / K7 differ from the plain versions'")
    if device == "cuda":
        out["profile"] = profile_call(lambda: idx._knn_device(q, k, n_probes, ef))
    d_dir = os.path.join(HERE, "tmp", "chip_smoke_sharded_ivfpq")
    shutil.rmtree(d_dir, ignore_errors=True)
    os.makedirs(d_dir)
    try:
        path = os.path.join(d_dir, "ivfpq.npz")
        idx.save(path)
        del idx
        torch.cuda.empty_cache() if device == "cuda" else None
        t0 = time.perf_counter()
        idx2 = ShardedIVFPQIndex.load(path, card_mesh(2, device), fill=fill, row_gen=fill.row_gen)
        sync(device)
        _, i2 = idx2._knn_device(q, k, n_probes, ef)
        rec2 = recall_at_k(gt, i2.cpu().numpy().tolist(), k)
        out["resize_4_to_2"] = {"load_s": time.perf_counter() - t0, "recall_at_10": rec2}
        check(abs(rec2 - out["recall_at_10"]) <= 0.01,
              f"{tag}: recall on 2 shards {rec2:.4f} vs 4 shards {out['recall_at_10']:.4f}")
        del idx2
    finally:
        shutil.rmtree(d_dir, ignore_errors=True)
    log(f"[sharded] {tag}: build {out['build_s']:.1f} s, lpad {out['lpad']}, ov_cap {out['ov_cap']}, "
        f"recall {out['recall_at_10']:.4f} (single {single_recall:.4f}) QPS {out['qps_best']:.0f}, "
        f"launches {out['launches']}, 4 -> 2 recall {out['resize_4_to_2']['recall_at_10']:.4f} "
        f"in {out['resize_4_to_2']['load_s']:.1f} s")
    return out


def main() -> None:
    global PARENT
    if "--parent" in sys.argv[1:]:
        PARENT = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
        check(os.path.isdir(os.path.join(PARENT, PKG)), f"--parent {PARENT}: no {PKG}/ there")
    if not os.path.isdir(os.path.join(HERE, PKG)):
        fail(f"{PKG}/ not found beside {os.path.basename(__file__)}: run it from a checkout")
    sys.path.insert(0, HERE)
    import torch

    t_start = time.perf_counter()
    card = phase_device()
    build_s, build_log = phase_build()
    # ptxas's figures for the kernels redesigned on wgmma / cp.async, read
    # from this build's report; a name that matches nothing fails the run
    ptxas = {key: ptxas_of(build_log, frag) for key, frag in (
        ("k1", "scan_int8_packed_kernel"), ("k8_ids", "2k810ids_kernel"), ("k8_dense", "dense_onehot_kernel"),
        ("k10", "scan_int8_binned_kernel"), ("k12", "scan_bf16_chunkmin_kernel"),
        ("k13", "scan_int8_bf16_kernelILb0E"), ("k14", "scan_int8_bf16_kernelILb1E"),
        ("k3", "traverse_kernel"), ("k4", "beam_pre_kernel"), ("k5", "beam_post_kernel"),
        ("select", "select_survivors_kernel"), ("k1_u8", "scan_u8_exact_kernel"))}
    for key, rep in ptxas.items():
        check(rep["instantiations"] > 0, f"ptxas: no report for {key} in the build log")
        check(rep["spill_store_bytes"] == 0 == rep["spill_load_bytes"], f"ptxas: {key} spills: {rep}")
    # K1, K13 and K14 keep their wgmmas pipelined; K10's note is recorded only
    for key in ("k1", "k1_u8", "k13", "k14"):
        check(ptxas[key]["serialized"] == 0, f"ptxas: {key}'s wgmmas serialized: {ptxas[key]}")
    k3_occ = k3_occupancy()

    from lab_1806_vec_db_tpu_torch.bench import synth

    x = synth.make_device(200_000, 960, 2, "cuda")
    queries = synth.make_device(1000, 960, 3, "cuda")
    k1_err = phase_k1(x, queries)
    k2_err = phase_k2(x, queries)
    exact_small = {"200k_cosine": exact_small_row(x, x.shape[0], "cosine", 21)}
    resident_cos = phase_resident_cosine(x, queries)
    x_host, q_host = x.cpu().numpy(), queries.cpu().numpy()
    del x, queries
    torch.cuda.empty_cache()
    db_out, launches, hnsw_launches, hm, (pq_out, pq_launches, pm) = phase_vecdb(x_host, q_host)
    print(json.dumps({"phase": "vecdb", "card": card, **db_out}), flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = sharded_200k(x_host, q_host)
    sharded_s = {"200k": time.perf_counter() - t0}
    log(f"[sharded] hnsw_200k + pq_flat_200k + vecdb_mesh: {sharded_s['200k']:.1f} s")
    del x_host
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m, (resident, rm), pq_1m, k7, ivf_1m, k10, (pca, k1_pca), (s_flat, s_ivf) = phase_1m(card)
    sharded.update(sharded_flat_1m=s_flat, sharded_ivf_1m=s_ivf)
    print(json.dumps(m), flush=True)
    print(json.dumps({"phase": "resident", "card": card, "resident_1m": resident,
                      "kernels_vs_plain": {**rm, "cosine_200k": resident_cos}}, default=str), flush=True)
    print(json.dumps({"phase": "pq", "card": card, "flat_pq_1m": pq_1m, **pq_out,
                      "kernels_vs_plain": {"k7_1m": k7, **pm}}, default=str), flush=True)
    print(json.dumps({"phase": "pca", "card": card, **pca}, default=str), flush=True)
    torch.cuda.empty_cache()
    ivf_lean, lean_scan, k2_bf16 = phase_lean(card)
    print(json.dumps({"phase": "ivf", "card": card, "ivf_1m": ivf_1m, "ivf_lean_4m": ivf_lean,
                      "lean_scan_1m": lean_scan,
                      "kernels_vs_plain": {"k10_ivf_1m": k10, "k2_bf16_ivf_lean_4m": k2_bf16}},
                     default=str), flush=True)
    torch.cuda.empty_cache()
    codes, k11, k7s0, s_ivfpq = phase_codes(card)
    sharded[s_ivfpq["cell"]] = s_ivfpq
    sharded_s["ivfpq"] = s_ivfpq["cell_s"]
    print(json.dumps({"phase": "codes", "card": card, **codes,
                      "kernels_vs_plain": {"k11_codes_ivfpq_10m": k11, "k7_codes_pq_10m_stage0": k7s0}},
                     default=str), flush=True)
    torch.cuda.empty_cache()
    u8 = phase_u8()
    print(json.dumps({"phase": "u8", "card": card, **u8, "ptxas": {k: ptxas[k] for k in ("k1", "k1_u8")}},
                     default=str), flush=True)
    torch.cuda.empty_cache()
    harness_out = phase_harness()
    sharded["harness_mesh"] = harness_out.pop("mesh")
    print(json.dumps({"phase": "harness", "card": card, **harness_out}, default=str), flush=True)
    print(json.dumps({"phase": "examples", "card": card, **phase_examples()}, default=str), flush=True)
    sharded.update(shards=SHARDS, mesh=str(card_mesh(SHARDS)), device_count=torch.cuda.device_count(),
                   seconds=sharded_s)
    print(json.dumps({"phase": "sharded", "card": card, **sharded}, default=str), flush=True)
    # the sharded paths' launches of the kernels they reach (ef 200 / n_probes 48)
    s_launch = {"k4": sharded["sharded_hnsw_200k"]["ef"][200]["launches"]["k4"],
                "k5": sharded["sharded_hnsw_200k"]["ef"][200]["launches"]["k5"],
                "k11": s_ivfpq["launches"]["k11"], "k7": s_ivfpq["launches"]["k7"]}

    main_launches = launches["gist_l2"]
    # each error is the largest over every comparison of that kernel with its
    # plain version, the IVF path's own inputs included
    k1_err = max(k1_err, ivf_1m["k1_overflow_err"], ivf_lean["k1_overflow_err"], lean_scan["flat_k1_err"])
    k2_err = max(k2_err, ivf_1m["k2_binned_rerank_err"])
    k10 = {**k10, "max_abs_err": max(k10["max_abs_err"], ivf_lean["k10"]["max_abs_err"], ivf_1m["k10_ragged_err"]),
           "extra": {"ivf_lean_4m": {key: ivf_lean["k10"][key] for key in ("ms", "plain_ms", "bound", "rows")},
                     "ptxas": ptxas["k10"]}}
    k2_bf16 = {**k2_bf16, "max_abs_err": max(k2_bf16["max_abs_err"], lean_scan["flat_k2_bf16_err"])}
    k3b, k4b, k5b = bound_ms(hm["k3_bytes"]), bound_ms(hm["k4_bytes"]), bound_ms(hm["k5_bytes"])
    kernels = [
        {"name": "scan_chunkmin_int8_packed", "route": "cuda",
         "source": f"{PKG}/csrc/scan_int8_packed.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_scan.py:542",
         "launches": main_launches[0], "max_abs_err": k1_err,
         "ms": m["k1_ms"], "plain_ms": m["k1_plain_ms"], "bound_ms": m["k1_bound"][0],
         "bound_by": m["k1_bound"][1], "library_ms": None,
         "ptxas": ptxas["k1"]},
        # K1 on the "pca" route's projected mirror (flat_1m's rows at 256
        # lanes); launches: that route's first batch
        {"name": "scan_chunkmin_int8_packed_pca256", "route": "cuda",
         "source": f"{PKG}/csrc/scan_int8_packed.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_scan.py:542",
         "launches": k1_pca["launches"], "max_abs_err": k1_pca["max_abs_err"],
         "ms": k1_pca["ms"], "plain_ms": k1_pca["plain_ms"], "bound_ms": k1_pca["bound"][0],
         "bound_by": k1_pca["bound"][1], "library_ms": None},
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
         "library_ms": None, "ptxas": ptxas["k3"],
         "occupancy": {k: v for k, v in k3_occ.items() if k.startswith("f32")}},
        # K3 on the lean tier's bf16 rows: lean_graph's route at ef 120
        {"name": "traverse_bf16", "route": "cuda", "source": f"{PKG}/csrc/traverse.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_traverse.py:251",
         "launches": hm["k3_bf16"]["launches"], "max_abs_err": hm["k3_bf16"]["max_abs_err"],
         "ms": hm["k3_bf16"]["ms"], "plain_ms": hm["k3_bf16"]["plain_ms"],
         "bound_ms": hm["k3_bf16"]["bound"][0], "bound_by": hm["k3_bf16"]["bound"][1], "library_ms": None,
         "ptxas": ptxas["k3"], "occupancy": {k: v for k, v in k3_occ.items() if k.startswith("bf16")}},
        {"name": "beam_pre", "route": "cuda", "source": f"{PKG}/csrc/beam_pre.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_beam.py:148",
         "launches": hnsw_launches["k4"], "max_abs_err": hm["k4_err"],
         "ms": hm["k4"][0], "plain_ms": hm["k4"][1], "bound_ms": k4b[0], "bound_by": k4b[1],
         "library_ms": None, "graph_ms": hm["k4_graph_ms"], "pq_graph": pm["k45_graph_k4"],
         "ptxas": ptxas["k4"], "sharded_launches": s_launch["k4"]},
        {"name": "beam_post", "route": "cuda", "source": f"{PKG}/csrc/beam_post.cu",
         "replaces": "lab_1806_vec_db_tpu/ops/pallas_beam.py:257",
         "launches": hnsw_launches["k5"], "max_abs_err": hm["k5_err"],
         "ms": hm["k5"][0], "plain_ms": hm["k5"][1], "bound_ms": k5b[0], "bound_by": k5b[1],
         "library_ms": None, "graph_ms": hm["k5_graph_ms"], "pq_graph": pm["k45_graph_k5"],
         "ptxas": ptxas["k5"], "sharded_launches": s_launch["k5"]},
    ]

    es = exact_small["200k_cosine"]
    kernels.append(
        # no TPU kernel behind it (the JAX package's knn_scan is plain XLA);
        # launches: a FlatIndex.knn search at 1M; timed at 200,000 x 960
        # cosine and (extra) 1M x 960 l2sqr, one query
        {"name": "scan_exact_small", "route": "cuda", "source": f"{PKG}/csrc/scan_exact_small.cu",
         "replaces": None, "launches": m["knn_single"]["exact_small_launches_per_search"],
         "max_abs_err": max(es["max_rel_err_f64"], m["exact_small"]["max_rel_err_f64"]),
         "ms": es["ms"], "plain_ms": es["plain_ms"], "bound_ms": es["bound"][0], "bound_by": es["bound"][1],
         "library_ms": es["library_ms"], "ptxas": ptxas_of(build_log, "11scan_kernelI"),
         "flat_1m_l2sqr": m["exact_small"], "knn_single_1m": m["knn_single"]})
    sel = m["select"]["cell"]
    kernels.append(
        # no TPU kernel behind it (the JAX package's select is lax.approx_min_k);
        # launches: flat_1m's first batch; timed on its survivors at r 40,
        # every other shape under "shapes"
        {"name": "select_survivors", "route": "cuda", "source": f"{PKG}/csrc/select_survivors.cu",
         "replaces": None, "launches": main_launches[2],
         "max_abs_err": max(row["max_abs_err"] for row in m["select"].values()),
         "ms": sel["ms"], "plain_ms": sel["plain_ms"], "bound_ms": sel["bound"][0], "bound_by": sel["bound"][1],
         "library_ms": sel["library_ms"], "ptxas": ptxas["select"],
         "shapes": {**m["select"], "u8_100m": u8["u8_100m"]["select"]}})
    kernels.append(u8_kernel(u8, ptxas["k1_u8"]))

    def pq_kernel(name, src, replaces, launches, meas, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
                "replaces": f"lab_1806_vec_db_tpu/ops/{replaces}", "launches": launches,
                "max_abs_err": meas["max_abs_err"], "ms": meas["ms"], "plain_ms": meas["plain_ms"],
                "bound_ms": meas["bound"][0], "bound_by": meas["bound"][1], "library_ms": library_ms,
                **meas.get("extra", {})}

    k6 = pm["k6"][180]
    kernels += [
        # K6 on the classic loop (hnsw_pq_200k graph, fused=False, ef 180);
        # the error is the largest over ef 180 / 360 / 600; graph_ms
        # replays its captured ef 180 arguments (`classic_graph`: ef 180 / 600)
        pq_kernel("merge_sorted", "merge_sorted.cu", "pallas_merge.py:128",
                  pq_launches["graph_classic"]["k6"],
                  {**k6, "max_abs_err": max(v["max_abs_err"] for v in pm["k6"].values()),
                   "extra": {"graph_ms": pm["k6_graph"][180]["graph_ms"],
                             "library_graph_ms": pm["k6_graph"][180]["library_graph_ms"],
                             "classic_graph": {ef: {f: v[f] for f in ("ms", "graph_ms", "library_graph_ms",
                                                                      "bound", "launches", "score_ms")}
                                               for ef, v in pm["k6_graph"].items()}}},
                  k6["library_ms"]),
        # K7 on flat_pq_1m's first search (ef 100); measured there at 1M rows
        pq_kernel("adc_chunkmin", "adc_scan_chunkmin.cuh", "pallas_adc.py:415",
                  pq_1m[100]["launches"]["k7"], {**k7, "extra": {**k7.get("extra", {}),
                                                                 "sharded_launches": s_launch["k7"]}}),
        # K8 ids inside the fused loop (hnsw_pq_200k graph, ef 180)
        pq_kernel("adc_sums_ids_k16", "adc_sums.cu", "pallas_adc.py:253",
                  pq_launches["graph"]["k8_ids"],
                  {**pm["k8_ids"], "extra": {**pm["k8_ids"]["extra"],
                                             "ptxas": ptxas["k8_ids"]}}),
        # K8 dense on the 60,000-row Flat+PQ table at ef 600
        pq_kernel("adc_sums_dense_k16", "adc_sums.cu", "pallas_adc.py:253",
                  pq_launches["k8_dense"],
                  {**pm["k8_dense"], "extra": {**pm["k8_dense"]["extra"],
                                               "ptxas": ptxas["k8_dense"]}}),
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
        pq_kernel("adc_chunkmin_binned", "adc_chunkmin_binned.cuh", "pallas_adc.py:629",
                  codes["codes_ivfpq_10m"]["launches"]["k11"],
                  {**k11, "max_abs_err": max(k11["max_abs_err"], codes["cosine_300k"]["k11_max_abs_err"]),
                   "extra": {**k11.get("extra", {}), "sharded_launches": s_launch["k11"]}}),
        # K7 at stage 0 of codes_pq_10m's first knn_batch (10M coarse rows,
        # m 32); the error also over the overflow segment and the cosine codes
        pq_kernel("adc_chunkmin_codes_stage0", "adc_scan_chunkmin.cuh", "pallas_adc.py:415",
                  codes["codes_pq_10m"]["launches"]["k7"],
                  {**k7s0, "max_abs_err": max(k7s0["max_abs_err"], codes["cosine_300k"]["k7_cosine_max_abs_err"],
                                              codes["codes_ivfpq_10m"].get("k7_overflow", {}).get("max_abs_err", 0.0))}),
    ]
    # K12-K14 on the resident phase's entry points (flat_1m's rows, B = 1000);
    # checked and timed there, the error also over the cosine 200,000 rows
    for name, src, replaces, key in (("scan_chunkmin", "scan_bf16_chunkmin.cu", "pallas_scan.py:81", "k12"),
                                     ("scan_dist_int8", "scan_int8_bf16.cu", "pallas_scan.py:171", "k13"),
                                     ("scan_chunkmin_int8_t", "scan_int8_bf16.cu", "pallas_scan.py:286", "k14")):
        kernels.append(pq_kernel(name, src, replaces, resident["launches"][key],
                                 {**rm[key], "max_abs_err": max(rm[key]["max_abs_err"],
                                                                resident_cos[key]["max_abs_err"]),
                                  "extra": {"ptxas": ptxas[key], **({"graph_ms": rm[key]["graph_ms"]}
                                                                   if "graph_ms" in rm[key] else {})}}))
    log(f"total {time.perf_counter() - t_start:.1f} s (build {build_s:.1f} s)")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
