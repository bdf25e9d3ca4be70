"""Time the ADC kernels at the smoke's shapes on one NVIDIA GPU.

    python3 lab_1806_vec_db_tpu_torch/bench/time_adc.py [label] [k1] [k2] [k3] [k4] [k5] [k6] [k7] [k8] [k9] [k10] [k11] [k12] [k13] [k14]

(the named kernels only; all fourteen without a name).

Run from the root of a checkout (it imports the package found there, so a
second checkout, such as a parent commit unpacked with `git archive`, is
timed by running this file from that checkout's root).  On random codes and
LUTs it times, with CUDA events (three means of five launches each):

- K7 at flat_pq_1m's shape: 1,000,000 rows x 1000 queries, m 320, chunk 32,
  and its survivors against the plain version;
- K7 at codes_pq_10m's stage 0: 10,000,000 rows x 1000 queries, m 32,
  chunk 32;
- K11 at codes_ivfpq_10m's shape (when the checkout has it): 2048 lists x
  7,680 rows, qb 64 with 10-39 filled columns a list, lists 3,000-7,680 rows
  long, m 320, chunk 16, against the plain version on the filled columns;
- K9 at the 8-bit scan's shape: 1000 LUT rows (bf16, m 320, k 256) x one
  131,072-row block, and its ids shape: 1000 queries x 128 candidates of a
  200,000-row table, 10% of the ids -1;
- K8 at its ids shape (1000 x 128, m 320, k 16, bf16, packed codes), at
  codes_pq_10m's pool width (1000 x 2048 of a 10,000,000-row table) and
  dense shape (1000 x 60,000, int8 LUT);
- K1 (the packed int8 chunk-min scan; not an ADC kernel, timed here so that
  one script serves every redesigned kernel) at flat_1m's shape, 1000
  queries against 1,000,000 mirror rows of 1024 int8 lanes (padded to
  1,001,472 rows), and at the 8,765- and 69,856-row overflow segments of
  ivf_1m and ivf_lean_4m;

- K10 (the binned int8 group-min; timed here for the same reason) at
  ivf_1m's shape, 256 lists x 4,608 rows of 1024 int8 lanes x 128-query bins
  of 1000 queries, and at ivf_lean_4m's, 1024 lists x 5,120 rows, random
  bins (empty slots and one list no query probes), equal to its plain
  version; and untimed at the ragged widths 96 and 1040 (the second streams
  its gathered query boxes);
- K12 (the bf16 chunk-min) on Gist-spectrum rows (`synth.make_device`, the
  smoke's seeds): 1000 queries x 1,000,000 rows x 960 lanes (l2sqr), timed
  and held against the plain version (survivors outside rtol 1e-5 / atol
  1e-6, ids that differ); untimed at cosine on 200,000 rows, at B 50, at
  width 1344 (both query halves streamed) and at width 40;
- K13 and K14 (the int8 bf16-epilogue scans) on the Gist-spectrum rows of
  K12's timing, quantized to int8 with their raw channels, at resident_1m's
  shapes: 1,000,000 rows x 960 lanes (l2sqr) x 1000 queries (K13) or the
  1024 its entry point pads them to (K14), timed and held against the
  plain version (torch.equal, K14's ids too); untimed at cosine on 200,000
  rows, on a ragged 70,000-row base with n_valid 69,500 and B 50, at
  widths 96 and 1040 (the second streams its query boxes), both metrics,
  and with channels spread over f32's range (`int8_edge_case`);
- K4 and K5 (the fused lock-step beam body; timed here for the same reason)
  at the HNSW+PQ graph route's shapes: B 1000, E 4, EL 128, R 256, W 256
  (ef 180) and W 1024 (ef 600), on states shaped like a loop iteration's;
- K6 (the classic loop's merge) at its ef 180 and 600 shapes: B 1000, EL
  128, on `beam_states.merge_state`, with its library line (stable
  torch.sort + gather) replayed from a CUDA graph too, and untimed on
  `beam_states`' edge cases and at ef + EL = 8,192 (`k6_edge_checks`);
- K3 (the whole level-0 search) on one seeded HNSW graph of hnsw_200k's
  shape (`k3_graph`: 200,000 x 960 Gist-spectrum rows, M 16,
  ef_construction 200, the smoke's seeds; 1000 queries from the greedy
  descent's entries) at ef 120 / 200 / 360 over the f32 rows and over the
  lean tier's bf16 rows of the same graph, each with its byte bound (the
  novel rows `traversal_stats` counts), its ptxas registers and CTAs per
  SM, held to its plain version (`k3_check`); then untimed on random
  graphs (`k3_edge_checks`, which the smoke runs too);
- K2 (the rerank gather) at the smoke's shape, 1000 x 40 ids (10% -1) of
  those 200,000 rows, f32 and bf16, back to back and replayed;

each K1 / K4 / K5 / K6 / K8 / K9 / K10 result against its plain version (torch.equal,
the plain version timed beside it), and prints each kernel's registers from the
build.  K1, K4-K6, K13, K14 and the K8 / K9 ids shapes are also timed replayed from a CUDA graph
("graph ms"): at a few tens of microseconds a call's host work (argument
checks, the launch plan, ctypes) outlasts the kernel, and back-to-back
launches then time the host.
"""

from __future__ import annotations

import inspect
import os
import sys
import time


def _ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device ms of `fn` replayed from a CUDA graph of `reps` calls
    (after one call on a side stream): the launches without the host's
    per-call work, which for a kernel of a few tens of microseconds is
    longer than the kernel.  Also chip_smoke.py's K4 / K5 timer."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch
    from lab_1806_vec_db_tpu_torch.ops import _build
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    if not torch.cuda.is_available():
        sys.exit("time_adc: no CUDA device")
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    which = set(sys.argv[2:]) or {"k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "k9", "k10", "k11", "k12",
                                  "k13", "k14"}
    _build.library()
    print(label, "build s", round(_build.build_info["seconds"], 1))
    log = _build.build_info["log"].splitlines()
    for i, ln in enumerate(log[:-1]):
        if "Function properties for" in ln and any(f in ln for f in ("chunkmin", "adc_sums", "k9", "k8",
                                                                       "scan_int8_packed", "binned", "beam_p",
                                                                       "scan_int8_bf16", "merge_sorted", "gather_dists")):
            print("  ", ln.split("for ")[-1][:90], "|", log[i + 1].strip()[:60], "|",
                  log[i + 2].strip()[:70] if i + 2 < len(log) else "")
    g = torch.Generator(device="cuda").manual_seed(0)
    has_chunk = "chunk" in inspect.signature(A.adc_chunkmin).parameters

    def lut(m):
        lookup = torch.rand((1000, m, 16), generator=g, device="cuda")
        cb = torch.rand((m, 16), generator=g, device="cuda") + 0.1
        qn = torch.rand(1000, generator=g, device="cuda") + 0.5
        return A.chunkmin_inputs(lookup, cb, "l2sqr", True, m // 2), qn

    for m, N in ((320, 1_000_000), (32, 10_000_000)) if "k7" in which else ():
        codes = torch.randint(0, 256, (N, m // 2), generator=g, device="cuda", dtype=torch.uint8)
        (lut_q, sc, cs_q, cs_s), qn = lut(m)
        S = -(-N // 256) * 256 // 32
        args = (codes, lut_q, sc, qn, cs_q, cs_s, N, True, S) + ((32,) if has_chunk else ())
        times = [_ms(lambda: A.adc_chunkmin(*args)) for _ in range(3)]
        equal = ""
        if m == 320:
            got, ref = A.adc_chunkmin(*args), A.adc_chunkmin_ref(*args)
            equal = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        print(label, f"K7 N {N} m {m} chunk 32: ms {[round(t, 3) for t in times]} equal {equal}", flush=True)
        del codes
    if "k1" in which:
        _time_k1(label, g)
    if which & {"k2", "k3"}:
        _time_k23(label, which)
    if which & {"k4", "k5"}:
        _time_k45(label, which)
    if "k10" in which:
        _time_k10(label, g)
    if "k12" in which:
        _time_k12(label)
    if which & {"k13", "k14"}:
        _time_k1314(label, which)
    if "k6" in which:
        _time_k6(label)
    if "k9" in which:
        _time_sums(label, g, 256, False, torch.bfloat16, 131_072, 200_000)
    if "k8" in which:
        _time_sums(label, g, 16, True, torch.int8, 60_000, 200_000)
        _time_pool(label, g)
    if "k11" in which and hasattr(A, "adc_chunkmin_binned"):
        nl, lpad, qb, m = 2048, 7680, 64, 320
        codes = torch.randint(0, 256, (nl * lpad, m // 2), generator=g, device="cuda", dtype=torch.uint8)
        (lut_q, sc, cs_q, cs_s), qn = lut(m)
        lens = torch.randint(3000, lpad + 1, (nl,), generator=g, device="cuda", dtype=torch.int32)
        filled = torch.randint(10, 40, (nl,), generator=g, device="cuda")
        bins = torch.randint(0, 1000, (nl, qb), generator=g, device="cuda", dtype=torch.int32)
        bins = torch.where(torch.arange(qb, device="cuda")[None] < filled[:, None], bins, -1).int()
        args = (codes, lut_q, sc, qn, cs_q, cs_s, lens, bins, lpad, True, 16)
        times = [_ms(lambda: A.adc_chunkmin_binned(*args)) for _ in range(3)]
        got, ref = A.adc_chunkmin_binned(*args), A.adc_chunkmin_binned_ref(*args)
        f = bins >= 0
        equal = torch.equal(got[0][f], ref[0][f]) and torch.equal(got[1][f], ref[1][f])
        print(label, f"K11 {nl} x {lpad} qb {qb} m {m} chunk 16: ms {[round(t, 3) for t in times]} "
              f"equal {equal}", flush=True)


def _time_k1(label, g, B=1000, D=1024):
    """K1 on random int8 rows and queries with positive channels, at
    flat_1m's 1,000,000 rows and the 8,765- and 69,856-row overflow
    segments of ivf_1m and ivf_lean_4m (each padded to whole 2048-row
    chunks once, outside the timing), against its plain version."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import scan as S

    q8 = torch.randint(-127, 128, (B, D), generator=g, device="cuda", dtype=torch.int8)
    qs2 = torch.rand(B, generator=g, device="cuda") * 1e-2
    qc = torch.rand(B, generator=g, device="cuda") * 100
    for n in (1_000_000, 8765, 69_856):
        base = torch.randint(-127, 128, (n, D), generator=g, device="cuda", dtype=torch.int8)
        sc = torch.rand(n, generator=g, device="cuda") * 1e-3
        ca = torch.rand(n, generator=g, device="cuda") * 100
        args = (q8, qs2, qc) + S._pad_rows(base, sc, ca, S._NB)
        del base
        times = [_ms(lambda: S.scan_chunkmin_int8_packed(*args), 10) for _ in range(3)]
        plain = _ms(lambda: S.scan_chunkmin_int8_packed_ref(*args), 1)
        equal = torch.equal(S.scan_chunkmin_int8_packed(*args), S.scan_chunkmin_int8_packed_ref(*args))
        print(label, f"K1 N {n} (padded {args[3].shape[0]}) D {D} B {B}: ms {[round(t, 4) for t in times]} "
              f"graph ms {graph_ms(lambda: S.scan_chunkmin_int8_packed(*args)):.4f} plain {plain:.3f} "
              f"equal {equal}", flush=True)
        del args
        torch.cuda.empty_cache()


def k3_graph(n=200_000, dim=960, B=1000):
    """The seeded HNSW graph of hnsw_200k's shape: `synth.make_device`
    Gist-spectrum rows (seed 2, the smoke's table) and queries (seed 3), M
    16, ef_construction 200, levels from seed 0 -> (index, queries)."""
    from lab_1806_vec_db_tpu_torch.bench import synth
    from lab_1806_vec_db_tpu_torch.models import VecStore
    from lab_1806_vec_db_tpu_torch.models.hnsw import HNSWIndex
    from lab_1806_vec_db_tpu_torch.utils.config import HNSWConfig

    x = synth.make_device(n, dim, 2, "cuda")
    q = synth.make_device(B, dim, 3, "cuda")
    index = HNSWIndex.build_from_store(VecStore.from_device(x, "l2sqr"),
                                       HNSWConfig(M=16, ef_construction=200), seed=0)
    return index, q


def k3_check(q, base, links0, cur, ef, dist, E=4, R=None, iters=None):
    """K3 against its plain version on one set of inputs, at the graph
    route's budgets for ef unless R / iters are given -> (results, K3 call,
    plain call).  The results: the share of ids equal to the plain
    version's, the distances of equal ids within rtol 1e-5 (the plain
    version sums in another order), K3's distances K2's bits for the same
    rows, and K3 equal bit for bit to the plain loop (K4 / K5's plain
    versions) run on K2's distances."""
    import torch
    from lab_1806_vec_db_tpu_torch.models.hnsw import _budgets
    from lab_1806_vec_db_tpu_torch.ops import beam as BM
    from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import traverse as TR

    L = links0.shape[1]
    iters = _budgets(ef)[0] if iters is None else iters
    R = min(_budgets(ef)[1], 256) if R is None else R
    kw = dict(E=E, R=R, max_iters=iters, dist=dist)
    k3 = lambda: TR.traverse(q, base, links0, cur, ef, L, **kw)
    k3_ref = lambda: TR.traverse_ref(q, base, links0, cur, ef, L, **kw)
    (dk, ik), (dr, ir) = k3(), k3_ref()
    nd = lambda ids: G.gather_dists(q, base, ids, dist)
    dl, il = BM.lockstep(cur, nd, lambda ids: links0[ids.long()], ef, iters, E, R, BF.beam_pre_ref,
                         BF.beam_post_ref)
    torch.cuda.synchronize()
    same = ik == ir
    fin = same & (ik >= 0)
    a, r = dk[fin].double(), dr[fin].double()
    res = {"ids_equal_share": float(same.float().mean()), "ids_all_equal": bool(same.all()),
           "max_abs_err": float((a - r).abs().max()) if a.numel() else 0.0,
           "max_rel_err": float(((a - r).abs() / r.abs().clamp_min(1e-30)).max()) if a.numel() else 0.0,
           "rtol_1e-5": bool(torch.allclose(dk[fin], dr[fin], rtol=1e-5, atol=0.0)),
           "k2_bits": bool(torch.equal(G.gather_dists(q, base, ik, dist)[ik >= 0], dk[ik >= 0])),
           "equal_to_loop_on_k2": bool(torch.equal(ik, il) and torch.equal(dk.view(torch.int32),
                                                                          dl.view(torch.int32)))}
    return res, k3, k3_ref


# the random graphs of `k3_edge_checks`: (name, dim, rows dtype, dist, E,
# ef, R, links "dup" / "neg" / "dupneg" / "", padding queries)
K3_EDGE_CASES = (
    [(f"E{E}_{dist}_{dt}", 960, dt, dist, E, 128, 256, "dupneg", True)
     for dist in ("l2sqr", "cosine") for dt in ("f32", "bf16") for E in (1, 2, 4, 8)]
    + [(f"ef{ef}_{dt}", 960, dt, "l2sqr", 4, ef, 256, "", False)
       for ef in (1, 129, 1000, 4096) for dt in ("f32", "bf16")]
    + [(f"R{R}", 960, "bf16", "l2sqr", 4, 200, R, "dup", True) for R in (4, 5, 100, 256)]
    + [(f"dim{dim}_{dist}_{dt}", dim, dt, dist, 4, 200, 256, "neg", True)
       for dim in (100, 98) for dist in ("l2sqr", "cosine") for dt in ("f32", "bf16")])


def k3_edge_checks(n=20_000, B=64) -> dict:
    """K3 against its plain version (`k3_check`) on random graphs of n
    rows, one per `K3_EDGE_CASES` entry: every E / L the kernel takes, ef
    1 to 4096 (W = MAX_W), R from E to 256, duplicate-heavy and -1 links,
    padding queries, and dims 100 (the 4-lane loads' partial last step)
    and 98 (the scalar path), both metrics, f32 and bf16 rows ->
    {name: results}.  A case is "ok" when K3 equals the plain loop on K2's
    distances bit for bit, its distances are K2's bits, and equal ids'
    distances are within rtol 1e-5 of the plain version's; the share of
    ids equal to the plain version's is reported: on Gaussian rows of dim
    960 a deep beam (ef 1000) holds rows whose distances two summation
    orders put in either order."""
    import numpy as np
    import torch

    out = {}
    for k, (name, dim, dt, dist, E, ef, R, links, pad) in enumerate(K3_EDGE_CASES):
        rng = np.random.default_rng(100 + k)
        L = 128 // E
        x = rng.standard_normal((n, dim)).astype(np.float32) + (0.5 if dist == "cosine" else 0.0)
        lk = rng.integers(0, n // 200 if "dup" in links else n, (n, L)).astype(np.int32)
        if "neg" in links:
            lk[rng.random((n, L)) < 0.25] = -1
        cur = rng.integers(0, n, B).astype(np.int32)
        if pad:
            cur[::9] = -1
        q = torch.from_numpy(rng.standard_normal((B, dim)).astype(np.float32)).cuda()
        base = torch.from_numpy(x).cuda()
        base = base.to(torch.bfloat16) if dt == "bf16" else base
        r, _, _ = k3_check(q, base, torch.from_numpy(lk).cuda(), torch.from_numpy(cur).cuda(), ef, dist, E, R)
        r["ok"] = r["equal_to_loop_on_k2"] and r["k2_bits"] and r["rtol_1e-5"]
        out[name] = r
    return out


def _time_k23(label, which, B=1000):
    """K3 on `k3_graph` at ef 120 / 200 / 360 over its f32 rows and over
    the lean tier's bf16 rows of the same graph (timed and held to its
    plain version, the plain version timed once), with its byte bound and
    CTAs per SM, and the graph route's wall QPS (`knn_with_ef_batch`,
    host clock); `k3_edge_checks`; K2 at the smoke's shape on both row
    types."""
    import torch
    from lab_1806_vec_db_tpu_torch.models import VecStore
    from lab_1806_vec_db_tpu_torch.models.hnsw import _budgets, links_rows
    from lab_1806_vec_db_tpu_torch.ops import _build
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import traverse as TR

    index, q = k3_graph(B=B)
    full = index.store
    x = full.device()[0][: len(full)]
    lean = VecStore.from_device_blocks(lambda r0, r: x[r0 : r0 + r], len(full), full.dim, "l2sqr",
                                       device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log = _build.build_info["log"].splitlines()
    for i, ln in enumerate(log[:-2]):
        if "Function properties for" in ln and "traverse_kernel" in ln:
            print(label, "K3 ptxas", "bf16" if "It" in ln.split("traverse_kernel")[-1][:3] else "f32", "|",
                  log[i + 1].strip(), "|", log[i + 2].strip(), flush=True)
    for tag, store in (("f32", full), ("bf16", lean)):
        base = store.device_rerank()
        links0 = links_rows(index._links0_device(), base.shape[0])
        cur = index._descend(q, lambda ids: G.gather_dists(q, base, ids, "l2sqr"))
        index.store = store
        try:
            for ef in (120, 200, 360) if "k3" in which else ():
                res, k3, k3_ref = k3_check(q, base, links0, cur, ef, "l2sqr")
                rows = float(index.traversal_stats(q.cpu().numpy(), 10, ef)[2].mean())
                bound = B * rows * base.element_size() * base.shape[1] / 3.35e12 * 1e3
                times = [round(_ms(k3, 5), 4) for _ in range(3)]
                occ = ""
                if hasattr(TR, "k3_plan"):
                    smem = TR.k3_plan(ef, min(_budgets(ef)[1], 256), base.shape[1])[1]
                    ctas = TR.ctas_per_sm(smem, tag == "bf16")
                    occ = f"smem {smem} CTAs/SM {ctas} waves {-(-B // (ctas * sms))} "
                print(label, f"K3 {tag} ef {ef} B {B}: ms {times} plain {_ms(k3_ref, 1):.2f} bound {bound:.4f} "
                      f"(rows/query {rows:.1f}) {occ}check {res}", flush=True)
                # the graph route's wall QPS (host clock, synchronous batches): a report
                q_host = q.cpu().numpy()
                index.knn_with_ef_batch(q_host, 10, ef, route="graph")
                rounds = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    for _ in range(4):
                        index.knn_with_ef_batch(q_host, 10, ef, route="graph")
                    rounds.append(time.perf_counter() - t0)
                print(label, f"graph route ({tag} rows) ef {ef}: QPS best {4 * B / min(rounds):.0f} "
                      f"median {4 * B / sorted(rounds)[1]:.0f}", flush=True)
        finally:
            index.store = full
        if "k2" in which:
            g = torch.Generator(device="cuda").manual_seed(7)
            ids = torch.randint(0, len(full), (B, 40), generator=g, device="cuda", dtype=torch.int32)
            ids[torch.rand((B, 40), generator=g, device="cuda") < 0.1] = -1
            k2 = lambda: G.gather_dists(q, base, ids, "l2sqr")
            d, ref = k2(), G.gather_dists_ref(q, base, ids, "l2sqr")
            ok = bool(torch.allclose(d[ids >= 0], ref[ids >= 0], rtol=1e-5, atol=1e-6))
            print(label, f"K2 {tag} {B} x 40: ms {[round(_ms(k2, 20), 4) for _ in range(3)]} graph ms "
                  f"{[round(graph_ms(k2, 50), 4) for _ in range(3)]} close {ok}", flush=True)
    if "k3" in which:
        edge = k3_edge_checks()
        print(label, "K3 edge cases ok:", {k: v["ok"] for k, v in edge.items()}, "ids equal shares:",
              {k: round(v["ids_equal_share"], 4) for k, v in edge.items()}, flush=True)
        bad = {k: v for k, v in edge.items() if not v["ok"]}
        if bad:
            print(label, "K3 edge cases failing:", bad, flush=True)


def _time_k45(label, which, B=1000, E=4, EL=128, R=256, N=200_000):
    """K4 / K5 at the HNSW+PQ graph route's shapes (ef 180 -> W 256, ef
    600 -> W 1024) on `beam_states.loop_state`, back to back and replayed
    from a CUDA graph, against their plain versions."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.bench import beam_states
    from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF

    rng = np.random.default_rng(0)
    for ef, W in ((180, 256), (600, 1024)):
        state = beam_states.loop_state(rng, B, W, R, EL, E, ef, N)
        beam_d, beam_i, beam_e, ring, selq, nbrs, nd, nids = (torch.from_numpy(a).cuda() for a in state)
        calls = {"k4": (lambda: BF.beam_pre(beam_i, ring, selq, nbrs, E),
                        lambda: BF.beam_pre_ref(beam_i, ring, selq, nbrs, E)),
                 "k5": (lambda: BF.beam_post(beam_d, beam_i, beam_e, nd, nids, ef, E),
                        lambda: BF.beam_post_ref(beam_d, beam_i, beam_e, nd, nids, ef, E))}
        for key in sorted(which & calls.keys()):
            kern, plain = calls[key]
            equal = all(torch.equal(a, b) for a, b in zip(kern(), plain()))
            times = [round(_ms(kern, 20), 4) for _ in range(3)]
            print(label, f"{key.upper()} ef {ef} W {W} B {B} EL {EL} R {R} E {E}: ms {times} graph ms "
                  f"{[round(graph_ms(kern, 50), 4) for _ in range(3)]} plain {_ms(plain, 5):.4f} equal {equal}",
                  flush=True)


def _time_k10(label, g, B=1000):
    """K10 on random int8 rows and queries (10% pad rows with the losing
    sentinel), bins filling 30-100 of a list's 128 slots with random
    queries (list 0 probed by none), against its plain version: timed at
    ivf_1m's and ivf_lean_4m's shapes, untimed at widths 96 and 1040."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import scan_binned as SB

    for nlist, lpad, D, timed in ((256, 4608, 1024, True), (1024, 5120, 1024, True), (8, 1024, 96, False),
                                  (8, 1024, 1040, False)):
        rows = nlist * lpad
        q8 = torch.randint(-127, 128, (B, D), generator=g, device="cuda", dtype=torch.int8)
        qs2 = torch.rand(B, generator=g, device="cuda") * 1e-2
        qc = torch.rand(B, generator=g, device="cuda") * 100
        base = torch.randint(-127, 128, (rows, D), generator=g, device="cuda", dtype=torch.int8)
        pad = torch.rand(rows, generator=g, device="cuda") < 0.1
        sc = torch.where(pad, 0.0, torch.rand(rows, generator=g, device="cuda") * 1e-3)
        ca = torch.where(pad, 3.0e38, torch.rand(rows, generator=g, device="cuda") * 100)
        bins = torch.randint(0, B, (nlist, SB.QB), generator=g, device="cuda", dtype=torch.int32)
        filled = torch.randint(30, SB.QB + 1, (nlist, 1), generator=g, device="cuda")
        filled[0] = 0
        bins = torch.where(torch.arange(SB.QB, device="cuda")[None] < filled, bins, -1).int()
        args = (q8, qs2, qc, bins, base, sc, ca, lpad)
        equal = torch.equal(SB.scan_chunkmin_int8_binned(*args), SB.scan_chunkmin_int8_binned_ref(*args))
        times, plain = "untimed", ""
        if timed:
            times = [round(_ms(lambda: SB.scan_chunkmin_int8_binned(*args), 10), 4) for _ in range(3)]
            plain = f" plain {_ms(lambda: SB.scan_chunkmin_int8_binned_ref(*args), 1):.3f}"
        print(label, f"K10 {nlist} x {lpad} D {D} B {B}: ms {times}{plain} equal {equal}", flush=True)
        del base, args
        torch.cuda.empty_cache()


def _k12_errors(got, ref):
    """(survivors outside rtol 1e-5 / atol 1e-6 of the plain version's,
    largest relative error, ids that differ); +inf survivors must match."""
    import torch

    fin = torch.isfinite(ref[0])
    if not (torch.equal(fin, torch.isfinite(got[0])) and torch.equal(got[0][~fin], ref[0][~fin])):
        return "inf differs", None, None
    err = (got[0] - ref[0]).abs()[fin]
    over = int((err > 1e-6 + 1e-5 * ref[0].abs()[fin]).sum())
    return over, float((err / ref[0].abs()[fin].clamp_min(1e-30)).max()), int((got[1] != ref[1]).sum())


def _time_k12(label, B=1000):
    """K12 on the smoke's Gist-spectrum rows (uniform rows at widths 1344
    and 40) against its plain version: timed at flat_1m's l2sqr shape,
    checked there and at cosine 200,000, B 50 and widths 1344 and 40."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench import synth
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR

    cases = ((1_000_000, 960, B, 4, 5, "l2sqr", True), (200_000, 960, B, 2, 3, "cosine", False),
             (100_000, 960, 50, 6, 7, "l2sqr", False), (20_000, 1344, 300, 8, 9, "cosine", False),
             (20_000, 40, 300, 10, 11, "l2sqr", False))
    for n, dim, b, sx, sq, dist, timed in cases:
        if dim == 960:
            x, q = synth.make_device(n, dim, sx, "cuda"), synth.make_device(b, dim, sq, "cuda")
        else:  # the Gist spectrum has 960 lanes: uniform rows elsewhere
            g = torch.Generator(device="cuda").manual_seed(sx)
            x, q = torch.rand((n, dim), generator=g, device="cuda"), torch.rand((b, dim), generator=g, device="cuda")
        base, cache = x.to(torch.bfloat16), D.dist_cache(x, dist)
        del x
        qb, qc = q.to(torch.bfloat16), D.dist_cache(q, dist)
        args = (qb, qc, base, cache, n, dist)
        ref = SR.scan_chunkmin_ref(qb, qc, *SR._pad_rows(SR._NB, base, cache), n, dist)
        plain = f" plain {_ms(lambda: SR.scan_chunkmin_ref(qb, qc, *SR._pad_rows(SR._NB, base, cache), n, dist), 1):.2f}" if timed else ""
        over, max_rel, ids = _k12_errors(SR.scan_chunkmin(*args), ref)
        times = [round(_ms(lambda: SR.scan_chunkmin(*args), 5), 3) for _ in range(3)] if timed else "untimed"
        print(label, f"K12 {dist} {n} x {dim} B {b}: ms {times}{plain} outside tol {over} max rel {max_rel} "
              f"ids differ {ids}", flush=True)
        del base, cache, ref, args
        torch.cuda.empty_cache()


def int8_case(x, q, dist, k14):
    """K13 / K14's operands from f32 rows x and queries q: int8 rows and
    queries with their raw channels (`quantize_rows_int8`'s scales, the
    cache |v|^2 or |v|), the queries padded to a multiple of 128 for K14 as
    its entry point pads them.  Returns (the kernel's arguments without
    n_valid and dist, the plain version's, its rows padded to N_pad)."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import distance as D
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR
    from lab_1806_vec_db_tpu_torch.ops import topk as T

    if k14:
        q = torch.cat([q, q.new_zeros((-q.shape[0] % 128, q.shape[1]))])
    b8, bsc = T.quantize_rows_int8(x)
    q8, qsc = T.quantize_rows_int8(q)
    args = (q8, qsc, D.dist_cache(q, dist), b8, bsc, D.dist_cache(x, dist))
    return args, args[:3] + SR._pad_rows(SR._NB_T if k14 else SR._NB, *args[3:])


def int8_edge_case(n, dim, B, seed, k14):
    """K13 / K14's arguments (as `int8_case`) on uniform int8 rows and
    queries with channels spread over f32's range: scales 10^U(-25, 19) (so
    products reach bf16's largest values and its subnormals), caches
    10^U(-40, 18) (f32 subnormals included), a tenth of each zero; no
    combination yields a NaN.  B is padded to a multiple of 128 for K14."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B = -(-B // 128) * 128 if k14 else B

    def chan(m, lo, hi):
        v = 10.0 ** (torch.rand(m, generator=g, device="cuda", dtype=torch.float64) * (hi - lo) + lo)
        return torch.where(torch.rand(m, generator=g, device="cuda") < 0.1, 0.0, v).float()

    q8 = torch.randint(-127, 128, (B, dim), generator=g, device="cuda", dtype=torch.int8)
    b8 = torch.randint(-127, 128, (n, dim), generator=g, device="cuda", dtype=torch.int8)
    return (q8, chan(B, -25, 19), chan(B, -40, 18), b8, chan(n, -25, 19), chan(n, -40, 18))


def _time_k1314(label, which, B=1000):
    """K13 / K14 on the smoke's Gist-spectrum rows (uniform rows at widths
    96 and 1040) against their plain versions: timed at resident_1m's shape
    (back to back and replayed from a CUDA graph), checked there and at
    cosine 200,000, a ragged 70,000-row base (n_valid 69,500, B 50) and
    widths 96 and 1040 on both metrics."""
    import torch
    from lab_1806_vec_db_tpu_torch.bench import synth
    from lab_1806_vec_db_tpu_torch.ops import scan_resident as SR

    cases = [(1_000_000, 960, B, 4, 5, "l2sqr", None, True), (200_000, 960, B, 2, 3, "cosine", None, False)]
    cases += [(n, dim, b, sx, sx + 1, dist, nv, False) for dist in ("l2sqr", "cosine")
              for n, dim, b, sx, nv in ((70_000, 960, 50, 6, 69_500), (20_000, 96, 300, 8, None),
                                        (20_000, 1040, 300, 10, None))]
    for n, dim, b, sx, sq, dist, nv, timed in cases:
        if dim == 960:
            x, q = synth.make_device(n, dim, sx, "cuda"), synth.make_device(b, dim, sq, "cuda")
        else:  # the Gist spectrum has 960 lanes: uniform rows elsewhere
            g = torch.Generator(device="cuda").manual_seed(sx)
            x, q = torch.rand((n, dim), generator=g, device="cuda"), torch.rand((b, dim), generator=g, device="cuda")
        nv = n if nv is None else nv
        for key, fn, ref in (("k13", SR.scan_dist_int8, SR.scan_dist_int8_ref),
                             ("k14", SR.scan_chunkmin_int8_t, SR.scan_chunkmin_int8_t_ref)):
            if key not in which:
                continue
            args, pargs = int8_case(x, q, dist, key == "k14")
            got, want = fn(*args, nv, dist), ref(*pargs, nv, dist)
            got, want = (got, want) if key == "k14" else ((got,), (want,))
            equal = all(a.shape == w.shape and torch.equal(a, w) for a, w in zip(got, want))
            del got, want
            times = "untimed"
            if timed:
                times = (f"{[round(_ms(lambda: fn(*args, nv, dist), 5), 3) for _ in range(3)]} graph ms "
                         f"{[round(graph_ms(lambda: fn(*args, nv, dist), 5), 3) for _ in range(2)]} "
                         f"plain {_ms(lambda: ref(*pargs, nv, dist), 1):.2f}")
            print(label, f"{key.upper()} {dist} {n} x {dim} B {args[0].shape[0]} n_valid {nv}: ms {times} "
                  f"equal {equal}", flush=True)
            del args, pargs
            torch.cuda.empty_cache()
        del x, q
        torch.cuda.empty_cache()
    for dist in ("l2sqr", "cosine"):  # channels across f32's range, untimed
        for key, fn, ref in (("k13", SR.scan_dist_int8, SR.scan_dist_int8_ref),
                             ("k14", SR.scan_chunkmin_int8_t, SR.scan_chunkmin_int8_t_ref)):
            if key not in which:
                continue
            args = int8_edge_case(20_000, 96, 300, 13, key == "k14")
            pargs = args[:3] + SR._pad_rows(SR._NB_T if key == "k14" else SR._NB, *args[3:])
            got, want = fn(*args, 19_990, dist), ref(*pargs, 19_990, dist)
            got, want = (got, want) if key == "k14" else ((got,), (want,))
            equal = all(a.shape == w.shape and torch.equal(a, w) for a, w in zip(got, want))
            print(label, f"{key.upper()} {dist} edge channels 20000 x 96 B {args[0].shape[0]} n_valid 19990: "
                  f"equal {equal}", flush=True)


def k6_library(beam_d, beam_i, beam_e, nd, nids):
    """K6's library line: one stable torch.sort of [beam, tile] and the id
    gather (the flags' gather left out)."""
    import torch

    ef = beam_d.shape[1]
    d, pos = torch.sort(torch.cat([beam_d, nd], 1), dim=1, stable=True)
    return d[:, :ef], torch.gather(torch.cat([beam_i, nids], 1), 1, pos[:, :ef])


def k6_edge_checks() -> dict:
    """K6 against its plain version on the card on every
    `beam_states.MERGE_EDGE_CASES` draw, at the widest shapes (ef + EL =
    8,192, `MERGE_WIDE_SHAPES`) and on the "ties" draw with every operand 4
    bytes past a 16-byte boundary (the kernel's 4-byte lanes): {name: equal},
    d compared as its bits (NaN lanes count), i and e with torch.equal."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.bench import beam_states
    from lab_1806_vec_db_tpu_torch.ops import merge as M

    def shifted(t):  # the same values, 4 bytes past an aligned allocation
        buf = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8, device=t.device)
        out = buf[4:4 + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
        out.copy_(t)
        return out

    runs = [(c, c, None, False) for c in beam_states.MERGE_EDGE_CASES]
    runs += [("x".join(map(str, s)), "ties", s, False) for s in beam_states.MERGE_WIDE_SHAPES]
    runs.append(("ties_unaligned", "ties", None, True))
    out = {}
    for name, case, shape, shift in runs:
        st = [torch.from_numpy(a).cuda() for a in
              beam_states.merge_edge_state(np.random.default_rng(len(case)), case, shape)]
        if shift:
            st = [shifted(t) for t in st]
        got, want = M.merge_sorted(*st), M.merge_sorted_ref(*st)
        out[name] = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                     and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))
    return out


def _time_k6(label, B=1000, EL=128, N=200_000):
    """K6 at the classic loop's ef 180 and 600 shapes on
    `beam_states.merge_state`, back to back and replayed from a CUDA graph,
    against its plain version and its library line (`k6_library`, replayed
    from a CUDA graph too); then `k6_edge_checks` (untimed)."""
    import numpy as np
    import torch
    from lab_1806_vec_db_tpu_torch.bench import beam_states
    from lab_1806_vec_db_tpu_torch.ops import merge as M

    rng = np.random.default_rng(6)
    for ef in (180, 600):
        st = [torch.from_numpy(a).cuda() for a in beam_states.merge_state(rng, B, ef, EL, N)]
        kern, plain = (lambda: M.merge_sorted(*st)), (lambda: M.merge_sorted_ref(*st))
        equal = all(torch.equal(a, b) for a, b in zip(kern(), plain()))
        print(label, f"K6 ef {ef} B {B} EL {EL}: ms {[round(_ms(kern, 20), 4) for _ in range(3)]} graph ms "
              f"{[round(graph_ms(kern, 50), 4) for _ in range(3)]} plain {_ms(plain, 5):.4f} library graph ms "
              f"{graph_ms(lambda: k6_library(*st), 20):.4f} equal {equal}", flush=True)
    print(label, "K6 edge cases equal:", k6_edge_checks(), flush=True)


def _time_pool(label, g, B=1000, C=2048, m=320, n_table=10_000_000):
    """K8's ids shape at codes_pq_10m's stage-1 pool: 1000 queries x 2048
    candidates of a 10,000,000-row packed table, bf16 LUT."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    codes = torch.randint(0, 256, (n_table, m // 2), generator=g, device="cuda", dtype=torch.uint8)
    lut = torch.rand((B, m, 16), generator=g, device="cuda").to(torch.bfloat16)
    ids = torch.randint(0, n_table, (B, C), generator=g, device="cuda", dtype=torch.int32)
    args = (codes, lut, ids, m, True)
    times = [_ms(lambda: A.adc_sums_ids(*args), 10) for _ in range(3)]
    plain = _ms(lambda: A.adc_sums_ids_ref(*args, False), 1)
    equal = torch.equal(A.adc_sums_ids(*args), A.adc_sums_ids_ref(*args, False))
    print(label, f"K8 ids {B} x {C} (pool) m {m}: ms {[round(t, 4) for t in times]} graph ms "
          f"{graph_ms(lambda: A.adc_sums_ids(*args)):.4f} plain {plain:.3f} equal {equal}", flush=True)


def _time_sums(label, g, k, packed, dense_dtype, n_dense, n_table, m=320, B=1000):
    """K8 (k 16) or K9 (k 256): the dense shape on n_dense rows with a
    dense_dtype LUT, the ids shape at C 128 on an n_table-row table with a
    bf16 LUT; each equal to its plain version."""
    import torch
    from lab_1806_vec_db_tpu_torch.ops import adc as A

    cw = m // 2 if packed else m
    codes = torch.randint(0, 256, (n_table, cw), generator=g, device="cuda", dtype=torch.uint8)
    rows = torch.rand((B, m, k), generator=g, device="cuda")
    lut, scales = A.round_lut(rows, "int8" if dense_dtype == torch.int8 else "bf16")
    dense = (codes[:n_dense], lut, scales, m, packed)
    times = [_ms(lambda: A.adc_sums_dense(*dense), 3) for _ in range(3)]
    equal = torch.equal(A.adc_sums_dense(*dense), A.adc_sums_dense_ref(*dense))
    print(label, f"K{9 if k == 256 else 8} dense {B} x {n_dense} m {m} k {k} {lut.dtype}: "
          f"ms {[round(t, 3) for t in times]} equal {equal}", flush=True)
    ids = torch.randint(0, n_table, (B, 128), generator=g, device="cuda", dtype=torch.int32)
    ids[torch.rand((B, 128), generator=g, device="cuda") < 0.1] = -1
    lut_b = rows.to(torch.bfloat16)
    args = (codes, lut_b, ids, m, packed)
    times = [_ms(lambda: A.adc_sums_ids(*args), 20) for _ in range(3)]
    equal = torch.equal(A.adc_sums_ids(*args), A.adc_sums_ids_ref(*args, False))
    print(label, f"K{9 if k == 256 else 8} ids {B} x 128 m {m} k {k}: "
          f"ms {[round(t, 4) for t in times]} graph ms {graph_ms(lambda: A.adc_sums_ids(*args)):.4f} "
          f"equal {equal}", flush=True)


if __name__ == "__main__":
    main()
