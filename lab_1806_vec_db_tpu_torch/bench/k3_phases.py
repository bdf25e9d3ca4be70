"""Where K3's time goes, on one NVIDIA GPU: ptxas's registers and spills,
CTAs per SM and waves at B = 1000, and clock64() counters per phase of its
loop, summed over a query's iterations.

    python3 lab_1806_vec_db_tpu_torch/bench/k3_phases.py [label] [efs] [variants]

Run from the root of a checkout: it instruments that checkout's
`csrc/traverse.cu` (this tree's, or a parent's unpacked with `git archive`:
both layouts of the kernel are known), builds the copy with nvcc into the
package's git-ignored `_build/k3_phases/`, and runs it on `time_adc.k3_graph`
(the hnsw_200k-shaped graph, 1000 queries) over f32 and bf16 rows at each ef
(default 120,200,360), after checking its ids and distances against the
package's own K3.  The shipped source has no switch: the counters exist only
in the copy.  Thread 0 reads the clock at each phase boundary; a phase that
ends on a barrier includes the wait for the slowest warp, and "score wait"
is warp 0's wait for the others.  Then K2's rate of random row reads on
those rows (G rows/s, TB/s).  `variants` (this tree only) also builds
copies with other rows-at-once / load-step constants, `name:NR_bf16:U_bf16:
NR_f32:U_f32[,...]`, and times them without counters.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

# the earlier kernel (a bitonic merge, W beam lanes): boundaries after the links read, the
# dedup, the ring shift, warp 0's rows, the barrier, and the sort + select
OLD_MARKS = [
    ("      nbrs[t] = s >= 0 ? links0[static_cast<size_t>(s) * L + j] : -1;\n    }\n    __syncthreads();\n", 0),
    ("    const int count = vecdb::dedup_compact(nbrs, TILE, kid, W, ring, R, comp, TILE, warp_tot);\n", 1),
    ("    for (int j = t; j < R; j += THREADS) ring_next[j] = j < E ? sel[j] : ring[j - E];\n", 2),
    ("      if (lane == 0) td[j] = d;\n    }\n", 3),
    ("      if (lane == 0) td[j] = d;\n    }\n    __syncthreads();\n", 4),
    ("    vecdb::remask_select(kd, kre, kid, W, ef, E, sel, warp_tot);\n", 5),
]
OLD_NAMES = ["links", "dedup", "ring shift", "score (warp 0)", "score wait", "merge + select"]
# this tree's kernel: boundaries after the links and the set, the fresh
# lanes' compaction (with the ring shift), warp 0's rows, the barrier, and
# the merge by rank + select
NEW_MARKS = [
    ("      atomicMin(tlane + tslot, t);\n    }\n    __syncthreads();\n", 0),
    ("    if (fresh) comp[off + __popc(fm & ((1u << lane) - 1u))] = id;\n    __syncthreads();\n", 1),
    ("        tkey[r0 + lane] = (static_cast<unsigned long long>(vecdb::order_key(dl)) << 32) | (r0 + lane);\n"
     "      }\n    }\n", 2),
    ("        tkey[r0 + lane] = (static_cast<unsigned long long>(vecdb::order_key(dl)) << 32) | (r0 + lane);\n"
     "      }\n    }\n    __syncthreads();\n", 3),
    ("                 tsd, td, comp, count, ef, E, sel, wt + WARPS, set, n_set);\n", 4),
]
NEW_NAMES = ["links + set", "fresh + compaction + ring", "score (warp 0)", "score wait", "merge + select"]
NR_RE = re.compile(r"  constexpr int NR = sizeof\(T\) == 2 \? \d+ : \d+;\n  constexpr int U = sizeof\(T\) == 2 \? \d+ : \d+;\n")


def _tick(k: int) -> str:
    return f"    k3c1 = clock64(); k3acc[{k}] += k3c1 - k3c0; k3c0 = k3c1;\n"


def instrument(src: str) -> tuple[str, bool, list[str]]:
    """(the instrumented source, whether it is this tree's layout, phase
    names).  Adds a `long long* prof` argument: per query the phases'
    cycles, then iterations at [6] and novel rows at [7]."""
    new = "const Layout lay" in src
    marks = NEW_MARKS if new else OLD_MARKS
    for m, k in marks:
        assert m in src, f"k3_phases: marker not found: {m!r}"
    # the longer marker of a pair first (its prefix is the other one)
    for m, k in sorted(marks, key=lambda mk: -len(mk[0])):
        src = src.replace(m, m + _tick(k), 1)
    loop = "    if (!any) break;  // uniform: sel is in shared memory, synced\n"
    src = src.replace(loop, loop + "    ++k3it;\n    k3c0 = clock64();\n", 1)
    src = src.replace("  for (int it = 0; it < max_iters; ++it) {\n",
                      "  long long k3acc[6] = {0, 0, 0, 0, 0, 0}, k3c0 = 0, k3c1;\n  int k3it = 0, k3rows = 0;\n"
                      "  for (int it = 0; it < max_iters; ++it) {\n", 1)
    cnt = "    if (fresh) comp[off + __popc(fm & ((1u << lane) - 1u))] = id;\n" if new else \
        "    const int count = vecdb::dedup_compact(nbrs, TILE, kid, W, ring, R, comp, TILE, warp_tot);\n"
    src = src.replace(cnt, cnt + "    k3rows += count;\n", 1)
    out = "  for (int j = t; j < ef; j += THREADS) {\n    out_d[b * ef + j]"
    src = src.replace(out, "  if (t == 0) {\n    for (int k = 0; k < 6; ++k) prof[b * 8 + k] = k3acc[k];\n"
                           "    prof[b * 8 + 6] = k3it;\n    prof[b * 8 + 7] = k3rows;\n  }\n" + out, 1)
    if new:
        pairs = [("int max_iters, int flags, const Layout lay) {", "int max_iters, int flags, const Layout lay, long long* prof) {"),
                 ("n_rows, L, ef, R, E, max_iters, flags, lay);", "n_rows, L, ef, R, E, max_iters, flags, lay, prof);"),
                 ("int max_iters, int flags, const Layout& lay, void* stream) {",
                  "int max_iters, int flags, const Layout& lay, void* stream, long long* prof) {"),
                 ("int log2_set, long long smem, int flags, void* stream) {",
                  "int log2_set, long long smem, int flags, void* stream, long long* prof) {"),
                 ("max_iters, flags, lay, stream)", "max_iters, flags, lay, stream, prof)")]
    else:
        pairs = [("int L, int ef, int W, int R, int E, int max_iters, int flags) {",
                  "int L, int ef, int W, int R, int E, int max_iters, int flags, long long* prof) {"),
                 ("n_rows, L, ef, W, R, E, max_iters, flags);", "n_rows, L, ef, W, R, E, max_iters, flags, prof);"),
                 ("int max_iters, int flags, size_t smem, void* stream) {",
                  "int max_iters, int flags, size_t smem, void* stream, long long* prof) {"),
                 ("int flags, void* stream) {\n  if (B <= 0)", "int flags, void* stream, long long* prof) {\n  if (B <= 0)"),
                 ("max_iters, flags, smem, stream)", "max_iters, flags, smem, stream, prof)")]
    for a, b in pairs:
        assert a in src, f"k3_phases: signature not found: {a!r}"
        src = src.replace(a, b)
    src += """
extern "C" int k3_phases_ctas_per_sm(int bf16, long long smem, int* ctas) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(traverse_kernel<uint16_t>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaFuncSetAttribute(traverse_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return bf16 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, traverse_kernel<uint16_t>, THREADS, smem)
              : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, traverse_kernel<float>, THREADS, smem);
}
"""
    return src, new, NEW_NAMES if new else OLD_NAMES


def build(src: str, out_dir: str, csrc: str):
    """nvcc the source into out_dir/lib.so -> (ctypes library, ptxas lines)."""
    from lab_1806_vec_db_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "traverse.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, "lib.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", csrc, "-o", so, path],
                         capture_output=True, text=True)
    log = (res.stdout + res.stderr).splitlines()
    if res.returncode != 0:
        raise RuntimeError("k3_phases: nvcc failed:\n" + "\n".join(log))
    ptxas = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(so), ptxas


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import importlib.util

    import torch
    from lab_1806_vec_db_tpu_torch.models import VecStore
    from lab_1806_vec_db_tpu_torch.models.hnsw import _budgets, links_rows
    from lab_1806_vec_db_tpu_torch.ops import _build
    from lab_1806_vec_db_tpu_torch.ops import gather as G
    from lab_1806_vec_db_tpu_torch.ops import traverse as TR

    if not torch.cuda.is_available():
        sys.exit("k3_phases: no CUDA device")
    # time_adc.py beside this file (a parent's checkout may predate its K3
    # timer); its functions use the checkout's package
    spec = importlib.util.spec_from_file_location(
        "k3_time_adc", os.path.join(os.path.dirname(os.path.abspath(__file__)), "time_adc.py"))
    TA = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(TA)
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    efs = [int(e) for e in (sys.argv[2] if len(sys.argv) > 2 else "120,200,360").split(",")]
    variants = [v.split(":") for v in sys.argv[3].split(",")] if len(sys.argv) > 3 else []
    print(label, subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip(), flush=True)
    _build.library()
    csrc = _build.CSRC
    with open(os.path.join(csrc, "traverse.cu")) as f:
        src = f.read()
    root = os.path.join(_build.BUILD_DIR, "k3_phases", label)
    libs = {}
    isrc, new, names = instrument(src)
    libs["instrumented"], ptxas = build(isrc, os.path.join(root, "instrumented"), csrc)
    log = _build.build_info["log"].splitlines()
    print(label, "K3 ptxas (the shipped source):", [log[i + k].strip() for i, ln in enumerate(log[:-2])
                                                     if "Function properties for" in ln and "traverse_kernel" in ln
                                                     for k in (1, 2)], flush=True)
    print(label, "instrumented copy ptxas:", ptxas, flush=True)
    for name, nrb, ub, nrf, uf in variants:
        assert new and NR_RE.search(src), "k3_phases: variants need this tree's kernel"
        vsrc = NR_RE.sub(f"  constexpr int NR = sizeof(T) == 2 ? {nrb} : {nrf};\n"
                         f"  constexpr int U = sizeof(T) == 2 ? {ub} : {uf};\n", src)
        libs[name], ptxas = build(vsrc, os.path.join(root, name), csrc)
        print(label, f"variant {name} (bf16 NR {nrb} U {ub}, f32 NR {nrf} U {uf}) ptxas:", ptxas, flush=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for key, lib in libs.items():
        tail = [P, P] if key == "instrumented" else [P]
        lib.vecdb_traverse.argtypes = ([P] * 6 + [I, I, L] + [I] * 6 + [L, I] + tail if new else
                                       [P] * 6 + [I, I, L] + [I] * 7 + tail)
    libs["instrumented"].k3_phases_ctas_per_sm.argtypes = [I, L, P]

    index, q = TA.k3_graph()
    full = index.store
    x = full.device()[0][: len(full)]
    lean = VecStore.from_device_blocks(lambda r0, r: x[r0 : r0 + r], len(full), full.dim, "l2sqr",
                                       device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 0)
    B, dim = q.shape
    for rows, store in (("f32", full), ("bf16", lean)):
        base = store.device_rerank()
        links0 = links_rows(index._links0_device(), base.shape[0])
        cur = index._descend(q, lambda ids: G.gather_dists(q, base, ids, "l2sqr"))
        bf16 = rows == "bf16"
        for ef in efs:
            iters, ring = _budgets(ef)
            R, W = min(ring, 256), TR._widths(ef)
            if new:
                log2_set, smem = TR.k3_plan(ef, R, dim)
                flags = TR.k3_flags(base, dim, "l2sqr")
                plan = [R, 4, iters, log2_set, smem, flags]
            else:
                smem = 4 * (((dim + 3) & ~3) + 6 * W + 2 * R + 3 * 128 + 128 + 8)
                flags = 2 | (4 if bf16 else 0)
                plan = [W, R, 4, iters, flags]
            ctas = ctypes.c_int(0)
            libs["instrumented"].k3_phases_ctas_per_sm(int(bf16), smem, ctypes.byref(ctas))
            dk, ik = TR.traverse(q, base, links0, cur, ef, 32, E=4, R=R, max_iters=iters)
            prof = torch.zeros((B, 8), dtype=torch.int64, device="cuda")
            for key, lib in libs.items():
                od = torch.empty((B, ef), device="cuda")
                oi = torch.empty((B, ef), dtype=torch.int32, device="cuda")
                extra = [prof.data_ptr()] if key == "instrumented" else []
                call = lambda: lib.vecdb_traverse(q.data_ptr(), base.data_ptr(), links0.data_ptr(), cur.data_ptr(),
                                                  od.data_ptr(), oi.data_ptr(), B, dim, base.shape[0], 32, ef, *plan,
                                                  torch.cuda.current_stream().cuda_stream, *extra)
                status = call()
                torch.cuda.synchronize()
                same = status == 0 and torch.equal(oi, ik) and torch.equal(od, dk)
                ms = [round(TA._ms(call, 5), 4) for _ in range(3)]
                print(label, f"K3 {rows} ef {ef} {key}: ms {ms}, equal to the package's K3 {same}", flush=True)
            p = prof.double().cpu().numpy()
            it, tot = p[:, 6], p[:, :6].sum(1)
            print(label, f"K3 {rows} ef {ef}: smem {smem} B, {ctas.value} CTAs/SM, "
                  f"{-(-B // max(ctas.value * sms, 1))} wave(s) at B {B}; iterations {it.mean():.1f} (max "
                  f"{it.max():.0f}), novel rows {p[:, 7].mean():.1f} a query; cycles a query {tot.mean():.0f}, "
                  f"an iteration {tot.sum() / it.sum():.0f} (SM clock {clock_khz} kHz)", flush=True)
            for k, name in enumerate(names):
                print(label, f"    {name:26s} {p[:, k].sum() / it.sum():9.0f} cycles an iteration "
                      f"{100 * p[:, k].sum() / tot.sum():5.1f}%", flush=True)

    # K2's rate of random row reads (B x 512 ids a call), over the whole
    # table and over its first 20,000 rows (38-77 MB: L2 holds most)
    g = torch.Generator(device="cuda").manual_seed(1)
    for rows, base in (("bf16", lean.device_rerank()), ("f32", x)):
        for n in (len(full), 20_000):
            ids = torch.randint(0, n, (B, 512), generator=g, device="cuda", dtype=torch.int32)
            ms = min(TA._ms(lambda: G.gather_dists(q, base, ids, "l2sqr"), 10) for _ in range(3))
            print(label, f"K2 gather {rows} rows, ids of {n} rows: {ms:.4f} ms, {ids.numel() / ms / 1e6:.3f} "
                  f"G rows/s, {ids.numel() * dim * base.element_size() / ms / 1e9:.3f} TB/s", flush=True)


if __name__ == "__main__":
    main()
