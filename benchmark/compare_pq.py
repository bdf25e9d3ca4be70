"""The program's Flat+PQ search against the plain reference
(`reference_pq.py`) at a cell's widths, on the card.

    python3 benchmark/compare_pq.py --workload gist1m_pq.b1000 --seed <n> [--queries 1000] [--efs 200,100]

builds the cell's system from the seed (its entry: the rows, the index, the
table as the cell trains it), takes the first `--queries` queries of the
cell's pool, and for each ef prints one JSON line:

- `codes_differ`: the program's codes that are not the reference's encode
  (nearest centroid in float64), and `codes_tie_gap`, the widest gap, as a
  share of the group's largest distance, between the two centroids of such
  a code (a tie within float32's rounding reads ~1e-7);
- `lut_differ`: the program's int8 lookup entries that are not the
  reference's rounding of its own float64 lookup;
- on the program's own codes and int8 lookup, the reference's chunk plan
  against the program's K7 candidates: `not_chunk_min` (candidates that are
  not their chunk's ADC minimum under the table's permutation), `adc_rtol`
  (the widest relative gap of a candidate's ADC distance), `chunks_not_kept`
  (candidates whose chunk is not among the reference's best max(ef, k),
  ties at the last place counted as kept);
- `rerank_differ`: answers that are not the reference's exact rerank of the
  program's candidates (ids; `rerank_differ_past_ties` leaves out those
  whose exact distances tie within 1e-6 relative), `rerank_rtol`;
- recall@k against the exact top-k (`reference.exact_topk`) of the program,
  of the reference's chunk plan and of the upstream's row plan (each on the
  reference's own codes and lookup), and `program_vs_own_plan`, the share
  of the program's answers that the reference's plan of the program's route
  returns (the chunk plan, or the row plan under the int8 lookup).

The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import core, reference, reference_pq as R  # noqa: E402


def recall(ids, truth) -> float:
    """The share of `ids`' rows that `truth`'s rows hold, a query at a time."""
    hits = (ids[:, :, None] == truth[:, None, :]).any(2)
    return float(hits.double().mean())


def program_lut(pq, queries, k_out: int):
    """The program's lookup for `queries` at `k_out`, and the same as the
    reference reads it -> (lookup, q_norms, lut, `R.Lut`): K7's int8
    operands (`PQTable.scan_lookup`), or where the table takes the dense sums,
    their rounding (`ops/adc.py:round_lut`, with the cosine |c|^2 row)."""
    from lab_1806_vec_db_tpu_torch.ops import adc as A
    from lab_1806_vec_db_tpu_torch.ops import pq as P

    B, m = queries.shape[0], pq.config.m
    lookup, q_norms, lut = pq.scan_lookup(queries, k_out)
    if lut is None:
        col = P.centroid_sqnorm_cache(pq.device()[1]) if pq.config.dist == "cosine" else None
        q8, scales = A.round_lut(lookup if col is None else torch.cat([lookup, col[None]]), "int8")
        column = () if col is None else (q8[B], float(scales[B]))
        return lookup, q_norms, None, R.Lut(q8[:B].double(), scales[:B], q_norms, *column)
    lut_q, scales, cs_q, cs_scale = lut
    column = None if cs_q is None else cs_q[: m * 16].reshape(m, 16)
    return lookup, q_norms, lut, R.Lut(lut_q[:, : m * 16].reshape(B, m, 16).double(), scales, q_norms, column,
                                       float(cs_scale))


def compare(system, rows, queries, k: int, ef: int) -> dict:
    """One ef's JSON line (the module's doc): `system` is the entry's
    (`index`, `pq`), rows (n, dim) and queries (B, dim) on its device."""
    import numpy as np

    pq, index = system.pq, system.index
    dev = rows.device
    B, n = queries.shape[0], rows.shape[0]
    k_out = max(ef, k)
    out = {"ef": ef, "queries": B, "k7": pq.takes_k7(k_out)}
    q = queries.to(dev)
    lookup, q_norms, lut, prog_lut = program_lut(pq, q, k_out)
    d, cand = pq.adc_scan(lookup, q_norms, k_out, lut=lut)
    got_d, got_i = index.knn_pq_batch(queries.cpu().numpy(), k, ef, pq)
    got_i = torch.from_numpy(got_i).long().to(dev)
    got_d = torch.from_numpy(got_d).double().to(dev)

    table = R.Table(pq.codebooks, pq.dim, pq.config.dist, pq.rotation, pq.center, device=dev)
    codes = torch.from_numpy(pq.codes.astype(np.int64)).to(dev)
    ref_codes = table.encode(rows)
    diff = (ref_codes != codes).nonzero()
    out["codes_differ"] = int(len(diff))
    gap = 0.0
    for r, g in diff[:1000].tolist():
        s, e = table.groups[g]
        x = table.transform(rows[r : r + 1])[0, s:e]
        c = table.codebooks[g, :, : e - s]
        dd = ((x - c) ** 2).sum(-1) if table.dist == "l2sqr" else 1 - (c @ x) / (c.norm(dim=1) * x.norm()).clamp_min(1e-10)
        gap = max(gap, float(dd[codes[r, g]] - dd[ref_codes[r, g]]) / float(dd.max()))
    out["codes_tie_gap"] = gap
    truth = reference.exact_topk(rows, q, k, table.dist)[1]
    out["recall_program"] = recall(got_i, truth)

    out["lut_differ"] = int((prog_lut.values != R.Lut.of(table, q, rounded=True).values).sum())
    if lut is not None:
        ref = R.chunk_plan(table, rows, q, k, ef, codes=codes, lut=prog_lut)
        perm = pq.device_scan()[1].long()
        inv = torch.empty(n, dtype=torch.int64, device=dev)
        inv[perm] = torch.arange(n, device=dev)
        cand = cand.long()
        pos = inv[cand.clamp_min(0)]
        chunk = pos // R.CHUNK
        minima = torch.gather(ref["minima"], 1, chunk)
        out["not_chunk_min"] = int((torch.gather(ref["min_pos"], 1, chunk) != pos).sum())
        out["adc_rtol"] = float(((d.double() - minima).abs() / minima.abs().clamp_min(1e-30)).max())
        kept = (chunk[:, :, None] == ref["chunks"][:, None, :]).any(2) | (minima == ref["cand_adc"][:, -1:])
        out["chunks_not_kept"] = int((~kept).sum())
    want_d, want_i = R.rerank(rows, q, cand.long(), k, table.dist)
    off = got_i != want_i
    out["rerank_differ"] = int(off.sum())
    exact_got = reference.distances(rows, q, torch.arange(B, device=dev), got_i, table.dist)
    out["rerank_differ_past_ties"] = int((off & ((exact_got - want_d).abs() > 1e-6 * want_d.abs())).sum())
    out["rerank_rtol"] = float(((got_d - want_d).abs() / want_d.abs().clamp_min(1e-30)).max())

    own = R.chunk_plan(table, rows, q, k, ef, codes=ref_codes)
    out["recall_chunk_plan"] = recall(own["ids"], truth)
    if lut is None:  # the program's dense plan: the row plan under the int8 lookup
        own = R.row_plan(table, rows, q, k, ef, codes=ref_codes, lut=R.Lut.of(table, q, rounded=True))
    out["program_vs_own_plan"] = recall(got_i, own["ids"])
    out["recall_row_plan"] = recall(R.row_plan(table, rows, q, k, ef, codes=ref_codes)["ids"], truth)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--efs", default=None, help="comma-separated; the configuration's ef by default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = core.Cell(args.workload, core.load_json(os.path.join(ROOT, "BENCHMARK.json")))
    ctx = core.Context(cell, args.seed, "cuda")
    t0 = time.perf_counter()
    queries = torch.from_numpy(ctx.make_pool()[: args.queries])
    system = core.load_entry(cell.config["entry"]).setup(ctx)
    rows = ctx.make_rows()
    print(f"set-up {time.perf_counter() - t0:.1f} s; adc_quality {system.pq.adc_quality}", file=sys.stderr)
    efs = [cell.config["ef"]] if args.efs is None else [int(e) for e in args.efs.split(",")]
    for ef in efs:
        t1 = time.perf_counter()
        out = compare(system, rows, queries, cell.traffic["k"], ef)
        out.update(cell=cell.name, seed=args.seed, seconds=round(time.perf_counter() - t1, 1))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
