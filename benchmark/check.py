"""The comparison that decides `correct`.

Every answer the harness kept from the measured window (see `core.py`:
every call of the first pass over the query pool, and the first call after
each of a few instants drawn from the seed) is judged against the plain
reference (`reference.py`), from the rows and queries the benchmark made:

- `malformed`: answers that are not k distinct valid row ids with finite,
  ascending distances, or whose metadata does not name its row.  Limit 0.
- `dist_gap`: the widest gap between a returned distance and the float64
  distance of the row it names, over every returned row, as a share of the
  query's exact k-th distance.  Its limit lies between what sound runs of the
  program read and what the TF32 control reads (`cells/<cell>.json`).
- `recall`: recall@k of the kept answers against the exact top-k, at least
  the cell's `recall_min` (`cells/<cell>.json`), set from sound runs'
  readings.  Ties count, as far as the exact top-k has them: a valid
  returned row is a hit if it is in the exact top-k, or if it lies outside
  it at a distance equal to the exact k-th row's (both by
  `reference.distances`) and stands in for a top-k row at that distance
  that was not returned.  Integer distances (uint8 rows) tie at the k-th
  place, and the reference's top-k keeps the tied rows in no defined order;
  a set that drops a nearer row for a second tied one still loses a hit
  (ANN-Benchmarks' `knn` recall at an epsilon of 0 would count it).
- `failed`: queries whose call raised.  Limit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference


def judge(ids: np.ndarray, dists: np.ndarray, bad: np.ndarray, q_of: np.ndarray, queries: np.ndarray,
          rows: torch.Tensor, dist: str, k: int) -> dict:
    """Numbers of the comparison for kept answers: ids (A, k) int64 (-1
    where absent), dists (A, k) float64, bad (A,) bool (the entry found the
    answer malformed, e.g. its metadata), q_of (A,) int64 indexes into the
    (Q, dim) `queries`; rows (n, dim) on the reference's device, float32 or
    uint8 as the queries.  Returns {"malformed", "dist_gap", "recall",
    "answers"}."""
    dev = rows.device
    n = rows.shape[0]
    A = ids.shape[0]
    kk = min(k, n)
    used, q_idx = np.unique(q_of, return_inverse=True)
    q_dev = torch.from_numpy(np.ascontiguousarray(queries[used])).to(dev)
    exact_d, exact_i = reference.exact_topk(rows, q_dev, kk, dist)
    ids_t = torch.from_numpy(ids).to(dev)
    q_idx_t = torch.from_numpy(q_idx.astype(np.int64)).to(dev)
    d64 = reference.distances(rows, q_dev, q_idx_t, ids_t, dist)

    valid = (ids_t >= 0) & (ids_t < n)
    prog = torch.from_numpy(dists).to(dev)
    srt = torch.sort(ids_t, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    unsorted = prog[:, 1:] < prog[:, :-1]
    bad_t = (torch.from_numpy(bad).to(dev) | (valid.sum(1) < kk) | dup.any(1)
             | (valid & ~torch.isfinite(prog)).any(1) | unsorted.any(1))

    kth = exact_d[q_idx_t, kk - 1].clamp_min(1e-12)
    gap = torch.where(valid, (prog - d64).abs() / kth[:, None], 0.0)
    gap = torch.nan_to_num(gap, nan=float("inf"))
    truth = exact_i[q_idx_t]
    ex64 = reference.distances(rows, q_dev, torch.arange(len(used), device=dev), exact_i, dist)[q_idx_t]
    kth_row = ex64[:, kk - 1 :]
    in_truth = (ids_t[:, :, None] == truth[:, None, :]).any(2) & valid
    returned = ((truth[:, :, None] == ids_t[:, None, :]) & valid[:, None, :]).any(2)
    untaken = ((ex64 == kth_row) & ~returned).sum(1)  # tied top-k rows not returned
    stand_in = (valid & ~in_truth & (d64 == kth_row)).sum(1)  # returned rows tied with them
    hits = in_truth.sum(1) + torch.minimum(stand_in, untaken)
    return {
        "malformed": int(bad_t.sum()),
        "dist_gap": float(gap.max()) if A else float("inf"),
        "recall": float(hits.double().sum() / (A * kk)) if A else 0.0,
        "answers": int(A),
    }


def verdict(numbers: dict, failed: int, limits: dict):
    """(correct, [(name, value, limit, sense)]) for the numbers of `judge`:
    each number beside its limit, `sense` "<=" or ">="."""
    rows = [
        ("failed", failed, 0, "<="),
        ("malformed", numbers["malformed"], 0, "<="),
        ("dist_gap", numbers["dist_gap"], limits["dist_gap"], "<="),
        ("recall", numbers["recall"], limits["recall_min"], ">="),
    ]
    ok = numbers["answers"] > 0 and all(v <= lim if s == "<=" else v >= lim for _, v, lim, s in rows)
    return ok, rows
