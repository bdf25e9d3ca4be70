"""Batched link selection for HNSW construction (port of ops/graph.py).

The reference selects neighbors with a sequential heuristic: walk candidates
in ascending distance order and keep one only if no already-kept neighbor is
closer to it than it is to the pivot (`ResultSet::heuristic`,
candidate_pair.rs:85-99).  Reverse-link re-arrangement appends and, on
overflow, re-prunes with the same heuristic (hnsw_index.rs:204-239).

Both run batched over a chunk of nodes: the candidate-pair distances are
batched products, and the heuristic's sequential dependence is only over the
candidate axis (C ~ 64), so it is a C-step masked loop over all pivots at
once.  Every ordering is a stable sort, so ties break toward the lower
position as `lax.top_k` breaks them in the reference.
"""

from __future__ import annotations

import torch


def later_duplicates(ids: torch.Tensor) -> torch.Tensor:
    """(B, C) bool: True where a valid id (>= 0) also occurs at an EARLIER
    position of its row.  A stable sort puts equal ids next to each other in
    position order, so only the first copy of each survives; no (B, C, C)
    compare is ever built."""
    vals, order = torch.sort(ids, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(vals, dtype=torch.bool)
    dup_sorted[:, 1:] = (vals[:, 1:] == vals[:, :-1]) & (vals[:, 1:] >= 0)
    return torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)


def compact_front(ids: torch.Tensor, keep: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width): the kept ids moved to the front in their original order,
    -1 after (cut or padded to `width`)."""
    B, C = ids.shape
    pos = torch.sort((~keep).to(torch.int8), dim=1, stable=True)[1][:, : min(width, C)]
    out = torch.where(torch.gather(keep, 1, pos), torch.gather(ids, 1, pos), -1)
    if width > C:
        out = torch.cat([out, out.new_full((B, width - C), -1)], 1)
    return out


def heuristic_select(cand_ids: torch.Tensor, cand_d: torch.Tensor, pair_d: torch.Tensor,
                     limit: int):
    """Batched HNSW neighbor-selection heuristic.

    cand_ids (B, C) int32 sorted ascending by distance, -1 padded; cand_d
    (B, C) f32 distance to the pivot; pair_d (B, C, C) f32 distances among
    the candidates.  Iterate candidates in order and keep one while
    kept < limit and min over kept q of pair_d[c, q] >= cand_d[c].
    Returns (sel_ids (B, limit) int32 -1 padded, keep_mask (B, C))."""
    B, C = cand_ids.shape
    keep = torch.zeros((B, C), dtype=torch.bool, device=cand_ids.device)
    count = torch.zeros(B, dtype=torch.int32, device=cand_ids.device)
    inf = torch.tensor(float("inf"), device=cand_ids.device)
    for j in range(C):
        min_pair = torch.where(keep, pair_d[:, j, :], inf).amin(dim=1)
        take = (cand_ids[:, j] >= 0) & (count < limit) & (min_pair >= cand_d[:, j])
        keep[:, j] = take
        count += take.to(torch.int32)
    return compact_front(cand_ids, keep, limit), keep


def sort_candidates(ids: torch.Tensor, d: torch.Tensor):
    """Sort candidate lists ascending by distance; invalid (-1) ids last."""
    d = torch.where(ids >= 0, d, float("inf"))
    sd, pos = torch.sort(d, dim=-1, stable=True)
    return torch.gather(ids, -1, pos), sd


def pairwise_among(vectors: torch.Tensor, ids: torch.Tensor, dist: str) -> torch.Tensor:
    """(B, C, C) distance matrices among the gathered candidate vectors,
    +inf where either id is -1."""
    v = vectors[ids.clamp_min(0).long()].float()  # (B, C, dim)
    dots = torch.bmm(v, v.transpose(1, 2))
    sq = (v * v).sum(-1)
    if dist == "l2sqr":
        out = (sq[:, :, None] + sq[:, None, :] - 2.0 * dots).clamp_min_(0.0)
    else:
        n = sq.sqrt()
        out = 1.0 - dots / (n[:, :, None] * n[:, None, :]).clamp_min(1e-10)
    invalid = (ids < 0)[:, :, None] | (ids < 0)[:, None, :]
    return out.masked_fill_(invalid, float("inf"))


def _arrange_core(vectors, links_rows, pivot_ids, new_ids, dist: str, link_width: int):
    """Batched reverse-link arrangement (hnsw_index.rs:204-224).

    For each pivot p: candidates = current links + new ids, later duplicates
    dropped.  If they fit in `link_width`, keep all (existing first, order
    kept); otherwise sort by distance to p and heuristic-prune to
    `link_width`.  Returns the new (P, link_width) int32 link rows."""
    cand = torch.cat([links_rows, new_ids], 1)  # (P, C)
    cand = torch.where(later_duplicates(cand), -1, cand)
    valid = cand >= 0
    count = valid.sum(1)

    pv = vectors[pivot_ids.long()].float()  # (P, dim)
    cv = vectors[cand.clamp_min(0).long()].float()  # (P, C, dim)
    dots = torch.bmm(cv, pv[:, :, None])[:, :, 0]
    if dist == "l2sqr":
        cd = ((pv * pv).sum(-1, keepdim=True) + (cv * cv).sum(-1) - 2.0 * dots).clamp_min_(0.0)
    else:
        denom = ((pv * pv).sum(-1, keepdim=True).sqrt() * (cv * cv).sum(-1).sqrt()).clamp_min(1e-10)
        cd = 1.0 - dots / denom
    cd = torch.where(valid, cd, float("inf"))

    sorted_ids, sorted_d = sort_candidates(cand, cd)
    pruned, _ = heuristic_select(sorted_ids, sorted_d, pairwise_among(vectors, sorted_ids, dist),
                                 link_width)
    appended = compact_front(cand, valid, link_width)
    return torch.where((count > link_width)[:, None], pruned, appended)


def arrange_links_batch(vectors, links_rows, pivot_ids, new_ids, dist: str, link_width: int):
    """Host-path arrange: explicit pivot rows in, new rows out (see
    `_arrange_core`)."""
    return _arrange_core(vectors, links_rows, pivot_ids, new_ids, dist, link_width)


def arrange_links_inplace(vectors, links_dev: torch.Tensor, piv_new: torch.Tensor, dist: str,
                          link_width: int) -> torch.Tensor:
    """Device-canonical arrange: gather the pivot rows from `links_dev`
    (cap, link_width), arrange, and write the new rows back IN PLACE with
    `index_copy_` (the reference's functional scatter donated its buffer).

    piv_new (P, 1 + A) int32: column 0 = pivot id, the rest = new candidate
    ids (-1 padded).  Pivot ids >= cap are padding: their gather reads a
    clamped row and their rows are masked out before the write (the
    reference's scatter drops them, `mode="drop"`), so a padding row never
    touches a real one.  Returns `links_dev`."""
    cap = links_dev.shape[0]
    pivot_ids = piv_new[:, 0]
    rows = links_dev[pivot_ids.clamp_max(cap - 1).long()]
    new_rows = _arrange_core(vectors, rows, pivot_ids.clamp_max(cap - 1), piv_new[:, 1:], dist,
                             link_width)
    real = pivot_ids < cap
    links_dev.index_copy_(0, pivot_ids[real].long(), new_rows[real])
    return links_dev
