"""Batched lock-step beam search over a neighbor graph (port of ops/beam.py).

The reference's HNSW search is a sequential best-first loop per query
(hnsw_index.rs:258-291).  Here a whole batch advances in lock step: per
iteration each query expands its E best unexpanded beam entries, gathers
their neighbor ids, scores the novel ones and merges them into a sorted beam.
The loop stops when no beam entry is left unexpanded (the reference's
`check_candidate` rule, candidate_pair.rs:55-57) or after `max_iters`.

Two formulations:

- `beam_search` (classic): the CPU route.  A position-tracked circular
  visited ring, dedup by broadcast compare, and the sorted merge K6
  (`ops/merge.py`: the kernel on CUDA tensors, its stable-sort plain
  version on CPU tensors).  On a CUDA tensor it hands over to the fused
  loop, as the reference does on its accelerator, unless `fused=False`
  (the port's counterpart of the reference's `set_fused_beam` seam, an
  argument instead of a global).
- `beam_search_fused`: the loop body is K4 -> node_dist -> K5
  (`ops/beam_fused.py`); kernels on CUDA tensors, their plain versions on
  CPU tensors.

The loops run in Python and ask the host once per iteration whether any
query is still expanding (`host_syncs` counts those reads).

node_dist_fn: (B, C) int32 ids -> (B, C) f32 distances; it may return any
value where an id is -1 (callers mask).  links_fn: (B, E) int32 ids ->
(B, E, L) int32 neighbor ids, -1 padded.
"""

from __future__ import annotations

import torch

from . import beam_fused as BF
from . import merge as M
from .graph import compact_front

# host reads of the loops' stop conditions since the last reset (one per
# iteration of each loop; the per-iteration cost of a host-driven loop)
host_syncs = {"beam": 0, "greedy": 0}


def lockstep(entry, node_dist_fn, links_fn, ef: int, max_iters: int, E: int, R: int, pre, post,
             with_stats: bool = False):
    """The fused lock-step loop with ring R and the body functions `pre` /
    `post` (K4 / K5 or their plain versions).  The tile is E * L lanes
    rounded up to 128, the beam W = pow2(max(ef, tile, 128)) lanes.
    Returns ((B, ef) dists, (B, ef) ids[, (B,) int32 novel rows scored])."""
    B = entry.shape[0]
    dev = entry.device
    L = links_fn(torch.zeros((1, 1), dtype=torch.int32, device=dev)).shape[-1]
    EL = ((E * L + 127) // 128) * 128
    W = BF.pow2(max(ef, EL, 128))
    inf = float("inf")
    entry_d = node_dist_fn(entry[:, None])[:, 0]
    beam_d = torch.full((B, W), inf, device=dev)
    beam_d[:, 0] = torch.where(entry >= 0, entry_d, inf)
    beam_i = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    beam_i[:, 0] = entry
    beam_e = torch.zeros((B, W), dtype=torch.int32, device=dev)
    ring = torch.full((B, R), -1, dtype=torch.int32, device=dev)
    rows = torch.ones(B, dtype=torch.int32, device=dev)
    # the first selection: one merge of an empty tile
    beam_d, beam_i, beam_e, selq = post(beam_d, beam_i, beam_e, torch.full_like(beam_d, inf),
                                        torch.full_like(beam_i, -1), ef, E)
    for _ in range(max_iters):
        host_syncs["beam"] += 1
        if not bool((selq[:, :E] >= 0).any()):
            break
        ids_e = selq[:, :E]
        nbrs = links_fn(ids_e.clamp_min(0))
        nbrs = torch.where(ids_e[:, :, None] >= 0, nbrs, -1).reshape(B, E * L)
        if EL != E * L:
            nbrs = torch.cat([nbrs, nbrs.new_full((B, EL - E * L), -1)], 1)
        comp, ring, cnt = pre(beam_i, ring, selq, nbrs, E)
        # comp lanes >= EL are always -1: score only the tile's lanes
        nd = torch.full_like(beam_d, inf)
        nd[:, :EL] = torch.where(comp[:, :EL] >= 0, node_dist_fn(comp[:, :EL]), inf)
        beam_d, beam_i, beam_e, selq = post(beam_d, beam_i, beam_e, nd, comp, ef, E)
        rows += cnt[:, 0]
    if with_stats:
        return beam_d[:, :ef], beam_i[:, :ef], rows
    return beam_d[:, :ef], beam_i[:, :ef]


def beam_search_fused(entry, node_dist_fn, links_fn, ef: int, max_iters: int, expand: int = 4,
                      ring_size: int = 512, with_stats: bool = False):
    """Lock-step beam search on the fused body: K4 / K5 on CUDA tensors,
    their plain versions on CPU tensors.  The ring is capped at 256 slots
    (a node evicted past that horizon is merely re-scored) and rounded up
    to a multiple of 128, as in the reference."""
    R = ((max(min(ring_size, 256), 128) + 127) // 128) * 128
    return lockstep(entry, node_dist_fn, links_fn, ef, max_iters, expand, R, BF.beam_pre,
                    BF.beam_post, with_stats)


def beam_search(entry, node_dist_fn, links_fn, ef: int, max_iters: int, expand: int = 1,
                ring_size: int = 64, with_stats: bool = False, fused: bool = True):
    """Lock-step beam search from per-query entry points (B,) int32.

    Returns (beam_dists, beam_ids): (B, ef) sorted ascending, -1 padded;
    with_stats adds (B,) int32 NOVEL rows scored per query.  A CUDA entry
    runs the fused loop (`beam_search_fused`) unless `fused` is False; the
    classic loop merges with K6 (`merge.merge_sorted`)."""
    if entry.is_cuda and fused:
        return beam_search_fused(entry, node_dist_fn, links_fn, ef, max_iters, expand=expand,
                                 ring_size=ring_size, with_stats=with_stats)
    B, E, R = entry.shape[0], expand, ring_size
    dev = entry.device
    inf = float("inf")
    beam_d = torch.full((B, ef), inf, device=dev)
    beam_d[:, 0] = node_dist_fn(entry[:, None])[:, 0]
    beam_i = torch.full((B, ef), -1, dtype=torch.int32, device=dev)
    beam_i[:, 0] = entry
    expanded = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    ring = torch.full((B, R), -1, dtype=torch.int32, device=dev)
    ring_pos = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.ones(B, dtype=torch.int32, device=dev)
    lanes = torch.arange(E, device=dev)

    for _ in range(max_iters):
        unexp = ~expanded & (beam_i >= 0)
        host_syncs["beam"] += 1
        if not bool(unexp.any()):
            break
        active = unexp.any(1)
        # the E best (lowest-slot) unexpanded entries
        sel_mask = unexp & (torch.cumsum(unexp, 1) <= E)
        cand = compact_front(beam_i, sel_mask, E)  # (B, E), -1 where none
        sel_valid = cand >= 0
        exp_new = expanded | sel_mask

        nbrs = links_fn(cand.clamp_min(0))
        EL = E * nbrs.shape[-1]
        nbrs = torch.where(sel_valid[:, :, None], nbrs, -1).reshape(B, EL)
        fresh = BF.fresh_mask(nbrs, beam_i, ring)
        comp = compact_front(nbrs, fresh, EL)
        nd = torch.where(comp >= 0, node_dist_fn(comp), inf)

        # merge (K6): the beam sits first, so ties keep the existing entry
        beam_d, beam_i, exp2 = M.merge_sorted(beam_d, beam_i, exp_new, nd, comp)
        beam_i = torch.where(torch.isfinite(beam_d), beam_i, -1)
        expanded = exp2 & (beam_i >= 0)

        # push this step's expanded ids into the circular ring (the E slots
        # written are distinct: consecutive mod R, E <= R)
        write = sel_valid & active[:, None]
        slots = (ring_pos[:, None] + lanes[None, :]) % R
        ring.scatter_(1, slots, torch.where(write, cand, torch.gather(ring, 1, slots)))
        ring_pos += sel_valid.sum(1)
        rows += torch.where(active, fresh.sum(1, dtype=torch.int32), 0)
    if with_stats:
        return beam_d, beam_i, rows
    return beam_d, beam_i


def greedy_descent(entry, node_dist_fn, links_fn, max_iters: int):
    """Batched greedy descent on one level: hill-climb to a local minimum
    (hnsw_index.rs:306-330).  entry (B,) -> (B,) improved ids."""
    cur = entry.clone()
    cur_d = node_dist_fn(cur[:, None])[:, 0]
    moved = torch.ones_like(cur, dtype=torch.bool)
    for _ in range(max_iters):
        host_syncs["greedy"] += 1
        if not bool(moved.any()):
            break
        # a query that did not move last step cannot improve: blank its ids
        nbrs = torch.where(moved[:, None], links_fn(cur[:, None])[:, 0, :], -1)
        nd = torch.where(nbrs >= 0, node_dist_fn(nbrs), float("inf"))
        best_pos = nd.argmin(1, keepdim=True)  # the first minimum, as jnp.argmin
        best_d = torch.gather(nd, 1, best_pos)[:, 0]
        best_i = torch.gather(nbrs, 1, best_pos)[:, 0]
        moved = best_d < cur_d
        cur = torch.where(moved, best_i, cur)
        cur_d = torch.where(moved, best_d, cur_d)
    return cur
