"""Query binning for the batched IVF scan (port of ops/binning.py).

A batch of B queries each probes p posting lists.  The binned search inverts
that map: each LIST is scanned once against the block of queries probing
it (K10, `ops/scan_binned.py`), so it needs list -> (queries probing it),
built here on the device with fixed shapes (no host round trip a batch).

Construction: sort the B*p probe pairs by list id, stably; the rank of a
pair within its list's run (position minus the run's start, the starts from
a histogram cumsum) is its slot in that list's fixed-width bin.  Pairs whose
rank reaches qb are dropped (slot -1); callers size qb so that overflow is
rare and count the drops from `slots`.
"""

from __future__ import annotations

import torch


def bin_queries(probe: torch.Tensor, nlist: int, qb: int):
    """Invert the query -> lists probe map into fixed-width per-list bins.

    probe (B, p) int32 list ids in [0, nlist).  Returns
      bins  (nlist, qb) int32: the query ids probing each list, -1 padded;
      slots (B, p) int32: the bin slot of each probe pair, -1 if dropped.

    The flattening is probe-rank-major (element j*B + b), so within a list's
    run the primary (rank-0) probes sort first and an overflowing bin drops
    the least important pairs.  Overflowing pairs are written to a
    sacrificial column qb that is cut off: several land on it, in an order
    `index_put_` leaves open on CUDA, which is harmless because the column is
    discarded and `slots` does not read it."""
    B, p = probe.shape
    m = B * p
    dev = probe.device
    flat = probe.T.reshape(m).long()
    order = torch.argsort(flat, stable=True)
    sorted_lists = flat[order]
    counts = torch.bincount(flat, minlength=nlist)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(m, device=dev) - start[sorted_lists]
    qid_sorted = (order % B).to(torch.int32)
    col = rank.clamp_max(qb)
    bins = torch.full((nlist, qb + 1), -1, dtype=torch.int32, device=dev)
    bins[sorted_lists, col] = qid_sorted
    slot_flat = torch.where(rank < qb, rank, -1).to(torch.int32)
    slots = torch.empty(m, dtype=torch.int32, device=dev)
    slots[order] = slot_flat
    return bins[:, :qb].contiguous(), slots.reshape(p, B).T.contiguous()
