"""Batched k-means (port of lab_1806_vec_db_tpu/ops/kmeans.py).

The reference's k-means (src/distance/k_means.rs) in two steps, each batched
over a leading axis of independent problems (the m PQ subspaces train in one
call, never in a Python loop over m):

- `kmeanspp_init`: k-means++ seeding with distance-weighted sampling
  (k_means.rs:61-87); all-zero weights fall back to uniform over the valid
  rows (k_means.rs:80-82).
- `lloyd`: Lloyd iterations (k_means.rs:114-160): assignment by a distance
  GEMM + argmin (ties to the lowest index), the update as a blocked one-hot
  product (no (N, dim) scatter), empty clusters keep their centroid
  (k_means.rs:131-137), and each problem stops on its own once its largest
  centroid move falls below `tol` (k_means.rs:150-159).

The JAX package fuses both into `kmeans_fit`; they are split here because
jax.random's streams cannot be reproduced in torch: a test seeds `lloyd`
with the reference's own init and compares the iterations.  Randomness
comes from an explicit `torch.Generator`.

Shapes: data (P, N_pad, dim) with rows >= n_valid ignored; centroids
(P, k, dim).  A 2-D input is one problem.
"""

from __future__ import annotations

import torch

from . import distance as D
from . import topk as T

_LLOYD_BLOCK = 8192  # rows per block of the one-hot update (bounds the transients)


def _batched(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    return (x[None], True) if x.dim() == 2 else (x, False)


def _pairwise_b(a: torch.Tensor, b: torch.Tensor, dist: str) -> torch.Tensor:
    """(P, n, dim) x (P, k, dim) -> (P, n, k) distances, the cached-norm
    formula of `distance.pairwise` per problem."""
    dots = torch.bmm(a, b.transpose(1, 2))
    if dist == "l2sqr":
        d = (a * a).sum(-1)[:, :, None] + (b * b).sum(-1)[:, None, :] - 2.0 * dots
        return d.clamp_min_(0.0)
    denom = ((a * a).sum(-1).sqrt()[:, :, None] * (b * b).sum(-1).sqrt()[:, None, :]).clamp_min_(1e-10)
    return 1.0 - dots / denom


def kmeanspp_init(data: torch.Tensor, n_valid: int, k: int, dist: str,
                  generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeds -> (P, k, dim) f32 (or (k, dim) for 2-D data).

    The first centroid is a uniform valid row; each next one is drawn with
    probability proportional to its distance to the nearest centroid so far
    (uniform over the valid rows when every such distance is 0)."""
    D.check_dist(dist)
    x, squeeze = _batched(data.float())
    P, n_pad, dim = x.shape
    dev = x.device
    valid = torch.arange(n_pad, device=dev) < n_valid
    first = torch.randint(0, max(int(n_valid), 1), (P,), generator=generator, device=dev)
    cent = torch.zeros((P, k, dim), dtype=torch.float32, device=dev)
    cent[:, 0] = x[torch.arange(P, device=dev), first]
    weight = torch.full((P, n_pad), float("inf"), device=dev)
    for i in range(1, k):
        d = D.pointwise(x, cent[:, i - 1][:, None, :], dist)
        weight = torch.minimum(weight, d)
        # slots with a non-positive or non-finite weight are never drawn
        w = torch.where(valid & torch.isfinite(weight) & (weight > 0.0), weight, 0.0)
        positive = (w.sum(1, keepdim=True) > 0.0)
        probs = torch.where(positive, w, valid.float().expand(P, -1))
        pick = torch.multinomial(probs, 1, generator=generator)[:, 0]
        cent[:, i] = x[torch.arange(P, device=dev), pick]
    return cent[0] if squeeze else cent


def lloyd(data: torch.Tensor, n_valid: int, centroids: torch.Tensor, max_iter: int, tol: float,
          dist: str) -> torch.Tensor:
    """Lloyd iterations from `centroids` -> (P, k, dim) f32 (or (k, dim)).

    Each problem runs until `max_iter` updates or until the largest squared
    move of one of its centroids is below `tol`, as the reference's
    per-problem while loop (vmapped over PQ groups) stops."""
    D.check_dist(dist)
    x, squeeze = _batched(data.float())
    c, _ = _batched(centroids.float())
    c = c.clone()
    P, n_pad, dim = x.shape
    k = c.shape[1]
    n = min(int(n_valid), n_pad)
    active = torch.ones(P, dtype=torch.bool, device=x.device)
    for _ in range(max_iter):
        counts = torch.zeros((P, k), dtype=torch.float32, device=x.device)
        sums = torch.zeros((P, k, dim), dtype=torch.float32, device=x.device)
        for r0 in range(0, n, _LLOYD_BLOCK):
            blk = x[:, r0 : min(r0 + _LLOYD_BLOCK, n)]
            assign = _pairwise_b(blk, c, dist).argmin(-1)  # first minimum
            oh = torch.nn.functional.one_hot(assign, k).float()  # (P, blk, k)
            counts += oh.sum(1)
            sums += torch.bmm(oh.transpose(1, 2), blk)
        new_c = torch.where(counts[:, :, None] > 0, sums / counts.clamp_min(1.0)[:, :, None], c)
        diff = ((new_c - c) ** 2).sum(-1).amax(-1)
        c = torch.where(active[:, None, None], new_c, c)
        active = active & (diff >= tol)
        if not bool(active.any()):
            break
    return c[0] if squeeze else c


def find_nearest(vectors: torch.Tensor, centroids: torch.Tensor, dist: str) -> torch.Tensor:
    """Nearest-centroid ids (N,) int32; ties go to the lowest index
    (k_means.rs:40-57)."""
    return D.pairwise(vectors, centroids, dist).argmin(1).to(torch.int32)


def find_n_nearest(vectors: torch.Tensor, centroids: torch.Tensor, n_probes: int, dist: str):
    """The n_probes nearest centroids per vector, ascending
    (k_means.rs:174-191) -> ((N, n) f32, (N, n) int32)."""
    d = D.pairwise(vectors, centroids, dist)
    ids = torch.arange(centroids.shape[0], dtype=torch.int32, device=d.device).expand_as(d)
    return T.topk_smallest(d, ids, min(n_probes, centroids.shape[0]))
