"""Distances as batched GEMMs (port of lab_1806_vec_db_tpu/ops/distance.py).

The reference's cached-distance identity `(a-b)^2 = a^2 + b^2 - 2ab` is the
decomposition: the `ab` term is a `(B, dim) x (dim, N)` f32 matmul (TF32 is
off package-wide, see `__init__.py`) and the row norms are per-index caches.

Supported algorithms:
- "l2sqr":  squared Euclidean, range [0, inf)
- "cosine": 1 - cos_sim, range [0, 2]
"""

from __future__ import annotations

import numpy as np
import torch

DISTANCES = ("l2sqr", "cosine")

# rows per block of `dist_cache`'s float64 accumulation (bounds the transient)
_CACHE_BLOCK = 65536


def check_dist(dist: str) -> str:
    if dist not in DISTANCES:
        raise ValueError("Invalid distance function")
    return dist


def dist_cache(x: torch.Tensor, dist: str) -> torch.Tensor:
    """Per-row cache: dot(a,a) for l2sqr, norm(a) for cosine -> (...,) f32.

    The squares are summed in float64 and rounded once to f32, so a row's
    cache does not depend on how many rows are computed together (a reduce
    over a (k, dim) slice and one over the whole (cap, dim) set may sum in
    different orders in f32).  Incremental row syncs and full rebuilds then
    give bit-identical mirrors, and so identical stage-1 candidates."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1]) if x.dim() != 2 else x
    out = torch.empty(flat.shape[0], dtype=torch.float32, device=x.device)
    for r0 in range(0, flat.shape[0], _CACHE_BLOCK):
        sq = flat[r0 : r0 + _CACHE_BLOCK].double().square().sum(-1)
        out[r0 : r0 + _CACHE_BLOCK] = sq if dist == "l2sqr" else sq.sqrt()
    return out.reshape(lead)


def pairwise(
    queries: torch.Tensor,
    base: torch.Tensor,
    dist: str,
    q_cache: torch.Tensor | None = None,
    base_cache: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-pairs distances (B, N) between queries (B, dim) and base (N, dim):
    one f32 GEMM plus rank-1 corrections."""
    check_dist(dist)
    q = queries.float()
    b = base.float()
    dots = q @ b.T
    if q_cache is None:
        q_cache = dist_cache(q, dist)
    if base_cache is None:
        base_cache = dist_cache(b, dist)
    if dist == "l2sqr":
        d = q_cache[:, None] + base_cache[None, :] - 2.0 * dots
        return d.clamp_min_(0.0)
    denom = (q_cache[:, None] * base_cache[None, :]).clamp_min_(1e-10)
    return 1.0 - dots / denom


def pointwise(a: torch.Tensor, b: torch.Tensor, dist: str) -> torch.Tensor:
    """Row-wise distances between a (..., dim) and b (..., dim) -> (...,).
    l2sqr is computed directly (no cancellation)."""
    check_dist(dist)
    a = a.float()
    b = b.float()
    if dist == "l2sqr":
        diff = a - b
        return (diff * diff).sum(-1)
    dots = (a * b).sum(-1)
    na = (a * a).sum(-1).sqrt()
    nb = (b * b).sum(-1).sqrt()
    return 1.0 - dots / (na * nb).clamp_min(1e-10)


def calc_dist_host(a, b, dist: str = "cosine") -> float:
    """Host scalar helper backing the public `calc_dist`.  Raises ValueError
    on a bad name or mismatched dims."""
    check_dist(dist)
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError("calc_dist expects two 1-D vectors of equal length")
    if dist == "l2sqr":
        d = a - b
        return float(np.dot(d, d))
    denom = max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-10)
    return float(1.0 - np.dot(a, b) / denom)
