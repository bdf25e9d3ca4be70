"""Top-k selection over distance tiles and candidate lists (port of
lab_1806_vec_db_tpu/ops/topk.py).

Results ascend by distance.  Ties come out as `lax.top_k` orders them in the
reference, lower position first: every selection here is a STABLE sort, never
a bare `torch.topk` (whose tie order is unspecified).  Tiles are scanned in
index order, so ties break toward the smaller row id, like the reference's
(distance, index) order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import distance as D
from . import scan_small as SS
from ..utils.profiling import span

INVALID_ID = -1


def topk_smallest(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest distances of the last axis, ascending, with their ids.
    Padded slots should carry +inf.  Returns ((..., k), (..., k))."""
    d, pos = torch.sort(dists, dim=-1, stable=True)
    pos = pos[..., :k]
    return d[..., :k], torch.gather(ids, -1, pos)


_KEY_QUERIES = 64  # rows per block of `smallest_positions` (bounds its int64 keys)


def smallest_positions(d: torch.Tensor, k: int):
    """The k smallest entries of each row of a wide (B, N) tensor, ascending,
    ties to the lower position (a stable sort's order), without sorting the
    row: one int64 key per entry, (order-preserving int of the f32 value)
    << 32 | position, selected by `torch.topk`, 64 rows at a time.  -0.0
    ties with +0.0.  Returns ((B, k) f32 values, (B, k) int64 positions)."""
    B, n = d.shape
    pos = torch.arange(n, dtype=torch.int64, device=d.device)
    out_d = torch.empty((B, k), dtype=torch.float32, device=d.device)
    out_p = torch.empty((B, k), dtype=torch.int64, device=d.device)
    for b0 in range(0, B, _KEY_QUERIES):
        f = d[b0 : b0 + _KEY_QUERIES].float() + 0.0  # -0.0 -> +0.0
        bits = f.view(torch.int32)
        ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
        key = torch.topk((ordered << 32) | pos, k, dim=1, largest=False, sorted=True).values
        p = key & 0xFFFFFFFF
        out_d[b0 : b0 + _KEY_QUERIES] = torch.gather(f, 1, p)
        out_p[b0 : b0 + _KEY_QUERIES] = p
    return out_d, out_p


def merge_topk(best_d, best_i, new_d, new_i, k: int):
    """Merge a new candidate tile into the running k-best.  The running set
    comes first, so on a tie it keeps the earlier (lower) id."""
    return topk_smallest(torch.cat([best_d, new_d], -1), torch.cat([best_i, new_i], -1), k)


def select_smallest(d: torch.Tensor, ids: torch.Tensor, kk: int):
    """Exact kk-smallest over the last axis.  The reference routes wide rows
    to `approx_min_k(recall_target=1.0)`, which is exact; one stable sort is
    the same selection here."""
    return topk_smallest(d, ids, kk)


def _pad_k(bd, bi, k: int):
    kk = bd.shape[-1]
    if kk < k:
        B = bd.shape[0]
        bd = torch.cat([bd, bd.new_full((B, k - kk), float("inf"))], 1)
        bi = torch.cat([bi, bi.new_full((B, k - kk), INVALID_ID)], 1)
    return bd, torch.where(torch.isfinite(bd), bi, INVALID_ID)


def knn_scan(
    queries: torch.Tensor,
    base: torch.Tensor,
    base_cache: torch.Tensor,
    n_valid: int,
    k: int,
    dist: str,
    block: int = 65536,
):
    """Exact brute-force kNN as a blocked f32 GEMM scan with a running top-k.

    queries (B, dim); base (N_pad, dim) with rows >= n_valid as padding;
    base_cache (N_pad,).  Returns (B, k) f32 dists ascending and (B, k) int32
    ids (-1 where fewer than k rows exist).  The product is `torch.matmul`,
    as the reference leaves it to XLA outside any Pallas kernel.

    A small batch on the card (`scan_small.takes_kernel`: B <= B_MAX, k <=
    K_MAX, f32 rows) is one hand-written kernel instead, the span
    `scan.exact_small`; every other call, and every CPU call, is the chain."""
    with span("scan.knn_scan"):  # on CUDA it only enqueues: nothing in it syncs
        if SS.takes_kernel(queries, base, k):
            with span("scan.exact_small"):
                return SS.exact_scan_small(queries, base, base_cache, n_valid, k, dist)
        B = queries.shape[0]
        q = queries.float()
        q_cache = D.dist_cache(q, dist)
        n = min(int(n_valid), base.shape[0])
        best_d = torch.full((B, 0), float("inf"), device=q.device)
        best_i = torch.full((B, 0), INVALID_ID, dtype=torch.int32, device=q.device)
        for start in range(0, max(n, 1), block):
            stop = min(start + block, n)
            if stop <= start:
                break
            d = D.pairwise(q, base[start:stop], dist, q_cache=q_cache,
                           base_cache=base_cache[start:stop])
            ids = torch.arange(start, stop, dtype=torch.int32, device=q.device).expand(B, -1)
            td, ti = select_smallest(d, ids, min(k, stop - start))
            best_d, best_i = merge_topk(best_d, best_i, td, ti, k)
        return _pad_k(best_d, best_i, k)


_SCAN_BLOCK = 262144  # rows per block of `scan_candidates` (bounds its (B, block) tiles)


def scan_candidates(queries, base_scan, base_cache, n_valid: int, r: int, dist: str,
                    block: int = _SCAN_BLOCK):
    """Stage 1 of the bf16 two-stage scan (the reference's XLA
    `topk.scan_candidates`, the "bf16" / "2stage" scan mode): one bf16
    product per block of the scan copy, the distance kept in bf16
    (selection-grade only; the exact rerank follows), and an exact top-r
    merged across blocks, ties to the lower row id.  The reference takes
    each block's top-r with `lax.approx_min_k(recall_target=0.99)`.

    queries (B, dim) f32; base_scan (N_pad, dim) bf16 (or f32); base_cache
    (N_pad,) f32.  Returns ((B, r) f32 approximate distances, (B, r) int32
    ids), ascending, -1 / +inf padded."""
    B = queries.shape[0]
    n = min(int(n_valid), base_scan.shape[0])
    qs = queries.to(base_scan.dtype)
    q_cache = D.dist_cache(queries.float(), dist)
    best_d = torch.full((B, 0), float("inf"), device=queries.device)
    best_i = torch.full((B, 0), INVALID_ID, dtype=torch.int32, device=queries.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        dots = (qs @ base_scan[start:stop].T).to(torch.bfloat16)
        tc = base_cache[start:stop]
        if dist == "l2sqr":
            d = (q_cache[:, None] + tc[None, :]).to(torch.bfloat16) - 2.0 * dots
        else:
            denom = (q_cache[:, None] * tc[None, :]).clamp_min(1e-10)
            d = 1.0 - dots / denom.to(torch.bfloat16)
        td, tp = smallest_positions(d.float(), min(r, stop - start))
        best_d, best_i = merge_topk(best_d, best_i, td, (tp + start).to(torch.int32), r)
    return _pad_k(best_d, best_i, r)


def quantize_rows_int8(x: torch.Tensor):
    """Per-row symmetric int8 quantization: x ~= q8 * scale[:, None].
    Returns ((N, dim) int8, (N,) f32 scales); zero rows get scale 1.
    `torch.round` rounds half to even, like `jnp.round` and `np.round`."""
    x = x.float()
    amax = x.abs().amax(dim=1) if x.shape[1] else x.new_zeros(x.shape[0])
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q8 = torch.round(x / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    return q8, scale


def decode_perm(cand: torch.Tensor, perm: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Map candidate ids of the scan-PERMUTED int8 mirror back to original
    row ids.  Drops -1 inputs and decoded ids >= n_valid (invalid mirror
    rows carry losing sentinels but can still surface when a query's
    survivor group holds nothing better)."""
    safe = cand.clamp(0, perm.shape[0] - 1).long()
    orig = torch.where(cand >= 0, perm[safe].to(torch.int32), INVALID_ID)
    return torch.where(orig < n_valid, orig, INVALID_ID)


def int8_ordering_selftest(vecs: torch.Tensor, n_valid: int, dist: str) -> float:
    """Estimate whether per-row int8 quantization preserves NEIGHBOR ORDER:
    mean fraction of each sampled query's exact top-10 (within a 2048-row
    sample) found in its int8 top-12.  Healthy datasets score 1.0; the
    pathological regime (gaps tiny relative to magnitudes) ~0.7.

    The sample rows are drawn with `np.random.default_rng(0)`; the reference
    draws them with `jax.random.PRNGKey(0)`, and the two generators give
    different rows from the same seed, so the scores agree only in
    distribution."""
    rng = np.random.default_rng(0)
    n = max(int(n_valid), 1)
    si = torch.as_tensor(rng.integers(0, n, size=2048), device=vecs.device)
    qi = torch.as_tensor(rng.integers(0, n, size=32), device=vecs.device)
    samp = vecs[si].float()
    qs = vecs[qi].float()

    def dists(a_dot_b, a_sq, b_sq):
        if dist == "l2sqr":
            return a_sq[:, None] + b_sq[None, :] - 2.0 * a_dot_b
        denom = (a_sq.sqrt()[:, None] * b_sq.sqrt()[None, :]).clamp_min(1e-10)
        return 1.0 - a_dot_b / denom

    q_sq = (qs * qs).sum(1)
    s_sq = (samp * samp).sum(1)
    d_exact = dists(qs @ samp.T, q_sq, s_sq)
    q8s, ss = quantize_rows_int8(samp)
    q8q, sq = quantize_rows_int8(qs)
    # int8 dots are integers < 2^24, so the f32 product is exact
    dots8 = (q8q.float() @ q8s.float().T) * (sq[:, None] * ss[None, :])
    d_int8 = dists(dots8, q_sq, s_sq)
    t_exact = torch.sort(d_exact, dim=1, stable=True)[1][:, :10]
    t_int8 = torch.sort(d_int8, dim=1, stable=True)[1][:, :12]
    hit = (t_exact[:, :, None] == t_int8[:, None, :]).any(2)
    return float(hit.float().mean())


def knn_gathered(queries, base, cand_ids, k: int, dist: str, base_cache=None):
    """kNN over per-query candidate id lists (the HNSW beam's rerank on the
    CPU route): exact f32 distances by the cached-norm formula, then a
    stable top-k.  queries (B, dim); cand_ids (B, C) int32, -1 padded.
    Returns ((B, k) f32 ascending, (B, k) int32), -1 where not finite."""
    safe = cand_ids.clamp_min(0).long()
    v = base[safe].float()  # (B, C, dim)
    q = queries.float()
    dots = torch.bmm(v, q[:, :, None])[:, :, 0]
    v_sq = base_cache[safe] if base_cache is not None else None
    if dist == "l2sqr":
        v_sq = v_sq if v_sq is not None else (v * v).sum(-1)
        d = ((q * q).sum(-1, keepdim=True) + v_sq - 2.0 * dots).clamp_min_(0.0)
    else:
        v_n = v_sq if v_sq is not None else (v * v).sum(-1).sqrt()
        q_n = (q * q).sum(-1, keepdim=True).sqrt()
        d = 1.0 - dots / (q_n * v_n).clamp_min(1e-10)
    d = torch.where(cand_ids >= 0, d, float("inf"))
    bd, bi = topk_smallest(d, cand_ids, min(k, cand_ids.shape[1]))
    return _pad_k(bd, bi, k)


def exact_distances_sorted(queries, base, ids, dist: str, base_cache=None):
    """Exact f32 distances for small per-query id lists, sorted ascending
    -> ((B, k) f32, (B, k) int32), -1 where the distance is not finite."""
    safe = ids.clamp_min(0).long()
    v = base[safe].float()  # (B, k, dim)
    q = queries.float()
    if dist == "l2sqr":
        diff = q[:, None, :] - v
        d = (diff * diff).sum(-1)
    else:
        dots = (q[:, None, :] * v).sum(-1)
        v_n = base_cache[safe] if base_cache is not None else (v * v).sum(-1).sqrt()
        q_n = (q * q).sum(-1, keepdim=True).sqrt()
        d = 1.0 - dots / (q_n * v_n).clamp_min(1e-10)
    d = torch.where(ids >= 0, d, float("inf"))
    bd, bi = topk_smallest(d, ids, ids.shape[1])
    return bd, torch.where(torch.isfinite(bd), bi, INVALID_ID)
