"""K2: row-gather + exact distance, the rerank of the two-stage Flat search
(port of ops/pallas_gather.py's `gather_dists_rs` / `gather_dists_rs_1q`
and their wrapper `rerank_topk_rs`).

The rows are read in place from the store's f32 (cap, dim) tensor, or from
the lean tier's bf16 (slab_cap, dim) rerank tensor (upcast to f32 before
any arithmetic, as the reference does).  The TPU kernel needed a second,
(N*SR, 128) row-slab copy so each row was one aligned DMA; on the H100 a
warp reads a row with coalesced vector loads, so that copy (and its device
memory) is gone.

`rerank_topk_blocked` streams a wide candidate list (an IVF posting union)
through K2 512 ids at a time with a running top-k.

On a CUDA tensor the distances come from the hand-written kernel
`csrc/gather_dists.cu`; on a CPU tensor from the plain PyTorch version
`gather_dists_ref`.  There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from . import _build
from .topk import INVALID_ID, merge_topk, topk_smallest


def gather_dists_ref(queries, base, ids, dist: str) -> torch.Tensor:
    """Plain PyTorch version of K2: exact f32 distances base[ids[b, j]] <->
    queries[b] -> (B, r), +inf where ids[b, j] < 0 or >= len(base).  bf16
    rows are upcast to f32 first (the row norm too).  l2sqr is
    the direct sum of squared differences (no cached norms); cosine is
    1 - dot / max(|v| |q|, 1e-10)."""
    q = queries.float()
    valid = (ids >= 0) & (ids < base.shape[0])
    v = base[torch.where(valid, ids, 0).long()].float()  # (B, r, dim)
    if dist == "l2sqr":
        diff = v - q[:, None, :]
        d = (diff * diff).sum(-1)
    else:
        dots = (v * q[:, None, :]).sum(-1)
        vn = (v * v).sum(-1).sqrt()
        qn = (q * q).sum(-1).sqrt()[:, None]
        d = 1.0 - dots / (vn * qn).clamp_min(1e-10)
    return torch.where(valid, d, float("inf"))


def gather_dists(queries, base, ids, dist: str) -> torch.Tensor:
    """Exact f32 distances base[ids[b, j]] <-> queries[b] -> (B, r) f32.

    queries (B, dim) f32; base (n_rows, dim) f32 or bf16 (the store's rows,
    read in place; bf16 is the lean tier's rerank tensor); ids (B, r) int32,
    -1 = invalid.  Ids < 0 or >= n_rows give +inf.  CPU tensors run the plain
    version; CUDA tensors launch the kernel and count the launch in
    `gather_dists.launches`."""
    if dist not in ("l2sqr", "cosine"):
        raise ValueError("Invalid distance function")
    if base.dtype not in (torch.float32, torch.bfloat16) or queries.dtype != torch.float32:
        raise TypeError(f"gather_dists takes f32 queries and f32 / bf16 rows, got {queries.dtype}/{base.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if queries.dim() != 2 or base.dim() != 2 or ids.dim() != 2:
        raise ValueError("queries, base and ids must be 2-D")
    B, dim = queries.shape
    if base.shape[1] != dim or ids.shape[0] != B:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, base {tuple(base.shape)}, ids {tuple(ids.shape)}")
    devs = {queries.device, base.device, ids.device}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if not base.is_contiguous():
        raise ValueError("base must be contiguous (the kernel reads its rows in place)")
    if dev.type == "cpu":
        return gather_dists_ref(queries, base, ids, dist)
    if dev.type != "cuda":
        raise RuntimeError(f"no K2 kernel for device {dev}")
    queries, ids = queries.contiguous(), ids.contiguous()
    r = ids.shape[1]
    out = torch.empty((B, r), dtype=torch.float32, device=dev)
    bf16 = base.dtype == torch.bfloat16
    # 4 lanes a load: 16 bytes of f32 rows, 8 of bf16 rows
    vec4 = dim % 4 == 0 and queries.data_ptr() % 16 == 0 and base.data_ptr() % (8 if bf16 else 16) == 0
    flags = (1 if dist == "cosine" else 0) | (2 if vec4 else 0) | (4 if bf16 else 0)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.vecdb_gather_dists(
            queries.data_ptr(), base.data_ptr(), ids.data_ptr(), out.data_ptr(),
            B, r, dim, base.shape[0], flags, stream,
        )
    _build.check(status, "gather_dists")
    gather_dists.launches += 1
    return out


gather_dists.launches = 0


def rerank_topk(queries, base, ids, k: int, dist: str):
    """Exact top-k over candidate ids: K2 distances, then a stable sort
    (ties keep `lax.top_k`'s lower-position-first order).  Returns ((B, k)
    f32 ascending, (B, k) int32), -1 where the distance is not finite."""
    d = gather_dists(queries, base, ids, dist)
    return _finish_topk(*topk_smallest(d, ids, min(k, d.shape[1])), k)


def _finish_topk(bd, bi, k: int):
    """Pad a (B, kk <= k) top list to k with (+inf, -1), and -1 every id
    whose distance is not finite."""
    B, kk = bd.shape
    if kk < k:
        bd = torch.cat([bd, bd.new_full((B, k - kk), float("inf"))], 1)
        bi = torch.cat([bi, bi.new_full((B, k - kk), INVALID_ID)], 1)
    return bd, torch.where(torch.isfinite(bd), bi, INVALID_ID)


_RERANK_BLOCK = 512  # candidate ids per K2 launch of rerank_topk_blocked


def rerank_topk_blocked(queries, base, ids, k: int, dist: str):
    """Exact top-k over a WIDE candidate list (an IVF posting union, C ids a
    query): K2 on 512 ids at a time with a running `merge_topk`, so no
    (B, C) distance matrix and no (B, C, dim) gather ever exists.  One K2
    launch per block.  Returns ((B, k) f32 ascending, (B, k) int32), -1
    where the distance is not finite."""
    block = _RERANK_BLOCK
    B, C = ids.shape
    if C <= block:
        return rerank_topk(queries, base, ids, k, dist)
    kk = min(k, block)
    best_d = torch.full((B, kk), float("inf"), device=ids.device)
    best_i = torch.full((B, kk), INVALID_ID, dtype=torch.int32, device=ids.device)
    for c0 in range(0, C, block):
        sl = ids[:, c0 : c0 + block]
        if sl.shape[1] < block:  # the reference pads the last block with -1
            sl = torch.nn.functional.pad(sl, (0, block - sl.shape[1]), value=INVALID_ID)
        d = gather_dists(queries, base, sl.contiguous(), dist)
        td, ti = topk_smallest(d, sl, kk)
        best_d, best_i = merge_topk(best_d, best_i, td, ti, kk)
    return _finish_topk(best_d, best_i, k)
