"""The plain reference: exact k-nearest-neighbour answers in float64, and the
control, the same search with its products in TF32.

Plain PyTorch only.  It imports nothing of the program (the package under
test) and takes nothing the program made: the rows and queries come from the
benchmark's own generator (`synth.py`), and everything is worked out again
from them.  Distances are the package's definitions:

    l2sqr:  sum_i (q_i - x_i)^2
    cosine: 1 - q.x / (|q| |x|)      (0 where a norm is 0 would divide: 1)

`exact_topk` ranks every row of every query in float64 and keeps the k
smallest; `distances` gives the float64 distance of given (query, row) pairs
by the direct formula.  Both work in blocks of rows and queries, so they fit
beside nothing else on the device once the program's state is freed.

Both take uint8 rows and queries too (a configuration of dtype "uint8"),
which stay uint8 on the device; a block is cast when it is used.  Their
products and sums are integers, so the answers are exact: in float64, and
for l2sqr at dim <= 129 in float32 (`_exact_in_f32`), where every term and
partial sum stays below 2^24.

`control_topk` is the reference computed one precision below the float32 the
configurations state: the query-row products in TF32 (each operand rounded to
a 10-bit mantissa, products summed in float32, as a tensor core does with TF32
on), norms and the rest in float32.  It returns its own float32 distances, and
a sound check has to refuse them.
"""

from __future__ import annotations

import torch

_ROW_BLOCK = 65536
_QUERY_BLOCK = 1024
_PAIR_BLOCK = 65536


def _sq_norms64(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return (x * x).sum(-1)


def _exact_in_f32(rows: torch.Tensor, queries: torch.Tensor, dist: str) -> bool:
    """uint8 l2sqr is exact in float32 while |q|^2 + |x|^2 <= 2 dim 255^2
    stays below 2^24: every product, partial sum and distance is then an
    integer that float32 holds, in any order of summation, TF32 or not (a
    uint8 operand needs 8 of its 11 bits)."""
    return (rows.dtype == torch.uint8 and queries.dtype == torch.uint8 and dist == "l2sqr"
            and 2 * rows.shape[1] * 255**2 < 2**24)


def _merge(best_d, best_i, d, r0: int, kk: int):
    """The k smallest of the running (best_d, best_i) and a block's
    distances `d`, whose columns are rows r0 onward."""
    td, tp = torch.topk(d, min(kk, d.shape[1]), dim=1, largest=False)
    d_all = torch.cat([best_d, td], 1)
    i_all = torch.cat([best_i, tp + r0], 1)
    sel_d, sel = torch.topk(d_all, min(kk, d_all.shape[1]), dim=1, largest=False)
    return sel_d, torch.gather(i_all, 1, sel)


def _exact_topk_f32(rows: torch.Tensor, queries: torch.Tensor, kk: int):
    """`exact_topk` for uint8 l2sqr where `_exact_in_f32`: rows ranked by
    |x|^2 - 2 q.x (one product a block), |q|^2 added to the k kept."""
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], _QUERY_BLOCK):
        q = queries[q0 : q0 + _QUERY_BLOCK].float()
        best_d = torch.empty((q.shape[0], 0), device=q.device)
        best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
        for r0 in range(0, rows.shape[0], _ROW_BLOCK):
            x = rows[r0 : r0 + _ROW_BLOCK].float()
            key = torch.addmm((x * x).sum(-1), q, x.T, alpha=-2.0)
            best_d, best_i = _merge(best_d, best_i, key, r0, kk)
        out_d.append((best_d + (q * q).sum(-1)[:, None]).double())
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def exact_topk(rows: torch.Tensor, queries: torch.Tensor, k: int, dist: str):
    """Exact top-k of each query over `rows` in float64 -> ((Q, k) float64
    distances ascending, (Q, k) int64 row ids).  rows (n, dim) and queries
    (Q, dim) on one device, both float32 or both uint8."""
    n = rows.shape[0]
    kk = min(k, n)
    if _exact_in_f32(rows, queries, dist):
        return _exact_topk_f32(rows, queries, kk)
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], _QUERY_BLOCK):
        q = queries[q0 : q0 + _QUERY_BLOCK].double()
        q_sq = (q * q).sum(-1)
        best_d = torch.full((q.shape[0], 0), float("inf"), dtype=torch.float64, device=q.device)
        best_i = torch.full((q.shape[0], 0), -1, dtype=torch.int64, device=q.device)
        for r0 in range(0, n, _ROW_BLOCK):
            x = rows[r0 : r0 + _ROW_BLOCK].double()
            dots = q @ x.T
            x_sq = (x * x).sum(-1)
            if dist == "l2sqr":
                d = (q_sq[:, None] + x_sq[None, :] - 2.0 * dots).clamp_min_(0.0)
            else:
                den = (q_sq.sqrt()[:, None] * x_sq.sqrt()[None, :])
                d = 1.0 - torch.where(den > 0, dots / den.clamp_min(1e-300), 0.0)
            best_d, best_i = _merge(best_d, best_i, d, r0, kk)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)


def distances(rows: torch.Tensor, queries: torch.Tensor, q_of: torch.Tensor, ids: torch.Tensor,
              dist: str) -> torch.Tensor:
    """float64 distance of each (query q_of[a], row ids[a, j]) pair -> (A, k)
    float64; +inf where ids[a, j] is outside [0, n).  q_of (A,) int64 indexes
    `queries`; ids (A, k) int64."""
    n = rows.shape[0]
    out = torch.full(ids.shape, float("inf"), dtype=torch.float64, device=ids.device)
    per = max(1, _PAIR_BLOCK // max(ids.shape[1], 1))
    for a0 in range(0, ids.shape[0], per):
        idb = ids[a0 : a0 + per]
        ok = (idb >= 0) & (idb < n)
        x = rows[idb.clamp(0, n - 1)].double()  # (a, k, dim)
        q = queries[q_of[a0 : a0 + per]].double()[:, None, :]
        if dist == "l2sqr":
            d = ((x - q) ** 2).sum(-1)
        else:
            den = (x * x).sum(-1).sqrt() * (q * q).sum(-1).sqrt()
            d = 1.0 - torch.where(den > 0, (x * q).sum(-1) / den.clamp_min(1e-300), 0.0)
        out[a0 : a0 + per] = torch.where(ok, d, float("inf"))
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (a 10-bit mantissa), to nearest, ties
    to even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def control_topk(rows_tf32: torch.Tensor, rows_norm: torch.Tensor, queries: torch.Tensor, k: int,
                 dist: str):
    """The control's answers: top-k by the distance formula of the package's
    scan (`|q|^2 + |x|^2 - 2 q.x`, or `1 - q.x / (|q| |x|)`) with the
    products in TF32 -> ((B, k) float32 distances ascending, (B, k) int64
    ids).  rows_tf32 is `tf32(rows)`; rows_norm the float32 squared norm
    (l2sqr) or norm (cosine) of the unrounded rows."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the control rounds its operands itself: TF32 matmul must be off")
    q = queries.float()
    qt = tf32(q)
    q_sq = (q * q).sum(-1)
    n = rows_tf32.shape[0]
    kk = min(k, n)
    best_d = torch.full((q.shape[0], 0), float("inf"), device=q.device)
    best_i = torch.full((q.shape[0], 0), -1, dtype=torch.int64, device=q.device)
    for r0 in range(0, n, _ROW_BLOCK):
        dots = qt @ rows_tf32[r0 : r0 + _ROW_BLOCK].T
        cache = rows_norm[r0 : r0 + _ROW_BLOCK]
        if dist == "l2sqr":
            d = (q_sq[:, None] + cache[None, :] - 2.0 * dots).clamp_min_(0.0)
        else:
            d = 1.0 - dots / (q_sq.sqrt()[:, None] * cache[None, :]).clamp_min(1e-10)
        td, tp = torch.topk(d, min(kk, d.shape[1]), dim=1, largest=False)
        d_all, i_all = torch.cat([best_d, td], 1), torch.cat([best_i, tp + r0], 1)
        sel_d, sel = torch.topk(d_all, min(kk, d_all.shape[1]), dim=1, largest=False)
        best_d, best_i = sel_d, torch.gather(i_all, 1, sel)
    return best_d, best_i
