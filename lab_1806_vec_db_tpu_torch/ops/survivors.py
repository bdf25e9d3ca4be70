"""The stage-1 survivor select in one hand-written kernel,
`csrc/select_survivors.cu`: the exact top-r of K1's packed survivors of every
query, decoded, in one launch.

It replaces the sort, gather and decode of `scan.select_survivors_ref` (the
plain version, which CPU tensors run): a transposed copy of K1's (S, B)
output, a stable `torch.sort` of all S survivors of every query (cub's
segmented radix sort), a gather of the first r and ~10 elementwise launches.
No Pallas kernel stands behind it: the JAX package takes this select with
`lax.approx_min_k`, plain XLA.

The contract is `select_survivors_ref`'s, bit for bit: order by the packed
int32 viewed as f32, ascending, ties to the lower survivor position (-0.0
ties with +0.0); distance (v & ~127) viewed as f32, id (s // 16) * 2048 + s %
16 + (v & 127) * 16; (+inf, -1) where the distance is >= 1e38 and past the
S survivors there are.

Its byte bound is one read of K1's output and one write of the (B, r)
results: S B 4 + B r 8 bytes, 31.8 MB or 0.0096 ms at flat_1m's S 7,936, B
1000, r 40 (3.35 TB/s).  The kernel reads the survivors in place, coalesced
across 8 neighbouring queries, twice (the second time mostly from L2): once
for a bound on each query's r-th key, once to keep the few survivors at or
below it (about r); only those are sorted, in registers or shared memory
(the .cu file's note).  On an H100 it takes 0.029-0.033 ms there, where the
sort took 1.01.

`select_top_r` launches it for a CUDA tensor and raises on what it does not
take; `scan.select_survivors` hands it the calls where `takes_kernel` holds
(the span `scan.select`) and keeps the sort for the rest.  The rule's limits come
from `chip_smoke.py`'s select phase on an H100 (PERF.md §6), ms a call,
kernel back to back / replayed from a CUDA graph against the sort:

    (S, B, r)                        kernel           sort
    (7936, 1000, 40)  flat_1m        0.0327 / 0.0289  1.0061
    (7936, 1000, 160) pca            0.0395 / 0.0384  1.0113
    (1568, 1000, 120) HNSW ef 120    0.0245 / 0.0199  0.2009
    (1568, 1000, 600) HNSW ef 600    0.0637 / 0.0626  0.5152
    (7936, 1000, 1024) R_MAX         0.5420 / 0.5408  1.0601
    (80, 1000, 40)  IVF overflow     0.0333 / 0.0079  0.2516
    (560, 1000, 40) IVF overflow     0.0327 / 0.0086  0.2928
    (7936, 1, 40)                    0.0298 / 0.0197  0.2369
    (7936, 1001, 40)                 0.0329 / 0.0309  1.0223
    (16, 1000, 40)  r past S         0.0314 / 0.0040  0.2633
    four keys / one key, the cell    0.0328 / 0.0344  0.9630 / 0.9518

The kernel is the faster at every one, so the rule's one limit is the
kernel's buffer: a CUDA tensor with r <= R_MAX takes the kernel (its
launcher sizes the buffer from r: the least power of two >= 2 r, at least
64), and past it the stable sort keeps the call.  The rule reads nothing
else of the tensor: a CUDA tensor the kernel cannot read (not int32, not
(S, B), not contiguous) reaches `select_top_r`'s error, not the sort.
"""

from __future__ import annotations

import torch

from . import _build

R_MAX = 1024  # the kernel's shared-memory buffer holds 2 r <= 2048 items a query


def takes_kernel(packed: torch.Tensor, r: int) -> bool:
    """The shape rule: whether `scan.select_survivors` hands this call to
    the kernel."""
    return packed.is_cuda and r <= R_MAX


def select_top_r(packed: torch.Tensor, r: int):
    """K1's (S, B) int32 survivors -> ((B, r) f32 distances, (B, r) int32
    mirror ids), the plain version's contract (module doc), in one launch,
    counted in `select_top_r.launches`.  Raises on a tensor that is not a
    contiguous 2-D int32 CUDA tensor, or on r outside [0, R_MAX]."""
    if packed.dtype != torch.int32:
        raise TypeError(f"select_survivors: packed must be int32, got {packed.dtype}")
    if packed.dim() != 2:
        raise ValueError(f"select_survivors: packed must be (S, B), got {tuple(packed.shape)}")
    if not packed.is_contiguous():
        raise ValueError("select_survivors: packed must be contiguous (the kernel reads it row-major in place)")
    if not packed.is_cuda:
        raise ValueError(f"select_survivors: no kernel for device {packed.device}")
    if not 0 <= r <= R_MAX:
        raise ValueError(f"select_survivors: r {r} outside the kernel's buffer [0, {R_MAX}]")
    S, B = packed.shape
    dev = packed.device
    out_d = torch.empty((B, r), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, r), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_select_survivors(packed.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), S, B, r,
                                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "select_survivors")
    select_top_r.launches += 1
    return out_d, out_i


select_top_r.launches = 0
