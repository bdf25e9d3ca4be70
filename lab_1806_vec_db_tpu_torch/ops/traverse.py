"""K3: the whole level-0 HNSW beam search in one kernel (port of
ops/pallas_traverse.py's `traverse`).

Per query the kernel (`csrc/traverse.cu`) runs the fused lock-step loop of
`ops/beam.py` with all of its state in shared memory: each iteration reads
the level-0 links of the E selected ids straight from the (cap, L) link
matrix, dedups and compacts them through K4's hash set, scores the novel
rows (K2's row distance, several rows a warp at once), and merges and
selects by K5's merge by rank, until no beam entry is left unexpanded or
`max_iters` is reached: the same semantics as K4 + K2 + K5 and the same
distance bits as K2.  `k3_plan` sizes a CTA's shared memory, so that B =
1000 queries are resident in one wave up to ef 360.

The rows are the full store's f32 rows or the lean tier's bf16 rerank rows
(`VecStore.device_rerank()`), read in place: the kernel is a template on the
row type and upcasts each bf16 lane to f32 before the arithmetic, as the
reference's candidate-row scratch takes the slab's dtype and upcasts at its
distance epilogue.  The plain version upcasts the gathered rows the same way
(`gather_dists_ref`).

The reference packed the links into an (N, 128) table with the node's own
id in lane 0, a TPU DMA-alignment trick; a CUDA thread reads the (cap, L)
rows in place, so there is no packed copy.

`traverse_ref` is the plain version: the same loop on the plain K4, K5 and
K2 versions.  On a CUDA tensor `traverse` launches the kernel (no fallback);
on a CPU tensor it runs `traverse_ref`.
"""

from __future__ import annotations

import torch

from . import _build
from . import beam as BM
from . import beam_fused as BF
from . import gather as G

EL = 128  # neighbor-tile lanes: the kernel requires E * L == 128
THREADS = 128  # a K3 CTA: one thread per tile lane (csrc/traverse.cu)
SMEM_MAX = 227 * 1024  # the most shared memory an H100 CTA may take


def _widths(ef: int) -> int:
    return BF.pow2(max(ef, EL))


def k3_plan(ef: int, R: int, dim: int) -> tuple[int, int]:
    """(log2 of the id set's slots, shared-memory bytes) of one K3 CTA.

    The set holds the beam's and the ring's ids: a power of two of at least
    2 (W + R) slots (W = pow2(max(ef, 128)), the reference's beam width), so
    it stays under half full.  The bytes are `csrc/traverse.cu:smem_bytes`'s
    sum, which the kernel checks: the query row, two beams of ef lanes (d,
    id, e), the set, the tile's id table (256 slots, ids and smallest
    lanes), the ring, the compacted tile (ids, distances), sel (128 lanes)
    and two rows of warp totals, each section rounded up to 4 words."""
    log2_set = (2 * (_widths(ef) + R) - 1).bit_length()
    up4 = lambda n: (n + 3) & ~3
    smem = 4 * (up4(dim) + 6 * up4(ef) + (1 << log2_set) + 2 * 2 * EL + up4(R) + 2 * EL + 128
                + 2 * (THREADS // 32))
    return log2_set, smem


def ctas_per_sm(smem: int, bf16: bool) -> int:
    """K3 CTAs resident on one SM of the current CUDA device at this
    shared-memory size (CUDA's occupancy calculator)."""
    import ctypes

    n = ctypes.c_int(0)
    _build.check(_build.library().vecdb_traverse_ctas_per_sm(int(bf16), smem, ctypes.byref(n)),
                 "traverse occupancy")
    return n.value


def k3_flags(base, dim: int, dist: str) -> int:
    """The kernel's flags: bit 0 cosine; bit 1 the 4-lane vector loads (16
    bytes of f32, 8 of bf16: dim % 4 == 0 and the rows aligned to that);
    bit 2 bf16 rows."""
    bf16 = base.dtype == torch.bfloat16
    vec4 = dim % 4 == 0 and base.data_ptr() % (8 if bf16 else 16) == 0
    return (1 if dist == "cosine" else 0) | (2 if vec4 else 0) | (4 if bf16 else 0)


def traverse_ref(q, base, links0, entry, ef: int, L: int, E: int = 4, R: int = 256,
                 max_iters: int = 92, dist: str = "l2sqr"):
    """Plain version of K3 -> ((B, ef) f32 sorted dists, (B, ef) int32 ids)."""
    nd = lambda ids: G.gather_dists_ref(q, base, ids, dist)
    lf = lambda ids: links0[ids.long()]
    return BM.lockstep(entry, nd, lf, ef, max_iters, E, R, BF.beam_pre_ref, BF.beam_post_ref)


def traverse(q, base, links0, entry, ef: int, L: int, E: int = 4, R: int = 256,
             max_iters: int = 92, dist: str = "l2sqr"):
    """Level-0 beam search from per-query entries.

    q (B, dim) f32 queries; base (n_rows, dim) f32 or bf16 rows (the
    store's, or the lean tier's bf16 rerank rows, read in place); links0 (n_rows, L) int32 level-0 links, -1 padded; entry (B,)
    int32 (-1 = padding query).  E * L must be 128; R <= 256 ring slots.
    Returns ((B, ef) f32 exact distances ascending, (B, ef) int32 ids), -1
    / inf padded.  CUDA tensors launch the kernel and count it in
    `traverse.launches`."""
    if dist not in ("l2sqr", "cosine"):
        raise ValueError("Invalid distance function")
    if E * L != EL or links0.dim() != 2 or links0.shape[1] != L:
        raise ValueError(f"traverse needs E * L == {EL} and links0 (n, L); got E={E}, L={L}, "
                         f"links0 {tuple(links0.shape)}")
    if not 0 < E <= R <= 256 or ef <= 0 or _widths(ef) > BF.MAX_W:
        raise ValueError(f"traverse: need 0 < E <= R <= 256 and 0 < ef <= {BF.MAX_W}")
    log2_set, smem = k3_plan(ef, R, q.shape[1])
    if smem > SMEM_MAX:
        raise ValueError(f"traverse: ef {ef}, R {R}, dim {q.shape[1]} need {smem} bytes of shared "
                         f"memory a CTA (> {SMEM_MAX})")
    if q.dtype != torch.float32 or base.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"traverse takes f32 queries and f32 / bf16 rows, got {q.dtype}/{base.dtype}")
    if links0.dtype != torch.int32 or entry.dtype != torch.int32:
        raise TypeError("links0 and entry must be int32")
    B, dim = q.shape
    if base.shape[1] != dim or entry.shape != (B,) or links0.shape[0] != base.shape[0]:
        raise ValueError("traverse: shape mismatch among q, base, links0, entry")
    devs = {q.device, base.device, links0.device, entry.device}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if not base.is_contiguous() or not links0.is_contiguous():
        raise ValueError("base and links0 must be contiguous (the kernel reads them in place)")
    if dev.type == "cpu":
        return traverse_ref(q, base, links0, entry, ef, L, E, R, max_iters, dist)
    if dev.type != "cuda":
        raise RuntimeError(f"no K3 kernel for device {dev}")
    q, entry = q.contiguous(), entry.contiguous()
    out_d = torch.empty((B, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, ef), dtype=torch.int32, device=dev)
    flags = k3_flags(base, dim, dist)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_traverse(
            q.data_ptr(), base.data_ptr(), links0.data_ptr(), entry.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), B, dim, base.shape[0], L, ef, R, E, max_iters,
            log2_set, smem, flags, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "traverse")
    traverse.launches += 1
    return out_d, out_i


traverse.launches = 0
