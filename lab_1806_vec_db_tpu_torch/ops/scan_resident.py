"""K12, K13, K14: the q-resident scans and their stage-1 candidate
functions (port of ops/pallas_scan.py's `scan_chunkmin`, `scan_dist_int8`,
`scan_chunkmin_int8_t` and `scan_candidates_pallas`,
`scan_candidates_int8_pallas`, `scan_candidates_int8_chunkmin`).

Each scans every row of a base against a whole query batch:
- K12 `scan_chunkmin`: bf16 queries x bf16 rows with f32 sums (compensated
  on the card, float64 in the plain version: module doc of the kernel), one
  (min, lowest argmin) survivor per 128 consecutive rows -> (B, N_pad/128);
- K13 `scan_dist_int8`: int8 queries x int8 rows, exact int32 dots, a bf16
  epilogue, the whole (B, N_pad) bf16 distance matrix;
- K14 `scan_chunkmin_int8_t`: K13's values, one survivor per 128 rows ->
  (N_pad/128, B).
Rows >= n_valid score +inf.  Each candidate function takes an exact top-r
of its kernel's output, to be reranked exactly (K2, `ops/gather.py`).

On a CUDA tensor each scan is its hand-written kernel
(`csrc/scan_bf16_chunkmin.cu`: `wgmma` + TMA, `k12_plan` sizes its launch,
`k12_acc_coords` gives its accumulator map; `csrc/scan_int8_bf16.cu`: int8
`wgmma` + TMA, the same plan and accumulator map, the base read in place);
on a CPU tensor it is the plain PyTorch version `*_ref`.  There is no fallback
from one to the other.

Channels are RAW, as the reference's kernel bodies take them: the base's
int8 scale s_x and cache |x|^2 (l2sqr) or |x| (cosine), never the unified
channels of the store's `device_int8()` mirror.

K13 / K14 ROUNDING ORDER.  With bf(v) = v rounded to bf16 (nearest even)
and every f32 operation rounded once:
    p = bf(bf(dot) * bf(qs * scale))
    l2sqr:  d = bf(bf(qc + cache) - bf(2 p))
    cosine: d = bf(1 - bf(p / bf(max(qc * cache, 1e-10))))
This is what the reference computes in interpret mode on the CPU: XLA
upcasts each bf16 operation of the Pallas body to f32 and rounds its result
back to bf16, keeping no excess precision between them (a probe of the
fused alternatives, the product or the whole epilogue kept in f32, differs
from interpret mode in 6-40% of the values).  The plain versions and the
kernels round in exactly these places, so they agree bit for bit.

Top-r: the reference takes `lax.approx_min_k` on the TPU (ROADMAP's allowed
difference) and an exact `top_k` in interpret mode; here every top-r is
exact with ties to the lower position.
"""

from __future__ import annotations

import torch

from . import _build
from . import distance as D
from .scan import _sm_count
from .topk import INVALID_ID, quantize_rows_int8, smallest_positions, topk_smallest

_NB = 1024  # K12 / K13 row padding (the reference's grid step)
_NB_T = 2048  # K14 row padding
_CHUNK = 128  # rows per survivor
_ROW_ALIGN = 16  # K13 / K14: TMA's row stride is a multiple of 16 bytes (int8 lanes)
_K12_QT = 128  # K12's queries per CTA: 64 (the wgmma M) per consumer; a 128-row chunk is its N
_REF_ROWS = 65536  # rows per block of the plain versions (bounds their transients)


def _bf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (nearest even), held as f32."""
    return x.to(torch.bfloat16).float()


def _pad_rows(n_multiple: int, *tensors):
    """Zero-pad the leading axis of each tensor to a multiple of
    `n_multiple` (the reference's `jnp.pad`)."""
    n = tensors[0].shape[0]
    extra = -n % n_multiple
    if not extra:
        return tensors
    return tuple(torch.cat([t, t.new_zeros((extra, *t.shape[1:]))]) for t in tensors)


def _pad_cols(multiple: int, *tensors):
    """Zero columns up to a multiple: they add nothing to a dot."""
    extra = -tensors[0].shape[1] % multiple
    if not extra:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, extra)) for t in tensors)


def _chunk_min(d: torch.Tensor):
    """(B, R) -> the min of each 128 consecutive columns and the lowest
    column (within the chunk) that attains it, ((B, R/128) f32, int32)."""
    seg = d.view(d.shape[0], -1, _CHUNK)
    m = seg.amin(-1)
    pos = torch.arange(_CHUNK, dtype=torch.int32, device=d.device)
    a = torch.where(seg == m[..., None], pos, _CHUNK).amin(-1)
    return m, a


def _check(dist: str, q, base, *vecs):
    D.check_dist(dist)
    if q.dim() != 2 or base.dim() != 2 or q.shape[1] != base.shape[1]:
        raise ValueError(f"shape mismatch: queries {tuple(q.shape)} vs base {tuple(base.shape)}")
    devs = {t.device for t in (q, base, *vecs)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev


# ---------------------------------------------------------------- K12 ----

def scan_chunkmin_ref(queries_scan, q_cache, base_scan, base_cache, n_valid: int, dist: str):
    """Plain PyTorch version of K12 (N a multiple of 1024): the dot is the
    float64 sum of the exact bf16 products, rounded once to f32 (a yardstick
    within an f32 rounding of exact; the kernel's compensated tensor-core
    sums and the reference's MXU sums each land a few f32 ulps from it), and
    the epilogue runs in f32.  Returns ((B, N/128) f32, (B, N/128) int32
    global row ids)."""
    B = queries_scan.shape[0]
    n = base_scan.shape[0]
    dev = queries_scan.device
    q = queries_scan.double()
    qc = q_cache.float()[:, None]
    outd = torch.empty((B, n // _CHUNK), dtype=torch.float32, device=dev)
    outi = torch.empty((B, n // _CHUNK), dtype=torch.int32, device=dev)
    for r0 in range(0, n, _REF_ROWS):
        r1 = min(r0 + _REF_ROWS, n)
        dots = (q @ base_scan[r0:r1].double().T).float()  # (B, rows)
        ca = base_cache[r0:r1].float()[None, :]
        if dist == "l2sqr":
            d = (qc + ca) - 2.0 * dots
        else:
            d = 1.0 - dots / (qc * ca).clamp_min(1e-10)
        rows = torch.arange(r0, r1, device=dev)
        d = torch.where(rows < n_valid, d, float("inf"))
        m, a = _chunk_min(d)
        c0, c1 = r0 // _CHUNK, r1 // _CHUNK
        outd[:, c0:c1] = m
        outi[:, c0:c1] = a + torch.arange(r0, r1, _CHUNK, dtype=torch.int32, device=dev)
    return outd, outi


def k12_plan(n_pad: int, B: int, sms: int = 132) -> dict:
    """How K12's kernel (csrc/scan_bf16_chunkmin.cu) and K13 / K14's
    (csrc/scan_int8_bf16.cu) cover a (B, n_pad) scan on a card of `sms` SMs
    -> {"qtiles", "ctas", "chunks"}.

    The grid is (qtiles = ceil(B / 128), ctas); CTA (x, y) scans query tile
    x against the 128-row chunks y, y + ctas, y + 2 ctas, ...  ctas fills at
    most one wave (sms // qtiles CTAs a query tile).  In K12 consumer p
    takes the queries 128 x + 64 p ... + 63 of every chunk; in K13 / K14 the
    CTA's i-th chunk goes to consumer i % 2, which multiplies all 128
    queries of the tile while the other runs its own chunk's epilogue."""
    qtiles = -(-B // _K12_QT)
    chunks = n_pad // _CHUNK
    return {"qtiles": qtiles, "ctas": max(1, min(chunks, sms // qtiles)), "chunks": chunks}


def k12_acc_coords(warp, lane, i):
    """(query within the consumer's 64, row within the 128-row chunk) of
    accumulator register i (0 <= i < 64) of `lane` in `warp` (0-3) of a K12
    consumer, the m64n128 wgmma layout with the queries as A and the rows
    as B: query 16 warp + lane // 4 + 8 ((i // 2) % 2), row 8 (i // 4) + 2
    (lane % 4) + i % 2.  A lane thus holds 32 rows of each of its two
    queries, and the 4 lanes of a quad (lane // 4 equal) hold all 128
    (works on ints and arrays)."""
    return 16 * warp + lane // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2


def scan_chunkmin(queries_scan, q_cache, base_scan, base_cache, n_valid: int, dist: str):
    """Fused scan: the min distance of each (query, 128-row chunk) and its
    lowest argmin -> ((B, N_pad/128) f32, (B, N_pad/128) int32 global ids).

    queries_scan (B, dim) in the base's dtype; q_cache (B,) f32 (|q|^2 or
    |q|); base_scan (N, dim) bf16 (the store's `device_traversal()` copy);
    base_cache (N,) f32.  N_pad is N rounded up to a multiple of 1024, the
    rows past N zero rows (the kernel reads them as TMA's zero fill, so the
    base is never copied); rows >= n_valid are +inf.  CPU tensors run the
    plain version (any float base); CUDA tensors launch the kernel, which
    takes bf16 only, and count the launch in `scan_chunkmin.launches`."""
    dev = _check(dist, queries_scan, base_scan, q_cache, base_cache)
    if queries_scan.dtype != base_scan.dtype:
        raise TypeError(f"queries {queries_scan.dtype} and base {base_scan.dtype} must share a dtype")
    B = queries_scan.shape[0]
    n = base_scan.shape[0]
    if q_cache.shape != (B,) or base_cache.shape != (n,):
        raise ValueError("q_cache must be (B,) and base_cache (N,)")
    if dev.type == "cpu":
        return scan_chunkmin_ref(queries_scan, q_cache, *_pad_rows(_NB, base_scan, base_cache), n_valid, dist)
    if base_scan.dtype != torch.bfloat16:
        raise TypeError(f"the K12 kernel takes bf16 rows, got {base_scan.dtype}")
    if not base_scan.is_contiguous():
        raise ValueError("base_scan must be contiguous (the kernel reads it row-major in place)")
    n_pad = -(-n // _NB) * _NB
    if n_pad >= 2**31:
        raise ValueError(f"a base of {n} rows exceeds the kernel's int32 row ids")
    # TMA's row stride is a multiple of 16 bytes: zero columns add nothing to a dot
    q, base_scan = _pad_cols(8, queries_scan.contiguous(), base_scan)
    if q.data_ptr() % 16:
        q = q.clone()
    if base_scan.data_ptr() % 16:
        raise ValueError("base_scan must be 16-byte aligned (TMA reads it in place)")
    qc, ca = q_cache.float().contiguous(), base_cache.float().contiguous()
    S = n_pad // _CHUNK
    outd = torch.empty((B, S), dtype=torch.float32, device=dev)
    outi = torch.empty((B, S), dtype=torch.int32, device=dev)
    if n_pad == 0 or B == 0:
        return outd, outi
    plan = k12_plan(n_pad, B, _sm_count(dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.vecdb_scan_bf16_chunkmin(
            q.data_ptr(), qc.data_ptr(), base_scan.data_ptr(), ca.data_ptr(), outd.data_ptr(),
            outi.data_ptr(), B, n, n_pad, base_scan.shape[1], int(n_valid), int(dist == "cosine"),
            plan["ctas"], stream,
        )
    _build.check(status, "scan_bf16_chunkmin")
    scan_chunkmin.launches += 1
    return outd, outi


scan_chunkmin.launches = 0


# ---------------------------------------------------------- K13 / K14 ----

def _epilogue_bf16(dots, qs, qc, sc, ca, dist: str) -> torch.Tensor:
    """K13 / K14's bf16 epilogue (module doc) on f32 tensors that broadcast:
    exact int dots, query (qs, qc) and row (sc, ca) channels.  Returns the
    bf16 values held as f32."""
    p = _bf(_bf(dots) * _bf(qs * sc))
    if dist == "l2sqr":
        return _bf(_bf(qc + ca) - _bf(2.0 * p))
    return _bf(1.0 - _bf(p / _bf((qc * ca).clamp_min(1e-10))))


def _int8_blocks(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid: int, dist: str):
    """Yield (r0, r1, (B, r1 - r0) f32 distances of bf16 values) over row
    blocks of the base: exact dots (an f32 matmul of int8 values below 2^24,
    TF32 off), the bf16 epilogue, +inf past n_valid."""
    dev = q8.device
    qf = q8.float()
    qs, qc = q_scale.float()[:, None], q_cache.float()[:, None]
    n = base_i8.shape[0]
    for r0 in range(0, n, _REF_ROWS):
        r1 = min(r0 + _REF_ROWS, n)
        dots = qf @ base_i8[r0:r1].float().T
        d = _epilogue_bf16(dots, qs, qc, base_scale[None, r0:r1].float(), base_cache[None, r0:r1].float(), dist)
        rows = torch.arange(r0, r1, device=dev)
        yield r0, r1, torch.where(rows < n_valid, d, float("inf"))


def scan_dist_int8_ref(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid: int, dist: str):
    """Plain PyTorch version of K13 (N a multiple of 1024) -> (B, N) bf16."""
    out = torch.empty((q8.shape[0], base_i8.shape[0]), dtype=torch.bfloat16, device=q8.device)
    for r0, r1, d in _int8_blocks(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid, dist):
        out[:, r0:r1] = d.to(torch.bfloat16)
    return out


def scan_chunkmin_int8_t_ref(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid: int, dist: str):
    """Plain PyTorch version of K14 (N a multiple of 2048) -> ((N/128, B)
    f32, (N/128, B) int32 global ids)."""
    B, n = q8.shape[0], base_i8.shape[0]
    dev = q8.device
    outd = torch.empty((n // _CHUNK, B), dtype=torch.float32, device=dev)
    outi = torch.empty((n // _CHUNK, B), dtype=torch.int32, device=dev)
    for r0, r1, d in _int8_blocks(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid, dist):
        m, a = _chunk_min(d)
        c0, c1 = r0 // _CHUNK, r1 // _CHUNK
        outd[c0:c1] = m.T
        outi[c0:c1] = (a + torch.arange(r0, r1, _CHUNK, dtype=torch.int32, device=dev)).T
    return outd, outi


def _int8_launch(chunkmin: bool, q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid, dist, n_multiple):
    """Checks and the launch shared by K13 and K14.  On the CPU the plain
    version takes the base zero-padded to N_pad rows; on CUDA the kernel
    reads it in place (rows past N are TMA's zero fill)."""
    dev = _check(dist, q8, base_i8, q_scale, q_cache, base_scale, base_cache)
    if q8.dtype != torch.int8 or base_i8.dtype != torch.int8:
        raise TypeError("q8 and base_i8 must be int8")
    B, n = q8.shape[0], base_i8.shape[0]
    if q_scale.shape != (B,) or q_cache.shape != (B,):
        raise ValueError("q_scale and q_cache must be (B,)")
    if base_scale.shape != (n,) or base_cache.shape != (n,):
        raise ValueError("base_scale and base_cache must be (N,)")
    if dev.type == "cpu":
        args = (q8, q_scale, q_cache, *_pad_rows(n_multiple, base_i8, base_scale, base_cache), n_valid, dist)
        return (scan_chunkmin_int8_t_ref if chunkmin else scan_dist_int8_ref)(*args)
    if not base_i8.is_contiguous():
        raise ValueError("base_i8 must be contiguous (the kernel reads it row-major in place)")
    n_pad = -(-n // n_multiple) * n_multiple
    if n_pad >= 2**31:
        raise ValueError(f"a base of {n} rows exceeds the kernel's int32 row ids")
    # TMA's row stride is a multiple of 16 bytes: zero columns add nothing to a dot
    q8, base_i8 = _pad_cols(_ROW_ALIGN, q8.contiguous(), base_i8)
    if q8.data_ptr() % 16:
        q8 = q8.clone()
    if base_i8.data_ptr() % 16:
        raise ValueError("base_i8 must be 16-byte aligned (TMA reads it in place)")
    # the kernel reads the rows' channels in float2 pairs
    qs, qc, sc, ca = (t.float().contiguous() for t in (q_scale, q_cache, base_scale, base_cache))
    sc, ca = (t if t.data_ptr() % 8 == 0 else t.clone() for t in (sc, ca))
    if chunkmin:
        outd = torch.empty((n_pad // _CHUNK, B), dtype=torch.float32, device=dev)
        outi = torch.empty((n_pad // _CHUNK, B), dtype=torch.int32, device=dev)
    else:
        outd, outi = torch.empty((B, n_pad), dtype=torch.bfloat16, device=dev), None
    if n_pad == 0 or B == 0:
        return (outd, outi) if chunkmin else outd
    flags = int(dist == "cosine") | (2 if chunkmin else 0)
    plan = k12_plan(n_pad, B, _sm_count(dev))  # the same 128-query tiles and 128-row chunks
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.vecdb_scan_int8_bf16(
            q8.data_ptr(), qs.data_ptr(), qc.data_ptr(), base_i8.data_ptr(), sc.data_ptr(), ca.data_ptr(),
            outd.data_ptr(), 0 if outi is None else outi.data_ptr(), B, n, n_pad, base_i8.shape[1],
            int(n_valid), flags, plan["ctas"], stream,
        )
    _build.check(status, "scan_int8_bf16")
    if chunkmin:
        scan_chunkmin_int8_t.launches += 1
        return outd, outi
    scan_dist_int8.launches += 1
    return outd


def scan_dist_int8(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid: int, dist: str):
    """Fused int8 distance scan -> the (B, N_pad) bf16 distance matrix.

    q8 (B, dim) int8 with q_scale, q_cache (B,) f32 (`quantize_rows_int8`,
    `distance.dist_cache`); base_i8 (N, dim) int8 with its raw base_scale
    and base_cache (N,) f32.  N_pad is N rounded up to a multiple of 1024,
    the rows past N zero rows (the kernel reads them as TMA's zero fill, so
    the base is not copied unless its rows need zero columns to a multiple
    of 16 bytes); rows >= n_valid are +inf.  CPU tensors run the plain
    version; CUDA tensors launch the kernel and count the launch in
    `scan_dist_int8.launches`."""
    return _int8_launch(False, q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid, dist, _NB)


scan_dist_int8.launches = 0


def scan_chunkmin_int8_t(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid: int, dist: str):
    """K13's distances reduced to one survivor per 128 rows -> ((N_pad/128,
    B) f32 min, (N_pad/128, B) int32 lowest argmin as a global row id).

    Arguments as `scan_dist_int8`; N_pad is N rounded up to a multiple of
    2048, the rows past N zero rows (read in place as `scan_dist_int8`).
    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count the launch in `scan_chunkmin_int8_t.launches`."""
    return _int8_launch(True, q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid, dist, _NB_T)


scan_chunkmin_int8_t.launches = 0


# ------------------------------------------------------ stage-1 entries ----

def _finish(bd, bi, r: int):
    """Pad a (B, rr <= r) top list to r with (+inf, -1); -1 every id whose
    distance is not finite."""
    B, rr = bd.shape
    if rr < r:
        bd = torch.cat([bd, bd.new_full((B, r - rr), float("inf"))], 1)
        bi = torch.cat([bi, bi.new_full((B, r - rr), INVALID_ID)], 1)
    return bd, torch.where(torch.isfinite(bd), bi, INVALID_ID)


def scan_candidates_pallas(queries, base_scan, base_cache, n_valid: int, r: int, dist: str):
    """Stage-1 candidates through K12: ((B, r) f32 distances ascending,
    (B, r) int32 row ids), -1 / +inf padded.  At most one candidate
    survives per 128 consecutive base rows.  base_scan (N, dim) bf16 with
    base_cache (N,) f32 (|x|^2 or |x|)."""
    q_cache = D.dist_cache(queries.float(), dist)
    outd, outi = scan_chunkmin(queries.to(base_scan.dtype), q_cache, base_scan, base_cache, n_valid, dist)
    bd, bi = topk_smallest(outd, outi, min(r, outd.shape[1]))
    return _finish(bd, bi, r)


def scan_candidates_int8_pallas(queries, base_i8, base_scale, base_cache, n_valid: int, r: int, dist: str):
    """Stage-1 candidates through K13 over every row: ((B, r) f32
    distances of bf16 grade ascending, (B, r) int32 row ids), -1 / +inf
    padded.  base_i8 (N, dim) int8 with its RAW base_scale and base_cache
    (N,) f32 (`quantize_rows_int8`'s scale; |x|^2 or |x|)."""
    q = queries.float()
    q_cache = D.dist_cache(q, dist)
    q8, q_scale = quantize_rows_int8(q)
    d = scan_dist_int8(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid, dist)
    bd, pos = smallest_positions(d, min(r, d.shape[1]))
    return _finish(bd, pos.to(torch.int32), r)


def scan_candidates_int8_chunkmin(queries, base_i8, base_scale, base_cache, n_valid: int, r: int, dist: str):
    """Stage-1 candidates through K14: the queries are padded to a multiple
    of 128 (at least 128) as the reference pads them, one candidate
    survives per 128 base rows, then the exact top-r.  Arguments and result
    as `scan_candidates_int8_pallas` (RAW channels)."""
    q = queries.float()
    B = q.shape[0]
    B_pad = max(128, -(-B // 128) * 128)
    if B_pad != B:
        q = torch.cat([q, q.new_zeros((B_pad - B, q.shape[1]))])
    q_cache = D.dist_cache(q, dist)
    q8, q_scale = quantize_rows_int8(q)
    outd, outi = scan_chunkmin_int8_t(q8, q_scale, q_cache, base_i8, base_scale, base_cache, n_valid, dist)
    bd, bi = topk_smallest(outd.T, outi.T, min(r, outd.shape[0]))
    return _finish(bd[:B], bi[:B], r)
