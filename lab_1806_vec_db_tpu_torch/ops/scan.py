"""K1: the packed int8 chunk-min scan (port of ops/pallas_scan.py's
`scan_chunkmin_int8_packed` and its wrapper `scan_candidates_int8_packed`).

Stage 1 of the two-stage Flat search: every query is scored against the
whole permuted int8 mirror, and each strided 128-row group keeps one packed
(distance, level) survivor, so the (N, B) distance matrix never exists in
device memory.  The caller takes an exact top-r over the (B, N/128)
survivors, decodes their ids, and reranks them exactly (K2, `ops/gather.py`).

On a CUDA tensor the scan is the hand-written kernel
`csrc/scan_int8_packed.cu` (`wgmma` + TMA; `k1_plan` sizes its launch,
`k1_stage_offset` / `k1_acc_coords` give its tile layouts); on a CPU tensor it is the plain PyTorch version
`scan_chunkmin_int8_packed_ref`, which computes the same int32 values bit for
bit.  There is no fallback from one to the other.

CHANNELS — one distance formula for both metrics:
    d = cache_x + qc_q - dots * (scale_x * qs2_q)
    l2sqr:  cache=|x|^2, qc=|q|^2, scale=s_x,      qs2=2*s_q
    cosine: cache=0,     qc=1,     scale=s_x/|x|,  qs2=s_q/|q|
Invalid rows carry scale 0 and cache +_BIG (a finite sentinel: inf would
turn packed bits into inf/NaN patterns); there is no positional mask.

THE UINT8 VARIANT (`scan_chunkmin_u8_packed`, the kernel
`csrc/scan_u8_exact.cu:scan_u8_exact_kernel`, a body of its own with the rows
as wgmma's B operand; `u8_plan` sizes its launch, `u8_acc_coords` gives its
accumulator layout; plain version `scan_chunkmin_u8_packed_ref`): rows and
queries are uint8 centred by 128 (x8 = u - 128, exact in int8; L2 does not
move), with n8 = |x8|^2 and qn8 = |q8|^2 as int32 channels, and

    d = n8 + qn8 - 2 dot   (exact int32),   packed = (d << 7) | level

exact while d < 2^24, so `u8_exact_width` holds the width to dim 255^2 <
2^23: the row sentinel U8_SENTINEL = 2^23 (a zero row) then reads 2^23 + qn8
< 2^24 and loses to every valid row.  A positive packed int32 orders as its
f32 bits do, so `select_survivors` takes it unchanged; its ids are the rows
of each group's minimum.  The k groups with the least (d, level) minima hold
an exact top-k (ties counted): a row nearer than the k-th distance d_k lies
in a group whose minimum is below d_k, there are fewer than k such groups
and they rank first, and each other chosen group holds a row at d_k or the
k groups hold every row at d_k.  `rescan_u8_groups` scores the k chosen
groups' 128 rows exactly and keeps the top-k, ties to the lower row.
"""

from __future__ import annotations

import torch

from . import _build
from . import distance as D
from . import survivors as SV
from ..utils.profiling import span
from .topk import INVALID_ID, quantize_rows_int8

_BIG = 3.0e38  # finite losing sentinel of invalid mirror rows
_CHUNK = 128  # rows per survivor group
_NB = 2048  # rows per chunk (the reference's NB = CB, `_tiles_for`)
_SB = _NB // _CHUNK  # survivors per chunk (16)
_BK = 128  # the CUDA kernel's int8 depth step (one TMA box): D must be a multiple
_REF_BLOCK = 65536  # rows per block of the plain version (bounds transients)
_K1_BN, _K1_BM = 128, 64  # the kernel's queries per CTA (wgmma N) and rows per tile (M)
_K1_PARTS = (1, 2, 4, 8)  # the parts a chunk may be split into
_K1_ITEM_ROWS = 64  # an item's fixed cost (its survivors' fold and stores) in rows scanned
_INT32_MAX = 2**31 - 1


def query_channels(q_scale: torch.Tensor, q_cache: torch.Tensor, dist: str):
    """Query-side (qs2, qc) for the unified formula (see module doc).
    q_cache is `D.dist_cache(q, dist)`: |q|^2 for l2sqr, |q| for cosine."""
    q_scale = q_scale.float()
    q_cache = q_cache.float()
    if dist == "l2sqr":
        return 2.0 * q_scale, q_cache
    return q_scale / q_cache.clamp_min(1e-20), torch.ones_like(q_cache)


def _pad_rows(base_i8, base_scale, base_cache, multiple: int):
    """Pad the mirror to a whole number of chunks with losing sentinels."""
    n = base_i8.shape[0]
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return base_i8, base_scale, base_cache
    extra = n_pad - n
    return (
        torch.cat([base_i8, base_i8.new_zeros((extra, base_i8.shape[1]))]),
        torch.cat([base_scale.float(), base_scale.new_zeros(extra, dtype=torch.float32)]),
        torch.cat([base_cache.float(), base_cache.new_full((extra,), _BIG, dtype=torch.float32)]),
    )


def scan_chunkmin_int8_packed_ref(q8, qs2, qc, base_i8, base_scale, base_cache):
    """Plain PyTorch version of K1 (same arguments as the wrapper, N a
    multiple of 2048).  The int8 product runs as an f32 matmul, which is
    exact (integers < 2^24, TF32 off); the epilogue rounds each operation in
    the kernel's order.  Returns (N/128, B) int32."""
    B = q8.shape[0]
    n = base_i8.shape[0]
    qf = q8.float()
    qs2 = qs2.float()[:, None]
    qc = qc.float()[:, None]
    lvl = ((torch.arange(_NB, device=q8.device) // _SB).to(torch.int32))
    out = torch.empty((n // _CHUNK, B), dtype=torch.int32, device=q8.device)
    for r0 in range(0, n, _REF_BLOCK):
        r1 = min(r0 + _REF_BLOCK, n)
        dots = qf @ base_i8[r0:r1].float().T  # (B, rows)
        d = (base_cache[None, r0:r1].float() + qc) - dots * (base_scale[None, r0:r1].float() * qs2)
        bits = d.view(torch.int32)
        g = (r1 - r0) // _NB
        m = (bits.reshape(B, g, _NB) & ~(_CHUNK - 1)) | lvl
        # (query, chunk, level, slot) -> min over level
        m = m.reshape(B, g, _CHUNK, _SB).amin(dim=2)
        out[r0 // _CHUNK : r1 // _CHUNK] = m.reshape(B, g * _SB).T
    return out


def k1_plan(n_pad: int, B: int, sms: int = 132) -> dict:
    """How the float K1's kernel (csrc/scan_int8_packed.cu) covers a (n_pad, B) scan
    on a card of `sms` SMs -> {"qtiles", "parts", "ctas", "items"}.

    The grid is (qtiles = ceil(B / 128), ctas).  Each 2048-row chunk is
    split into `parts` items of 2048 / parts rows (1, 2, 4 or 8); CTA
    (x, y) scans query tile x against items y, y + ctas, y + 2 ctas, ...
    (item i: chunk i // parts, part i % parts).  ctas fills at most one
    wave (sms // qtiles CTAs a query tile), and `parts` is the split that
    gives the busiest CTA the least work, an item costing its rows plus
    _K1_ITEM_ROWS (the smallest split on ties): 1 at flat_1m, more on the
    few chunks of an IVF overflow segment.  Where parts > 1 the kernel folds
    partial survivors into the output with atomicMin."""
    qtiles = -(-B // _K1_BN)
    chunks = n_pad // _NB
    per_tile = max(1, sms // qtiles)
    best = None
    for parts in _K1_PARTS:
        items = chunks * parts
        ctas = min(items, per_tile)
        rows = -(-items // ctas) * (_NB // parts + _K1_ITEM_ROWS)
        if best is None or rows < best[0]:
            best = (rows, parts, ctas)
    _, parts, ctas = best
    return {"qtiles": qtiles, "parts": parts, "ctas": ctas, "items": chunks * parts}


def k1_stage_offset(r, c):
    """Byte offset of byte c (0 <= c < 128) of row r within a K1 box as TMA's
    128-byte swizzle writes it (rows 128 bytes apart, 16-byte chunk j of
    row r at chunk j ^ (r % 8)); the same for a 64-row mirror box and the
    128-row query box (works on ints and integer tensors / arrays)."""
    return r * _BK + ((((c % _BK) // 16) ^ (r % 8)) * 16) + c % 16


def k1_acc_coords(warp, lane, i):
    """(row, query column) within a 64 x 128 tile of accumulator register i
    (0 <= i < 64) of `lane` in `warp` (0-3) of a consumer warpgroup, the
    m64n128 wgmma layout: row 16 warp + lane // 4 + 8 ((i // 2) % 2),
    column 8 (i // 4) + 2 (lane % 4) + i % 2.  In a 16-row aligned tile that
    row is level row // 16 and slot row % 16 (works on ints and arrays)."""
    return 16 * warp + lane // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def scan_chunkmin_int8_packed(q8, qs2, qc, base_i8, base_scale, base_cache):
    """Packed-survivor int8 scan -> (N_pad/128, B) int32.

    q8 (B, D) int8; qs2, qc (B,) f32 from `query_channels`; base_i8 (N, D)
    int8 (the permuted mirror); base_scale, base_cache (N,) f32.  N is padded
    here to a multiple of 2048 with +BIG sentinels.  Survivor row c*16 + s
    covers chunk c, slot s; decode: id = c*2048 + (v & 127)*16 + s,
    dist = bitcast_f32(v & ~127).

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count the launch in `scan_chunkmin_int8_packed.launches`."""
    if q8.dtype != torch.int8 or base_i8.dtype != torch.int8:
        raise TypeError("q8 and base_i8 must be int8")
    if q8.dim() != 2 or base_i8.dim() != 2 or q8.shape[1] != base_i8.shape[1]:
        raise ValueError(f"shape mismatch: q8 {tuple(q8.shape)} vs base {tuple(base_i8.shape)}")
    B = q8.shape[0]
    if qs2.shape != (B,) or qc.shape != (B,):
        raise ValueError("qs2 and qc must be (B,)")
    if base_scale.shape != (base_i8.shape[0],) or base_cache.shape != (base_i8.shape[0],):
        raise ValueError("base_scale and base_cache must be (N,)")
    devs = {t.device for t in (q8, qs2, qc, base_i8, base_scale, base_cache)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if not base_i8.is_contiguous():
        raise ValueError("base_i8 must be contiguous (the kernel reads it row-major in place)")
    base_i8, base_scale, base_cache = _pad_rows(base_i8, base_scale, base_cache, _NB)
    if dev.type == "cpu":
        return scan_chunkmin_int8_packed_ref(q8, qs2, qc, base_i8, base_scale, base_cache)
    if dev.type != "cuda":
        raise RuntimeError(f"no K1 kernel for device {dev}")
    if q8.shape[1] % _BK:
        # zero columns are dot-transparent (the store pads to 128 already)
        pad = _BK - q8.shape[1] % _BK
        q8 = torch.nn.functional.pad(q8, (0, pad))
        base_i8 = torch.nn.functional.pad(base_i8, (0, pad))
    n_pad, dpad = base_i8.shape
    if n_pad >= 2**31:
        raise ValueError(f"mirror of {n_pad} rows exceeds the kernel's int32 row coordinates")
    q8 = q8.contiguous()
    if q8.data_ptr() % 16:  # TMA reads from 16-byte aligned bases
        q8 = q8.clone()
    if base_i8.data_ptr() % 16:
        base_i8 = base_i8.clone()
    qs2, qc = qs2.float().contiguous(), qc.float().contiguous()
    base_scale, base_cache = base_scale.float().contiguous(), base_cache.float().contiguous()
    plan = k1_plan(n_pad, B, _sm_count(dev))
    shape = (n_pad // _CHUNK, B)
    out = (torch.full(shape, _INT32_MAX, dtype=torch.int32, device=dev) if plan["parts"] > 1
           else torch.empty(shape, dtype=torch.int32, device=dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.vecdb_scan_int8_packed(
            q8.data_ptr(), qs2.data_ptr(), qc.data_ptr(), base_i8.data_ptr(),
            base_scale.data_ptr(), base_cache.data_ptr(), out.data_ptr(),
            B, n_pad, dpad, plan["parts"], plan["ctas"], stream,
        )
    _build.check(status, "scan_int8_packed")
    scan_chunkmin_int8_packed.launches += 1
    return out


scan_chunkmin_int8_packed.launches = 0


def quantize_queries(queries: torch.Tensor, dim_pad: int, dist: str):
    """(B, dim) f32 queries -> (q8 (B, dim_pad) int8, qs2, qc) for K1."""
    q = queries.float()
    q_cache = D.dist_cache(q, dist)
    q8, q_scale = quantize_rows_int8(q)
    if dim_pad != q8.shape[1]:
        # the mirror's columns are zero-padded to a 128 multiple
        q8 = torch.nn.functional.pad(q8, (0, dim_pad - q8.shape[1]))
    qs2, qc = query_channels(q_scale, q_cache, dist)
    return q8, qs2, qc


def select_survivors(packed: torch.Tensor, r: int):
    """Exact top-r over K1's survivors -> ((B, r) f32 dists, (B, r) int32
    mirror ids), -1 / +inf padded.

    `packed` is K1's (S, B) output.  The order is the packed value viewed
    as f32 (the int32 min within a group and the f32 order across groups
    differ for slightly negative d; both are the reference's).  The
    reference takes this top-r with `lax.approx_min_k(recall_target=0.95)`
    on the TPU; here it is exact, ties lower position first as `lax.top_k`
    orders them.  On the card, where `survivors.takes_kernel` holds, one
    hand-written kernel (the span `scan.select`); else the plain version
    `select_survivors_ref`, which gives the same bits."""
    if SV.takes_kernel(packed, r):
        with span("scan.select"):
            return SV.select_top_r(packed, r)
    return select_survivors_ref(packed, r)


def select_survivors_ref(packed: torch.Tensor, r: int):
    """Plain PyTorch version of the select (`select_survivors`' contract):
    a stable sort of every query's survivors by the packed value viewed as
    f32, the first r gathered and decoded."""
    packed = packed.T  # (B, S)
    B, S = packed.shape
    as_f32 = packed.view(torch.float32)
    rr = min(r, S)
    _, pos = torch.sort(as_f32, dim=1, stable=True)
    pos = pos[:, :rr]
    pk = torch.gather(packed, 1, pos)
    pos32 = pos.to(torch.int32)
    base0 = (pos32 // _SB) * _NB + pos32 % _SB
    bd = (pk & ~(_CHUNK - 1)).view(torch.float32)
    bi = base0 + (pk & (_CHUNK - 1)) * _SB
    if rr < r:
        bd = torch.cat([bd, bd.new_full((B, r - rr), float("inf"))], 1)
        bi = torch.cat([bi, bi.new_full((B, r - rr), INVALID_ID)], 1)
    bad = bd >= 1.0e38
    return torch.where(bad, float("inf"), bd), torch.where(bad, INVALID_ID, bi)


def scan_candidates_int8_packed(queries, base_i8, base_scale, base_cache, r: int, dist: str):
    """Stage-1 candidate selection: quantize the queries, run K1 over the
    permuted mirror, take the exact top-r survivors.  Returns ((B, r) f32
    16-mantissa-bit distances, (B, r) int32 MIRROR ids, -1 padded); decode
    them with `topk.decode_perm` before the rerank."""
    q8, qs2, qc = quantize_queries(queries, base_i8.shape[1], dist)
    packed = scan_chunkmin_int8_packed(q8, qs2, qc, base_i8, base_scale, base_cache)
    return select_survivors(packed, r)


# ------------------------------------------------------------------ uint8 ----
U8_SENTINEL = 2**23  # n8 of a zero mirror row that holds no valid row
_U8_QM, _U8_BOX = 64, 128  # the uint8 kernel's queries a tile (wgmma M) and rows a box (wgmma N)
_U8_QS = (1, 2, 4)  # the query tiles a consumer may run against each box (the kernel's instantiations)
_U8_BOX_COST = 1.0  # a box's fixed cost a consumer (its wait, its row channel, its L2 feed) in tiles' products
_U8_ITEM_ROWS = 128  # an item's fixed cost (the pipeline's drain, the stores) in rows scanned
_U8_SMEM, _U8_MIN_RING, _U8_MAX_RING = 232448, 3, 16  # the kernel's shared memory, its ring's bounds


def u8_exact_width(dim: int) -> bool:
    """Whether the uint8 variant is exact at `dim`: every distance below
    U8_SENTINEL = 2^23, and the sentinel plus |q8|^2 <= dim 2^14 below 2^24
    (dim <= 129)."""
    return dim * 255**2 < U8_SENTINEL


def scan_chunkmin_u8_packed_ref(q8, qn8, base_i8, base_n8):
    """Plain PyTorch version of the uint8 variant (N a multiple of 2048) ->
    (N/128, B) int32, equal to the kernel's.  The product runs as an f32
    matmul, exact (|dot| <= 256 * 128^2 < 2^24 at the widths it takes)."""
    B = q8.shape[0]
    n = base_i8.shape[0]
    qf = q8.float()
    qn8 = qn8.to(torch.int32)[:, None]
    lvl = (torch.arange(_NB, device=q8.device) // _SB).to(torch.int32)
    out = torch.empty((n // _CHUNK, B), dtype=torch.int32, device=q8.device)
    for r0 in range(0, n, _REF_BLOCK):
        r1 = min(r0 + _REF_BLOCK, n)
        dots = (qf @ base_i8[r0:r1].float().T).to(torch.int32)  # (B, rows)
        d = base_n8[None, r0:r1].to(torch.int32) + qn8 - 2 * dots
        g = (r1 - r0) // _NB
        m = (d * _CHUNK).reshape(B, g, _NB) + lvl
        m = m.reshape(B, g, _CHUNK, _SB).amin(dim=2)
        out[r0 // _CHUNK : r1 // _CHUNK] = m.reshape(B, g * _SB).T
    return out


def u8_ring(kt: int, q: int) -> int:
    """The row boxes the uint8 kernel's ring holds at KT = lanes / 128 boxes
    of depth and q query tiles a consumer (`csrc/scan_u8_exact.cu:layout`:
    the 2 q resident query tiles and their qn8, then KT 16 KB boxes and a
    512-byte row channel a stage); the kernel refuses fewer than 3."""
    fixed = 1024 + 2 * q * kt * _U8_QM * _BK + 2 * q * _U8_QM * 4 + 8
    return min((_U8_SMEM - fixed) // (kt * _U8_BOX * _BK + _U8_BOX * 4 + 16), _U8_MAX_RING)


def u8_plan(n_pad: int, B: int, lanes: int, sms: int = 132) -> dict:
    """How the uint8 kernel (csrc/scan_u8_exact.cu) covers a (n_pad, B) scan
    at `lanes` (128 or 256) on a card of `sms` SMs -> {"qgroups", "q",
    "parts", "ctas", "items"}.

    A CTA holds 2 q query tiles of 64 (128 q queries, resident), each of its
    two consumers runs q of them against every 128-row box, so the rows
    cross L2 once per query group.  The grid is (qgroups = ceil(B / 128 q),
    ctas); items (chunk i // parts, part i % parts of 2048 / parts rows) are
    dealt to a group's CTAs round-robin, at most one wave (sms // qgroups
    CTAs a group).  The plan takes the (q, parts) whose busiest CTA costs
    least: its items' rows plus _U8_ITEM_ROWS, times q tiles plus
    _U8_BOX_COST a box; the larger q, then the smaller split, on ties.  A q
    whose ring would hold fewer than 3 boxes at these lanes is not taken.
    Where parts > 1 the kernel folds partial survivors with atomicMin."""
    kt = lanes // _BK
    chunks = n_pad // _NB
    best = None
    for q in _U8_QS:
        if u8_ring(kt, q) < _U8_MIN_RING:
            continue
        qgroups = -(-B // (2 * q * _U8_QM))
        per_group = max(1, sms // qgroups)
        for parts in _K1_PARTS:
            items = chunks * parts
            ctas = min(items, per_group)
            cost = -(-items // ctas) * (_NB // parts + _U8_ITEM_ROWS) * (q + _U8_BOX_COST)
            key = (cost, -q, parts)
            if best is None or key < best[0]:
                best = (key, {"qgroups": qgroups, "q": q, "parts": parts, "ctas": ctas, "items": items})
    return best[1]


def u8_acc_coords(warp, lane, i):
    """(query, column, slot, level) within a (64-query tile, 128-row box)
    of accumulator register i (0 <= i < 64) of `lane` in `warp` (0-3) of a
    consumer warpgroup of the uint8 kernel, whose A operand is the queries
    and B the box's rows (the m64n128 wgmma layout): query 16 warp + lane //
    4 + 8 ((i // 2) % 2), column 8 (i // 4) + 2 (lane % 4) + i % 2; a box
    starts on a 16-row boundary, so the column is slot column % 16 and level
    column // 16 of the box (works on ints and arrays)."""
    col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
    return 16 * warp + lane // 4 + 8 * ((i // 2) % 2), col, col % _SB, col // _SB


def scan_chunkmin_u8_packed(q8, qn8, base_i8, base_n8):
    """Packed-survivor exact uint8 scan -> (N/128, B) int32, the
    survivor layout of `scan_chunkmin_int8_packed` with (d << 7) | level
    values (module doc).

    q8 (B, D) int8 and base_i8 (N, D) int8 the centred rows, D a multiple
    of 128 with zero lanes past the width; qn8 (B,) and base_n8 (N,) int32
    their squared norms, U8_SENTINEL on zero rows holding no valid row; N
    a multiple of 2048 (`models/mirror.py:U8Mirror` builds it so; another N
    raises ValueError).  CPU tensors run the plain version; CUDA tensors
    launch the kernel and count the launch in
    `scan_chunkmin_u8_packed.launches`."""
    if q8.dtype != torch.int8 or base_i8.dtype != torch.int8:
        raise TypeError("q8 and base_i8 must be int8")
    if qn8.dtype != torch.int32 or base_n8.dtype != torch.int32:
        raise TypeError("qn8 and base_n8 must be int32")
    if q8.dim() != 2 or base_i8.dim() != 2 or q8.shape[1] != base_i8.shape[1] or q8.shape[1] % _BK:
        raise ValueError(f"shape mismatch or width not a multiple of {_BK}: q8 {tuple(q8.shape)} vs base "
                         f"{tuple(base_i8.shape)}")
    B = q8.shape[0]
    if qn8.shape != (B,) or base_n8.shape != (base_i8.shape[0],):
        raise ValueError("qn8 must be (B,) and base_n8 (N,)")
    devs = {t.device for t in (q8, qn8, base_i8, base_n8)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if not base_i8.is_contiguous() or not base_n8.is_contiguous():
        raise ValueError("base_i8 and base_n8 must be contiguous (the kernel reads them in place)")
    if base_i8.shape[0] % _NB:
        raise ValueError(f"the mirror's {base_i8.shape[0]} rows are not a multiple of {_NB}")
    if dev.type == "cpu":
        return scan_chunkmin_u8_packed_ref(q8, qn8, base_i8, base_n8)
    if dev.type != "cuda":
        raise RuntimeError(f"no uint8 K1 kernel for device {dev}")
    n_pad, dpad = base_i8.shape
    if n_pad >= 2**31:
        raise ValueError(f"mirror of {n_pad} rows exceeds the kernel's int32 row coordinates")
    if dpad > 2 * _BK:
        raise ValueError(f"{dpad} lanes: the uint8 kernel takes at most {2 * _BK} (width <= 129)")
    q8, qn8 = q8.contiguous(), qn8.contiguous()
    if q8.data_ptr() % 16:  # TMA reads from 16-byte aligned bases
        q8 = q8.clone()
    if base_i8.data_ptr() % 16:
        raise ValueError("base_i8 must start on a 16-byte boundary (TMA)")
    plan = u8_plan(n_pad, B, dpad, _sm_count(dev))
    shape = (n_pad // _CHUNK, B)
    out = (torch.full(shape, _INT32_MAX, dtype=torch.int32, device=dev) if plan["parts"] > 1
           else torch.empty(shape, dtype=torch.int32, device=dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.vecdb_scan_u8_exact(q8.data_ptr(), qn8.data_ptr(), base_i8.data_ptr(), base_n8.data_ptr(),
                                         out.data_ptr(), B, n_pad, dpad, plan["parts"], plan["ctas"], plan["q"],
                                         stream)
    _build.check(status, "scan_u8_exact")
    scan_chunkmin_u8_packed.launches += 1
    return out


scan_chunkmin_u8_packed.launches = 0


def u8_group_rows(cand: torch.Tensor) -> torch.Tensor:
    """(B, G) int32 rows of the groups' minima (`select_survivors`' ids) ->
    (B, G * 128) int64 rows of those groups: group (c, s) holds rows
    c * 2048 + s + 16 l, l = 0..127."""
    c = cand.long()
    first = (c // _NB) * _NB + c % _SB
    rows = first[:, :, None] + _SB * torch.arange(_CHUNK, device=cand.device)
    return rows.reshape(cand.shape[0], -1)


def rescan_u8_groups(q8, qn8, base_i8, base_n8, rows: torch.Tensor, k: int):
    """Exact uint8 distances of each query to its `rows` ((B, R) int64
    mirror rows, distinct a query) and their top-k -> ((B, k) f32 exact
    integer distances ascending, (B, k) int32 mirror rows), ties to the
    lower row.  The products run as a batched f32 product, exact for
    integers of 8 bits at these widths, whatever the matmul precision."""
    g = base_i8[rows]  # (B, R, D)
    dots = torch.bmm(g.float(), q8.float()[:, :, None])[:, :, 0].to(torch.int32)
    d = base_n8[rows] + qn8[:, None] - 2 * dots
    n_rows = base_i8.shape[0]
    top = torch.topk(d.long() * n_rows + rows, k, dim=1, largest=False).values  # sorted, ascending
    return (top // n_rows).float(), (top % n_rows).to(torch.int32)
