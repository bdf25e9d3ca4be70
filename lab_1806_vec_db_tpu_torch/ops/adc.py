"""K7, K8, K9 and K11: the PQ-ADC kernels (port of ops/pallas_adc.py).

- K7 `adc_chunkmin` (`csrc/adc_scan_chunkmin.cuh`): the full ADC scan over
  the permuted codes with an int8 LUT, fused with a chunk-min (1, 2, 4, 8,
  16 or 32 rows, default 32); the scan of Flat+PQ and of HNSW+PQ route
  "scan", the codes tier's stage 0 and the IVF-PQ overflow segment.
  `adc_scan_chunkmin` adds the LUT quantization, the top-k over the
  survivors and the id decode.
- K11 `adc_chunkmin_binned` (`csrc/adc_chunkmin_binned.cuh`): the same
  chunk-min over the cluster-sorted posting lists of IVF-PQ, each list row
  scored against only the queries binned to its list, on a `wgmma` pipeline
  of its own whose N (32 or 64) fits each 64-column bin block
  (`k11_plan`) and whose LUT rows are gathered through the bins
  (`k11_stage_offset` says where they land; `k7_stage_offset` for K7's).
- K8 / K9 `adc_sums_dense` and `adc_sums_ids` (`csrc/adc_sums.cu`; K8's
  kernels for k = 16: its dense int8 shape on K7's one-hot `wgmma`
  pipeline (`k8_dense_operands`), its ids shape a warp per query
  (`k8_ids_plan`); K9's own kernels for k = 256, `k9_dense_layout`):
  ADC sums of every code row against every LUT row (`adc_scan_pallas`, the
  scan of small sets and of n_bits = 8 tables) and of per-query candidate
  ids (`adc_dists_for_ids`, the HNSW+PQ node distance; it replaces the
  TPU's 128-query diagonal trick).

The LUT is rounded as the reference rounds it (`_prep_lut_quant`,
`_adc_sums_v2`, `_adc_sums_stepwise`): int8 with a per-row scale
s = max|lut_row| / 127 (1 where that is 0), q = round_half_even(lut / s);
bf16 for `adc_dists_for_ids` and for every k = 256 table; f32 under
`exact`.  For cosine the centroid-sqnorm row goes through the same rounding
(K7: its own int8 scale, floored at 1e-30).

Each kernel has a plain PyTorch version here that computes the same bits:
the int8 sums are exact int32 sums, and the bf16 / f32 sums add the groups
in order (i = 0 .. m-1), as the kernels do.  Against the JAX package the
bf16 / f32 sums of K8 differ in summation order only.  On a CUDA tensor a
wrapper launches its kernel (no fallback); on a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

import torch

from . import _build
from . import pq as P
from . import topk as T

CHUNK = 32  # rows per K7 survivor by default
CHUNKS = (1, 2, 4, 8, 16, 32)  # the chunk sizes K7 and K11 take
_NT = 256  # the reference's row tile: survivors cover ceil(N / 256) * 256 rows
_TILE_BIN = 512  # K11's list rows per LUT pass: lpad is a multiple
_REF_BLOCK = 8192  # rows per block of K7's plain version (bounds the one-hot)
_LUT_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
_SMEM_MAX = 232448  # shared memory one H100 CTA may take


def _device_of(*tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no ADC kernel for device {dev}")
    return dev


def unpack_codes(codes: torch.Tensor, m: int, packed: bool) -> torch.Tensor:
    """(..., cw) uint8 code bytes -> (..., m) int64 codes (low nibble first
    when packed; groups past the bytes read as 0)."""
    c = (P.unpack_codes_4bit_dev(codes, 2 * codes.shape[-1]) if packed else codes).to(torch.int64)
    if c.shape[-1] < m:
        c = torch.nn.functional.pad(c, (0, m - c.shape[-1]))
    return c[..., :m]


# XLA folds the reference's `x / 127.0` into a product with the f32
# reciprocal of 127; the port computes the scales the same way, so they (and
# every int8 entry) equal the reference's bit for bit
_INV_127 = 1.0 / 127.0


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (the kernels' IEEE sqrtf): taken
    in f64 and rounded once, since torch's vectorized f32 sqrt on the CPU is
    off by an ulp on some inputs."""
    return x.double().sqrt().float()


def quantize_lut_int8(lut_flat: torch.Tensor):
    """Per-row symmetric int8 quantization of (R, W) f32 LUT rows ->
    ((R, W) int8, (R,) f32 scales): s = max|row| / 127 (1 where 0),
    q = round(row / s) (half to even, a true division by s)."""
    s = lut_flat.abs().amax(1) * _INV_127
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.round(lut_flat / s[:, None]).to(torch.int8), s


# ---------------------------------------------------------------- K7 ----

def adc_chunkmin_ref(codes, lut_q, scales, q_norms, cs_q, cs_scale, n_valid: int, packed: bool,
                     S: int, chunk: int = CHUNK):
    """Plain version of K7 -> ((B, S) f32 minima of each `chunk` rows,
    (B, S) int32 their lowest positions).  lut_q (B, Kd) int8 (or bf16 /
    f32, then `scales` are ones), Kd = 16 * mk; cs_q (Kd,) with its scale,
    or None (l2sqr).  The
    one-hot product runs as an f32 matmul: its int8 sums are exact integers
    (< 2^24; TF32 is off)."""
    B, Kd = lut_q.shape
    mk = Kd // 16
    N = codes.shape[0]
    dev = lut_q.device
    lut_f = lut_q.float().T.contiguous()  # (Kd, B)
    cs_f = None if cs_q is None else cs_q.float()
    out_d = torch.empty((B, S), dtype=torch.float32, device=dev)
    out_p = torch.empty((B, S), dtype=torch.int32, device=dev)
    for r0 in range(0, S * chunk, _REF_BLOCK):
        r1 = min(r0 + _REF_BLOCK, S * chunk)
        c = unpack_codes(codes[r0:min(r1, N)], mk, packed)
        if c.shape[0] < r1 - r0:
            c = torch.nn.functional.pad(c, (0, 0, 0, r1 - r0 - c.shape[0]))
        oh = torch.zeros((r1 - r0, mk, 16), dtype=torch.float32, device=dev)
        oh.scatter_(2, c[:, :, None], 1.0)
        oh = oh.reshape(r1 - r0, Kd)
        d = (oh @ lut_f) * scales[None, :]  # (rows, B)
        if cs_f is not None:
            c_sq = (oh @ cs_f) * cs_scale
            norm0 = _sqrt_rn(c_sq.clamp_min(0.0))
            d = 1.0 - d / (norm0[:, None] * q_norms[None, :]).clamp_min(1e-10)
        pos = torch.arange(r0, r1, device=dev)
        d = torch.where(pos[:, None] < n_valid, d, float("inf"))
        dc = d.T.reshape(B, -1, chunk)
        arg = dc.argmin(-1)  # the first (lowest-position) minimum
        s0, s1 = r0 // chunk, r1 // chunk
        out_d[:, s0:s1] = torch.gather(dc, 2, arg[:, :, None])[:, :, 0]
        out_p[:, s0:s1] = (pos[::chunk][None, :] + arg).to(torch.int32)
    return out_d, out_p


# K7's kernel (csrc/adc_scan_chunkmin.cuh) stages its LUT in 128-column TMA
# boxes of 128 queries with a 128-byte swizzle: query n's column c lands at
# byte n * 128 + (((c % 128) // 16) ^ (n % 8)) * 16 + c % 16 of the stage;
# the cosine column shares the rest of its shared memory
_K7_BK, _K7_BN = 128, 128
_K7_KD_MAX = _SMEM_MAX - (1024 + 8 * _K7_BK * _K7_BN + 128 + 8 * _K7_BN)


def k7_stage_offset(n, c):
    """Byte offset of LUT column c of CTA query n within its K7 stage
    (works on ints and integer tensors / arrays)."""
    return n * _K7_BK + ((((c % _K7_BK) // 16) ^ (n % 8)) * 16) + c % 16


def k7_pack(codes, lut_q, cs_q):
    """K7's kernel takes nibble-packed codes: one code a byte (N, cw) ->
    ((N, cw') packed, low nibble first, cw' a multiple of 4; the LUT and the
    cosine column zero-padded to 32 cw' columns).  Padding groups read code
    0 against zero columns, so every sum stays as it was."""
    N, cw = codes.shape
    c = torch.nn.functional.pad(codes, (0, cw % 2))
    packed = c[:, 0::2] | (c[:, 1::2] << 4)
    packed = torch.nn.functional.pad(packed, (0, -packed.shape[1] % 4)).contiguous()
    extra = 32 * packed.shape[1] - lut_q.shape[1]
    lut_q = torch.nn.functional.pad(lut_q, (0, extra))
    cs_q = None if cs_q is None else torch.nn.functional.pad(cs_q, (0, extra))
    return packed, lut_q, cs_q


def _check_chunk(chunk: int) -> None:
    if chunk not in CHUNKS:
        raise ValueError(f"chunk must be one of {CHUNKS}, got {chunk}")


def adc_chunkmin(codes, lut_q, scales, q_norms, cs_q, cs_scale, n_valid: int, packed: bool,
                 S: int, chunk: int = CHUNK):
    """K7: the (B, S) chunk-min survivors of the ADC scan over `codes`
    ((N, cw) uint8, cw % 4 == 0, Kd = 16 groups per code byte (32 when
    packed); see `adc_scan_chunkmin` for the rest).  CPU tensors run the
    plain version; CUDA tensors launch the kernel (int8 LUT only; one code
    a byte is packed first, `k7_pack`) and count it in
    `adc_chunkmin.launches`."""
    _check_chunk(chunk)
    dev = _device_of(codes, lut_q, scales, q_norms, cs_q)
    B, Kd = lut_q.shape
    N, cw = codes.shape
    if codes.dtype != torch.uint8 or cw % 4 or Kd != 16 * (2 * cw if packed else cw):
        raise ValueError(f"K7 needs uint8 codes with cw % 4 == 0 and 16 LUT columns per code "
                         f"group; got cw={cw}, Kd={Kd}, packed={packed}")
    if dev.type == "cpu":
        return adc_chunkmin_ref(codes, lut_q, scales, q_norms, cs_q, cs_scale, n_valid, packed, S,
                                chunk)
    if lut_q.dtype != torch.int8:
        raise ValueError("the K7 kernel takes an int8 LUT (lut_dtype='int8')")
    if not packed:
        codes, lut_q, cs_q = k7_pack(codes, lut_q, cs_q)
        cw = codes.shape[1]
    if -(-N // 2048) > 65535 or 32 * cw > _K7_KD_MAX:
        raise ValueError(f"K7: {N} rows x {2 * cw} groups exceed the kernel's grid or shared memory")
    codes, lut_q = codes.contiguous(), lut_q.contiguous()
    if lut_q.data_ptr() % 16:  # the TMA reads the LUT from a 16-byte aligned base
        lut_q = lut_q.clone()
    scales, q_norms = scales.float().contiguous(), q_norms.float().contiguous()
    cs_ptr = 0 if cs_q is None else cs_q.contiguous().data_ptr()
    out_d = torch.empty((B, S), dtype=torch.float32, device=dev)
    out_p = torch.empty((B, S), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_adc_chunkmin(
            codes.data_ptr(), lut_q.data_ptr(), scales.data_ptr(), q_norms.data_ptr(), cs_ptr,
            float(cs_scale), out_d.data_ptr(), out_p.data_ptr(), B, N, int(n_valid), cw, 2 * cw, S,
            1, chunk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "adc_chunkmin")
    adc_chunkmin.launches += 1
    return out_d, out_p


adc_chunkmin.launches = 0


def chunkmin_inputs(lookup, cb_sqnorm, dist: str, packed: bool, cw: int, lut_dtype: str = "int8"):
    """K7's LUT operands from (B, m, k) f32 lookup rows: (lut_q (B, Kd),
    scales (B,), cs_q (Kd,) or None, cs_scale) with Kd = 16 * mk columns in
    group order (zero columns for the groups past m), as `_prep_lut_quant`
    and the cosine column of `adc_scan_chunkmin` round them."""
    B, m, k = lookup.shape
    mk = 2 * cw if packed else cw
    lut = torch.nn.functional.pad(lookup.float(), (0, 0, 0, mk - m)).reshape(B, mk * k)
    cs = None
    cs_scale = torch.ones((), dtype=torch.float32, device=lookup.device)
    if dist == "cosine":
        cs = torch.nn.functional.pad(cb_sqnorm.float(), (0, 0, 0, mk - m)).reshape(mk * k)
    if lut_dtype == "int8":
        lut_q, scales = quantize_lut_int8(lut)
        if cs is not None:
            cs_scale = (cs.abs().amax() * _INV_127).clamp_min(1e-30)
            cs = torch.round(cs / cs_scale).to(torch.int8)
        return lut_q, scales, cs, cs_scale
    dt = torch.float32 if lut_dtype == "f32" else torch.bfloat16
    ones = torch.ones(B, dtype=torch.float32, device=lookup.device)
    return lut.to(dt), ones, None if cs is None else cs.to(dt), cs_scale


def adc_scan_chunkmin(lookup, codes, perm, n_valid: int, cb_sqnorm, q_norms, k_out: int,
                      dist: str, packed: bool = False, lut_dtype: str = "int8",
                      chunk: int = CHUNK, selector: str = "exact", lut=None):
    """Full ADC scan fused with a chunk-min partial top-k (K7) -> ((B, k_out)
    f32 ADC distances ascending, (B, k_out) int32 ORIGINAL ids), -1 padded.

    lookup (B, m, 16) f32; codes (N, cw) uint8, PERMUTED (position p holds
    row perm[p]; padding is masked by position, so positions [0, n_valid)
    must hold exactly the valid rows); cb_sqnorm (m, 16); q_norms (B,).
    Each `chunk`-position group keeps its minimum (the lowest position on
    ties); the top-k over the S = ceil(N / 256) * 256 / chunk survivors is a
    stable sort, and the positions decode through `perm`
    (pallas_adc.py:536-551).  `selector="approx"` is the reference's
    `approx_min_k(recall_target=0.95)` for wide survivor rows; on the CPU
    that call is exact, and here both selectors take the exact stable
    top-k.  `lut`: the LUT operands `chunkmin_inputs` gives for these codes
    (their cw padded to a multiple of 4), built beforehand; None builds
    them here."""
    if selector not in ("exact", "approx"):
        raise ValueError(f"selector must be 'exact' or 'approx', got {selector!r}")
    B, m, k = lookup.shape
    if k != 16:
        raise ValueError(f"adc_scan_chunkmin serves k = 16 tables, got k = {k}")
    _check_chunk(chunk)
    N, cw = codes.shape
    if cw % 4:
        codes = torch.nn.functional.pad(codes, (0, 4 - cw % 4))
        cw = codes.shape[1]
    S = -(-N // _NT) * _NT // chunk
    if lut is None:
        lut = chunkmin_inputs(lookup, cb_sqnorm, dist, packed, cw, lut_dtype)
    lut_q, scales, cs_q, cs_scale = lut
    dmin, pos = adc_chunkmin(codes, lut_q, scales, q_norms.float(), cs_q, cs_scale, n_valid,
                             packed, S, chunk)
    kk = min(k_out, S)
    td, tp = T.topk_smallest(dmin, pos, kk)
    ids = torch.where(torch.isfinite(td), perm[tp.clamp(0, N - 1).long()].to(torch.int32), -1)
    return T._pad_k(td, ids, k_out)


# ---------------------------------------------------------------- K11 ----

def adc_chunkmin_binned_ref(codes, lut_q, scales, q_norms, cs_q, cs_scale, lens, bins, lpad: int,
                            packed: bool, chunk: int):
    """Plain version of K11 -> ((nlist, QB, lpad / chunk) f32 minima of each
    `chunk` list rows, int32 their lowest GLOBAL slots l * lpad + x).  codes
    (>= nlist * lpad, cw) cluster-sorted; lut_q (B, Kd) int8 with `scales`,
    q_norms, cs_q / cs_scale as K7 takes them; lens (nlist,) valid rows per
    list; bins (nlist, QB) query ids, -1 empty (those columns give +inf and
    each chunk's first slot).  The one-hot product runs as an f32 matmul,
    exact for int8 sums."""
    nlist, QB = bins.shape
    Kd = lut_q.shape[1]
    mk = Kd // 16
    dev = lut_q.device
    SL = lpad // chunk
    out_d = torch.empty((nlist, QB, SL), dtype=torch.float32, device=dev)
    out_p = torch.empty((nlist, QB, SL), dtype=torch.int32, device=dev)
    lut_f = lut_q.float()
    cs_f = None if cs_q is None else cs_q.float()
    x = torch.arange(lpad, device=dev)
    first = torch.arange(SL, device=dev) * chunk
    per = max(1, _REF_BLOCK // lpad)  # lists per block (bounds the one-hot)
    for l0 in range(0, nlist, per):
        l1 = min(l0 + per, nlist)
        L = l1 - l0
        c = unpack_codes(codes[l0 * lpad : l1 * lpad], mk, packed)
        oh = torch.zeros((L * lpad, mk, 16), dtype=torch.float32, device=dev)
        oh.scatter_(2, c[:, :, None], 1.0)
        oh = oh.reshape(L, lpad, Kd)
        b = bins[l0:l1].long()
        safe = b.clamp_min(0)
        d = torch.bmm(oh, lut_f[safe].transpose(1, 2)) * scales[safe][:, None, :]  # (L, lpad, QB)
        if cs_f is not None:
            c_sq = (oh @ cs_f) * cs_scale  # (L, lpad)
            norm0 = _sqrt_rn(c_sq.clamp_min(0.0))
            d = 1.0 - d / (norm0[:, :, None] * q_norms[safe][:, None, :]).clamp_min(1e-10)
        keep = (x[None, :] < lens[l0:l1, None])[:, :, None] & (b >= 0)[:, None, :]
        dc = torch.where(keep, d, float("inf")).transpose(1, 2).reshape(L, QB, SL, chunk)
        arg = dc.argmin(-1)  # the first (lowest-slot) minimum
        out_d[l0:l1] = torch.gather(dc, 3, arg[..., None])[..., 0]
        base = torch.arange(l0, l1, device=dev) * lpad
        out_p[l0:l1] = (base[:, None, None] + first[None, None, :] + arg).to(torch.int32)
    return out_d, out_p


# K11's kernel (csrc/adc_chunkmin_binned.cuh): a CTA takes one list, 2048 of
# its rows and 64 bin columns, in LUT passes of 512 rows at N 32 and 256 at
# N 64 (each of two consumers owns half a pass); each ring stage holds 512
# LUT columns as four 128-column sub-stages of N rows (the block's columns'
# LUT rows, gathered through the bins), each in the 128-byte swizzle that
# TMA would write for an N-row box
_K11_BLOCK, _K11_SUB, _K11_SUBS = 64, 128, 4
_K11_SMEM = 1024 + 4 * (_K11_SUBS * _K11_BLOCK * _K11_SUB + _TILE_BIN * 16) + 64 + 64 * 20 + 16


def k11_stage_offset(n, c, N: int):
    """Byte offset of LUT column c (0 <= c < 512) of block column n within
    K11's ring stage of N-row sub-stages (works on ints and integer tensors
    / arrays): sub-stage c // 128, row n at 128 n, 16-byte chunk j of the
    row at chunk j ^ (n % 8)."""
    return (c // _K11_SUB) * N * _K11_SUB + n * _K11_SUB + ((((c % _K11_SUB) // 16) ^ (n % 8)) * 16) + c % 16


def k11_plan(lens, bins, lpad: int):
    """What K11's CTAs do with `bins` (nlist, QB) and `lens` (nlist,), as the
    kernel decides it on the card -> (n (nlist, ceil(QB / 64)) int64: the
    wgmma N of each (list, 64-column block), 0 where no column of the block
    is filled (the CTA only writes +inf), 32 where the last filled column is
    among the block's first 32, else 64; live (nlist, ceil(QB / 64), lpad /
    128) bool: whether the consumer that owns each 128 list rows runs its
    product (a consumer owns 256 rows at N 32, 128 at N 64, and runs only if
    its first row is below lens[l]; the rest write +inf))."""
    nlist, QB = bins.shape
    nb = -(-QB // _K11_BLOCK)
    filled = torch.nn.functional.pad(bins >= 0, (0, nb * _K11_BLOCK - QB)).reshape(nlist, nb, _K11_BLOCK)
    col = torch.arange(1, _K11_BLOCK + 1, device=bins.device)
    last = torch.where(filled, col, 0).amax(2)  # 1 + the last filled column, 0 if none
    n = torch.where(last == 0, 0, torch.where(last > 32, 64, 32))
    rows = torch.arange(0, lpad, 128, device=bins.device)
    half = 8192 // n[:, :, None].clamp_min(32)  # a consumer's rows: 256 at N 32, 128 at N 64
    owner = rows[None, None, :] // half * half
    live = (n[:, :, None] > 0) & (owner < lens.reshape(nlist, 1, 1).to(owner.dtype))
    return n, live


def adc_chunkmin_binned(codes, lut_q, scales, q_norms, cs_q, cs_scale, lens, bins, lpad: int,
                        packed: bool, chunk: int):
    """K11: the chunk-min survivors of the binned ADC over the probed posting
    lists -> ((nlist, QB, lpad / chunk) f32, int32 global slots); see
    `adc_chunkmin_binned_ref`.  Survivors of query bins[l, j] over list l
    are the contiguous row [l, j]: the caller gathers them per (probe,
    slot).  CPU tensors run the plain version; CUDA tensors launch the
    kernel and count it in `adc_chunkmin_binned.launches`."""
    _check_chunk(chunk)
    dev = _device_of(codes, lut_q, scales, q_norms, cs_q, lens, bins)
    nlist, QB = bins.shape
    if lpad % _TILE_BIN or codes.shape[0] < nlist * lpad:
        raise ValueError(f"K11 needs lpad % {_TILE_BIN} == 0 and nlist * lpad code rows; got "
                         f"lpad {lpad}, {codes.shape[0]} rows for {nlist} lists")
    if dev.type == "cpu":
        return adc_chunkmin_binned_ref(codes, lut_q, scales, q_norms, cs_q, cs_scale, lens, bins,
                                       lpad, packed, chunk)
    B, Kd = lut_q.shape
    cw = codes.shape[1]
    mk = Kd // 16
    if lut_q.dtype != torch.int8 or codes.dtype != torch.uint8:
        raise ValueError("the K11 kernel takes uint8 codes and an int8 LUT")
    if cw % 4 or mk != (2 * cw if packed else cw):
        raise ValueError(f"K11 needs cw % 4 == 0 and 16 LUT columns per code group; got cw={cw}, "
                         f"Kd={Kd}, packed={packed}")
    if not packed:  # the kernel takes nibble-packed codes
        codes, lut_q, cs_q = k7_pack(codes, lut_q, cs_q)
        cw, Kd = codes.shape[1], lut_q.shape[1]
        mk = Kd // 16
    if _K11_SMEM + (Kd if cs_q is not None else 0) > _SMEM_MAX or nlist * lpad >= 2**31:
        raise ValueError(f"K11: {mk} groups x {nlist} lists x {lpad} rows exceed the kernel's shared "
                         f"memory or its int32 slots")
    codes, lut_q = codes.contiguous(), lut_q.contiguous()
    if codes.data_ptr() % 16:  # 16-byte cp.async reads
        codes = codes.clone()
    if lut_q.data_ptr() % 16:
        lut_q = lut_q.clone()
    scales, q_norms = scales.float().contiguous(), q_norms.float().contiguous()
    lens, bins = lens.to(torch.int32).contiguous(), bins.to(torch.int32).contiguous()
    cs_ptr = 0 if cs_q is None else cs_q.contiguous().data_ptr()
    SL = lpad // chunk
    out_d = torch.empty((nlist, QB, SL), dtype=torch.float32, device=dev)
    out_p = torch.empty((nlist, QB, SL), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_adc_chunkmin_binned(
            codes.data_ptr(), lut_q.data_ptr(), scales.data_ptr(), q_norms.data_ptr(), cs_ptr,
            float(cs_scale), lens.data_ptr(), bins.data_ptr(), out_d.data_ptr(), out_p.data_ptr(),
            nlist, lpad, QB, cw, mk, 1, chunk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "adc_chunkmin_binned")
    adc_chunkmin_binned.launches += 1
    return out_d, out_p


adc_chunkmin_binned.launches = 0


# ------------------------------------------------------------- K8 / K9 ----

def round_lut(lut_rows, lut_dtype: str = "bf16", exact: bool = False):
    """(R, m, k) f32 LUT rows -> (rows in the kernel's type, (R,) int8
    scales or None), as `adc_sums` rounds them: int8 only for k <= 16 (the
    step-wise k = 256 kernel ignores lut_dtype: bf16), f32 under `exact`."""
    R, m, k = lut_rows.shape
    lut = lut_rows.float()
    if exact or lut_dtype == "f32":
        return lut.contiguous(), None
    if lut_dtype == "int8" and k <= 16:
        q, s = quantize_lut_int8(lut.reshape(R, m * k))
        return q.reshape(R, m, k), s
    return lut.to(torch.bfloat16).contiguous(), None


# K9's dense tile (csrc/adc_sums.cu, namespace k9): a CTA sums 32 LUT rows
# (one per lane) against 1024 code rows, 4 groups a stage
K9_QB, K9_RB, K9_G = 32, 1024, 4


def k9_dense_layout(lut_dtype: torch.dtype) -> dict:
    """Shared-memory layout of K9's dense kernel for a bf16 or f32 LUT:
    each stage holds K9_QB LUT rows of K9_G groups (`words` 4-byte words a
    row) at a stride of `stride` words, odd so that the 32 lanes (one LUT
    row each) looking up one code hit 32 distinct banks, then K9_RB code
    words (the rows' K9_G code bytes); `stages` buffers (two for bf16,
    whose next stage is copied while this one is looked up)."""
    if lut_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K9 takes a bf16 or f32 LUT, got {lut_dtype}")
    size = 2 if lut_dtype == torch.bfloat16 else 4
    words = K9_G * 256 * size // 4
    stride = words + 1
    stages = 2 if size == 2 else 1
    return {"words": words, "stride": stride, "stages": stages,
            "smem_bytes": stages * (K9_QB * stride * 4 + K9_RB * 4)}


# K8's ids kernel (csrc/adc_sums.cu, namespace k8): 8 warps a CTA, a warp on
# one query, one candidate a lane per pass
_K8_WARPS = 8


def k8_ids_plan(C: int, m: int, lut_itemsize: int, shared: bool = False) -> dict:
    """How K8's ids kernel covers (B, C) -> {"wq", "qc", "passes",
    "row_bytes", "smem_bytes"}: wq = min(8, ceil(C / 32)) warps (a power
    of two) share a query, a CTA holds qc = 8 / wq queries (fewer where
    their LUT rows, m * 16 entries each, would overflow shared memory; one
    row when `shared`).  Warp w of CTA x serves query x * qc + w // wq; its
    lane l takes candidates p * 32 wq + (w % wq) * 32 + l in `passes`
    passes p."""
    wq = 1
    while wq < _K8_WARPS and 32 * wq < C:
        wq *= 2
    row_bytes = m * 16 * lut_itemsize
    qc = _K8_WARPS // wq
    if not shared:
        qc = min(qc, _SMEM_MAX // row_bytes)
    if qc < 1 or row_bytes > _SMEM_MAX:
        raise ValueError(f"K8 ids: a LUT row of m = {m} groups ({row_bytes} bytes) exceeds shared memory")
    return {"wq": wq, "qc": qc, "passes": -(-C // (32 * wq)), "row_bytes": row_bytes,
            "smem_bytes": row_bytes * (1 if shared else qc)}


def k8_dense_operands(codes, lut):
    """K8's one-hot dense kernel takes K7's operands: packed codes (N, cw)
    and an int8 LUT (R, m, 16) -> (codes (N, cw') zero-padded to cw' % 4
    == 0, LUT (R, 32 cw') int8, column g * 16 + v for group g, code v, zero
    for the groups past m).  Sent to the kernel with m' = 2 cw'; a padded
    group reads a zero column, so every int32 sum stays as it was."""
    R, m, _ = lut.shape
    cw = codes.shape[1]
    cw4 = -(-cw // 4) * 4
    if cw4 != cw:
        codes = torch.nn.functional.pad(codes, (0, cw4 - cw))
    lut2 = lut.reshape(R, m * 16)
    if 32 * cw4 != m * 16:
        lut2 = torch.nn.functional.pad(lut2, (0, 32 * cw4 - m * 16))
    return codes.contiguous(), lut2.contiguous()


def _sums_args(codes, lut, m: int, packed: bool):
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError("codes must be (n, cw) uint8")
    if lut.dtype not in _LUT_TYPES or lut.dim() != 3 or lut.shape[1] != m:
        raise ValueError(f"lut must be (R, m={m}, k) int8 / bf16 / f32, got {tuple(lut.shape)} "
                         f"{lut.dtype}")
    k = lut.shape[2]
    if k not in (16, 256) or (packed and k != 16):
        raise ValueError(f"ADC sums take k = 16 (packed or not) or k = 256 (unpacked), got {k}")
    if codes.shape[1] * (2 if packed else 1) < m:
        raise ValueError(f"codes of width {codes.shape[1]} hold fewer than m = {m} groups")
    if k == 256 and lut.dtype == torch.int8:
        raise ValueError("k = 256 sums take a bf16 or f32 LUT (`round_lut` never makes an int8 one)")
    return k


def adc_sums_dense_ref(codes, lut, scales, m: int, packed: bool):
    """Plain version of the dense shape -> (R, N) f32: the groups added in
    order, int32 for an int8 LUT (then times the row's scale), f32 else."""
    c = unpack_codes(codes, m, packed)  # (N, m)
    is_int = lut.dtype == torch.int8
    lw = lut.to(torch.int32) if is_int else lut.float()
    acc = torch.zeros((lut.shape[0], codes.shape[0]), dtype=lw.dtype, device=lut.device)
    for i in range(m):
        acc += lw[:, i, :].index_select(1, c[:, i])
    return acc.float() * scales[:, None] if is_int else acc


def adc_sums_dense(codes, lut, scales, m: int, packed: bool):
    """ADC sums of every code row against every LUT row -> (R, N) f32 (K8
    for k = 16, K9 for k = 256).  codes (N, cw) uint8; lut (R, m, k) int8 /
    bf16 / f32 from `round_lut`; scales (R,) for int8, else None.  CUDA
    tensors launch the kernel and count it in `adc_sums_dense.launches[k]`."""
    k = _sums_args(codes, lut, m, packed)
    dev = _device_of(codes, lut, scales)
    if lut.dtype == torch.int8 and scales is None:
        raise ValueError("an int8 LUT needs its scales")
    if dev.type == "cpu":
        return adc_sums_dense_ref(codes, lut, scales, m, packed)
    N, R = codes.shape[0], lut.shape[0]
    codes, lut = codes.contiguous(), lut.contiguous()
    if lut.dtype == torch.int8 and packed:  # the one-hot wgmma kernel (K7's operands)
        codes, lut = k8_dense_operands(codes, lut)
        m = 2 * codes.shape[1]
        if codes.data_ptr() % 4:  # 4-byte code words
            codes = codes.clone()
        if lut.data_ptr() % 16:  # the TMA reads the LUT from a 16-byte aligned base
            lut = lut.clone()
    sc = 0 if scales is None else scales.float().contiguous()
    out = torch.empty((R, N), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_adc_sums_dense(
            codes.data_ptr(), lut.data_ptr(), 0 if scales is None else sc.data_ptr(),
            out.data_ptr(), N, R, m, k, codes.shape[1], int(packed), _LUT_TYPES[lut.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "adc_sums_dense")
    adc_sums_dense.launches[k] += 1
    return out


adc_sums_dense.launches = {16: 0, 256: 0}


def adc_sums_ids_ref(codes, lut, ids, m: int, packed: bool, shared: bool):
    """Plain version of the ids shape -> (B, C) f32, +inf where the id is
    < 0 or >= len(codes); the groups added in order in f32."""
    valid = (ids >= 0) & (ids < codes.shape[0])
    c = unpack_codes(codes[torch.where(valid, ids, 0).long()], m, packed)  # (B, C, m)
    lw = lut.float()
    B = ids.shape[0]
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=lut.device)
    for i in range(m):
        li = lw[:, i, :].expand(B, -1) if shared else lw[:, i, :]
        acc += torch.gather(li, 1, c[:, :, i])
    return torch.where(valid, acc, float("inf"))


def adc_sums_ids(codes, lut, ids, m: int, packed: bool, shared: bool = False):
    """ADC sums of query b's LUT row against the code rows ids[b, :] ->
    (B, C) f32, +inf where the id is < 0 or >= len(codes) (K8 for k = 16,
    K9 for k = 256).  lut (B, m, k) bf16 / f32, or (1, m, k) with `shared`.
    CUDA tensors launch the kernel and count it in
    `adc_sums_ids.launches[k]`."""
    k = _sums_args(codes, lut, m, packed)
    dev = _device_of(codes, lut, ids)
    B, C = ids.shape
    if ids.dtype != torch.int32 or lut.dtype == torch.int8 or lut.shape[0] != (1 if shared else B):
        raise ValueError("adc_sums_ids takes int32 ids and a bf16 / f32 LUT of B rows (1 if shared)")
    if dev.type == "cpu":
        return adc_sums_ids_ref(codes, lut, ids, m, packed, shared)
    codes, lut, ids = codes.contiguous(), lut.contiguous(), ids.contiguous()
    plan = {"wq": 0, "qc": 0}
    if k == 16:
        plan = k8_ids_plan(C, m, lut.element_size(), shared)
        if lut.data_ptr() % 16:  # 16-byte cp.async copies of the LUT rows
            lut = lut.clone()
    out = torch.empty((B, C), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        status = lib.vecdb_adc_sums_ids(
            codes.data_ptr(), lut.data_ptr(), ids.data_ptr(), out.data_ptr(), B, C, m, k,
            codes.shape[1], int(packed), codes.shape[0], int(shared), _LUT_TYPES[lut.dtype],
            plan["wq"], plan["qc"], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "adc_sums_ids")
    adc_sums_ids.launches[k] += 1
    return out


adc_sums_ids.launches = {16: 0, 256: 0}


def adc_sums(codes, lut_rows, packed: bool = False, exact: bool = False, lut_dtype: str = "bf16"):
    """(N, R) f32 sums: sum_i lut_rows[r, i, codes[n, i]], the LUT rounded
    as `round_lut` says (the reference's `adc_sums` contract)."""
    lut, scales = round_lut(lut_rows, lut_dtype, exact)
    return adc_sums_dense(codes, lut, scales, lut_rows.shape[1], packed).T


def _cosine(dots, c_sq, q_norms):
    """1 - dots / max(sqrt(max(c_sq, 0)) * |q|, 1e-10); dots and c_sq
    broadcast against q_norms (B, 1)."""
    norm0 = c_sq.clamp_min(0.0).sqrt()
    return 1.0 - dots / (norm0 * q_norms).clamp_min(1e-10)


def adc_dists_for_ids(lookup, q_norms, codes, cb_sqnorm, ids, dist: str, m: int,
                      packed: bool = False):
    """ADC distances of per-query candidate ids -> (B, C) f32, +inf where
    the id is -1: the HNSW+PQ node distance (hnsw_index.rs:672-697).  The
    LUT and the cosine centroid-sqnorm row are rounded to bf16, as the
    reference's `adc_sums` default rounds them; each query's sums are K8
    (k = 16) or K9 (k = 256) in its ids shape."""
    lut = lookup.to(torch.bfloat16)
    s = adc_sums_ids(codes, lut, ids, m, packed)
    if dist == "cosine":
        c_sq = adc_sums_ids(codes, cb_sqnorm[None].to(torch.bfloat16), ids, m, packed, shared=True)
        s = _cosine(s, c_sq, q_norms[:, None])
    return torch.where(ids >= 0, s, float("inf"))


def adc_scan_pallas(lookup, codes, n_valid: int, cb_sqnorm, q_norms, k_out: int, dist: str,
                    packed: bool = False, exact: bool = False, block: int = 131072,
                    lut_dtype: str = "int8"):
    """Full ADC scan + top-k through the dense sums (K8 / K9), blocked over
    N so the (B, N) distance matrix never exists whole -> ((B, k_out) f32,
    (B, k_out) int32), -1 padded.  Cosine appends the centroid-sqnorm row
    to the LUT rows (pallas_adc.py:811-886)."""
    B, m, _ = lookup.shape
    N = codes.shape[0]
    rows = torch.cat([lookup, cb_sqnorm[None]], 0) if dist == "cosine" else lookup
    lut, scales = round_lut(rows, lut_dtype, exact)
    best_d = torch.full((B, 0), float("inf"), device=lookup.device)
    best_i = torch.full((B, 0), -1, dtype=torch.int32, device=lookup.device)
    for start in range(0, N, block):
        sums = adc_sums_dense(codes[start : start + block], lut, scales, m, packed)  # (R, nb)
        d = _cosine(sums[:B], sums[B][None, :], q_norms[:, None]) if dist == "cosine" else sums[:B]
        ids = torch.arange(start, start + d.shape[1], dtype=torch.int32, device=d.device)
        d = torch.where(ids[None, :] < n_valid, d, float("inf"))
        td, ti = T.select_smallest(d, ids.expand(B, -1), min(k_out, d.shape[1]))
        best_d, best_i = T.merge_topk(best_d, best_i, td, ti, k_out)
    return T._pad_k(best_d, best_i, k_out)
