"""K10: the segmented (binned) int8 group-min scan of the binned IVF search
(port of ops/pallas_scan.py's `scan_chunkmin_int8_binned`).

Every posting list of the cluster-sorted int8 mirror is scanned once against
the bin of (up to) 128 queries that probe it.  Each 512-row tile keeps 128
survivors, one per strided group of 4 rows {s, s+128, s+256, s+384}, packed
as (bits(d) & ~3) | level with level = row-in-tile // 128.

On a CUDA tensor the scan is the hand-written kernel
`csrc/scan_int8_binned.cu` (`wgmma` + TMA; `k10_plan` sizes its launch,
`k10_tiles` gives the tile -> consumer -> survivor map, and its gathered
query tile lies as `scan.k1_stage_offset` says); on a CPU tensor it is the
plain PyTorch version `scan_chunkmin_int8_binned_ref`, which computes the
same int32 values bit for bit.  There is no fallback from one to the other.

The distance is K1's one formula (see `ops/scan.py`):
    d = (cache_x + qc_q) - float(dot) * (scale_x * qs2_q)
with the multiply-subtract FUSED (rounded once): XLA contracts the
reference's Pallas body so, and K1's separately rounded epilogue differs from
it in about 2% of the packed values.  Pad rows carry scale 0 and cache +BIG,
so no row is masked.
"""

from __future__ import annotations

import torch

from . import _build
from .scan import _sm_count

_TILE = 512  # mirror rows per grid step (_NB_BIN): list lengths pad to it
_SPT = 128  # survivors per tile
_GS = _TILE // _SPT  # rows per survivor group (4): the 2 packed low bits
QB = 128  # queries per list bin
_K10_BM = 64  # mirror rows per wgmma tile: eight a 512-row tile
_REF_ROWS = 65536  # mirror rows per block of the plain version (bounds transients)


def _fms_f32(c, a, b):
    """round_f32(c - a * b) with ONE rounding, for f32 tensors with a * b
    exact in f64 (a an integer below 2^24): the f64 difference s and its
    exact error (TwoSum) give the exact value s + err, which rounds like s
    unless s is an f32 midpoint, where err's sign breaks the tie."""
    cd = c.double()
    p = a.double() * b.double()  # 24 x 24 bits: exact
    s = cd - p
    bb = s - cd
    err = (cd - (s - bb)) + (-p - bb)
    r = s.float()
    rd = r.double()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=r.device)
    nxt = torch.nextafter(r, torch.where(s > rd, inf, -inf))  # the neighbour on s's side
    tie = (s == (rd + nxt.double()) * 0.5) & (err != 0)
    fix = torch.where(err > 0, torch.maximum(r, nxt), torch.minimum(r, nxt))
    return torch.where(tie, fix, r)


def scan_chunkmin_int8_binned_ref(q8, qs2, qc, bins, base_i8, base_scale, base_cache, lpad: int):
    """Plain PyTorch version of K10 (the wrapper's arguments).  The int8
    product runs as a batched f32 matmul per block of lists, which is exact
    (integers < 2^24, TF32 off); the epilogue rounds as the kernel does
    (cache + qc and scale * qs2 each once, the multiply-subtract once).
    Returns (nlist * lpad / 4, QB) int32."""
    nlist, qb = bins.shape
    dim = q8.shape[1]
    dev = q8.device
    bc = bins.clamp_min(0).long()  # empty slots score query 0, never read back
    lvl = (torch.arange(_GS, device=dev, dtype=torch.int32)).view(1, 1, _GS, 1, 1)
    out = torch.empty((nlist * lpad // _GS, qb), dtype=torch.int32, device=dev)
    per = max(1, _REF_ROWS // lpad)
    for l0 in range(0, nlist, per):
        l1 = min(l0 + per, nlist)
        nb = l1 - l0
        r0, r1 = l0 * lpad, l1 * lpad
        a = base_i8[r0:r1].float().view(nb, lpad, dim)
        b = q8[bc[l0:l1]].float()  # (nb, QB, dim)
        dots = torch.bmm(a, b.transpose(1, 2))  # (nb, lpad, QB)
        sc = base_scale[r0:r1].float().view(nb, lpad, 1)
        ca = base_cache[r0:r1].float().view(nb, lpad, 1)
        qs = qs2.float()[bc[l0:l1]].view(nb, 1, qb)
        qcc = qc.float()[bc[l0:l1]].view(nb, 1, qb)
        d = _fms_f32(ca + qcc, dots, sc * qs)
        bits = d.view(torch.int32).view(nb, lpad // _TILE, _GS, _SPT, qb)
        m = ((bits & ~(_GS - 1)) | lvl).amin(dim=2)  # (nb, tiles, SPT, QB)
        out[r0 // _GS : r1 // _GS] = m.reshape(-1, qb)
    return out


def k10_plan(nlist: int, lpad: int, sms: int = 132) -> dict:
    """How K10's kernel (csrc/scan_int8_binned.cu) covers nlist lists of
    lpad rows on a card of `sms` SMs -> {"tiles", "tiles_per_list", "ctas"}.

    The nlist * lpad / 512 tiles (tile G: list G // tiles_per_list, mirror
    rows G * 512 ...) are cut into `ctas` contiguous runs, CTA y taking
    tiles [y * tiles // ctas, (y + 1) * tiles // ctas): one wave, every CTA
    within a tile of the same work, so a list is split across CTAs where
    whole lists would leave SMs idle (256 lists of 9 tiles are 1.9 waves on
    132 SMs).  A CTA gathers a list's query tile once per run, again only
    where its run crosses into the next list."""
    tiles_per_list = lpad // _TILE
    tiles = nlist * tiles_per_list
    return {"tiles": tiles, "tiles_per_list": tiles_per_list, "ctas": max(1, min(tiles, sms))}


def k10_tiles(p: int, lev: int):
    """The 64-row wgmma tile of a 512-row tile that consumer p (0, 1) scans
    at level lev (0-3) -> (first row within the 512-row tile, first survivor
    slot): tile j = 2 lev + p covers rows 64 j ... and, as level j // 2,
    slots 64 (j % 2) ...; so a consumer folds its four levels into the same
    64 survivors and no survivor needs a second consumer."""
    j = 2 * lev + p
    return j * _K10_BM, (j % 2) * _K10_BM


def scan_chunkmin_int8_binned(q8, qs2, qc, bins, base_i8, base_scale, base_cache, lpad: int):
    """Segmented packed group-min -> (nlist * lpad / 4, 128) int32.

    q8 (B_pad, D) int8 padded queries; qs2, qc (B_pad,) f32 from
    `scan.query_channels`; bins (nlist, 128) int32 query ids per list (-1 on
    empty slots, from `binning.bin_queries`; the caller guarantees every value
    lies in [-1, B_pad), which is not checked: reading bins back would sync
    the host); base_i8 (>= nlist * lpad, D)
    int8 cluster-sorted mirror with base_scale / base_cache (same rows).
    List l owns rows [l * lpad, (l + 1) * lpad); rows past nlist * lpad (the
    ingest-sorted mirror's overflow segment and capacity padding) are never
    read.  Survivor m of list l decodes to mirror row
    l * lpad + (m // 128) * 512 + m % 128 + (v & 3) * 128.

    CPU tensors run the plain version; CUDA tensors launch the kernel and
    count the launch in `scan_chunkmin_int8_binned.launches`."""
    if q8.dtype != torch.int8 or base_i8.dtype != torch.int8:
        raise TypeError("q8 and base_i8 must be int8")
    if bins.dtype != torch.int32 or bins.dim() != 2 or bins.shape[1] != QB:
        raise ValueError(f"bins must be (nlist, {QB}) int32, got {tuple(bins.shape)} {bins.dtype}")
    if q8.dim() != 2 or base_i8.dim() != 2 or q8.shape[1] != base_i8.shape[1]:
        raise ValueError(f"shape mismatch: q8 {tuple(q8.shape)} vs base {tuple(base_i8.shape)}")
    if lpad <= 0 or lpad % _TILE:
        raise ValueError(f"lpad={lpad} must be a positive multiple of {_TILE}")
    nlist = bins.shape[0]
    total = base_i8.shape[0]
    if nlist * lpad > total:
        raise ValueError(
            f"binned scan layout overruns the base array: nlist={nlist} * lpad={lpad} > total rows {total}")
    if base_scale.shape != (total,) or base_cache.shape != (total,):
        raise ValueError("base_scale and base_cache must be (N,)")
    B = q8.shape[0]
    if qs2.shape != (B,) or qc.shape != (B,):
        raise ValueError("qs2 and qc must be (B_pad,)")
    devs = {t.device for t in (q8, qs2, qc, bins, base_i8, base_scale, base_cache)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    dev = devs.pop()
    if not base_i8.is_contiguous():
        raise ValueError("base_i8 must be contiguous (the kernel reads it row-major in place)")
    if dev.type == "cpu":
        return scan_chunkmin_int8_binned_ref(q8, qs2, qc, bins, base_i8, base_scale, base_cache, lpad)
    if dev.type != "cuda":
        raise RuntimeError(f"no K10 kernel for device {dev}")
    rows = nlist * lpad
    dim = q8.shape[1]
    if dim % 16:
        raise ValueError(f"the K10 kernel reads mirror rows by TMA, whose row stride is a multiple of 16 "
                         f"bytes; got {dim} (the store pads rows to 128)")
    q8, bins = q8.contiguous(), bins.contiguous()
    if q8.data_ptr() % 16 or base_i8.data_ptr() % 16:
        raise ValueError("q8 and base_i8 must be 16-byte aligned (TMA and cp.async read 16-byte chunks)")
    qs2, qc = qs2.float().contiguous(), qc.float().contiguous()
    sc = base_scale[:rows].float().contiguous()
    ca = base_cache[:rows].float().contiguous()
    out = torch.empty((rows // _GS, QB), dtype=torch.int32, device=dev)
    plan = k10_plan(nlist, lpad, _sm_count(dev))
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.vecdb_scan_int8_binned(
            q8.data_ptr(), qs2.data_ptr(), qc.data_ptr(), bins.data_ptr(), base_i8.data_ptr(),
            sc.data_ptr(), ca.data_ptr(), out.data_ptr(), nlist, lpad, dim, plan["ctas"], stream,
        )
    _build.check(status, "scan_int8_binned")
    scan_chunkmin_int8_binned.launches += 1
    return out


scan_chunkmin_int8_binned.launches = 0
