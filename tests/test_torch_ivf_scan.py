"""K10 (the binned int8 group-min scan) of the PyTorch port against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that plain version, bit for bit, on the
card by `chip_smoke.py`.  The same int8 operands, made from a numpy seed, go
to both sides, and the packed int32 output must be EQUAL element for element:
the plain version rounds the epilogue as XLA computes the Pallas body (the
multiply-subtract fused, one rounding)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import distance as JD
from lab_1806_vec_db_tpu.ops import pallas_scan as PS
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu_torch.ops import scan as S
from lab_1806_vec_db_tpu_torch.ops import scan_binned as SB

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _inputs(nlist, lpad, extra, dim, B_pad, dist, seed):
    """A cluster-sorted-like mirror of nlist * lpad + extra rows (10% pad
    rows with the losing sentinel), queries, and bins with empty slots."""
    rng = np.random.default_rng(seed)
    total = nlist * lpad + extra
    rows = rng.standard_normal((total, dim)).astype(np.float32)
    b8, scales = JT.quantize_rows_int8(jnp.asarray(rows))
    cache = JD.dist_cache(jnp.asarray(rows), dist)
    if dist == "cosine":
        scales, cache = scales / jnp.maximum(cache, 1e-20), jnp.zeros_like(cache)
    pad = rng.random(total) < 0.1
    scales = np.where(pad, 0.0, np.asarray(scales)).astype(np.float32)
    cache = np.where(pad, np.float32(PS._BIG), np.asarray(cache)).astype(np.float32)
    q = rng.standard_normal((B_pad, dim)).astype(np.float32)
    q8, q_scale = JT.quantize_rows_int8(jnp.asarray(q))
    qs2, qc = PS.query_channels(q_scale, JD.dist_cache(jnp.asarray(q), dist), dist)
    bins = rng.integers(0, B_pad, (nlist, SB.QB)).astype(np.int32)
    bins[rng.random(bins.shape) < 0.3] = -1
    return (np.array(q8), np.array(qs2), np.array(qc), bins, np.array(b8), scales, cache)


def _reference(q8, qs2, qc, bins, b8, scales, cache, dist, lpad):
    bc = np.maximum(bins, 0)
    qbT = jnp.transpose(jnp.asarray(q8)[bc], (0, 2, 1))
    out = PS.scan_chunkmin_int8_binned(
        qbT, jnp.asarray(qs2)[bc][:, None, :], jnp.asarray(qc)[bc][:, None, :],
        jnp.asarray(b8), jnp.asarray(scales), jnp.asarray(cache), dist,
        interpret=True, lpad=lpad)
    return np.asarray(out)


@pytest.mark.parametrize("lpad", [512, 1024])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_binned_scan_plain_equals_pallas(dist, lpad):
    """Both metrics, lpad 512 and 1024, pad rows, and a mirror longer than
    nlist * lpad (the ingest-sorted layout's overflow tail): equal."""
    nlist, dim, B_pad = 3, 64, 160
    args = _inputs(nlist, lpad, 700, dim, B_pad, dist, seed=lpad + len(dist))
    ref = _reference(*args, dist, lpad)
    out = SB.scan_chunkmin_int8_binned(*[torch.from_numpy(a) for a in args], lpad)
    assert out.dtype == torch.int32 and tuple(out.shape) == (nlist * lpad // 4, SB.QB)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_binned_scan_odd_dim_equal():
    """A dim that is not a multiple of 64 (the plain version has no depth
    step) still equals the Pallas kernel."""
    args = _inputs(2, 512, 0, 96, 128, "l2sqr", seed=9)
    ref = _reference(*args, "l2sqr", 512)
    out = SB.scan_chunkmin_int8_binned(*[torch.from_numpy(a) for a in args], 512)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_binned_scan_survivor_decode():
    """Survivor m of list l decodes to row l*lpad + (m//128)*512 + m%128 +
    low*128, and its value is that row's packed distance: the minimum of its
    strided group of 4."""
    nlist, lpad, dim = 2, 1024, 64
    q8, qs2, qc, bins, b8, sc, ca = _inputs(nlist, lpad, 0, dim, 128, "l2sqr", seed=4)
    out = SB.scan_chunkmin_int8_binned(*[torch.from_numpy(a) for a in (q8, qs2, qc, bins, b8, sc, ca)], lpad).numpy()
    spl = lpad // 4
    for l in range(nlist):
        for m in (0, 5, 127, 128, 255):
            for c in (0, 17):
                v = out[l * spl + m, c]
                row = l * lpad + (m // 128) * 512 + m % 128 + (v & 3) * 128
                qid = max(bins[l, c], 0)
                dot = float(b8[row].astype(np.int32) @ q8[qid].astype(np.int32))
                # the fused multiply-subtract: exact in float64, rounded once
                cq, s2 = np.float32(ca[row] + qc[qid]), np.float32(sc[row] * qs2[qid])
                d = np.float32(np.float64(cq) - np.float64(dot) * np.float64(s2))
                assert (v & ~3) == (d.view(np.int32) & ~3)


def test_binned_scan_rejects_bad_layouts():
    args = [torch.from_numpy(a) for a in _inputs(2, 512, 0, 64, 128, "l2sqr", seed=1)]
    with pytest.raises(ValueError, match="overruns"):
        SB.scan_chunkmin_int8_binned(*args, 1024)  # 2 * 1024 > 1024 rows
    with pytest.raises(ValueError, match="multiple of 512"):
        SB.scan_chunkmin_int8_binned(*args, 256)
    bad = list(args)
    bad[3] = bad[3][:, :64]
    with pytest.raises(ValueError, match="bins"):
        SB.scan_chunkmin_int8_binned(*bad, 512)
    assert S._BIG == PS._BIG


@pytest.mark.parametrize("nlist,lpad", [(256, 512), (256, 4608), (1024, 5120), (3, 4608)])
def test_k10_plan_covers_every_tile_once(nlist, lpad):
    """K10's plan (`k10_plan`, which sizes the kernel's launch) gives every
    (list, 512-row tile) to exactly one CTA, as the kernel cuts the tiles
    (CTA y: tiles [y T // ctas, (y + 1) T // ctas)), in one wave of CTAs
    whose shares differ by at most one tile."""
    plan = SB.k10_plan(nlist, lpad)
    tpl = lpad // 512
    assert plan["tiles_per_list"] == tpl and plan["tiles"] == nlist * tpl
    assert plan["ctas"] <= 132 and plan["ctas"] <= plan["tiles"]
    count = np.zeros((nlist, tpl), np.int64)
    shares = []
    for y in range(plan["ctas"]):
        run = range(y * plan["tiles"] // plan["ctas"], (y + 1) * plan["tiles"] // plan["ctas"])
        shares.append(len(run))
        for G in run:
            count[G // tpl, G % tpl] += 1
    assert (count == 1).all()
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1


def _k10_emulate(q8, qs2, qc, bins, b8, sc, ca, lpad, sms):
    """K10's kernel step by step in numpy: CTA y walks its run of tiles; at
    each new list it gathers the list's 128 query rows through the bins in
    16-byte chunks to the swizzled offsets `k1_stage_offset` (zeros past D),
    each row's chunk j at chunk j ^ (row % 8); each 64-row tile's
    128-byte mirror boxes land as TMA's swizzle writes them
    (`k1_stage_offset`, zeros past D); the wgmma descriptors read both;
    consumer p scans the tiles `k10_tiles(p, level)`, its accumulator
    register i of lane l in warp w holding (row, bin) `k1_acc_coords(w, l,
    i)`; the fused epilogue rounds once (`_fms_f32`) and each level folds
    into the same minima; each consumer stores its 64 survivors of a tile.
    Returns the output and how often each (survivor, bin) was stored."""
    nlist = bins.shape[0]
    D = q8.shape[1]
    KT = -(-D // 128)
    plan = SB.k10_plan(nlist, lpad, sms)
    tpl = plan["tiles_per_list"]
    out = np.zeros((nlist * lpad // 4, SB.QB), np.int64)
    stores = np.zeros((nlist * lpad // 4, SB.QB), np.int64)
    r = np.arange(128)[:, None]
    c = np.arange(128)[None, :]
    k = np.arange(32)[None, :]
    wide = np.zeros((b8.shape[0], KT * 128), np.int8)
    wide[:, :D] = b8

    def read(buf, rows, kk):  # what a descriptor reads for k-step kk
        addr = 32 * kk + (r[:rows] // 8) * 1024 + (r[:rows] % 8) * 128 + k
        return buf[addr ^ (((addr >> 7) & 7) << 4)]

    warp, lane, i = np.meshgrid(np.arange(4), np.arange(32), np.arange(64), indexing="ij")
    row, col = S.k1_acc_coords(warp, lane, i)
    for y in range(plan["ctas"]):
        cur = -1
        for G in range(y * plan["tiles"] // plan["ctas"], (y + 1) * plan["tiles"] // plan["ctas"]):
            l = G // tpl
            if l != cur:
                cur = l
                qid = np.maximum(bins[l], 0)
                qbufs = []
                for kt in range(KT):
                    buf = np.zeros(128 * 128, np.int8)
                    for j in range(8):
                        c0 = kt * 128 + 16 * j
                        if c0 < D:  # D % 16 == 0: a chunk lies wholly inside or past D
                            buf[S.k1_stage_offset(r, 16 * j + np.arange(16)[None, :])] = q8[qid, c0 : c0 + 16]
                    qbufs.append(buf)
                qs_c, qc_c = qs2[qid], qc[qid]
            for p in (0, 1):
                mins = np.full((4, 32, 64), 2**31 - 1, np.int64)
                for lev in range(4):
                    r0, s0 = SB.k10_tiles(p, lev)
                    x0 = G * 512 + r0
                    acc = np.zeros((64, 128), np.int64)
                    for kt in range(KT):
                        abuf = np.zeros(64 * 128, np.int8)
                        abuf[S.k1_stage_offset(r[:64], c)] = wide[x0 : x0 + 64, kt * 128 : kt * 128 + 128]
                        for kk in range(4):
                            acc += read(abuf, 64, kk).astype(np.int64) @ read(qbufs[kt], 128, kk).astype(np.int64).T
                    xr = x0 + row
                    cq = torch.from_numpy((ca[xr] + qc_c[col]).astype(np.float32))
                    s2 = torch.from_numpy((sc[xr] * qs_c[col]).astype(np.float32))
                    d = SB._fms_f32(cq, torch.from_numpy(acc[row, col].astype(np.float32)), s2).numpy()
                    mins = np.minimum(mins, (d.view(np.int32).astype(np.int64) & ~3) | lev)
                out[G * 128 + s0 + row, col] = mins
                np.add.at(stores, (G * 128 + s0 + row, col), 1)
    return out.astype(np.int32), stores


@pytest.mark.parametrize("dist,dim", [("l2sqr", 96), ("cosine", 256), ("l2sqr", 1040)])
def test_k10_tiles_emulated(dist, dim):
    """An emulation of K10's plan, gathered query tiles, swizzled mirror
    boxes, wgmma descriptors and tile -> consumer -> survivor map gives
    `scan_chunkmin_int8_binned_ref`'s output bit for bit, every survivor row
    stored once: runs that split a list and cross into the next (4 SMs),
    empty slots, a list no query probes, a width that is not a multiple of
    128 (96: the zero fill; 1040: nine boxes, the streamed query tile)."""
    nlist, lpad = 3, 1024
    q8, qs2, qc, bins, b8, sc, ca = _inputs(nlist, lpad, 0, dim, 160, dist, seed=dim)
    bins[1] = -1
    got, stores = _k10_emulate(q8, qs2, qc, bins, b8, sc, ca, lpad, sms=4)
    ref = SB.scan_chunkmin_int8_binned_ref(*[torch.from_numpy(a) for a in (q8, qs2, qc, bins, b8, sc, ca)], lpad)
    np.testing.assert_array_equal(got, ref.numpy())
    assert (stores == 1).all()  # no survivor is stored twice, none left out
