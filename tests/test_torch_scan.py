"""K1 (the packed int8 chunk-min scan) of the PyTorch port against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card by
`chip_smoke.py`.  Same int8 inputs, made from a numpy seed, go to both sides.
Tolerances are those of tests/test_pallas_kernels.py: the packed distance
keeps 16 mantissa bits, and XLA may round the f32 epilogue differently from
the port's operation-by-operation rounding, so survivors may swap at the
rank-r boundary (overlap >= (r-1)/r, top-3 identical, rel. distance error
< 3e-5)."""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import distance as JD
from lab_1806_vec_db_tpu.ops import pallas_scan as PS
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu_torch.ops import scan as S
from lab_1806_vec_db_tpu_torch.ops import topk as T

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _make(n, dim, b, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((b, dim)).astype(np.float32)
    return base, qs


def _channels(base, dist):
    """Mirror rows and channels in the unified convention, from the JAX
    package (store.device_int8 does the same)."""
    b8, scales = JT.quantize_rows_int8(jnp.asarray(base))
    cache = JD.dist_cache(jnp.asarray(base), dist)
    if dist == "cosine":
        return b8, scales / jnp.maximum(cache, 1e-20), jnp.zeros_like(cache)
    return b8, scales, cache


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _assert_candidates_close(bd, bi, od, oi, r):
    overlap = np.mean([len(set(bi[i]) & set(oi[i])) / r for i in range(len(bi))])
    assert overlap >= (r - 1) / r
    assert (bi[:, :3] == oi[:, :3]).all()
    match = bi == oi
    rel = np.abs(bd - od)[match] / np.maximum(np.abs(od[match]), 1e-3)
    assert rel.max() < 3e-5


@pytest.mark.parametrize("dim", [32, 128])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_packed_scan_matches_pallas_kernel(dist, dim):
    """K1's packed (N/128, B) survivors against the Pallas kernel on the
    same int8 operands; decoded through the same exact top-r."""
    N, B, r = 4200, 8, 12
    base, qs = _make(N, dim, B)
    b8, sc, cache = _channels(base, dist)
    q8, q_scale = JT.quantize_rows_int8(jnp.asarray(qs))
    qs2, qc = PS.query_channels(q_scale, JD.dist_cache(jnp.asarray(qs), dist), dist)
    pj = np.array(PS.scan_chunkmin_int8_packed(
        q8, qs2, qc, b8, sc, cache, jnp.int32(N), dist, interpret=True))
    pt = S.scan_chunkmin_int8_packed(*_t(q8, qs2, qc, b8, sc, cache)).numpy()
    assert pt.shape == pj.shape == (-(-N // 2048) * 16, B)
    # the level bits (argmin) agree wherever the 16-bit distances do
    same_d = (pj & ~127) == (pt & ~127)
    assert same_d.mean() > 0.99
    assert ((pj & 127) == (pt & 127))[same_d].all()
    od, oi = S.select_survivors(torch.from_numpy(pj), r)
    bd, bi = S.select_survivors(torch.from_numpy(pt), r)
    _assert_candidates_close(bd.numpy(), bi.numpy(), od.numpy(), oi.numpy(), r)


@pytest.mark.parametrize("dim", [32, 128])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_scan_candidates_match_pallas_wrapper(dist, dim):
    """The whole stage 1 (query quantization, K1, top-r, decode) against
    `scan_candidates_int8_packed(interpret=True)`."""
    N, B, r = 4200, 8, 12
    base, qs = _make(N, dim, B, seed=1)
    b8, sc, cache = _channels(base, dist)
    od, oi = PS.scan_candidates_int8_packed(
        jnp.asarray(qs), b8, sc, cache, jnp.int32(N), r, dist, interpret=True)
    bd, bi = S.scan_candidates_int8_packed(
        torch.from_numpy(qs), *_t(b8, sc, cache), r, dist)
    assert bi.dtype == torch.int32 and bd.dtype == torch.float32
    _assert_candidates_close(bd.numpy(), bi.numpy(), np.asarray(od), np.asarray(oi), r)


@pytest.mark.parametrize("n_valid", [4200, 4096, 100])
def test_packed_scan_validity_boundary(n_valid):
    """Invalid rows are never selected: validity rides the +BIG cache
    sentinel, and the wrapper sentinels its own 2048-row padding."""
    N, dim, B, r = 4200, 32, 4, 12
    base, qs = _make(N, dim, B, seed=3)
    # make the tail rows the closest to every query: if the sentinels fail
    # to suppress them, they win every min
    if n_valid < N:
        base[n_valid:] = qs[0]
    b8, sc, cache = _channels(base, "l2sqr")
    valid = jnp.arange(N) < n_valid
    sc = jnp.where(valid, sc, 0.0)
    cache = jnp.where(valid, cache, jnp.float32(S._BIG))
    _, bi = S.scan_candidates_int8_packed(torch.from_numpy(qs), *_t(b8, sc, cache), r, "l2sqr")
    _, oi = PS.scan_candidates_int8_packed(
        jnp.asarray(qs), b8, sc, cache, jnp.int32(n_valid), r, "l2sqr", interpret=True)
    bi = bi.numpy()
    assert (bi[bi >= 0] < n_valid).all()
    np.testing.assert_array_equal(bi >= 0, np.asarray(oi) >= 0)


def test_packed_scan_pads_ragged_rows_with_sentinels():
    """A mirror whose row count is not a multiple of 2048 scans as if padded
    with losing rows: the survivors equal those of an explicitly padded
    mirror."""
    N, dim, B = 2500, 64, 3
    base, qs = _make(N, dim, B, seed=5)
    b8, sc, cache = _t(*_channels(base, "l2sqr"))
    q8, qs2, qc = S.quantize_queries(torch.from_numpy(qs), dim, "l2sqr")
    out = S.scan_chunkmin_int8_packed(q8, qs2, qc, b8, sc, cache)
    pb8 = torch.cat([b8, torch.zeros((4096 - N, dim), dtype=torch.int8)])
    psc = torch.cat([sc, torch.zeros(4096 - N)])
    pca = torch.cat([cache, torch.full((4096 - N,), S._BIG)])
    torch.testing.assert_close(out, S.scan_chunkmin_int8_packed_ref(q8, qs2, qc, pb8, psc, pca), rtol=0, atol=0)


def test_packed_scan_rejects_what_the_kernel_does_not_take():
    base, qs = _make(2048, 64, 2, seed=6)
    b8, sc, cache = _t(*_channels(base, "l2sqr"))
    q8, qs2, qc = S.quantize_queries(torch.from_numpy(qs), 64, "l2sqr")
    with pytest.raises(TypeError):
        S.scan_chunkmin_int8_packed(q8.float(), qs2, qc, b8, sc, cache)
    with pytest.raises(ValueError):
        S.scan_chunkmin_int8_packed(q8[:, :32], qs2, qc, b8, sc, cache)
    with pytest.raises(ValueError):
        S.scan_chunkmin_int8_packed(q8, qs2[:1], qc, b8, sc, cache)
    with pytest.raises(ValueError, match="contiguous"):
        S.scan_chunkmin_int8_packed(q8, qs2, qc, b8.T.contiguous().T, sc, cache)


def test_quantize_rows_matches_reference():
    x = _make(300, 70, 1, seed=7)[0] * 3.0
    x[5] = 0.0  # zero row: scale 1
    q8j, scj = JT.quantize_rows_int8(jnp.asarray(x))
    q8t, sct = T.quantize_rows_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q8t.numpy(), np.asarray(q8j))
    np.testing.assert_array_equal(sct.numpy(), np.asarray(scj))


def test_decode_perm_matches_reference():
    rng = np.random.default_rng(11)
    perm = rng.permutation(64).astype(np.int32)
    cand = rng.integers(-1, 64, size=(4, 10)).astype(np.int32)
    expect = np.asarray(JT.decode_perm(jnp.asarray(cand), jnp.asarray(perm), jnp.int32(40)))
    got = T.decode_perm(torch.from_numpy(cand), torch.from_numpy(perm), 40).numpy()
    np.testing.assert_array_equal(got, expect)


def _k1_coverage(n_pad, B, sms=132):
    """Survivor contributions of K1's launch as the kernel walks it: CTA
    (x, y) scans query tile x against items y, y + ctas, ...; item i covers
    levels (i % parts) * 128 / parts ... of chunk i // parts -> (chunks, 128
    levels, B) counts, and the plan."""
    plan = S.k1_plan(n_pad, B, sms)
    chunks = n_pad // S._NB
    lv = 128 // plan["parts"]
    count = np.zeros((chunks, 128, B), np.uint8)
    for x in range(plan["qtiles"]):
        q0, q1 = x * S._K1_BN, min(B, (x + 1) * S._K1_BN)
        for y in range(plan["ctas"]):
            for item in range(y, plan["items"], plan["ctas"]):
                c, p = divmod(item, plan["parts"])
                count[c, p * lv : (p + 1) * lv, q0:q1] += 1
    return count, plan


@pytest.mark.parametrize("B", [1, 16, 129, 1000])
@pytest.mark.parametrize("n", [2048, 8765, 1_000_000])
def test_k1_plan_covers_every_survivor_once(n, B):
    """K1's tile plan (`k1_plan`, which sizes the kernel's launch) gives
    every (chunk, slot, query) survivor each of its chunk's 128 levels
    exactly once (the 16 slots of a level lie in one 64-row tile of an
    item), in one wave of CTAs; items that split a chunk fold into it with
    atomicMin, so the plan's parts say whether the output starts filled."""
    n_pad = -(-n // S._NB) * S._NB
    count, plan = _k1_coverage(n_pad, B)
    assert (count == 1).all()
    assert plan["qtiles"] * plan["ctas"] <= 132 or plan["ctas"] == 1
    assert plan["items"] == n_pad // S._NB * plan["parts"] and plan["ctas"] <= plan["items"]
    assert (S._NB // plan["parts"]) % (2 * S._K1_BM) == 0  # whole tiles, an even count per item


def _k1_layout(KT):
    """`layout()` of csrc/scan_int8_packed.cu -> (resident, ring stages): the
    query tile stays in shared memory up to 8 boxes (1024 lanes), past that
    each stage carries its query box beside its row box; the ring takes what
    232,448 bytes leave after the tile, the reduction, the channels and the
    alignment pad, at most 16 stages, ring // 2 for each consumer."""
    resident = KT <= 8
    stage = 64 * 128 + (0 if resident else 128 * 128)
    fixed = 1024 + (KT * 128 * 128 if resident else 0) + 16 * 128 * 4 + 2 * 128 * 4 + 8
    return resident, min((232448 - fixed) // (stage + 16), 16)


def _k1_stage(mat, rows):
    """A box as TMA writes it: rows x 128 bytes with the 128-byte swizzle."""
    buf = np.zeros(rows * 128, np.int8)
    buf[S.k1_stage_offset(np.arange(rows)[:, None], np.arange(128)[None, :])] = mat
    return buf


def _k1_read(buf, rows, kk):
    """What a wgmma descriptor reads of a box for k-step kk: rows 128 bytes
    apart, 8-row groups 1024 apart, the address swizzled by the hardware."""
    r = np.arange(rows)[:, None]
    addr = 32 * kk + (r // 8) * 1024 + (r % 8) * 128 + np.arange(32)[None, :]
    return buf[addr ^ (((addr >> 7) & 7) << 4)]


def _k1_cta(y, plan, KT, load, qbufs, rng):
    """One CTA's two producers and two consumers under the kernel's mbarrier
    protocol, interleaved at random (each mbarrier a count of completed
    phases, a wait on parity P done once the count's parity differs from P,
    as mbarrier.try_wait.parity has it): producer p loads box it of consumer
    p's tiles (tile T of the CTA is consumer T % 2's) into slot p * rc + it %
    rc once that slot's empty phase allows; consumer p waits on the slot's
    full phase, issues the box's products, and frees the stage of the box
    before (its products then complete), the tile's last box at the tile's
    end; at an item's end both consumers meet.  The box must sit in its slot
    from the consumer's wait until the stage is freed; the products are read
    when it is freed -> {(item, tile): the 64 x 128 int64 products}."""
    resident, ring = _k1_layout(KT)
    rc = ring // 2
    tiles = S._NB // plan["parts"] // S._K1_BM
    my_items = range(y, plan["items"], plan["ctas"])
    boxes = ([], [])
    for n, item in enumerate(my_items):
        for tile in range(tiles):
            boxes[(n * tiles + tile) & 1].extend((item, tile, kt) for kt in range(KT))
    full, empty, held, met = [0] * ring, [0] * ring, [None] * ring, [0, 0]
    acc = {}

    def producer(p):
        for it, box in enumerate(boxes[p]):
            slot = p * rc + it % rc
            if it >= rc:
                yield lambda s=slot, par=((it // rc) - 1) & 1: (empty[s] & 1) != par
            held[slot] = (box, load(*box))
            full[slot] += 1
            yield None

    def free(slot, box):
        assert held[slot][0] == box, f"stage {slot} was refilled while box {box} was being multiplied"
        abuf, qbuf = held[slot][1]
        item, tile, kt = box
        qb = qbufs[kt] if resident else qbuf
        prod = acc.setdefault((item, tile), np.zeros((64, 128), np.int64))
        for kk in range(4):
            prod += (_k1_read(abuf, 64, kk).astype(np.float64)
                     @ _k1_read(qb, 128, kk).astype(np.float64).T).astype(np.int64)
        empty[slot] += 1

    def consumer(p):
        it = 0
        for n, item in enumerate(my_items):
            for tile in range(tiles):
                if (n * tiles + tile) & 1 != p:
                    continue
                prev = None
                for kt in range(KT):
                    slot = p * rc + it % rc
                    yield lambda s=slot, par=(it // rc) & 1: (full[s] & 1) != par
                    assert held[slot][0] == (item, tile, kt), f"consumer {p} found {held[slot][0]} in stage {slot}"
                    if prev is not None:
                        free(*prev)
                    prev = (slot, (item, tile, kt))
                    it += 1
                    yield None
                free(*prev)
            met[p] += 1
            yield lambda: met[1 - p] >= met[p]

    agents = [producer(0), producer(1), consumer(0), consumer(1)]
    waits = [None] * 4
    weights = rng.random(4) + 0.05  # producers or consumers ahead, by CTA
    while agents:
        ready = [i for i, w in enumerate(waits) if w is None or w()]
        assert ready, "the protocol deadlocked"
        i = rng.choice(ready, p=weights[ready] / weights[ready].sum())
        try:
            waits[i] = next(agents[i])
        except StopIteration:
            del agents[i], waits[i]
            weights = np.delete(weights, i)
    assert sum(empty) == len(boxes[0]) + len(boxes[1])  # every stage loaded was freed
    return acc


def _k1_emulate(q8, qs2, qc, b8, sc, ca, plan, seed=0):
    """K1's kernel, step by step in numpy: the CTAs of the plan, each under
    its ring protocol (`_k1_cta`); each 64-row tile's 128-byte boxes land in
    shared memory as TMA's 128-byte swizzle writes them (`k1_stage_offset`),
    the query tile likewise (resident, or a query box beside each row box
    past 1024 lanes); each k-step's wgmma reads them through its
    descriptors; accumulator register i of lane l in warp w is (row,
    query) `k1_acc_coords(w, l, i)`; the epilogue rounds every operation in
    f32 and folds into the survivors' minimum."""
    B, D = q8.shape
    KT = D // 128
    resident, _ = _k1_layout(KT)
    rng = np.random.default_rng(seed)
    out = np.full((b8.shape[0] // 128, B), 2**31 - 1, np.int64)
    warp, lane, i = np.meshgrid(np.arange(4), np.arange(32), np.arange(64), indexing="ij")
    row, col = S.k1_acc_coords(warp, lane, i)
    part_rows = S._NB // plan["parts"]
    for x in range(plan["qtiles"]):
        qt = np.zeros((128, D), np.int8)
        qt[: min(128, B - 128 * x)] = q8[128 * x : 128 * x + 128]
        qbufs = [_k1_stage(qt[:, kt * 128 : kt * 128 + 128], 128) for kt in range(KT)]
        cols = 128 * x + col
        live = cols < B
        cl = np.minimum(cols, B - 1)

        def load(item, tile, kt):  # the stage a producer fills for this box
            x0 = (item // plan["parts"]) * S._NB + (item % plan["parts"]) * part_rows + tile * 64
            abuf = _k1_stage(b8[x0 : x0 + 64, kt * 128 : kt * 128 + 128], 64)
            return abuf, None if resident else qbufs[kt].copy()

        for y in range(plan["ctas"]):
            for (item, tile), acc in _k1_cta(y, plan, KT, load, qbufs, rng).items():
                chunk, part = divmod(item, plan["parts"])
                xr = chunk * S._NB + part * part_rows + tile * 64 + row
                ca_q = (ca[xr] + qc[cl]).astype(np.float32)
                sq = (sc[xr] * qs2[cl]).astype(np.float32)
                d = (ca_q - (acc[row, col].astype(np.float32) * sq).astype(np.float32)).astype(np.float32)
                level = (part * part_rows + tile * 64) // 16 + warp
                packed = (d.view(np.int32).astype(np.int64) & ~127) | level
                np.minimum.at(out, (chunk * 16 + row[live] % 16, cols[live]), packed[live])
    return out.astype(np.int32)


# id: (dist, lanes, rows, SMs the plan deals to, parts > 1): KT 2 (the "pca"
# route's 256 lanes), 8 (the resident tile's 1024) and 9 (1152: the query
# box streamed beside each row box); chunks whole or split in parts, one or
# several items a CTA
_K1_EMULATED = {
    "l2sqr": ("l2sqr", 256, 4096, 132, True),
    "cosine": ("cosine", 256, 4096, 132, True),
    "l2sqr-kt2-parts1": ("l2sqr", 256, 8192, 4, False),
    "cosine-kt8-parts2": ("cosine", 1024, 6144, 4, True),
    "l2sqr-kt8-parts1": ("l2sqr", 1024, 8192, 4, False),
    "l2sqr-kt9-parts2": ("l2sqr", 1152, 6144, 4, True),
    "cosine-kt9-parts1": ("cosine", 1152, 8192, 4, False),
}


@pytest.mark.parametrize("case", list(_K1_EMULATED), ids=list(_K1_EMULATED))
def test_k1_tiles_emulated(case):
    """An emulation of K1's ring protocol, its swizzled TMA tiles, its wgmma
    descriptors and its accumulator-to-(level, slot) map, run on the plan's
    items, gives `scan_chunkmin_int8_packed_ref`'s output bit for bit,
    including a partial second query tile."""
    dist, dim, N, sms, split = _K1_EMULATED[case]
    B = 130
    base, qs = _make(N, dim, B, seed=11)
    b8, sc, cache = _t(*_channels(base, dist))
    q8, qs2, qc = S.quantize_queries(torch.from_numpy(qs), dim, dist)
    plan = S.k1_plan(N, B, sms)
    assert (plan["parts"] > 1) == split and plan["qtiles"] == 2
    got = _k1_emulate(q8.numpy(), qs2.numpy(), qc.numpy(), b8.numpy(), sc.numpy(), cache.numpy(), plan)
    np.testing.assert_array_equal(got, S.scan_chunkmin_int8_packed_ref(q8, qs2, qc, b8, sc, cache).numpy())


def test_k1_stage_offset_is_the_swizzle_the_descriptor_reads():
    """`k1_stage_offset` is TMA's 128-byte swizzle of a 128-byte-row box
    (16-byte chunk j of row r at chunk j ^ (r % 8)), and reading a box
    through the descriptor addresses returns each row's 32 bytes of every
    k-step."""
    r = np.arange(64)[:, None]
    c = np.arange(128)[None, :]
    linear = r * 128 + c
    np.testing.assert_array_equal(S.k1_stage_offset(r, c), linear ^ (((linear >> 7) & 7) << 4))
    box = np.random.default_rng(4).integers(-127, 128, (64, 128)).astype(np.int8)
    buf = np.zeros(64 * 128, np.int8)
    buf[S.k1_stage_offset(r, c)] = box
    for kk in range(4):
        addr = 32 * kk + (r // 8) * 1024 + (r % 8) * 128 + np.arange(32)[None, :]
        np.testing.assert_array_equal(buf[addr ^ (((addr >> 7) & 7) << 4)], box[:, 32 * kk : 32 * kk + 32])


_K1_NAME = ("_ZN52_GLOBAL__N__a2fa5933_19_scan_int8_packed_cu_e78b269023scan_int8_packed_kernelE14CUtensorMap_stS0_"
            "PKfS2_S2_S2_Piiiiii")
_K10_NAME = ("_ZN52_GLOBAL__N__c233d802_19_scan_int8_binned_cu_6d44d4f723scan_int8_binned_kernelE14CUtensorMap_stPKaPKf"
             "S4_PKiS4_S4_Piiiii")


def _ptxas_report(name, serialized, spill=0):
    """nvcc -Xptxas -v's lines for one kernel, as ptxas prints them for sm_90a."""
    lines = [f"ptxas info    : (C7519) warpgroup.arrive is injected in around line 1312 by compiler to allow use "
             f"of registers in GMMA in function '{name}'"]
    if serialized:
        lines.append("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized "
                     f"due to program dependence on compiler-inserted WG.AR in divergent path in the function '{name}'")
    lines += ["ptxas info    : 0 bytes gmem",
              f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
              f"ptxas info    : Function properties for {name}",
              f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads",
              "ptxas info    : Used 168 registers, used 2 barriers",
              "ptxas info    : Compile time = 245.382 ms"]
    return lines


def _chip_smoke():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("k1_note", [True, False], ids=["with_note", "without_note"])
def test_ptxas_of_counts_wgmma_serialization_notes(k1_note):
    """`chip_smoke.ptxas_of` counts ptxas's notes that a kernel's wgmmas are
    serialized, for the kernel the note names: K1's with or without its
    note, beside K10's note, which is K10's alone."""
    smoke = _chip_smoke()
    log = "\n".join(_ptxas_report(_K1_NAME, k1_note) + _ptxas_report(_K10_NAME, True, spill=8))
    assert smoke.ptxas_of(log, "scan_int8_packed_kernel") == {
        "registers": 168, "spill_store_bytes": 0, "spill_load_bytes": 0, "instantiations": 1,
        "serialized": int(k1_note)}
    k10 = smoke.ptxas_of(log, "scan_int8_binned_kernel")
    assert k10["serialized"] == 1 and k10["spill_store_bytes"] == 8 == k10["spill_load_bytes"]


def test_ptxas_of_without_a_report():
    """A kernel the log does not name has no figures, `serialized` included."""
    smoke = _chip_smoke()
    log = "\n".join(_ptxas_report(_K10_NAME, True))
    assert smoke.ptxas_of(log, "scan_int8_packed_kernel") == {
        "registers": None, "spill_store_bytes": None, "spill_load_bytes": None, "instantiations": 0,
        "serialized": None}
