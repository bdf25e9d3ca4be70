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
