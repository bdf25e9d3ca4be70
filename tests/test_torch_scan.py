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

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import distance as JD
from lab_1806_vec_db_tpu.ops import pallas_scan as PS
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu_torch.ops import scan as S
from lab_1806_vec_db_tpu_torch.ops import topk as T


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
