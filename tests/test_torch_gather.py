"""K2 (row gather + exact distance) of the PyTorch port against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against it on the card by `chip_smoke.py`.  Both
sides compute f32 distances with different summation orders, hence rtol 1e-5
/ atol 1e-6.  bf16 rows (the lean tier's rerank rows) are upcast to f32 on
both sides before any arithmetic, so the same tolerance holds for them."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import pallas_gather as PG
from lab_1806_vec_db_tpu_torch.ops import gather as G

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _make(n, dim, b, r, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, dim)).astype(np.float32)
    qs = rng.standard_normal((b, dim)).astype(np.float32)
    ids = rng.integers(0, n, size=(b, r)).astype(np.int32)
    ids[0, -1] = -1
    ids[1, :3] = -1
    return base, qs, ids


@pytest.mark.parametrize("r", [16, 40])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_gather_dists_matches_pallas(dist, r):
    base, qs, ids = _make(500, 70, 6, r, seed=1)
    expect = np.asarray(PG.gather_dists_rs(
        jnp.asarray(qs), PG.prepare_rerank_base(jnp.asarray(base)), jnp.asarray(ids), dist,
        interpret=True))
    got = G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids), dist).numpy()
    assert got.shape == (6, r) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    fin = ids >= 0
    np.testing.assert_allclose(got[fin], expect[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_rerank_topk_matches_pallas(dist):
    """Top-k ids equal wherever the distances do not tie."""
    k = 5
    base, qs, ids = _make(400, 48, 8, 24, seed=2)
    ids[2, 5] = ids[2, 6]  # a duplicate candidate: an exact tie
    od, oi = PG.rerank_topk_rs(
        jnp.asarray(qs), PG.prepare_rerank_base(jnp.asarray(base)), jnp.asarray(ids), k, dist,
        interpret=True)
    bd, bi = G.rerank_topk(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids), k, dist)
    od, oi, bd, bi = np.asarray(od), np.asarray(oi), bd.numpy(), bi.numpy()
    np.testing.assert_allclose(bd, od, rtol=1e-5, atol=1e-6)
    tied = np.isclose(bd[:, :-1], bd[:, 1:], rtol=1e-6, atol=0)
    tie = np.zeros_like(bi, dtype=bool)
    tie[:, :-1] |= tied
    tie[:, 1:] |= tied
    assert (bi == oi)[~tie].all()
    assert (np.diff(bd, axis=1) >= 0).all()


def test_rerank_topk_pads_past_candidates():
    """k larger than the candidate list: +inf / -1 padding, and ids whose
    distance is not finite come back -1."""
    base, qs, ids = _make(50, 16, 3, 4, seed=3)
    bd, bi = G.rerank_topk(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids), 6, "l2sqr")
    bd, bi = bd.numpy(), bi.numpy()
    assert np.isinf(bd[:, 4:]).all() and (bi[:, 4:] == -1).all()
    assert (bi[np.isinf(bd)] == -1).all()
    assert (bi[1] >= 0).sum() == 1  # row 1 has 3 invalid of 4 candidates


def test_gather_dists_rejects_what_the_kernel_does_not_take():
    base, qs, ids = _make(10, 8, 2, 3, seed=4)
    with pytest.raises(TypeError):
        G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base).half(), torch.from_numpy(ids), "l2sqr")
    with pytest.raises(TypeError):
        G.gather_dists(torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(base), torch.from_numpy(ids),
                       "l2sqr")
    with pytest.raises(TypeError):
        G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids).long(), "l2sqr")
    with pytest.raises(ValueError):
        G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base[:, :4]), torch.from_numpy(ids), "l2sqr")
    with pytest.raises(ValueError):
        G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids), "dot")
    strided = torch.from_numpy(base).T.contiguous().T  # same shape, column-major
    with pytest.raises(ValueError, match="contiguous"):
        G.gather_dists(torch.from_numpy(qs), strided, torch.from_numpy(ids), "l2sqr")


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_gather_dists_bf16_rows_match_pallas(dist):
    """The lean tier's bf16 rows, read in place (no 128-lane slab), against
    the Pallas kernel on the reference's bf16 slab of the same rows."""
    base, qs, ids = _make(300, 70, 6, 24, seed=5)
    rows16 = torch.from_numpy(base).to(torch.bfloat16)
    slab = PG.prepare_rerank_base(jnp.asarray(base)).astype(jnp.bfloat16)
    expect = np.asarray(PG.gather_dists_rs(jnp.asarray(qs), slab, jnp.asarray(ids), dist, interpret=True))
    got = G.gather_dists(torch.from_numpy(qs), rows16, torch.from_numpy(ids), dist).numpy()
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    fin = ids >= 0
    np.testing.assert_allclose(got[fin], expect[fin], rtol=1e-5, atol=1e-6)
    # the upcast rows, not the f32 ones: bf16 rounding shows
    f32 = G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids), dist).numpy()
    assert not np.allclose(got[fin], f32[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_rerank_topk_blocked_matches_pallas(dist, rows_dtype):
    """A wide candidate list (700 ids: two 512-id K2 blocks, the last padded
    with -1) with -1 holes: the reference's streamed top-k."""
    k = 7
    base, qs, ids = _make(1000, 40, 2, 700, seed=6)
    ids[:, ::97] = -1
    slab = PG.prepare_rerank_base(jnp.asarray(base))
    if rows_dtype == torch.bfloat16:
        slab = slab.astype(jnp.bfloat16)
    od, oi = PG.rerank_topk_blocked(jnp.asarray(qs), slab, jnp.asarray(ids), k, dist, interpret=True)
    bd, bi = G.rerank_topk_blocked(torch.from_numpy(qs), torch.from_numpy(base).to(rows_dtype),
                                   torch.from_numpy(ids), k, dist)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(oi))
    np.testing.assert_allclose(bd.numpy(), np.asarray(od), rtol=1e-5, atol=1e-6)
    # narrow lists take rerank_topk directly; k past the candidates pads
    nd, ni = G.rerank_topk_blocked(torch.from_numpy(qs), torch.from_numpy(base).to(rows_dtype),
                                   torch.from_numpy(ids[:, :3]), 5, dist)
    assert (ni.numpy()[:, 3:] == -1).all() and np.isinf(nd.numpy()[:, 3:]).all()
