"""K2 (row gather + exact distance) of the PyTorch port against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper runs the kernel's plain PyTorch version; the
CUDA kernel itself is held against it on the card by `chip_smoke.py`.  Both
sides compute f32 distances with different summation orders, hence rtol 1e-5
/ atol 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import pallas_gather as PG
from lab_1806_vec_db_tpu_torch.ops import gather as G


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
        G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids).long(), "l2sqr")
    with pytest.raises(ValueError):
        G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base[:, :4]), torch.from_numpy(ids), "l2sqr")
    with pytest.raises(ValueError):
        G.gather_dists(torch.from_numpy(qs), torch.from_numpy(base), torch.from_numpy(ids), "dot")
    strided = torch.from_numpy(base).T.contiguous().T  # same shape, column-major
    with pytest.raises(ValueError, match="contiguous"):
        G.gather_dists(torch.from_numpy(qs), strided, torch.from_numpy(ids), "l2sqr")
