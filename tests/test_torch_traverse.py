"""K3 (the single-kernel level-0 traversal) of the PyTorch port against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

On CPU tensors `traverse` runs its plain version `traverse_ref` (the fused
lock-step loop on the plain K4, K5 and K2 versions); the CUDA kernel is held
against it on the card by `chip_smoke.py`.  The semantics are identical;
the distances are f32 sums in different orders, so a tie at the tail of a
beam may flip: id overlap >= 0.97 and the first 8 distances within rtol /
atol 1e-5, the reference's own tolerance for its kernel.  Over the lean
tier's bf16 rows (a few hundred rows, no near ties) the ids are equal and
every distance within rtol 1e-5, also at a dim that is not a multiple of 8
(or of 4: the kernel's scalar path) and at ef 129, one past a beam width.
The host side of the kernel is tested here too: its shared-memory plan
(`k3_plan`: one wave of 1000 queries up to ef 360, a launch at MAX_W) and
its load flags."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.ops import pallas_gather as PG
from lab_1806_vec_db_tpu.ops import pallas_traverse as PT
from lab_1806_vec_db_tpu_torch.ops import beam as BM
from lab_1806_vec_db_tpu_torch.ops import beam_fused as BF
from lab_1806_vec_db_tpu_torch.ops import gather as G
from lab_1806_vec_db_tpu_torch.ops import traverse as TR

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _inputs(N=2000, dim=64, L=32, B=16, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((N, dim)).astype(np.float32)
    links = rng.integers(0, N, (N, L)).astype(np.int32)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    entry = rng.integers(0, N, (B,)).astype(np.int32)
    return base, links, q, entry


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_traverse_ref_matches_pallas(dist):
    L, E, ef = 32, 4, 32
    base, links, q, entry = _inputs(L=L)
    if dist == "cosine":
        entry[3] = -1  # a padding query: empty result
    d1, i1 = PT.traverse(jnp.asarray(q), PG.prepare_rerank_base(jnp.asarray(base)),
                         PT.pack_links(jnp.asarray(links)), jnp.asarray(entry), ef, L, E=E,
                         R=256, max_iters=20, dist=dist, bq=16, interpret=True)
    d2, i2 = TR.traverse_ref(*(torch.from_numpy(a) for a in (q, base, links, entry)), ef, L, E=E,
                             R=256, max_iters=20, dist=dist)
    i1n, i2n = np.asarray(i1), i2.numpy()
    live = entry >= 0
    overlap = np.mean([len(set(i1n[b].tolist()) & set(i2n[b].tolist())) / ef
                       for b in np.nonzero(live)[0]])
    assert overlap >= 0.97, overlap
    np.testing.assert_allclose(d2.numpy()[:, :8], np.asarray(d1)[:, :8], rtol=1e-5, atol=1e-5)
    # a padding query comes back empty from both
    assert (i1n[~live] == -1).all() and (i2n[~live] == -1).all()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_traverse_bf16_rows_match_pallas(dist):
    """K3 over the lean tier's bf16 rows (M = 16: L = 32, E = 4): the
    reference's kernel on its bf16 slab in interpret mode, the port's plain
    version on the same bf16 rows.  Both upcast each row to f32 before the
    arithmetic: ids equal, distances within rtol 1e-5; and the port's bf16
    route equals its f32 route on the upcast rows bit for bit."""
    L, E, ef = 32, 4, 24
    base, links, q, entry = _inputs(N=400, dim=48, L=L, B=12, seed=3)
    rows = torch.from_numpy(base).to(torch.bfloat16)
    d1, i1 = PT.traverse(jnp.asarray(q), PG.prepare_rerank_base(jnp.asarray(base), jnp.bfloat16),
                         PT.pack_links(jnp.asarray(links)), jnp.asarray(entry), ef, L, E=E,
                         R=128, max_iters=24, dist=dist, bq=16, interpret=True)
    qt, lt, et = (torch.from_numpy(a) for a in (q, links, entry))
    launches = TR.traverse.launches
    d2, i2 = TR.traverse(qt, rows, lt, et, ef, L, E=E, R=128, max_iters=24, dist=dist)
    assert TR.traverse.launches == launches
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d1), rtol=1e-5, atol=1e-6)
    d3, i3 = TR.traverse(qt, rows.float(), lt, et, ef, L, E=E, R=128, max_iters=24, dist=dist)
    assert torch.equal(i2, i3) and torch.equal(d2, d3)
    # the beam's distances are the bf16 rows' exact f32 distances
    exact = G.gather_dists_ref(qt, rows, i2, dist).numpy()
    fin = i2.numpy() >= 0
    np.testing.assert_array_equal(d2.numpy()[fin], exact[fin])


@pytest.mark.parametrize("dim,ef,dist,iters", [(100, 129, "l2sqr", 8), (98, 24, "cosine", 24)])
def test_traverse_bf16_rows_match_pallas_at_odd_widths(dim, ef, dist, iters):
    """bf16 rows at a dim that is no multiple of 8 (100: 4-lane loads with a
    partial last step; 98: no multiple of 4, the scalar path), the first at
    ef 129 (W 256, one past the 128-lane beam; 8 iterations, the
    reference's interpret-mode sort of 512 keys an iteration being the
    test's cost): the reference in interpret mode and the port's plain
    version give the same ids, distances within rtol 1e-5."""
    L, E = 32, 4
    base, links, q, entry = _inputs(N=400, dim=dim, L=L, B=12, seed=5)
    d1, i1 = PT.traverse(jnp.asarray(q), PG.prepare_rerank_base(jnp.asarray(base), jnp.bfloat16),
                         PT.pack_links(jnp.asarray(links)), jnp.asarray(entry), ef, L, E=E,
                         R=128, max_iters=iters, dist=dist, bq=16, interpret=True)
    rows = torch.from_numpy(base).to(torch.bfloat16)
    d2, i2 = TR.traverse(torch.from_numpy(q), rows, torch.from_numpy(links), torch.from_numpy(entry), ef,
                         L, E=E, R=128, max_iters=iters, dist=dist)
    np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))
    np.testing.assert_allclose(d2.numpy(), np.asarray(d1), rtol=1e-5, atol=1e-6)
    assert (i2.numpy() >= 0).all()  # the beam is full: every lane past the old width is live


def test_k3_plan_one_wave_and_max_w():
    """K3's launch plan: the id set is the smallest power of two of at least
    2 (W + R) slots (and holds the merge's 384 words of keys); the shared
    memory is the kernel's layout; up to ef 360 at dim 960 eight CTAs fit an
    SM (8 x 132 SMs hold B = 1000 in one wave); MAX_W still launches; a plan
    past the CTA limit is refused before any work."""
    W = TR._widths
    for ef in (1, 120, 128, 129, 200, 360, 1000, BF.MAX_W):
        for R in (4, 100, 256):
            log2_set, smem = TR.k3_plan(ef, R, 960)
            n_set = 1 << log2_set
            assert 2 * (W(ef) + R) <= n_set < 4 * (W(ef) + R) and n_set >= 3 * TR.EL
            assert smem % 16 == 0
    # 960 + 6 x 120 + 1024 + 512 + 256 + 256 + 128 + 8 words
    assert TR.k3_plan(120, 256, 960) == (10, 4 * 3864)
    for ef in (120, 200, 360):  # an H100 SM has 228 KB, each resident CTA reserving 1 KB
        smem = TR.k3_plan(ef, 256, 960)[1]
        assert 228 * 1024 // (smem + 1024) >= 8, (ef, smem)
    assert TR.k3_plan(BF.MAX_W, 256, 960)[1] <= TR.SMEM_MAX
    assert TR.k3_plan(BF.MAX_W, 256, 20_000)[1] > TR.SMEM_MAX
    base, links, q, entry = (torch.from_numpy(a) for a in _inputs(N=50, dim=8, L=32, B=2))
    wide = torch.zeros((2, 60_000))
    with pytest.raises(ValueError, match="shared memory"):
        TR.traverse(wide, torch.zeros((50, 60_000)), links, entry, 10, 32, E=4)


def test_k3_flags():
    """Bit 0 cosine, bit 1 the 4-lane loads (dim % 4 == 0 and rows aligned
    to 16 bytes of f32 / 8 of bf16), bit 2 bf16 rows."""
    f = torch.zeros((10, 64))
    assert TR.k3_flags(f, 64, "l2sqr") == 2 and TR.k3_flags(f, 64, "cosine") == 3
    assert TR.k3_flags(f.to(torch.bfloat16), 64, "l2sqr") == 6
    assert TR.k3_flags(torch.zeros((10, 100), dtype=torch.bfloat16), 100, "l2sqr") == 6
    assert TR.k3_flags(torch.zeros((10, 98)), 98, "l2sqr") == 0
    assert TR.k3_flags(torch.zeros((10, 98), dtype=torch.bfloat16), 98, "cosine") == 5
    flat = torch.zeros(10 * 64 + 4)
    assert TR.k3_flags(flat[4:].view(10, 64), 64, "l2sqr") == 2  # 16 bytes in
    assert TR.k3_flags(flat[1:641].view(10, 64), 64, "l2sqr") == 0  # 4 bytes in
    half = torch.zeros(10 * 64 + 4, dtype=torch.bfloat16)
    assert TR.k3_flags(half[4:].view(10, 64), 64, "l2sqr") == 6  # 8 bytes in
    assert TR.k3_flags(half[2:642].view(10, 64), 64, "l2sqr") == 4  # 4 bytes in


def test_traverse_wrapper_on_cpu_is_the_plain_version():
    base, links, q, entry = (torch.from_numpy(a) for a in _inputs(N=500, dim=24, L=16, B=8, seed=1))
    launches = TR.traverse.launches
    d1, i1 = TR.traverse(q, base, links, entry, 40, 16, E=8, R=128, max_iters=60)
    d2, i2 = TR.traverse_ref(q, base, links, entry, 40, 16, E=8, R=128, max_iters=60)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert TR.traverse.launches == launches  # CPU tensors launch nothing
    # the beam is sorted, exact, -1/inf padded only at its tail
    d, i = d1.numpy(), i1.numpy()
    assert (np.diff(d, axis=1)[np.isfinite(d[:, 1:])] >= 0).all()
    fin = i >= 0
    exact = G.gather_dists_ref(q, base, i1, "l2sqr").numpy()
    np.testing.assert_array_equal(d[fin], exact[fin])


def test_traverse_ref_is_the_fused_loop_with_its_widths():
    """traverse_ref is the fused lock-step loop with W = pow2(max(ef, 128))
    and the ring as given; with the ring rounded as `beam_search_fused`
    rounds it the two agree exactly."""
    base, links, q, entry = (torch.from_numpy(a) for a in _inputs(N=800, dim=16, L=32, B=8, seed=2))
    nd = lambda ids: G.gather_dists(q, base, ids, "l2sqr")
    lf = lambda ids: links[ids.long()]
    d1, i1 = TR.traverse_ref(q, base, links, entry, 48, 32, E=4, R=128, max_iters=50)
    d2, i2 = BM.beam_search_fused(entry, nd, lf, 48, 50, expand=4, ring_size=128)
    assert torch.equal(i1, i2) and torch.equal(d1, d2)
    d3, i3 = BM.lockstep(entry, nd, lf, 48, 50, 4, 128, BF.beam_pre_ref, BF.beam_post_ref)
    assert torch.equal(i1, i3)


def test_traverse_rejects_what_the_kernel_does_not_take():
    base, links, q, entry = (torch.from_numpy(a) for a in _inputs(N=100, dim=8, L=16, B=2))
    with pytest.raises(ValueError, match="E \\* L"):
        TR.traverse(q, base, links, entry, 10, 16, E=4)  # 64 lanes, not 128
    with pytest.raises(ValueError):
        TR.traverse(q, base, links, entry, 10, 16, E=8, R=512)
    with pytest.raises(TypeError):
        TR.traverse(q, base, links.long(), entry, 10, 16, E=8)
    with pytest.raises(TypeError):
        TR.traverse(q, base.half(), links, entry, 10, 16, E=8)
    with pytest.raises(ValueError, match="shape mismatch"):
        # a links row per row of the (bf16) base, on the CPU as on the card
        TR.traverse(q, base.to(torch.bfloat16), links[:64].contiguous(), entry, 10, 16, E=8)
    with pytest.raises(ValueError):
        TR.traverse(q, base, links, entry, 10, 16, E=8, dist="dot")
