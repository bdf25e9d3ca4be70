"""VecStore of the PyTorch port against the JAX package's VecStore: the
scan-permuted int8 mirror, the dirty-row sync and the device footprint; the
mirrors' format (`models/mirror.py`) on both kinds of mirror.

int8 rows and the permutation must be identical (same quantizer, same
`default_rng(cap ^ 0x5EED)` permutation); scales and caches agree to rtol
1e-6 (the port sums squares in float64, the reference in f32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.models.store import VecStore as JVecStore
from lab_1806_vec_db_tpu_torch.models import mirror as MR
from lab_1806_vec_db_tpu_torch.models.store import VecStore
from lab_1806_vec_db_tpu_torch.ops import scan as S

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _rows(n=300, dim=70, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _assert_mirrors_equal(got, expect):
    q8, sc, ca, perm = (t.numpy() for t in got)
    jq8, jsc, jca, jperm = (np.asarray(a) for a in expect)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(q8, jq8)
    np.testing.assert_allclose(sc, jsc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ca, jca, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_int8_mirror_matches_reference(dist):
    x = _rows()
    s = VecStore.from_numpy(x, dist, device="cpu")
    j = JVecStore.from_numpy(x, dist)
    got = s.device_int8()
    assert got.q8.shape == (s.capacity, 128) and got.q8.dtype == torch.int8
    _assert_mirrors_equal(got, j.device_int8())
    # invalid rows carry the losing sentinel
    invalid = got.perm.numpy() >= len(x)
    assert (got.scale.numpy()[invalid] == 0).all()
    assert (got.cache.numpy()[invalid] == np.float32(S._BIG)).all()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_swap_remove_and_dirty_sync_match_reference(dist):
    """Mirror built, then rows removed and pushed: the in-place row sync
    gives the reference's mirror, and the same mirror as a full rebuild."""
    x = _rows(200, 40, seed=1)
    s = VecStore.from_numpy(x, dist, device="cpu")
    j = JVecStore.from_numpy(x, dist)
    s.device_int8()
    j.device_int8()
    extra = _rows(3, 40, seed=2)
    for st in (s, j):
        st.swap_remove(5)
        st.swap_remove(len(st) - 1)
        st.swap_remove(0)
        st.push(extra[0])
    synced = s.device_int8()
    _assert_mirrors_equal(synced, j.device_int8())
    vecs, cache = s.device()
    jv, jc = j.device()
    np.testing.assert_array_equal(vecs.numpy(), np.asarray(jv))
    np.testing.assert_allclose(cache.numpy(), np.asarray(jc), rtol=1e-6)
    fresh = VecStore.from_numpy(s.numpy(), dist, device="cpu")
    fresh._cap = s.capacity  # same capacity -> same permutation
    fresh._data = s._host().copy()
    fresh._dev_full_dirty = True
    for a, b in zip(synced, fresh.device_int8()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_scan_bound_masks_channels(monkeypatch):
    """`survivors(..., n_valid=)` scans with the rows >= n_valid turned into
    sentinels for that call alone; the mirror keeps its channels."""
    x = _rows(100, 16, seed=3)
    s = VecStore.from_numpy(x, "l2sqr", device="cpu")
    m = s.device_int8()
    scanned = []
    real = S.scan_candidates_int8_packed
    monkeypatch.setattr(S, "scan_candidates_int8_packed",
                        lambda q, b8, sc, ca, r, dist: scanned.append((sc, ca)) or real(q, b8, sc, ca, r, dist))
    q = torch.from_numpy(x[:4])
    _, cand = m.survivors(q, 8, n_valid=60)
    sc, ca = scanned[0]
    perm = m.perm.numpy()
    out = perm >= 60
    assert (sc.numpy()[out] == 0).all() and (ca.numpy()[out] == np.float32(S._BIG)).all()
    assert (sc.numpy()[~out] == m.scale.numpy()[~out]).all()
    ids = m.decode(cand, 60).numpy()
    assert (ids < 60).all() and (ids[:, 0] == np.arange(4)).all()
    m.survivors(q, 8)
    assert scanned[1][0] is m.scale and scanned[1][1] is m.cache
    assert (m.scale.numpy()[(perm >= 60) & (perm < 100)] > 0).all()


@pytest.mark.parametrize("kind", ["int8", "pca"])
@pytest.mark.parametrize("when", ["build", "written"])
def test_mirror_rows_follow_the_format(kind, when):
    """Each mirror row holds its original row under the channel rule, and
    every row holding none the losing sentinel: after a build, and after
    rows written in place by push / swap_remove, which then equal a fresh
    build.  The PCA mirror projects rows through its fit, a product whose
    rounding may depend on how many rows it holds: int8 lanes +-1, scales
    rtol 1e-5."""
    dist = "cosine" if kind == "int8" else "l2sqr"
    s = VecStore.from_numpy(_rows(200, 40, seed=9), dist, device="cpu")
    mirror = s.device_int8 if kind == "int8" else lambda: s.device_proj_int8(8)
    m = mirror()
    if when == "written":
        s.swap_remove(5)
        s.swap_remove(len(s) - 1)
        s.push(_rows(1, 40, seed=10)[0])
        assert mirror() is m  # written in place, not rebuilt
    vecs, cache = s.device()
    orig = m.perm.long() if kind == "int8" else torch.arange(s.capacity)
    valid = (orig < len(s)).numpy()
    if kind == "int8":
        q8, sc, ca = MR.quantize(vecs[orig], cache[orig], 128, dist)
    else:
        q8, sc, ca = MR.project_quantize(vecs[orig], m.proj, m.mu, dist)
    atol = 0 if kind == "int8" else 1
    assert np.abs(m.q8.numpy()[valid].astype(np.int32) - q8.numpy()[valid]).max() <= atol
    rtol = 0 if kind == "int8" else 1e-5
    np.testing.assert_allclose(m.scale.numpy()[valid], sc.numpy()[valid], rtol=rtol, atol=0)
    np.testing.assert_allclose(m.cache.numpy()[valid], ca.numpy()[valid], rtol=rtol, atol=0)
    assert (m.scale.numpy()[~valid] == 0).all()
    assert (m.cache.numpy()[~valid] == np.float32(S._BIG)).all()


def test_device_bytes_counts_each_tensor_once():
    """f32 rows + cache + int8 mirror (rows, scale, cache, perm); the rerank
    rows are the f32 rows, not a second copy."""
    x = _rows(300, 70, seed=4)
    s = VecStore.from_numpy(x, "l2sqr", device="cpu")
    s.device()
    cap = s.capacity
    assert s.device_bytes() == cap * 70 * 4 + cap * 4
    s.device_int8()
    assert s.device_rerank() is s.device()[0]
    assert s.device_bytes() == cap * 70 * 4 + cap * 4 + cap * 128 + 3 * cap * 4


def test_from_device_capacity_and_lazy_host():
    x = _rows(70000, 8, seed=5)
    s = VecStore.from_device(torch.from_numpy(x), "cosine")
    assert s.capacity == 81920 and len(s) == 70000  # 16384-multiple rounding
    assert s._data is None
    np.testing.assert_array_equal(s.numpy(), x)
    np.testing.assert_array_equal(s.state_arrays()["vectors"], x)
    j = JVecStore.from_device(jnp.asarray(x), "cosine")
    assert j.capacity == s.capacity


def test_int8_selftest_and_conversions(monkeypatch):
    x = _rows(500, 32, seed=6)
    s = VecStore.from_numpy(x, "l2sqr", device="cpu")
    assert s.int8_reliable()
    t = s.to_type(np.float16)
    assert t.dtype == np.float16 and len(t) == 500
    samp = s.random_sample(10, np.random.default_rng(0))
    assert samp.shape == (10, 32)
    with pytest.raises(ValueError):
        s.push(np.zeros(31, np.float32))
    # no hidden fallback: a CUDA store without a card raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        VecStore(4, "l2sqr", device="cuda")


def test_concurrent_readers_sync_once(monkeypatch):
    """Searches share a store under the table's read lock: many threads
    reaching the lazy row sync at once must sync the dirty rows once and all
    see the same, complete mirror."""
    import sys
    import threading

    x = _rows(3000, 24, seed=7)
    s = VecStore.from_numpy(x, "l2sqr", device="cpu")
    s.device_int8()
    for i in range(0, 400, 2):
        s.swap_remove(i)
    s.batch_push(_rows(300, 24, seed=8))
    expect = VecStore.from_numpy(s.numpy(), "l2sqr", device="cpu")
    expect._cap, expect._data, expect._dev_full_dirty = s.capacity, s._host().copy(), True
    expect = expect.device_int8()
    syncs = []
    real = MR.ScanMirror.write_rows
    monkeypatch.setattr(MR.ScanMirror, "write_rows", lambda *a: syncs.append(1) or real(*a))
    results, errors = [], []

    def reader():
        try:
            results.append(s.device_int8())
        except Exception as e:  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 12
    assert len(syncs) == 1
    for got in results:
        for a, b in zip(got, expect):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
