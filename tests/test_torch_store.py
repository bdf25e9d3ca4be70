"""VecStore of the PyTorch port against the JAX package's VecStore: the
scan-permuted int8 mirror, the dirty-row sync and the device footprint.

int8 rows and the permutation must be identical (same quantizer, same
`default_rng(cap ^ 0x5EED)` permutation); scales and caches agree to rtol
1e-6 (the port sums squares in float64, the reference in f32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.models.store import VecStore as JVecStore
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
    assert got[0].shape == (s.capacity, 128) and got[0].dtype == torch.int8
    _assert_mirrors_equal(got, j.device_int8())
    # invalid rows carry the losing sentinel
    invalid = got[3].numpy() >= len(x)
    assert (got[1].numpy()[invalid] == 0).all()
    assert (got[2].numpy()[invalid] == np.float32(S._BIG)).all()


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


def test_scan_bound_masks_channels():
    x = _rows(100, 16, seed=3)
    s = VecStore.from_numpy(x, "l2sqr", device="cpu")
    s.set_scan_bound(60)
    _, sc, ca, perm = s.device_int8()
    out = perm.numpy() >= 60
    assert (sc.numpy()[out] == 0).all() and (ca.numpy()[out] == np.float32(S._BIG)).all()
    s.set_scan_bound(None)
    _, sc2, _, _ = s.device_int8()
    assert (sc2.numpy()[(perm.numpy() >= 60) & (perm.numpy() < 100)] > 0).all()


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

    from lab_1806_vec_db_tpu_torch.models import store as store_mod

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
    real = store_mod._mirror_rows
    monkeypatch.setattr(store_mod, "_mirror_rows", lambda *a: syncs.append(1) or real(*a))
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
