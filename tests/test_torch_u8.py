"""uint8 tables of the PyTorch port against the JAX package (the counterpart
of tests/test_u8.py), on the CPU with inputs from a numpy seed.

- `pairwise_u8` l2sqr equals the reference, and an int64 oracle exactly
  (int32; the f32 distances are those integers rounded once); cosine is
  within 1e-6 of the reference (both divide the same exact dot by f32
  norms);
- `knn_scan_u8` returns the reference's distances exactly, ids equal except
  within a tie;
- k-means: the overflow guard, the centroid fixed point, and Lloyd from the
  reference's own init equal to the reference's centroids (the two
  packages draw different k-means++ seeds from one seed);
- `U8VecSet` mutation and the raw round trip, the dtype refusals;
- FlatU8 checkpoints and uint8 DB directories interchange both ways."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu import VecDB as JVecDB
from lab_1806_vec_db_tpu.models import FlatIndexU8 as JFlatIndexU8
from lab_1806_vec_db_tpu.ops import u8 as JU8
from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import FlatIndexU8, U8VecSet
from lab_1806_vec_db_tpu_torch.ops import u8 as U8
from lab_1806_vec_db_tpu_torch.utils import io as IO

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _rows(seed, n, dim, lo=0):
    return np.random.default_rng(seed).integers(lo, 256, size=(n, dim)).astype(np.uint8)


def _oracle_l2(a, b):
    af, bf = a.astype(np.int64), b.astype(np.int64)
    return ((af[:, None, :] - bf[None, :, :]) ** 2).sum(-1)


def test_pairwise_u8_l2sqr_exact_at_dim_960():
    """Full-range values (255 included): the 128-centering and the rank-1
    correction reproduce the integer distances exactly (int32), and the f32
    distances are those integers rounded once (row 0 reaches 6.2e7, past
    f32's 2^24); the int8 operands are zero-padded for the GEMM (33 and 17
    rows)."""
    a, b = _rows(0, 33, 960), _rows(1, 17, 960)
    a[0] = 255
    b[0] = 0
    got = U8.pairwise_u8(torch.from_numpy(a), torch.from_numpy(b), "l2sqr").numpy()
    ref = np.asarray(JU8.pairwise_u8(jnp.asarray(a), jnp.asarray(b), "l2sqr"))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _oracle_l2(a, b).astype(np.float32))
    assert (got[1:, 1:] < 2**24).all()
    np.testing.assert_array_equal(got[1:, 1:].astype(np.int64), _oracle_l2(a[1:], b[1:]))
    np.testing.assert_array_equal(U8.pairwise_u8_i32(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  _oracle_l2(a, b))


@pytest.mark.parametrize("dim", [64, 100])
def test_pairwise_u8_cosine_matches_reference(dim):
    a, b = _rows(2, 9, dim, lo=1), _rows(3, 7, dim, lo=1)
    got = U8.pairwise_u8(torch.from_numpy(a), torch.from_numpy(b), "cosine").numpy()
    ref = np.asarray(JU8.pairwise_u8(jnp.asarray(a), jnp.asarray(b), "cosine"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_u8_channels_match_reference():
    x = _rows(4, 50, 37)
    for g, r in zip(U8.u8_channels(torch.from_numpy(x)), JU8.u8_channels(jnp.asarray(x))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_knn_scan_u8_matches_reference(dist):
    """Blocks of 128 rows (the last one ragged), n_valid below the row
    count, k above a block's rows on a small base."""
    base = _rows(5, 700, 24, lo=1)
    base[650:660] = base[10]  # exact ties
    queries = np.concatenate([base[:4], _rows(6, 12, 24, lo=1)])
    n_valid, k = 690, 12
    jx8, jip, js8 = JU8.u8_channels(jnp.asarray(base))
    od, oi = JU8.knn_scan_u8(jnp.asarray(queries), jx8, jip, js8, jnp.int32(n_valid), k, dist, block=128)
    x8, ip, s8 = U8.u8_channels(torch.from_numpy(base))
    bd, bi = U8.knn_scan_u8(torch.from_numpy(queries), x8, ip, s8, n_valid, k, dist, block=128)
    od, oi, bd, bi = np.asarray(od), np.asarray(oi), bd.numpy(), bi.numpy()
    if dist == "l2sqr":
        np.testing.assert_array_equal(bd, od)
    else:
        np.testing.assert_allclose(bd, od, rtol=0, atol=1e-6)
    tied = np.zeros_like(od, dtype=bool)
    tied[:, 1:] |= np.isclose(od[:, 1:], od[:, :-1], rtol=0, atol=1e-6)
    tied[:, :-1] |= np.isclose(od[:, :-1], od[:, 1:], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(bi[~tied], oi[~tied])
    assert (bi < n_valid).all()
    # k above the rows present: +inf / -1 tails
    small = torch.from_numpy(base[:5])
    d, i = U8.knn_scan_u8(torch.from_numpy(queries[:2]), *U8.u8_channels(small), 5, 8, dist)
    assert np.isinf(d[:, 5:].numpy()).all() and (i[:, 5:] == -1).all()


def test_flat_u8_search_is_exact():
    base = _rows(7, 500, 96)
    idx = FlatIndexU8.from_numpy(base, "l2sqr", device="cpu")
    d, i = idx.knn_batch(base[:20], 5)
    assert (i[:, 0] == np.arange(20)).all() and (d[:, 0] == 0).all()
    od = _oracle_l2(base[:20], base)
    gt = np.argsort(od, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(d.astype(np.int64), np.take_along_axis(od, gt, axis=1))
    jd, ji = JFlatIndexU8.from_numpy(base, "l2sqr").knn_batch(base[:20], 5)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(i, ji)
    assert idx.knn(base[3], 1)[0].index == 3
    empty = FlatIndexU8(96, "l2sqr", device="cpu")
    d, i = empty.knn_batch(base[:2], 3)
    assert np.isinf(d).all() and (i == -1).all()


def test_kmeans_u8_overflow_guard():
    """The reference's guard set (k_means.rs:222-240): values at the top of
    the u8 range, where u8 sums would wrap and f32 sums do not."""
    data = torch.tensor([[0, 0], [1, 0], [255, 254], [255, 255]], dtype=torch.uint8)
    c = U8.kmeans_fit_u8(data, 4, 2, 20, 1e-6, "l2sqr", torch.Generator().manual_seed(42))
    assert c.dtype == torch.uint8 and c.shape == (2, 2)
    c = c.numpy()[np.argsort(c.numpy()[:, 0])]
    assert (c[0] <= 1).all() and (c[1] >= 254).all()
    # trunc toward zero: the mean {255, 254.5} casts to {255, 254}
    init = torch.tensor([[0, 0], [255, 255]], dtype=torch.uint8)
    np.testing.assert_array_equal(U8.lloyd_u8(data, 4, init, 20, 1e-6, "l2sqr").numpy(), [[0, 0], [255, 254]])


def test_kmeans_u8_centroid_fixed_point():
    """The nearest centroid of a centroid is itself (k_means.rs:269-274)."""
    data = torch.from_numpy(_rows(8, 200, 16))
    c = U8.kmeans_fit_u8(data, 200, 3, 20, 1e-6, "l2sqr", torch.Generator().manual_seed(42))
    np.testing.assert_array_equal(U8.find_nearest_u8(c, c, "l2sqr").numpy(), np.arange(3))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_lloyd_u8_from_reference_init_matches_reference(dist):
    """Lloyd from the reference's own k-means++ seeds (`kmeans_fit_u8` with
    max_iter = 0 returns them unchanged) gives the reference's centroids,
    rows past n_valid ignored."""
    data = _rows(9, 400, 12)
    key = jax.random.PRNGKey(3)
    init = np.asarray(JU8.kmeans_fit_u8(key, jnp.asarray(data), jnp.int32(380), 5, 0, 1e-6, dist))
    ref = np.asarray(JU8.kmeans_fit_u8(key, jnp.asarray(data), jnp.int32(380), 5, 20, 1e-6, dist))
    got = U8.lloyd_u8(torch.from_numpy(data), 380, torch.from_numpy(np.array(init)), 20, 1e-6, dist)
    np.testing.assert_array_equal(got.numpy(), ref)
    near = U8.find_nearest_u8(torch.from_numpy(data[:50]), got, dist).numpy()
    np.testing.assert_array_equal(near, np.asarray(JU8.find_nearest_u8(jnp.asarray(data[:50]), jnp.asarray(ref),
                                                                       dist)))


def test_kmeanspp_init_u8_picks_distinct_valid_rows():
    data = _rows(10, 300, 8)
    data[250:] = 0
    c = U8.kmeanspp_init_u8(torch.from_numpy(data), 250, 6, "l2sqr", torch.Generator().manual_seed(1)).numpy()
    rows = {tuple(r) for r in data[:250]}
    assert all(tuple(r) in rows for r in c) and len({tuple(r) for r in c}) == 6


def test_u8_store_mutation_and_raw_roundtrip(tmp_path):
    vs = U8VecSet(8, "l2sqr", device="cpu")
    rows = _rows(11, 5, 8)
    assert vs.batch_push(rows) == [0, 1, 2, 3, 4] and len(vs) == 5
    np.testing.assert_array_equal(vs[3], rows[3])
    x8, ip, _ = vs.device()
    assert x8.shape == (2048, 8) and (ip[5:] == 2**30).all()  # a whole chunk of K1's 2048 rows
    vs.swap_remove(1)  # the last row moves into the hole (vec_set.rs:131-137)
    assert len(vs) == 4
    np.testing.assert_array_equal(vs[1], rows[4])
    assert (vs.device()[1][4:] == 2**30).all()
    np.testing.assert_array_equal(vs.to_f32()[0], rows[0].astype(np.float32))
    sample = vs.random_sample(3, np.random.default_rng(0))  # rows without replacement, in row order
    assert sample.shape == (3, 8) and {tuple(r) for r in sample} <= {tuple(r) for r in vs.numpy()}
    p = str(tmp_path / "u8.bin")
    vs.save_raw(p)
    back = U8VecSet.load_raw(p, 8, device="cpu")
    np.testing.assert_array_equal(back.numpy(), vs.numpy())
    # the reference reads the port's file and the port the reference's
    from lab_1806_vec_db_tpu.utils import io as JIO

    np.testing.assert_array_equal(JIO.load_raw(p, 8, dtype="uint8"), vs.numpy())
    JIO.save_raw(str(tmp_path / "j.bin"), rows)
    np.testing.assert_array_equal(IO.load_raw(str(tmp_path / "j.bin"), 8, "uint8", limit=3), rows[:3])
    with pytest.raises(ValueError, match="Unsupported"):
        IO.dtype_from_name("int16")


def test_u8_rejects_wrong_dtype():
    with pytest.raises(ValueError, match="uint8"):
        U8VecSet.from_numpy(np.zeros((3, 4), np.float32), device="cpu")
    idx = FlatIndexU8.from_numpy(_rows(12, 10, 4), device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        idx.knn_batch(np.zeros((1, 4), np.float32), 3)
    with pytest.raises(ValueError, match="dim"):
        idx.batch_add(np.zeros((1, 5), np.uint8))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_flat_u8_checkpoint_interchanges(writer, reader, tmp_path):
    base = _rows(13, 120, 16)
    p = str(tmp_path / "flat_u8.npz")
    if writer == "jax":
        JFlatIndexU8.from_numpy(base, "cosine").save(p)
        idx = FlatIndexU8.load(p, device="cpu")
    else:
        FlatIndexU8.from_numpy(base, "cosine", device="cpu").save(p)
        idx = JFlatIndexU8.load(p)
    assert (idx.algorithm, idx.dist, len(idx)) == ("FlatU8", "cosine", 120)
    np.testing.assert_array_equal(idx.store.numpy(), base)


def _u8_session(db):
    db.create_table_if_not_exists("bytes", 4, "l2sqr", data_type="uint8")
    db.add("bytes", [0, 0, 0, 0], {"name": "zero"})
    db.batch_add("bytes", [[255, 255, 255, 255], [200.7, 200.7, 200.7, 200.7], [-3, 300, 7.9, 1]],
                 [{"name": "max"}, {"name": "trunc"}, {"name": "clip"}])
    return [db.search("bytes", [255, 255, 255, 255], 1), db.search("bytes", [201, 201, 201, 201], 1),
            db.batch_search("bytes", [[0, 255, 7, 1], [1, 1, 1, 1]], 4), db.get_len("bytes")]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_uint8_db_directory_interchanges(writer, reader, tmp_path):
    """One uint8 session on each package gives the same answers (the `as
    u8` cast: 200.7 -> 200, -3 -> 0, 300 -> 255, 7.9 -> 7); the directory
    one wrote opens in the other with the same rows and results."""
    open_ = {"jax": lambda: JVecDB(str(tmp_path)), "torch": lambda: VecDB(str(tmp_path), device="cpu")}
    db = open_[writer]()
    try:
        got = _u8_session(db)
    finally:
        db.close()
    assert got[0] == [({"name": "max"}, 0.0)] and got[1] == [({"name": "trunc"}, 4.0)]
    assert got[2][0][0] == ({"name": "clip"}, 0.0) and got[3] == 4
    db = open_[reader]()
    try:
        assert db.batch_search("bytes", [[0, 255, 7, 1], [1, 1, 1, 1]], 4) == got[2]
        assert sorted(m["name"] for m, _ in db.search("bytes", [0, 0, 0, 0], 4)) == ["clip", "max", "trunc", "zero"]
        rows = {m["name"]: v for v, m in db.extract_data("bytes")}
        assert rows["clip"] == [0.0, 255.0, 7.0, 1.0] and rows["trunc"] == [200.0] * 4
    finally:
        db.close()
