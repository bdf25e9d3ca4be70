"""PQCodesIndex (the codes-resident tier) of the PyTorch port against the
JAX package's, on the CPU.

The reference builds, searches (interpret-mode kernels) and saves each
index; the port loads the npz with a row source over the same numpy rows
and must return the reference's ids.  Stage 0 of both selects its pool
with ties in no fixed order (the reference's approx_min_k) and the stage-1
top-ef cuts through equal ADC distances, so the ids are held to >= 99% of
(query, rank) entries, and where they agree the exact distances to rtol
1e-5.  The port's own build is held to the reference test's gates (recall
>= 0.85, distances exact to 1e-3 + 1e-4 |d|, ascending), and npz files
load in both directions.  Sizes are the reference test's
(tests/test_pq_codes.py): 20,000 x 64, m = 16, coarse_m = 8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.models import PQCodesIndex as JPQCodes
from lab_1806_vec_db_tpu.utils.config import PQConfig as JPQConfig
from lab_1806_vec_db_tpu_torch.models import PQCodesIndex
from lab_1806_vec_db_tpu_torch.models.pq_codes import refine_blocked
from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

N, DIM, BR, NQ = 20000, 64, 4096, 32
SEARCH = dict(ef=128, c0=1024)


def _take_rows(params, key, row_ids):
    """The reference's row-addressable source over fixed rows (traceable)."""
    return params[0][row_ids]


@pytest.fixture(scope="module")
def data():
    """Spectrum-decay Gaussians clipped at 0 (the reference test's regime),
    made once with numpy, and exact ground truth for both metrics."""
    rng = np.random.default_rng(7)
    scales = (1.2 * np.exp(-0.06 * np.arange(DIM))).astype(np.float32)
    base = np.clip(rng.standard_normal((N, DIM)).astype(np.float32) * scales + 0.2, 0.0, None)
    queries = np.clip(rng.standard_normal((NQ, DIM)).astype(np.float32) * scales + 0.2, 0.0, None)
    b64, q64 = base.astype(np.float64), queries.astype(np.float64)
    exact = {"l2sqr": ((q64[:, None, :] - b64[None]) ** 2).sum(-1)}
    nb, nq = np.linalg.norm(b64, axis=1), np.linalg.norm(q64, axis=1)
    exact["cosine"] = 1.0 - (q64 @ b64.T) / np.maximum(nq[:, None] * nb[None], 1e-10)
    gt = {d: np.argsort(e, axis=1, kind="stable")[:, :10] for d, e in exact.items()}
    return base, queries, exact, gt


def _sources(base):
    """(reference fill, reference row_gen, port fill, port row_gen) over `base`."""
    bt, bj = torch.from_numpy(base), jnp.asarray(base)
    return (lambda r0, n: bj[r0 : r0 + n], (_take_rows, (bj,), None),
            lambda r0, n: bt[r0 : r0 + n], lambda ids: bt[ids.long()])


_REF = {}


@pytest.fixture(scope="module")
def ref_index(data, tmp_path_factory):
    """The reference's index per metric, built once: (index, npz path)."""
    def get(dist):
        if dist not in _REF:
            fill_j, gen_j, _, _ = _sources(data[0])
            idx = JPQCodes.build_from_fill(
                fill_j, N, DIM, dist,
                pq_config=JPQConfig(n_bits=4, m=16, dist=dist, k_means_size=4000, rotate=True),
                coarse_m=8, sample_rows=4000, block_rows=BR, row_gen=gen_j)
            path = str(tmp_path_factory.mktemp("pq_codes") / f"ref_{dist}.npz")
            idx.save(path)
            _REF[dist] = (idx, path)
        return _REF[dist]
    return get


_PORT = {}


@pytest.fixture(scope="module")
def port_index(data):
    """The port's own build per metric, once."""
    def get(dist):
        if dist not in _PORT:
            _, _, fill_t, gen_t = _sources(data[0])
            _PORT[dist] = PQCodesIndex.build_from_fill(
                fill_t, N, DIM, dist,
                pq_config=PQConfig(n_bits=4, m=16, dist=dist, k_means_size=4000, rotate=True),
                coarse_m=8, sample_rows=4000, block_rows=BR, row_gen=gen_t, device="cpu")
        return _PORT[dist]
    return get


def _agree(ids_a, d_a, ids_b, d_b, min_share=0.99):
    same = ids_a == ids_b
    assert same.mean() >= min_share, same.mean()
    np.testing.assert_allclose(d_a[same], d_b[same], rtol=1e-5)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_reference_checkpoint_searches_as_the_reference(dist, data, ref_index):
    _, queries, _, _ = data
    ref, path = ref_index(dist)
    ed, ei = (np.asarray(a) for a in ref.knn_batch(queries, 10, interpret=True, **SEARCH))
    _, _, fill_t, gen_t = _sources(data[0])
    port = PQCodesIndex.load(path, row_gen=gen_t, device="cpu")
    assert port._codes_c.shape[1] == 4 and port._codes.shape[1] == 8
    gd, gi = (a.numpy() for a in port.knn_batch(queries, 10, **SEARCH))
    _agree(gi, gd, ei, ed)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_port_build_recall_and_exact_distances(dist, data, port_index):
    base, queries, exact, gt = data
    idx = port_index(dist)
    d, i = (a.numpy() for a in idx.knn_batch(queries, 10, **SEARCH))
    recall = np.mean([len(set(gt[dist][q]) & set(i[q])) / 10 for q in range(NQ)])
    assert recall >= 0.85, recall
    assert (i >= 0).all()
    true = exact[dist][np.arange(NQ)[:, None], i]
    assert np.all(np.abs(d - true) <= 1e-3 + 1e-4 * np.abs(true))
    assert np.all(np.diff(d, axis=1) >= -1e-6)


def test_fill_refine_equals_row_gen_refine(data, port_index):
    """The block-source refine regenerates the same rows as the row source:
    equal distances, +inf at -1."""
    base, queries, _, _ = data
    idx = port_index("l2sqr")
    _, _, fill_t, gen_t = _sources(base)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(-1, N, (NQ, 40)).astype(np.int32))
    q = torch.from_numpy(queries)
    a = refine_blocked(None, BR, N, DIM, "l2sqr", q, ids, row_gen=gen_t)
    b = refine_blocked(fill_t, BR, N, DIM, "l2sqr", q, ids)
    assert torch.equal(a, b) and torch.equal(torch.isinf(a), ids < 0)
    assert refine_blocked(None, BR, N, DIM, "l2sqr", q, ids) is None
    # and the searches agree
    by_fill = PQCodesIndex(idx.pq, idx.coarse, N, DIM, "l2sqr", fill=fill_t, block_rows=BR,
                           device="cpu")
    by_fill._codes, by_fill._codes_c, by_fill._perm, by_fill._inv = (
        idx._codes, idx._codes_c, idx._perm, idx._inv)
    for x, y in zip(idx.knn_batch(queries, 10, **SEARCH), by_fill.knn_batch(queries, 10, **SEARCH)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_npz_both_ways(dist, data, port_index, tmp_path):
    """The reference loads the port's checkpoint (row-major uint8 coarse
    codes) and searches it to the port's ids; the port reloads its own
    identically."""
    base, queries, _, _ = data
    idx = port_index(dist)
    path = str(tmp_path / "port.npz")
    idx.save(path)
    _, gen_j, _, gen_t = _sources(base)
    gd, gi = (a.numpy() for a in idx.knn_batch(queries, 10, **SEARCH))
    again = PQCodesIndex.load(path, row_gen=gen_t, device="cpu")
    ad, ai = (a.numpy() for a in again.knn_batch(queries, 10, **SEARCH))
    np.testing.assert_array_equal(ai, gi)
    np.testing.assert_array_equal(ad, gd)
    ref = JPQCodes.load(path, row_gen=gen_j)
    assert not ref._codes_c_is_t
    ed, ei = (np.asarray(a) for a in ref.knn_batch(queries, 10, interpret=True, **SEARCH))
    _agree(gi, gd, ei, ed)


def test_index_bytes_small(port_index):
    """Device bytes ~ (m/2 + cw4(mc/2) + 8) a row: far below the f32 row."""
    per_row = port_index("l2sqr").index_bytes() / N
    assert per_row < 0.3 * DIM * 4
