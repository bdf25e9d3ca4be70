"""IVFPQIndex (the codes-resident IVF-PQ tier) of the PyTorch port against
the JAX package's, on the CPU, and the row-addressable generator.

The reference builds, searches (interpret-mode K11 and K7) and saves each
index; the port loads the npz with a row source over the same numpy rows
and must return the reference's ids.  The reference selects the top-ef with
approx_min_k (exact on the CPU, ties in no fixed order), so the ids are held
to >= 99% of (query, rank) entries, and where they agree the exact distances
to rtol 1e-5.  Sizes are the reference test's (tests/test_pq_codes.py):
20,000 x 64, m = 32, nlist = 32; searched at n_probes 8, ef 160, qb 32,
chunk 8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.models import IVFPQIndex as JIVFPQ
from lab_1806_vec_db_tpu.models import ivf as jivf
from lab_1806_vec_db_tpu.models import ivfpq as jivfpq
from lab_1806_vec_db_tpu.models.pq_table import PQTable as JPQTable
from lab_1806_vec_db_tpu.ops import kmeans as JKM
from lab_1806_vec_db_tpu.utils.config import PQConfig as JPQConfig
from lab_1806_vec_db_tpu_torch.bench import synth
from lab_1806_vec_db_tpu_torch.models import IVFPQIndex, PQTable
from lab_1806_vec_db_tpu_torch.models import ivf as ivf_mod
from lab_1806_vec_db_tpu_torch.models import ivfpq as ivfpq_mod
from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

N, DIM, BR, NQ, NLIST = 20000, 64, 4096, 32, 32
SEARCH = dict(n_probes=8, ef=160, qb=32, chunk=8)


def _take_rows(params, key, row_ids):
    """The reference's row-addressable source over fixed rows (traceable)."""
    return params[0][row_ids]


@pytest.fixture(scope="module")
def data():
    """Spectrum-decay Gaussians clipped at 0 (the reference test's regime),
    made once with numpy, with exact f64 distances for both metrics."""
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


_REF, _PORT = {}, {}


@pytest.fixture(scope="module")
def ref_index(data, tmp_path_factory):
    """The reference's index per metric, built and searched once: (index,
    npz path, (dists, ids))."""
    def get(dist):
        if dist not in _REF:
            base, queries, _, _ = data
            fill_j, gen_j, _, _ = _sources(base)
            idx = JIVFPQ.build_from_fill(
                fill_j, N, DIM, dist, nlist=NLIST,
                pq_config=JPQConfig(n_bits=4, m=32, dist=dist, k_means_size=4000, rotate=True),
                sample_rows=4000, block_rows=BR, row_gen=gen_j)
            path = str(tmp_path_factory.mktemp("ivfpq") / f"ref_{dist}.npz")
            idx.save(path)
            out = tuple(np.asarray(a) for a in idx.knn_batch(queries, 10, interpret=True, **SEARCH))
            _REF[dist] = (idx, path, out)
        return _REF[dist]
    return get


@pytest.fixture(scope="module")
def port_index(data):
    """The port's own build per metric (row-generated encode), once."""
    def get(dist):
        if dist not in _PORT:
            _, _, fill_t, gen_t = _sources(data[0])
            _PORT[dist] = IVFPQIndex.build_from_fill(
                fill_t, N, DIM, dist, nlist=NLIST,
                pq_config=PQConfig(n_bits=4, m=32, dist=dist, k_means_size=4000, rotate=True),
                sample_rows=4000, block_rows=BR, row_gen=gen_t, device="cpu")
        return _PORT[dist]
    return get


def _agree(ids_a, d_a, ids_b, d_b, min_share=0.99):
    same = ids_a == ids_b
    assert same.mean() >= min_share, same.mean()
    np.testing.assert_allclose(d_a[same], d_b[same], rtol=1e-5)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_reference_checkpoint_searches_as_the_reference(dist, data, ref_index):
    base, queries, _, _ = data
    _, path, (ed, ei) = ref_index(dist)
    port = IVFPQIndex.load(path, row_gen=_sources(base)[3], device="cpu")
    gd, gi = (a.numpy() for a in port.knn_batch(queries, 10, **SEARCH))
    _agree(gi, gd, ei, ed)
    assert int(port.last_dropped) == 0


def test_layout_encode_matches_the_reference(data, ref_index):
    """Given the reference's assignment and PQ table, the port's layout and
    encode give the reference's lpad, slot_id, lens, ov_count and codes on
    every valid slot (both encodes).  The table is the reference index's
    codebooks without its rotation: the two packages' f32 rotation products
    round differently, which can flip a code at a near-tie."""
    base, _, _, _ = data
    ref, _, _ = ref_index("l2sqr")
    fill_j, gen_j, fill_t, gen_t = _sources(base)
    assign = np.asarray(JKM.find_nearest(jnp.asarray(base), jnp.asarray(ref.centroids), "l2sqr"))
    arrays, meta = ref.pq.state()
    arrays = {k: v for k, v in arrays.items() if k not in ("pq_rotation", "pq_center")}
    meta = {"pq": {**meta["pq"], "rotate": False}}
    want = jivfpq._layout_encode(fill_j, N, JPQTable.from_state(arrays, meta), assign, NLIST, 0,
                                 BR, transposed=True, row_gen=gen_j)
    pq = PQTable.from_state(arrays, meta, device="cpu")
    for kw in (dict(row_gen=gen_t), {}):
        lpad, main, ov, slot_id, lens, ov_count = ivfpq_mod._layout_encode(
            fill_t, N, pq, assign, NLIST, 0, BR, device="cpu", **kw)
        assert (lpad, ov_count) == (want[0], want[5]) and ov_count > 0
        np.testing.assert_array_equal(slot_id, want[3])
        np.testing.assert_array_equal(lens, want[4])
        main_ref = np.asarray(want[1]).view(np.uint8).T
        rows = np.arange(main_ref.shape[0])
        valid = (rows % lpad) < lens[rows // lpad]
        np.testing.assert_array_equal(main.numpy()[valid, :16], main_ref[valid])
        np.testing.assert_array_equal(ov.numpy()[:ov_count, :16],
                                      np.asarray(want[2]).view(np.uint8).T[:ov_count])


def test_slot_ordered_encode_equals_scatter_and_rows_found_once(data, port_index):
    """The row-generated (slot-ordered) encode and the fill-block scatter
    give the same codes on valid slots; every row sits in exactly one valid
    slot (its list's first lens[l] slots or the overflow segment)."""
    base, _, _, _ = data
    idx = port_index("l2sqr")
    _, _, fill_t, _ = _sources(base)
    assign = ivf_mod._assign(torch.from_numpy(base), torch.from_numpy(idx.centroids), "l2sqr")
    lpad, main, ov, slot_id, lens, ov_count = ivfpq_mod._layout_encode(
        fill_t, N, idx.pq, assign, NLIST, 0, BR, device="cpu")
    assert lpad == idx.lpad and ov_count == idx.ov_count
    rows = np.arange(main.shape[0])
    valid = (rows % lpad) < lens[rows // lpad]
    np.testing.assert_array_equal(main.numpy()[valid], idx._codes.numpy()[valid])
    np.testing.assert_array_equal(ov.numpy()[:ov_count], idx._codes_ov.numpy()[:ov_count])
    sid = idx._slot_id.numpy()
    kl = idx.nlist * idx.lpad
    seen = np.concatenate([sid[l * lpad : l * lpad + idx.lens[l]] for l in range(idx.nlist)]
                          + [sid[kl : kl + idx.ov_count]])
    assert sorted(seen.tolist()) == list(range(N))


def test_port_build_recall_and_exact_distances(data, port_index):
    base, queries, exact, gt = data
    d, i = (a.numpy() for a in port_index("l2sqr").knn_batch(queries, 10, **SEARCH))
    recall = np.mean([len(set(gt["l2sqr"][q]) & set(i[q])) / 10 for q in range(NQ)])
    assert recall >= 0.85, recall
    true = exact["l2sqr"][np.arange(NQ)[:, None], i]
    assert (i >= 0).all() and np.all(np.abs(d - true) <= 1e-3 + 1e-4 * np.abs(true))
    assert np.all(np.diff(d, axis=1) >= -1e-6)


def test_cosine_and_npz_both_ways(data, port_index, tmp_path):
    """Cosine end to end (recall >= 0.8, the reference test's gate); the
    port reloads its checkpoint identically, and the reference loads it
    (row-major uint8 codes) and searches it to the port's ids."""
    base, queries, _, gt = data
    idx = port_index("cosine")
    gd, gi = (a.numpy() for a in idx.knn_batch(queries, 10, **SEARCH))
    assert np.mean([len(set(gt["cosine"][q]) & set(gi[q])) / 10 for q in range(NQ)]) >= 0.8
    path = str(tmp_path / "port.npz")
    idx.save(path)
    _, gen_j, _, gen_t = _sources(base)
    again = IVFPQIndex.load(path, row_gen=gen_t, device="cpu")
    ad, ai = (a.numpy() for a in again.knn_batch(queries, 10, **SEARCH))
    np.testing.assert_array_equal(ai, gi)
    np.testing.assert_array_equal(ad, gd)
    ref = JIVFPQ.load(path, row_gen=gen_j)
    assert not ref._codes_is_t
    ed, ei = (np.asarray(a) for a in ref.knn_batch(queries, 10, interpret=True, **SEARCH))
    _agree(gi, gd, ei, ed)


@pytest.mark.parametrize("q", [0.9, 0.95])
def test_sorted_layout_caps_at_the_quantile_the_reference_does(q):
    """`_sorted_layout(cap_quantile=q)` caps where the reference's does; the
    default stays the IVF's 0.9, read when called."""
    rng = np.random.default_rng(3)
    assign = rng.choice(48, 30000, p=rng.dirichlet(np.ones(48) * 2)).astype(np.int32)
    posting, counts = ivf_mod._build_posting(assign, 48)
    want = jivf._sorted_layout(posting, counts, 48, cap_quantile=q)
    got = ivf_mod._sorted_layout(posting, counts, 48, cap_quantile=q)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    assert ivf_mod._sorted_layout(posting, counts, 48)[0] == jivf._sorted_layout(posting, counts, 48)[0]


def test_make_fill_rows_depend_on_the_id_alone():
    """`fill(r0, n)` is `fill.row_gen(arange(r0, r0 + n))`; a row is the same
    whatever block or id set it is drawn in; seeds differ."""
    fill, _ = synth.make_fill(0, 48, "cpu")
    blk = fill(1000, 300)
    assert blk.shape == (300, 48) and blk.dtype == torch.float32 and (blk >= 0).all()
    assert torch.equal(blk, fill.row_gen(torch.arange(1000, 1300)))
    assert torch.equal(blk[50:80], fill(1050, 30))
    assert torch.equal(fill(0, 70000)[1000:1300], blk)
    ids = torch.tensor([1299, 5, 1000])
    assert torch.equal(fill.row_gen(ids)[[0, 2]], blk[[299, 0]])
    assert not torch.equal(synth.make_fill(1, 48, "cpu")[0](1000, 300), blk)
