"""The native single-query engine of the PyTorch port (models/native.py).

The port builds its own copy of the engine, `csrc/hnsw_native.cpp` (the
code of `native/hnsw_native.cpp` under a port header), with g++ into
`lab_1806_vec_db_tpu_torch/_build/` (the JAX package's committed `.so` is
not used).  Checks, on the bundled gist_1000 slice:
- the copy's code is byte-identical to the reference's source, and the
  package data ships it;
- native Flat equals the port's exact scan: ids equal, distances within
  rtol 1e-4 / atol 1e-4 (the engine sums in another order);
- native HNSW passes the reference's `test_native_hnsw_oracle` (the top-5 of
  a row equals the exact top-5 at ef 80), and on one graph (the port's,
  loaded into the JAX package) returns the reference engine's ids, with
  distances within rtol 1e-5 (two `-march=native` builds round apart);
- the single-query entry points (`FlatIndex.knn`, `HNSWIndex.knn_with_ef`,
  `VecDB.search`) go through it on a host store, and never on a CUDA store
  (one query is a batch of one on the card there);
- a failed build raises with the compiler's output.
"""

import os
import tomllib

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.models import HNSWIndex as JHNSWIndex
from lab_1806_vec_db_tpu.models import native as jnative
from lab_1806_vec_db_tpu_torch import VecDB
from lab_1806_vec_db_tpu_torch.models import FlatIndex, HNSWIndex, native
from lab_1806_vec_db_tpu_torch.utils.config import HNSWConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_engine_source_is_the_reference_engine():
    def code(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("//\n// Behavior parity"):]

    assert native.SOURCE == os.path.join(REPO, "lab_1806_vec_db_tpu_torch", "csrc", "hnsw_native.cpp")
    assert code(native.SOURCE) == code(os.path.join(REPO, "native", "hnsw_native.cpp"))
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]["lab_1806_vec_db_tpu_torch"]
    assert "csrc/*.cpp" in data


def test_engine_is_built_under_the_port():
    mod = native.module()
    assert mod.__name__ == "_vecdb_native"
    assert os.path.dirname(mod.__file__) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("lab_1806_vec_db_tpu_torch", "_build"))
    assert native.module() is mod


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_native_flat_equals_exact_scan(dist, gist_1000):
    vecs = gist_1000[:600, :64].copy()
    flat = FlatIndex.from_numpy(vecs, dist, device="cpu")
    d, i = flat.knn_batch(gist_1000[600:640, :64], 10, exact=True)
    for r, q in enumerate(gist_1000[600:640, :64]):
        ids, dists = native.flat_knn_single(flat.store, q, 10)
        assert ids == i[r].tolist()
        np.testing.assert_allclose(dists, d[r], rtol=1e-4, atol=1e-4)
        assert [p.index for p in flat.knn(q, 10)] == ids


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_native_hnsw_oracle(dist, gist_1000):
    vecs = gist_1000[:500, :12].copy()
    index = HNSWIndex.build(vecs, dist, HNSWConfig(), seed=3, device="cpu")
    _, exact = FlatIndex.from_numpy(vecs, dist, device="cpu").knn_batch(vecs[[5, 99, 250]], 5,
                                                                      exact=True)
    for r, qi in enumerate((5, 99, 250)):
        ids, dists = native.hnsw_knn_single(index, vecs[qi], 5, 80)
        assert ids == exact[r].tolist()
        assert dists == sorted(dists)
        assert [p.index for p in index.knn_with_ef(vecs[qi], 5, 80)] == ids


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_native_hnsw_equals_reference_engine_on_one_graph(dist, gist_1000):
    """The port's engine and the reference's committed `.so` on one graph:
    the ids equal exactly, the distances within rtol 1e-5 / atol 1e-6.  Both
    are the same C++ built with `-march=native`, but for different targets
    (the port's on the host running the tests, the reference's once on
    another), and two targets' vector code rounds the sums apart in the last
    bits (up to ~2e-7 absolute, ~5e-6 relative on this graph)."""
    assert jnative.available()
    vecs = gist_1000[:800, :32].copy()
    index = HNSWIndex.build(vecs, dist, HNSWConfig(M=8, ef_construction=60), seed=7, device="cpu")
    assert index.enter_level >= 1  # the upper levels take part
    arrays, meta = index.state()
    jindex = JHNSWIndex.from_state(arrays, meta)
    for q in gist_1000[800:840, :32]:
        for ef in (12, 48):
            ids, dists = native.hnsw_knn_single(index, q, 10, ef)
            ref_ids, ref_dists = jnative.hnsw_knn_single(jindex, q, 10, ef)
            assert ids == ref_ids
            np.testing.assert_allclose(dists, ref_dists, rtol=1e-5, atol=1e-6)


def test_beam_recall_curve_matches_native(gist_1000):
    """The reference's test_beam_recall_curve_matches_sequential_best_first
    on the port: its CPU graph route (the lock-step beam) against the native
    serial best-first search on the same graph."""
    vecs, queries = gist_1000[:800, :32].copy(), gist_1000[800:900, :32].copy()
    index = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(M=8), seed=7, device="cpu")
    _, gt = FlatIndex.from_numpy(vecs, "l2sqr", device="cpu").knn_batch(queries, 10, exact=True)

    def recall(ids):
        return np.mean([len(set(gt[i].tolist()) & set(list(ids[i])[:10])) / 10 for i in range(len(gt))])

    for ef in (12, 24, 48):
        r_beam = recall(index.knn_with_ef_batch(queries, 10, ef)[1])
        r_nat = recall([native.hnsw_knn_single(index, q, 10, ef)[0] for q in queries])
        assert r_beam >= r_nat - 0.03, (ef, r_beam, r_nat)
        assert abs(r_beam - r_nat) <= 0.08, (ef, r_beam, r_nat)


def test_vecdb_search_goes_native(tmp_path, gist_1000, monkeypatch):
    vecs = gist_1000[:400, :24].copy()
    calls = []
    real_flat, real_hnsw = native.flat_knn_single, native.hnsw_knn_single
    monkeypatch.setattr(native, "flat_knn_single", lambda *a: calls.append("flat") or real_flat(*a))
    monkeypatch.setattr(native, "hnsw_knn_single", lambda *a: calls.append("hnsw") or real_hnsw(*a))
    with VecDB(str(tmp_path / "db"), device="cpu", seed=1) as db:
        db.create_table_if_not_exists("t", 24, "l2sqr")
        db.batch_add("t", vecs, [{"i": str(j)} for j in range(len(vecs))])
        hit = db.search("t", vecs[17], 3)
        assert hit[0][0] == {"i": "17"} and calls == ["flat"]
        db.build_hnsw_index("t")
        hit = db.search("t", vecs[17], 3, ef=40)
        assert hit[0][0] == {"i": "17"} and calls == ["flat", "hnsw"]
        with pytest.raises(ValueError):
            db.search("t", vecs[17, :10], 3, ef=40)  # the engine never reads past the query


def test_single_query_on_a_cuda_store_stays_on_the_card(gist_1000, monkeypatch):
    """A CUDA store's rows live on the card, so one query is a batch of one
    there and never the host engine.  Routing only: this host has no card,
    so the stores' device is relabelled and the device calls recorded."""
    vecs = gist_1000[:300, :16].copy()
    flat = FlatIndex.from_numpy(vecs, "l2sqr", device="cpu")
    index = HNSWIndex.build(vecs, "l2sqr", HNSWConfig(M=8), seed=2, device="cpu")
    d, i = flat.knn_batch(vecs[:1], 3, exact=True)
    calls = []
    monkeypatch.setattr(native, "flat_knn_single", lambda *a: pytest.fail("host engine on a CUDA store"))
    monkeypatch.setattr(native, "hnsw_knn_single", lambda *a: pytest.fail("host engine on a CUDA store"))
    monkeypatch.setattr(FlatIndex, "_knn_device", lambda self, q, k, exact=None, rerank_depth=None:
                        calls.append(("flat", exact)) or (torch.from_numpy(d), torch.from_numpy(i)))
    monkeypatch.setattr(HNSWIndex, "knn_with_ef_batch", lambda self, q, k, ef, route="auto":
                        calls.append(("hnsw", ef)) or (d, i))
    for store in (flat.store, index.store):
        monkeypatch.setattr(store, "torch_device", torch.device("cuda"))
    assert [p.index for p in flat.knn(vecs[0], 3)] == i[0].tolist()
    assert [p.index for p in index.knn_with_ef(vecs[0], 3, 40)] == i[0].tolist()
    assert calls == [("flat", True), ("hnsw", 40)]


def test_empty_hnsw_answers_nothing():
    assert HNSWIndex(8, "l2sqr", device="cpu").knn_with_ef(np.zeros(8, np.float32), 3, 10) == []


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="native engine build failed") as err:
        native._build(native._library_path())
    assert "broken.cpp" in str(err.value)
    assert os.listdir(tmp_path / "build") == []  # no half-written library left behind
