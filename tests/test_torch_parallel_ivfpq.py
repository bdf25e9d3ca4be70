"""The sharded IVF-PQ of the PyTorch port (parallel/sharded.py) against the
JAX package's, on the CPU, then the harness's mesh path
(`config/real1000_mesh8_*.toml` through the port's `run_bench`) and the
dry run of every sharded path.

The JAX package's mesh is the conftest's 8-device host mesh (its Pallas
kernels run in interpret mode, as its own tests run them); the port's is
`make_mesh(n, device="cpu")`, n shards on the CPU, where the kernel
wrappers run their plain versions."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.parallel import sharded as JS
from lab_1806_vec_db_tpu.utils.config import PQConfig as JPQConfig
from lab_1806_vec_db_tpu_torch.bench import harness
from lab_1806_vec_db_tpu_torch.parallel import dryrun_multichip
from lab_1806_vec_db_tpu_torch.parallel import sharded as S
from lab_1806_vec_db_tpu_torch.utils.config import BenchConfig, PQConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

ROOT = os.path.join(os.path.dirname(__file__), "..")


def cpu_mesh(n):
    return S.make_mesh(n, device="cpu")


def exact_ids(base, q, k):
    return np.argsort(((base[None] - q[:, None]) ** 2).sum(-1), axis=1, kind="stable")[:, :k]


def _recall(ids, gt):
    return np.mean([len(set(ids[r]) & set(gt[r])) / gt.shape[1] for r in range(len(gt))])


def _ivfpq_data(gist_1000, n=800, dim=48):
    return np.ascontiguousarray(gist_1000[:n, :dim]), np.ascontiguousarray(gist_1000[900:910, :dim])


def _jax_row_gen(base):
    base_j = jnp.asarray(base)
    import jax

    return (lambda params, key, row_ids: base_j[jnp.clip(row_ids, 0, len(base) - 1)], (),
            jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_ivfpq(gist_1000, tmp_path_factory):
    """The JAX package's sharded IVF-PQ (the reference test's fixture:
    800 x 48, nlist 8, m 16, 8 shards), saved."""
    base, q = _ivfpq_data(gist_1000)
    idx = JS.ShardedIVFPQIndex(JS.make_mesh(), base, "l2sqr", nlist=8,
                               pq_config=JPQConfig(n_bits=4, m=16, dist="l2sqr", k_means_size=400),
                               sample_rows=400, block_rows=256, row_gen=_jax_row_gen(base))
    path = str(tmp_path_factory.mktemp("sivfpq") / "jax.npz")
    idx.save(path)
    return idx, base, q, path


def _agree_within_ties(d, i, dj, ij):
    """Share of (query, rank) entries whose id is in the other's row, or
    whose distance ties the other's at that rank."""
    ok = [(i[r, c] in set(ij[r].tolist())) or np.isclose(d[r, c], dj[r, c], rtol=1e-5)
          for r in range(len(i)) for c in range(i.shape[1])]
    return float(np.mean(ok))


@pytest.mark.parametrize("size", [8, 4])
def test_sharded_ivfpq_all_probes_is_exact(jax_ivfpq, size):
    """Loaded from the JAX package's checkpoint with external_base (the
    shards re-encoded on the port's mesh): every list probed with a dense
    overflow scan and the exact refine gives the exact kNN, distances exact
    f32 and ascending, ids as the JAX search's."""
    jidx, base, q, path = jax_ivfpq
    idx = S.ShardedIVFPQIndex.load(path, cpu_mesh(size), external_base=base)
    d, i = idx.knn_batch(q, 5, n_probes=idx.nlist, ef=400, chunk=1)
    np.testing.assert_array_equal(i, exact_ids(base, q, 5))
    for r in range(len(q)):
        np.testing.assert_allclose(d[r], ((base[i[r]] - q[r]) ** 2).sum(-1), rtol=1e-4, atol=1e-5)
        assert np.all(np.diff(d[r]) >= -1e-6)
    _, ij = jidx.knn_batch(q, 5, n_probes=jidx.nlist, ef=400, chunk=1, interpret=True)
    np.testing.assert_array_equal(i, np.asarray(ij))


def test_sharded_ivfpq_recall_and_serde(jax_ivfpq, tmp_path):
    """At 6 of 8 probes the port agrees with the JAX search as sets within
    ties at >= 99% of (query, rank), with useful recall; the port's own
    checkpoint re-places onto 4 shards and still searches exactly."""
    jidx, base, q, path = jax_ivfpq
    idx = S.ShardedIVFPQIndex.load(path, cpu_mesh(8), external_base=base)
    assert (idx.lpad, idx.ov_cap) == (jidx.lpad, jidx.ov_cap)
    d, i = idx.knn_batch(q, 5, n_probes=6, ef=128)
    dj, ij = (np.asarray(a) for a in jidx.knn_batch(q, 5, n_probes=6, ef=128, interpret=True))
    assert _agree_within_ties(d, i, dj, ij) >= 0.99
    assert _recall(i, exact_ids(base, q, 5)) >= 0.6
    p = str(tmp_path / "port.npz")
    idx.save(p)
    idx4 = S.ShardedIVFPQIndex.load(p, cpu_mesh(4), external_base=base)
    _, i4 = idx4.knn_batch(q, 5, n_probes=idx4.nlist, ef=400, chunk=1)
    np.testing.assert_array_equal(i4, exact_ids(base, q, 5))


def test_sharded_ivfpq_built_by_the_port(gist_1000):
    """The port's own build (global training, per-shard layouts at a common
    lpad / overflow capacity) and from_fill with a row source: exact at
    all probes, and the two builds give the same ids."""
    base, q = _ivfpq_data(gist_1000)
    cfg = PQConfig(n_bits=4, m=16, dist="l2sqr", k_means_size=400)
    kw = dict(nlist=8, pq_config=cfg, sample_rows=400, block_rows=256)
    idx = S.ShardedIVFPQIndex(cpu_mesh(4), base, "l2sqr", **kw)
    bt = torch.from_numpy(base)
    idx2 = S.ShardedIVFPQIndex.from_fill(cpu_mesh(4), lambda r0, n: bt[r0 : r0 + n], len(base),
                                         base.shape[1], "l2sqr", row_gen=lambda ids: bt[ids.long()],
                                         **kw)
    d, i = idx.knn_batch(q, 5, n_probes=8, ef=400, chunk=1)
    np.testing.assert_array_equal(i, exact_ids(base, q, 5))
    np.testing.assert_array_equal(idx2.knn_batch(q, 5, n_probes=8, ef=400, chunk=1)[1], i)
    for sub in idx._subs:
        assert sub.lpad == idx.lpad and sub._codes_ov.shape[0] == idx.ov_cap
    assert idx.index_bytes() > 0


def test_sharded_ivfpq_auto_chunk_is_a_kernel_chunk(gist_1000):
    """390 rows in 2 lists on 1 shard: 195 rows a list, so the reference's
    auto chunk min(16, 195 // 16) is 12, which no K11 instantiation (nor
    the reference's lpad % chunk check) takes; the port rounds it down to
    8, and a shard's search refuses 12 itself."""
    base, q = _ivfpq_data(gist_1000, n=390, dim=16)
    idx = S.ShardedIVFPQIndex(cpu_mesh(1), base, "l2sqr", nlist=2, sample_rows=390, block_rows=128,
                              pq_config=PQConfig(n_bits=4, m=8, dist="l2sqr", k_means_size=390))
    d, i = idx.knn_batch(q, 5, n_probes=2, ef=390)
    d8, i8 = idx.knn_batch(q, 5, n_probes=2, ef=390, chunk=8)
    np.testing.assert_array_equal(i, i8)
    np.testing.assert_array_equal(d, d8)
    assert (i >= 0).all()
    qt = torch.from_numpy(q)
    with pytest.raises(ValueError, match="chunk"):
        idx._subs[0].search_candidates(qt, *idx.pq.create_lookup(qt), 5, 2, 390, 32, 12)


# ---- the harness's mesh path and the dry run ----


MESH_SWEEP_QUERIES = 100  # HNSW and IVF-PQ: the first 100 of the 1,000 queries
MESH_SWEEP_HNSW_DIM = 96  # HNSW: the first 96 lanes of the 960-d rows


@pytest.mark.parametrize("algo", ["flat", "hnsw", "ivfpq"])
def test_harness_mesh_sweep_end_to_end(algo, tmp_path):
    """config/real1000_mesh8_{algo}.toml through the port's run_bench on an
    8-shard CPU mesh (the results file redirected into tmp_path): Flat's
    recall is exactly 1, HNSW's and IVF-PQ's useful; with an index cache a
    second run loads the sharded checkpoint.  Flat runs the TOML as it is.
    IVF-PQ runs the first 100 of the 1,000 queries with their ground truth
    (every list of every shard is still scanned, m = 320 on 960 lanes).
    HNSW runs the first 100 queries on a copy of the rows cut to their
    first 96 lanes, written to tmp_path, with the ground truth recomputed by
    the exact scan (the same M, ef_construction, ef list and 8 shards): the
    CPU beam gathers (B, 128, dim) rows a step and shard."""
    from lab_1806_vec_db_tpu_torch.utils.candidates import GroundTruth

    root = os.path.abspath(ROOT)
    with open(os.path.join(root, "config", f"real1000_mesh8_{algo}.toml")) as f:
        text = f.read().replace('"data/', f'"{root}/data/')
    text = re.sub(r'(?m)^bench_output = .*$', f'bench_output = "{tmp_path / "results.toml"}"', text)
    text = re.sub(r'(?m)^index_cache = .*$', f'index_cache = "{tmp_path / "index.npz"}"', text)
    if algo != "flat":
        gt = GroundTruth.load(os.path.join(root, "data", "cli", "gnd.npz"))
        rows = gt.rows[:MESH_SWEEP_QUERIES]
        if algo == "hnsw":
            dim, cut = MESH_SWEEP_HNSW_DIM, {}
            for name in ("gist_1000", "gist_test"):
                x = np.fromfile(os.path.join(root, "data", f"{name}.bin"), np.float32).reshape(-1, 960)
                cut[name] = np.ascontiguousarray(x[:, :dim])
                cut[name].tofile(tmp_path / f"{name}.bin")
                text = text.replace(f"{root}/data/{name}.bin", str(tmp_path / f"{name}.bin"))
            text = re.sub(r"(?m)^dim = 960$", f"dim = {dim}", text)
            rows = exact_ids(cut["gist_1000"], cut["gist_test"][:MESH_SWEEP_QUERIES], gt.k)
        GroundTruth(rows).save(tmp_path / "gnd100.npz")
        text = re.sub(r'(?m)^gnd_path = .*$', f'gnd_path = "{tmp_path / "gnd100.npz"}"', text)
        text = text.replace("[test]\n", f"[test]\nlimit = {MESH_SWEEP_QUERIES}\n")
    (tmp_path / "cfg.toml").write_text(text)
    cfg = BenchConfig.load_from_toml_file(tmp_path / "cfg.toml")
    assert cfg.mesh == 8
    if algo == "hnsw":
        assert cfg.base.dim == cfg.test.dim == MESH_SWEEP_HNSW_DIM
    res = harness.run_bench(cfg, device="cpu")
    floor = {"flat": 1.0, "hnsw": 0.9, "ivfpq": 0.5}[algo]
    assert min(res["recall"]) >= floor and res["build_seconds"] is not None
    assert (tmp_path / "index.npz").exists() and (tmp_path / "results.toml").exists()
    res2 = harness.run_bench(cfg, device="cpu")
    assert res2["build_seconds"] is None
    if algo != "hnsw":  # the HNSW cache holds the same graphs
        assert res2["recall"] == res["recall"]


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_graft_entry_compiles(n_shards):
    """dryrun_multichip, the counterpart of __graft_entry__.py's: every
    sharded path on tiny shapes against its exact oracle."""
    dryrun_multichip(n_shards, "cpu")
