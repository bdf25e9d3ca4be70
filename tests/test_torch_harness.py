"""The bench harness of the PyTorch port (bench/harness.py) on the CPU,
against the JAX package's harness.

- an end-to-end sweep on the bundled gist_1000 slice (800 base rows, 60
  queries, the first 64 lanes) for Flat, HNSW, IVF and Flat+PQ, merged into
  one results TOML with its .html: Flat's recall is exactly 1, the others'
  rise with ef / n_probes to within 0.05 of the reference's sweep on the
  same TOML;
- the chained timing mode flags its rows; an HNSW table's chained step is
  the auto routes' Flat two-stage plan on the card;
- the results TOML and the index / PQ caches written by either package load
  in the other (the same index: equal ids from both);
- the mesh path (`mesh = N`) runs on the sharded indexes over a mesh on
  the given device, and raises without a card on the default device
  (tests/test_torch_parallel.py holds it against the JAX package).
"""

import os

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.bench import harness as jharness
from lab_1806_vec_db_tpu.utils.config import BenchConfig as JBenchConfig
from lab_1806_vec_db_tpu_torch.bench import harness
from lab_1806_vec_db_tpu_torch.cli import gen_gnd
from lab_1806_vec_db_tpu_torch.models import HNSWIndex, IVFIndex
from lab_1806_vec_db_tpu_torch.models import flat as flat_mod
from lab_1806_vec_db_tpu_torch.utils import io
from lab_1806_vec_db_tpu_torch.utils.config import BenchConfig, HNSWConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

DIM = 64

ALGOS = {
    "Flat": ("[ef]\nlist = [10]\n\n[algorithm.Flat]\n", ""),
    "HNSW": ("[ef]\nlist = [10, 40]\n\n[algorithm.HNSW]\nM = 8\nef_construction = 60\n", ""),
    "IVF": ("[ef]\nlist = [2, 8]\n\n[algorithm.IVF]\nk = 16\nk_means_size = 400\n"
            "k_means_max_iter = 10\n", ""),
    "Flat+PQ": ("[ef]\nlist = [20, 100]\n\n[algorithm.Flat]\n",
                "[PQ]\nn_bits = 4\nm = 16\nk_means_size = 400\nk_means_max_iter = 10\n"),
}


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory, gist_1000):
    d = tmp_path_factory.mktemp("bench")
    io.save_raw(d / "base.bin", gist_1000[:800, :DIM])
    io.save_raw(d / "test.bin", gist_1000[800:860, :DIM])
    gen_gnd.main(["-d", str(DIM), "--base", str(d / "base.bin"), "--test", str(d / "test.bin"),
                  "-o", str(d / "gnd.npz"), "--device", "cpu"])
    return d


def _toml(d, algo, out, cache="", pq_cache="", extra=""):
    body, pq = ALGOS[algo]
    if pq and pq_cache:
        pq = pq.replace("[PQ]\n", f'[PQ]\npq_cache = "{pq_cache}"\n')
    path = d / f"{algo.replace('+', '_')}_{os.path.basename(out)}.toml"
    path.write_text(
        f'label = "{algo}"\ndist = "L2Sqr"\ngnd_path = "{d / "gnd.npz"}"\n'
        f'index_cache = "{cache}"\nbench_output = "{out}"\n{extra}\n{body}\n{pq}\n'
        f'[base]\ndim = {DIM}\ndata_path = "{d / "base.bin"}"\n\n'
        f'[test]\ndim = {DIM}\ndata_path = "{d / "test.bin"}"\n')
    return path


@pytest.mark.parametrize("algo", list(ALGOS))
def test_sweep_end_to_end(bench_dir, algo):
    out = bench_dir / f"results_{algo.replace('+', '_')}.toml"
    cfg = BenchConfig.load_from_toml_file(_toml(bench_dir, algo, out))
    res = harness.run_bench(cfg, device="cpu")
    assert res["ef"] == cfg.ef and len(res["recall"]) == len(cfg.ef)
    assert all(t > 0 for t in res["search_time"]) and res["index_device_bytes"] > 0
    assert res["build_seconds"] is not None
    if algo == "Flat":
        assert res["recall"] == [1.0]
    else:
        assert res["recall"][-1] >= res["recall"][0]
    rl = harness.ResultList.load(str(out))
    assert list(rl.results) == [algo] and "chained" not in rl.results[algo]
    assert rl.results[algo]["recall"] == res["recall"]
    assert os.path.exists(out.with_suffix(".html"))
    assert "<svg" in out.with_suffix(".html").read_text()
    jres = jharness.run_bench(JBenchConfig.load_from_toml_file(_toml(bench_dir, algo, out)))
    assert np.allclose(res["recall"], jres["recall"], atol=0.05), (res["recall"], jres["recall"])


@pytest.mark.parametrize("algo", ["Flat", "IVF"])
def test_chained_rows_are_flagged(bench_dir, algo):
    out = bench_dir / f"chained_{algo}.toml"
    cfg = BenchConfig.load_from_toml_file(_toml(bench_dir, algo, out, extra="chained = true"))
    assert cfg.chained
    res = harness.run_bench(cfg, device="cpu")
    assert res["chained"] and all(m >= t for m, t in zip(res["search_time_median"], res["search_time"]))
    rl = harness.ResultList.load(str(out))
    assert rl.results[algo]["chained"] is True
    if algo == "Flat":
        assert res["recall"] == [1.0]
    # a configuration without a device step falls back to the wall clock
    cfg = BenchConfig.load_from_toml_file(_toml(bench_dir, "HNSW", out, extra="chained = true"))
    assert not harness.run_bench(cfg, device="cpu")["chained"]
    assert "chained" not in harness.ResultList.load(str(out)).results["HNSW"]


@pytest.mark.parametrize("route", ["scan", "mirror"])
def test_hnsw_chained_step_is_the_auto_route_on_the_card(gist_1000, monkeypatch, route):
    """With and without a PQ table, the chained step of an HNSW table on the
    card is what `knn_with_ef_batch` ("scan") and `knn_pq_batch` ("mirror")
    run there: on a CPU store with the on-card check patched, the same ids."""
    monkeypatch.setattr(flat_mod, "_EXACT_BELOW", 0)  # the two-stage plan, not the exact scan
    monkeypatch.setattr(harness, "_on_card", lambda index: True)
    base, queries = gist_1000[:800, :DIM], gist_1000[800:840, :DIM]
    index = HNSWIndex.build(base, "l2sqr", HNSWConfig(M=8, ef_construction=40), seed=1, device="cpu")
    pq = object() if route == "mirror" else None  # neither route reads the table
    _, ids = harness._device_step(index, pq, 10)(torch.from_numpy(queries), 40)
    if route == "scan":
        _, expect = index.knn_with_ef_batch(queries, 10, 40, route="scan")
    else:
        _, expect = index.knn_pq_batch(queries, 10, 40, pq, route="mirror")
    np.testing.assert_array_equal(ids.numpy(), expect)


def test_result_lists_interchange(tmp_path):
    port_p, ref_p = str(tmp_path / "port.toml"), str(tmp_path / "ref.toml")
    rl = harness.ResultList("port title")
    rl.update("A", [10, 20], [0.5, 0.25], [0.9, 0.95], search_time_median=[0.6, 0.3],
              build_seconds=1.234, index_device_bytes=4096, chained=True)
    rl.save(port_p)
    jrl = jharness.ResultList.load(port_p)  # the reference reads the port's file
    assert jrl.title == "port title" and jrl.results["A"]["chained"] is True
    assert jrl.results["A"]["search_time_median"] == [0.6, 0.3]
    jrl.update("B", [5], [1.0], [0.8])
    jrl.save(port_p)  # ... and merges into it
    back = harness.ResultList.load(port_p)
    assert list(back.results) == ["A", "B"] and back.results["A"] == rl.results["A"]

    jrl2 = jharness.ResultList("ref title")
    jrl2.update("C", [1], [2.0], [0.5], build_seconds=3.0, index_device_bytes=8)
    jrl2.save(ref_p)
    prl = harness.ResultList.load(ref_p)  # the port reads the reference's file
    assert prl.results["C"]["build_seconds"] == 3.0 and "chained" not in prl.results["C"]
    prl.update("D", [2], [1.0], [0.7], chained=True)
    prl.save(ref_p)  # ... and merges into it
    assert list(jharness.ResultList.load(ref_p).results) == ["C", "D"]
    with open(ref_p) as f:
        ref_text = f.read()
    prl.save(str(tmp_path / "again.toml"))  # stable round trip
    with open(tmp_path / "again.toml") as f:
        assert f.read() == ref_text
    prl.plot_html(str(tmp_path / "plot.html"))
    assert "polyline" in (tmp_path / "plot.html").read_text()
    harness.ResultList().plot_html(str(tmp_path / "empty.html"))
    assert "No results" in (tmp_path / "empty.html").read_text()


@pytest.mark.parametrize("algo", ["HNSW", "IVF"])
def test_index_caches_interchange(bench_dir, algo, tmp_path):
    base = io.load_raw(bench_dir / "base.bin", DIM)
    test = io.load_raw(bench_dir / "test.bin", DIM)
    port_cache, ref_cache = tmp_path / "port.npz", tmp_path / "ref.npz"
    cfg = BenchConfig.load_from_toml_file(_toml(bench_dir, algo, tmp_path / "r.toml", str(port_cache)))
    index, build_s = harness.load_or_build_index(cfg, base, device="cpu")
    assert build_s is not None and port_cache.exists()
    jindex, jbuild_s = jharness.load_or_build_index(JBenchConfig.load_from_toml_file(
        _toml(bench_dir, algo, tmp_path / "r.toml", str(port_cache))), base)
    assert jbuild_s is None  # loaded the port's cache
    jcfg = JBenchConfig.load_from_toml_file(_toml(bench_dir, algo, tmp_path / "r.toml", str(ref_cache)))
    jharness.load_or_build_index(jcfg, base)
    cfg2 = BenchConfig.load_from_toml_file(_toml(bench_dir, algo, tmp_path / "r.toml", str(ref_cache)))
    index2, build2 = harness.load_or_build_index(cfg2, base, device="cpu")
    assert build2 is None and isinstance(index2, HNSWIndex if algo == "HNSW" else IVFIndex)
    if algo == "HNSW":  # the reference's reload of the port's cache is the same graph
        np.testing.assert_array_equal(index.knn_with_ef_batch(test, 10, 40)[1],
                                      jindex.knn_with_ef_batch(test, 10, 40, route="graph")[1])


def test_pq_cache_interchange(bench_dir, tmp_path):
    base = io.load_raw(bench_dir / "base.bin", DIM)
    cache = tmp_path / "pq.npz"
    cfg = BenchConfig.load_from_toml_file(
        _toml(bench_dir, "Flat+PQ", tmp_path / "r.toml", pq_cache=str(cache)))
    pq, train_s = harness.load_or_build_pq(cfg, base, device="cpu")
    assert train_s is not None and cache.exists()
    jpq, jtrain_s = jharness.load_or_build_pq(JBenchConfig.load_from_toml_file(
        _toml(bench_dir, "Flat+PQ", tmp_path / "r.toml", pq_cache=str(cache))), base)
    assert jtrain_s is None
    np.testing.assert_array_equal(np.asarray(jpq.codebooks), pq.codebooks)
    np.testing.assert_array_equal(np.asarray(jpq.codes), pq.codes)
    pq2, t2 = harness.load_or_build_pq(cfg, base, device="cpu")
    assert t2 is None


def test_mesh_path_raises(bench_dir, tmp_path, monkeypatch):
    """`mesh = 4` on the default device raises without a card (no move to
    the CPU), and on device="cpu" runs the sharded exact scan (recall 1)."""
    import torch

    cfg = BenchConfig.load_from_toml_file(_toml(bench_dir, "Flat", tmp_path / "r.toml", extra="mesh = 4"))
    assert cfg.mesh == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        harness.run_bench(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        harness.load_or_build_sharded(cfg, np.zeros((4, DIM), np.float32))
    res = harness.run_bench(cfg, device="cpu")
    assert res["recall"] == [1.0]
