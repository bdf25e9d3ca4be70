"""File IO, the CLIs, the synthetic-data CLI and the profiling seams of the
PyTorch port against the JAX package's.

Files (raw bins, fvecs conversions, synth outputs) must be byte-identical
for the same inputs and seed; ground truth npz files equal, except between
result slots whose exact distances tie (rtol 1e-6).  The port's exact scan
runs on the CPU here (`--device cpu`); the reference's on its CPU backend.
"""

import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.bench import synth as jsynth
from lab_1806_vec_db_tpu.cli import convert_fvecs as jconvert
from lab_1806_vec_db_tpu.cli import gen_gnd as jgen_gnd
from lab_1806_vec_db_tpu.utils import io as jio
from lab_1806_vec_db_tpu_torch.bench import synth
from lab_1806_vec_db_tpu_torch.cli import convert_fvecs, gen_gnd
from lab_1806_vec_db_tpu_torch.models import FlatIndex
from lab_1806_vec_db_tpu_torch.utils import io, profiling
from lab_1806_vec_db_tpu_torch.utils.candidates import GroundTruth

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _write_fvecs(path, vecs):
    with open(path, "wb") as f:
        for row in vecs:
            f.write(np.uint32(len(row)).tobytes())
            f.write(row.astype(np.float32).tobytes())


def _gt_equal_but_ties(ids, jids, base, test, dist="l2sqr"):
    """Ground truths equal except where the differing ids' exact distances
    tie with another slot of the row."""
    assert ids.shape == jids.shape
    d, _ = FlatIndex.from_numpy(base, dist, device="cpu").knn_batch(test, ids.shape[1], exact=True)
    for r, c in zip(*np.nonzero(ids != jids)):
        assert np.isclose(d[r, c], d[r], rtol=1e-6, atol=0).sum() > 1, (r, c)


def test_dtype_to_name_matches_reference():
    for dt in (np.float32, np.uint8, "float32", "uint8"):
        assert io.dtype_to_name(dt) == jio.dtype_to_name(dt)
    for dt in (np.float64, np.int8):
        with pytest.raises(ValueError):
            io.dtype_to_name(dt)
        with pytest.raises(ValueError):
            jio.dtype_to_name(dt)
    assert io.dtype_from_name(io.dtype_to_name(np.uint8)) == np.uint8


@pytest.mark.parametrize("limit", [None, 3])
def test_load_fvecs_matches_reference(tmp_path, limit):
    vecs = np.random.default_rng(1).standard_normal((7, 12)).astype(np.float32)
    p = tmp_path / "v.fvecs"
    _write_fvecs(p, vecs)
    got = io.load_fvecs(p, limit=limit)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.load_fvecs(p, limit=limit))
    np.testing.assert_array_equal(got, vecs[:limit])


def test_load_fvecs_rejects_bad_files(tmp_path):
    p = tmp_path / "bad.fvecs"
    _write_fvecs(p, [np.zeros(4, np.float32), np.zeros(5, np.float32)])
    with pytest.raises(ValueError):
        io.load_fvecs(p)
    (tmp_path / "empty.fvecs").write_bytes(b"")
    assert io.load_fvecs(tmp_path / "empty.fvecs").shape == (0, 0)


def test_convert_fvecs_byte_identical(tmp_path, capsys):
    vecs = np.random.default_rng(2).standard_normal((9, 6)).astype(np.float32)
    src = tmp_path / "in.fvecs"
    _write_fvecs(src, vecs)
    convert_fvecs.main([str(src), "-o", str(tmp_path / "port.bin"), "-l", "5"])
    jconvert.main([str(src), "-o", str(tmp_path / "ref.bin"), "-l", "5"])
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    np.testing.assert_array_equal(io.load_raw(tmp_path / "port.bin", 6), vecs[:5])
    assert "Done! 5 vectors written." in capsys.readouterr().out


@pytest.mark.parametrize("dist_fn", ["L2Sqr", "Cosine"])
def test_gen_gnd_matches_reference(tmp_path, gist_1000, dist_fn):
    base, test = gist_1000[:700, :48], gist_1000[700:760, :48]
    io.save_raw(tmp_path / "base.bin", base)
    io.save_raw(tmp_path / "test.bin", test)
    common = ["-d", "48", "--base", str(tmp_path / "base.bin"), "--test", str(tmp_path / "test.bin"),
              "--dist-fn", dist_fn]
    gen_gnd.main(common + ["-o", str(tmp_path / "port.npz"), "--device", "cpu"])
    jgen_gnd.main(common + ["-o", str(tmp_path / "ref.npz")])
    got, ref = GroundTruth.load(tmp_path / "port.npz"), GroundTruth.load(tmp_path / "ref.npz")
    assert got.k == 10 and len(got) == 60
    _gt_equal_but_ties(got.rows, ref.rows, base, test, dist_fn.lower())


def test_synth_cli_byte_identical(tmp_path):
    for pkg, main in (("port", synth.main), ("ref", jsynth.main)):
        args = ["-n", "600", "-d", "96", "--prefix", str(tmp_path / pkg), "--seed", "3", "-q", "40"]
        if pkg == "port":
            args += ["--device", "cpu"]
        main(args + ["--gnd", str(tmp_path / f"{pkg}_test.local.bin")])
    for suffix in (".local.bin", "_test.local.bin"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"ref{suffix}").read_bytes()
    base = io.load_raw(tmp_path / "port.local.bin", 96)
    test = io.load_raw(tmp_path / "port_test.local.bin", 96)
    assert base.shape == (600, 96) and test.shape == (40, 96) and (base >= 0).all()
    np.testing.assert_array_equal(base, synth.make(600, 96, 3))
    got = GroundTruth.load(tmp_path / "port_gnd.local.npz").rows
    _gt_equal_but_ties(got, GroundTruth.load(tmp_path / "ref_gnd.local.npz").rows, base, test)


def test_synth_make_clustered_matches_reference():
    np.testing.assert_array_equal(synth.make(300, 1000, 5), jsynth.make(300, 1000, 5))
    np.testing.assert_array_equal(synth.make(200, 32, 1, kind="clustered"),
                                  jsynth.make(200, 32, 1, kind="clustered"))


def test_spans_accumulate():
    spans = profiling.Spans()
    for _ in range(3):
        with spans.span("a"):
            pass
    with pytest.raises(KeyError):
        with spans.span("b"):
            raise KeyError("x")
    assert spans.count["a"] == 3 and spans.count["b"] == 1  # counted even on an exception
    assert spans.avg("a") >= 0 and spans.avg("missing") == 0.0
    rep = spans.report().splitlines()
    assert len(rep) == 2 and rep[0].startswith("a: total=") and "n=3" in rep[0]


def test_progress_bar_writes_stderr(capsys):
    cb = profiling.progress_bar(4, label="unit")
    cb(2)
    cb(4)
    err = capsys.readouterr().err
    assert "[unit] 2/4 (50%)" in err and "[unit] 4/4 (100%)" in err and err.endswith("\n")


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "traceEvents" in text and "aten::mm" in text
