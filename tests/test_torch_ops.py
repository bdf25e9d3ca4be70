"""Plain-PyTorch ops of the port (distances, top-k, the int8 self-test, the
Gist-spectrum generator, config and capability protocols) against the JAX
package on the same numpy-seeded inputs.  f32 results differ only by
summation order: rtol 1e-5 / atol 1e-5 where cancellation makes values
small."""

import glob
import os
from dataclasses import asdict

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lab_1806_vec_db_tpu.bench import synth as JS
from lab_1806_vec_db_tpu.ops import distance as JD
from lab_1806_vec_db_tpu.ops import topk as JT
from lab_1806_vec_db_tpu.utils import config as JC
from lab_1806_vec_db_tpu_torch.bench import synth
from lab_1806_vec_db_tpu_torch.models import FlatIndex
from lab_1806_vec_db_tpu_torch.models import base
from lab_1806_vec_db_tpu_torch.ops import distance as D
from lab_1806_vec_db_tpu_torch.ops import topk as T
from lab_1806_vec_db_tpu_torch.utils import config as C

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_distances_match_reference(dist, gist_1000):
    q, b = gist_1000[:6, :96], gist_1000[100:400, :96]
    np.testing.assert_allclose(
        D.dist_cache(torch.from_numpy(b), dist).numpy(), np.asarray(JD.dist_cache(jnp.asarray(b), dist)),
        rtol=1e-6)
    np.testing.assert_allclose(
        D.pairwise(torch.from_numpy(q), torch.from_numpy(b), dist).numpy(),
        np.asarray(JD.pairwise(jnp.asarray(q), jnp.asarray(b), dist)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        D.pointwise(torch.from_numpy(q), torch.from_numpy(b[:6]), dist).numpy(),
        np.asarray(JD.pointwise(jnp.asarray(q), jnp.asarray(b[:6]), dist)), rtol=1e-5, atol=1e-6)
    assert D.calc_dist_host(q[0], b[0], dist) == pytest.approx(JD.calc_dist_host(q[0], b[0], dist), rel=1e-6)
    with pytest.raises(ValueError):
        D.check_dist("dot")
    with pytest.raises(ValueError):
        D.calc_dist_host([1.0, 2.0], [1.0], dist)


def test_knn_scan_blocked_matches_reference_and_single_tile(gist_1000):
    vecs, queries = gist_1000[:512, :64], gist_1000[512:520, :64]
    cache = D.dist_cache(torch.from_numpy(vecs), "l2sqr")
    d1, i1 = T.knn_scan(torch.from_numpy(queries), torch.from_numpy(vecs), cache, 500, 10, "l2sqr")
    d2, i2 = T.knn_scan(torch.from_numpy(queries), torch.from_numpy(vecs), cache, 500, 10, "l2sqr",
                        block=128)
    jd, ji = JT.knn_scan(jnp.asarray(queries), jnp.asarray(vecs), JD.dist_cache(jnp.asarray(vecs), "l2sqr"),
                         jnp.int32(500), 10, "l2sqr")
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d1.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert (i1.numpy() < 500).all()
    # fewer valid rows than k: -1 / +inf padding
    d3, i3 = T.knn_scan(torch.from_numpy(queries), torch.from_numpy(vecs), cache, 3, 5, "l2sqr")
    assert (i3[:, 3:] == -1).all() and torch.isinf(d3[:, 3:]).all()


def test_topk_ties_keep_lower_position_first():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, float("inf")]])
    ids = torch.arange(6, dtype=torch.int32)[None]
    bd, bi = T.topk_smallest(d, ids, 4)
    jd, ji = JT.topk_smallest(jnp.asarray(d.numpy()), jnp.asarray(ids.numpy()), 4)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))
    md, mi = T.merge_topk(bd, bi, torch.tensor([[1.0, 0.1]]), torch.tensor([[9, 8]], dtype=torch.int32), 3)
    assert mi.tolist() == [[8, 3, 1]]


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_exact_distances_sorted_matches_reference(dist, gist_1000):
    q, b = gist_1000[:5, :40], gist_1000[10:200, :40]
    ids = np.random.default_rng(0).integers(-1, 190, size=(5, 7)).astype(np.int32)
    bd, bi = T.exact_distances_sorted(torch.from_numpy(q), torch.from_numpy(b), torch.from_numpy(ids), dist)
    jd, ji = JT.exact_distances_sorted(jnp.asarray(q), jnp.asarray(b), jnp.asarray(ids), dist)
    np.testing.assert_allclose(bd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_int8_selftest_agrees_in_distribution(dist):
    """Both packages score healthy data 1.0 and the pathological regime
    (tiny gaps far from the origin) low; the sample rows differ (numpy vs
    jax.random generators), so only the verdicts are compared."""
    rng = np.random.default_rng(5)
    healthy = rng.standard_normal((4000, 64)).astype(np.float32)
    hard = (100.0 + 1e-3 * rng.standard_normal((4000, 64))).astype(np.float32)
    for x, ok in ((healthy, True), (hard, False)):
        got = T.int8_ordering_selftest(torch.from_numpy(x), len(x), dist)
        ref = float(JT.int8_ordering_selftest(jnp.asarray(x), jnp.int32(len(x)), jax.random.PRNGKey(0), dist))
        assert (got >= 0.95) == (ref >= 0.95) == ok


def test_gist_spectrum_and_device_generator():
    # a cropped spectrum keeps the SVD small (the 960-d one takes seconds)
    for dim in (32, 64):
        for a, b in zip(synth.gist_spectrum(dim), JS.gist_spectrum(dim)):
            np.testing.assert_array_equal(a, b)
    x = synth.make_device(300, 64, 7, "cpu", block_rows=128)
    assert x.shape == (300, 64) and x.dtype == torch.float32
    assert torch.isfinite(x).all() and (x >= 0).all()
    torch.testing.assert_close(x, synth.make_device(300, 64, 7, "cpu", block_rows=128), rtol=0, atol=0)
    # same spectrum as the host reference generator: mean row norm within 5%
    ref = JS.make(300, 64, seed=7)
    assert abs(float(x.norm(dim=1).mean()) / float(np.linalg.norm(ref, axis=1).mean()) - 1) < 0.05


def test_config_files_parse_like_the_reference():
    paths = sorted(glob.glob(os.path.join(REPO, "config", "*.toml")))
    compared = 0
    for p in paths:
        try:
            expect = asdict(JC.BenchConfig.load_from_toml_file(p))
        except (KeyError, ValueError):
            continue  # not a bench config (e.g. a data config)
        assert asdict(C.BenchConfig.load_from_toml_file(p)) == expect
        compared += 1
    assert compared >= 10


def test_flat_index_satisfies_the_capability_protocols():
    idx = FlatIndex(4, "l2sqr", device="cpu")
    for proto in (base.IndexIter, base.IndexBuilder, base.IndexKNN, base.IndexKNNWithEf,
                  base.IndexSerde, base.IndexPQ):
        assert isinstance(idx, proto)
