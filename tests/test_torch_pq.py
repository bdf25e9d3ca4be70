"""PQ of the PyTorch port (`ops/pq.py`, `models/pq_table.py`) against the JAX
package, on the CPU.

Tolerances: group splits, packing, the scan permutation, the rotation and
checkpoints are exact; codes from the same codebooks agree on >= 99.9% of
entries (a code flips only where two centroids are within f32 rounding of
each other); lookup tables agree to rtol 1e-5 (f32 summation order).  The
port's own training is held to the reference's gates (pq_table.rs:312-438):
exact ADC when num_vec <= k, p90 relative error < 0.2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lab_1806_vec_db_tpu.models import PQTable as JPQTable
from lab_1806_vec_db_tpu.ops import distance as JD
from lab_1806_vec_db_tpu.ops import pq as JP
from lab_1806_vec_db_tpu.utils.config import PQConfig as JPQConfig
from lab_1806_vec_db_tpu_torch.models import PQTable
from lab_1806_vec_db_tpu_torch.ops import pq as P
from lab_1806_vec_db_tpu_torch.utils.config import PQConfig

torch.set_num_threads(1)  # the test workers share the host's cores: one intra-op thread each


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dim,m", [(6, 2), (7, 3), (960, 320), (13, 5), (24, 24)])
def test_pq_groups_and_gather_indices(dim, m):
    assert P.pq_groups(dim, m) == JP.pq_groups(dim, m)
    gi, gm, ds = P.group_gather_indices(dim, m)
    ji, jm, jds = JP.group_gather_indices(dim, m)
    np.testing.assert_array_equal(gi, ji)
    np.testing.assert_array_equal(gm, jm)
    assert ds == jds


@pytest.mark.parametrize("m", [7, 8])
def test_pack_unpack_roundtrip(m):
    codes = np.random.default_rng(m).integers(0, 16, size=(10, m)).astype(np.uint8)
    packed = P.pack_codes_4bit(codes)
    np.testing.assert_array_equal(packed, JP.pack_codes_4bit(codes))
    np.testing.assert_array_equal(P.unpack_codes_4bit(packed, m), codes)
    np.testing.assert_array_equal(P.unpack_codes_4bit_dev(_t(packed), m).numpy(), codes)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
@pytest.mark.parametrize("n_bits", [4, 8])
def test_encode_and_lookup_with_reference_codebooks(dist, n_bits, gist_1000):
    """Encoding with the reference's trained codebooks gives its codes on
    >= 99.9% of entries; the lookup tables agree to rtol 1e-5."""
    dim, m = 48, 16
    vecs = gist_1000[:600, :dim].copy()
    jt = JPQTable.train(vecs, JPQConfig(n_bits=n_bits, m=m, dist=dist), seed=1)
    gi, gm, _ = P.group_gather_indices(dim, m)
    gi, gm = torch.from_numpy(gi), torch.from_numpy(gm)
    cb = _t(jt.codebooks)
    codes = P.encode(P.regroup(_t(vecs), gi, gm), cb, dist)
    assert codes.dtype == torch.uint8
    assert (codes.numpy() == jt.codes).mean() >= 0.999
    q = gist_1000[700:720, :dim].copy()
    expect = JP.build_lookup(JP.regroup(jnp.asarray(q), jnp.asarray(gi.numpy()),
                                        jnp.asarray(gm.numpy())), jnp.asarray(jt.codebooks), dist)
    got = P.build_lookup(P.regroup(_t(q), gi, gm), cb, dist)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pq_exactness_when_num_vec_le_k(dist):
    """num_vec <= k: quantization is lossless, so ADC distances equal the
    true distances (pq_table.rs:324-372), on the port's own training."""
    rng = np.random.default_rng(42)
    dim, m, num_vec = 8, 2, 5
    src = rng.uniform(-1.0, 1.0, size=(num_vec, dim)).astype(np.float32)
    cfg = PQConfig(n_bits=4, m=m, dist=dist, k_means_size=None)
    pq = PQTable.train(src, cfg, seed=42, device="cpu")
    lookup, q_norms = pq.create_lookup(_t(src))
    ids = torch.arange(num_vec, dtype=torch.int32)[None, :].expand(num_vec, -1)
    adc = pq.adc_for_ids(lookup, q_norms, ids).numpy()
    for i in range(num_vec):
        for j in range(num_vec):
            assert abs(adc[i, j] - JD.calc_dist_host(src[i], src[j], dist)) < 1e-5


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_pq_p90_relative_error(dist, gist_1000):
    """p90 relative error < 0.2 on real data (pq_table.rs:374-413)."""
    rng = np.random.default_rng(42)
    vecs = gist_1000[:64, :13].copy()
    pq = PQTable.train(vecs, PQConfig(n_bits=4, m=5, dist=dist), seed=42, device="cpu")
    errors = []
    for _ in range(20):
        i0, i1 = rng.integers(0, len(vecs), 2)
        lookup, q_norms = pq.create_lookup(_t(vecs[i1][None, :]))
        adc = float(pq.adc_for_ids(lookup, q_norms, torch.tensor([[int(i0)]], dtype=torch.int32)))
        expect = JD.calc_dist_host(vecs[i0], vecs[i1], dist)
        errors.append(abs(adc - expect) / max(expect, 1.0))
    errors.sort()
    assert errors[int(np.ceil(len(errors) * 0.9)) - 1] < 0.2


def test_train_from_device_tensor_with_n_valid(gist_1000):
    """A capacity-padded tensor with n_valid trains and encodes exactly as
    the host array of its first n_valid rows does."""
    vecs = gist_1000[:300, :24].copy()
    padded = torch.zeros((512, 24))
    padded[:300] = _t(vecs)
    cfg = PQConfig(n_bits=4, m=8, dist="l2sqr", k_means_size=200)
    a = PQTable.train(padded, cfg, seed=5, n_valid=300)
    b = PQTable.train(vecs, PQConfig(n_bits=4, m=8, dist="l2sqr", k_means_size=200), seed=5,
                      device="cpu")
    assert len(a) == 300 and a.torch_device.type == "cpu"
    # the device path gathers the sorted sample, the host path the drawn
    # order (as in the reference), so compare against a sorted host draw
    sel = np.sort(np.random.default_rng(5).choice(300, size=200, replace=False))
    c = PQTable.train(vecs[sel], PQConfig(n_bits=4, m=8, dist="l2sqr"), seed=5, device="cpu")
    np.testing.assert_array_equal(a.codebooks, c.codebooks)
    assert a.codes.shape == b.codes.shape == (300, 8)
    with pytest.raises(ValueError):
        PQTable.train(padded, cfg, n_valid=600)


@pytest.mark.parametrize("rotate", [False, True])
@pytest.mark.parametrize("n_bits", [4, 8])
def test_pq_npz_interchanges_both_ways(rotate, n_bits, tmp_path, gist_1000):
    vecs = gist_1000[:200, :12].copy()
    q = gist_1000[300:305, :12].copy()
    jt = JPQTable.train(vecs, JPQConfig(n_bits=n_bits, m=4, dist="l2sqr", rotate=rotate), seed=3)
    jt.save(str(tmp_path / "j.npz"))
    pt = PQTable.load(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(pt.codes, jt.codes)
    np.testing.assert_array_equal(pt.codebooks, jt.codebooks)
    assert pt.adc_quality == jt.adc_quality and pt.config.rotate == rotate
    # the rotated lookup goes through the same transform
    jl, _ = jt.create_lookup(jnp.asarray(q))
    pl, _ = pt.create_lookup(_t(q))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)

    own = PQTable.train(vecs, PQConfig(n_bits=n_bits, m=4, dist="l2sqr", rotate=rotate), seed=3,
                        device="cpu")
    if rotate:  # the same numpy rotation as the reference's
        np.testing.assert_array_equal(own.rotation, jt.rotation)
    own.save(str(tmp_path / "p.npz"))
    back = JPQTable.load(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(back.codes, own.codes)
    np.testing.assert_array_equal(back.codebooks, own.codebooks)


def test_device_views_and_scan_permutation(gist_1000):
    """Packed device codes, the 0xC0DE5 scan permutation (the reference's
    own), and device_bytes counting every cached tensor."""
    vecs = gist_1000[:150, :14].copy()
    jt = JPQTable.train(vecs, JPQConfig(n_bits=4, m=7, dist="l2sqr"), seed=0)
    pt = PQTable.from_state(*jt.state(), device="cpu")
    codes, cb, cb_sq = pt.device()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jt.device()[0]))
    np.testing.assert_allclose(cb_sq.numpy(), np.asarray(jt.device()[2]), rtol=1e-6)
    scan, perm = pt.device_scan()
    jscan, jperm = jt.device_scan()
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    assert scan.shape == (150, 4)  # 4 packed bytes, padded to a multiple of 4
    np.testing.assert_array_equal(scan[:, :4].numpy(), np.asarray(jscan))
    expect = sum(t.numel() * t.element_size() for t in (codes, cb, cb_sq, scan, perm))
    assert pt.device_bytes() == expect
