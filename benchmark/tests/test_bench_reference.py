"""The plain reference against a brute-force float64 count, and its TF32
rounding."""

import numpy as np
import pytest
import torch

from benchmark import reference, synth


def brute(rows, queries, dist):
    r, q = rows.astype(np.float64), queries.astype(np.float64)
    if dist == "l2sqr":
        return ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    return 1.0 - (q @ r.T) / (np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(r, axis=1)[None, :])


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_exact_topk_is_the_brute_force_top_k(dist, monkeypatch):
    monkeypatch.setattr(reference, "_ROW_BLOCK", 700)  # several row blocks, a ragged last one
    monkeypatch.setattr(reference, "_QUERY_BLOCK", 7)
    rows = synth.make_device(2000, 96, 5, "cpu")
    queries = synth.make_device(20, 96, 6, "cpu")
    d, i = reference.exact_topk(rows, queries, 10, dist)
    full = brute(rows.numpy(), queries.numpy(), dist)
    want = np.sort(full, axis=1)[:, :10]
    np.testing.assert_allclose(d.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.take_along_axis(full, i.numpy(), 1), d.numpy(), rtol=1e-12, atol=1e-12)
    got = reference.distances(rows, queries, torch.arange(20), i, dist)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_distances_of_invalid_ids_are_inf():
    rows = synth.make_device(50, 16, 1, "cpu")
    d = reference.distances(rows, rows[:2], torch.tensor([0, 1]), torch.tensor([[0, -1], [50, 1]]), "l2sqr")
    assert d[0, 0] == 0 and d[1, 1] == 0 and torch.isinf(d[0, 1]) and torch.isinf(d[1, 0])


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0 - 2**-11])
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0])
    assert torch.equal(reference.tf32(x), want)
    y = torch.randn(1000)
    assert ((reference.tf32(y) - y).abs() <= y.abs() * 2**-11).all()


@pytest.mark.parametrize("dist", ["l2sqr", "cosine"])
def test_control_finds_the_neighbours_at_lower_precision(dist):
    rows = synth.make_device(3000, 960, 2, "cpu")
    queries = synth.make_device(16, 960, 3, "cpu")
    d64, i64 = reference.exact_topk(rows, queries, 10, dist)
    sq = (rows * rows).sum(-1)
    d, i = reference.control_topk(reference.tf32(rows), sq if dist == "l2sqr" else sq.sqrt(), queries, 10,
                                  dist)
    hits = (i[:, :, None] == i64[:, None, :]).any(2).float().mean()
    assert hits >= 0.9
    gap = ((d.double() - reference.distances(rows, queries, torch.arange(16), i, dist)).abs()
           / d64[:, -1:]).max()
    assert 1e-5 < gap < 1e-2  # TF32-grade, far from float32's
