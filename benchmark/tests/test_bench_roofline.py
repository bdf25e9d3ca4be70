"""K1's bound against a count by hand."""

import pytest

from benchmark import roofline


def test_k1_counts_by_hand():
    # 1,000,000 rows x 960 lanes, 1000 queries: rows 960,000,000 B, their
    # scale and cached term 8,000,000 B, queries 1000 x (960 + 8) B, and
    # ceil(1e6 / 128) = 7,813 survivors a query of 4 B each
    assert roofline.k1_bytes(1_000_000, 960, 1000) == 960_000_000 + 8_000_000 + 968_000 + 31_252_000
    assert roofline.k1_ops(1_000_000, 960, 1000) == 1_920_000_000_000
    # operations bound it at B = 1000: 1.92e12 / 1.979e15 s
    assert roofline.k1_bound_s(1_000_000, 960, 1000) == pytest.approx(1.92e12 / 1.979e15)
    # bytes at B = 32: 968,000,000 + 30,976 + 1,000,064 B over 3.35 TB/s
    assert roofline.k1_bound_s(1_000_000, 960, 32) == pytest.approx(969_031_040 / 3.35e12)


def test_kernel_names_match_the_launches():
    k1 = roofline.kernel_matcher("k1")
    assert k1("scan_int8_packed_kernel(CUtensorMap, CUtensorMap, float const*, int)")
    assert not k1("void vecdb::gather_dists_kernel<float>(float const*, int)")
    assert roofline.kernel_matcher("k2")("void vecdb::gather_dists_kernel<float>(float const*)")
