"""The uint8 stage 1's bound against a count by hand, and its name in a trace."""

import pytest

from benchmark import roofline, roofline_u8


def test_u8_scan_counts_at_the_cell_by_hand():
    # 100,000,000 rows x 128 lanes, 1000 queries: rows 12.8e9 B, their int32
    # squared norms 4e8 B, queries 1000 x (128 + 8) B, and 781,250 survivors a
    # query of 4 B each
    n, dim, b = 100_000_000, 128, 1000
    assert roofline_u8.u8_scan_bytes(n, dim, b) == 12_800_000_000 + 400_000_000 + 136_000 + 3_125_000_000
    assert roofline_u8.u8_scan_ops(n, dim, b) == 25_600_000_000_000
    # operations bound it: 2.56e13 / 1.979e15 s = 12.94 ms; bytes 16.3 GB / 3.35e12 = 4.87 ms
    assert roofline_u8.u8_scan_bound_s(n, dim, b) == pytest.approx(2.56e13 / 1.979e15)
    assert roofline_u8.u8_scan_bytes(n, dim, b) / 3.35e12 == pytest.approx(4.873e-3, rel=1e-3)
    # bytes bound it at B = 32
    assert roofline_u8.u8_scan_bound_s(n, dim, 32) == pytest.approx(roofline_u8.u8_scan_bytes(n, dim, 32) / 3.35e12)


def test_u8_scan_name_matches_its_launches_and_not_k1s():
    u8 = roofline_u8.matcher()
    name = "(anonymous namespace)::scan_u8_exact_kernel(CUtensorMap_st, CUtensorMap_st, int const*, int const*, int*)"
    assert u8(name) and not roofline.kernel_matcher("k1")(name)
    assert not u8("(anonymous namespace)::scan_int8_packed_kernel(CUtensorMap_st, CUtensorMap_st, float const*)")
