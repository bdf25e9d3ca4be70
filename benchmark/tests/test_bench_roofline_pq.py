"""K7's byte bound against a count by hand, and its name in a trace."""

import pytest

from benchmark import roofline, roofline_pq

K7 = "void k7::adc_chunkmin_kernel<32>(CUtensorMap_st, unsigned char const*, float const*, float const*)"
K11 = ("void (anonymous namespace)::adc_chunkmin_binned_kernel<16, 64, false>(unsigned char const*, "
       "signed char const*, float const*)")


def test_k7_bytes_at_the_cell_by_hand():
    # 1,000,000 rows of 320 4-bit codes (160 B), 1000 queries: the int8
    # lookup 1000 x 320 x 16 B, 8 B of scale and norm a query, and 31,256
    # survivors (ceil(1e6 / 256) * 256 / 32) of 8 B a query
    n, m, b = 1_000_000, 320, 1000
    assert roofline_pq.k7_bytes(n, m, b) == 160_000_000 + 5_120_000 + 8_000 + 8 * 31_256 * 1000
    # 415.2 MB over 3.35e12 B/s: 0.1239 ms, the smoke's `check_k7` bound
    assert roofline_pq.k7_bound_s(n, m, b) == pytest.approx(0.12393e-3, rel=1e-4)
    assert roofline_pq.k7_bound_s(n, m, b) == pytest.approx(roofline_pq.k7_bytes(n, m, b) / roofline.peaks()["hbm_bytes_per_s"])
    # an odd m rounds its last byte up; a ragged n covers its last tile
    assert roofline_pq.k7_bytes(300, 7, 2) == 300 * 4 + 2 * 7 * 16 + 16 + 8 * 16 * 2


def test_k7_name_matches_its_launches_and_not_k11s():
    k7 = roofline_pq.matcher()
    assert k7(K7) and k7("k7::adc_chunkmin_kernel<1>(CUtensorMap_st)")
    assert not k7(K11) and not k7("adc_chunkmin_binned_kernel")
    assert not k7("void (anonymous namespace)::scan_int8_packed_kernel(CUtensorMap_st, CUtensorMap_st)")
    assert not k7("void k8::dense_onehot_kernel<0>(CUtensorMap_st, unsigned char const*)")
