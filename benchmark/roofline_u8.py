"""The yardstick of the uint8 stage 1 (K1's uint8 variant,
`scan_u8_exact_kernel` in `csrc/scan_int8_packed.cu`): its name in a trace
and its operations and bytes from the shape of its call, in `roofline.py`'s
manner and on its peaks (`roofline.peaks()`).

Bytes count each input read once and each output written once: the n
centred int8 rows of dim lanes with an int32 squared norm each, b queries
of dim bytes with 8 bytes of channels each, and one int32 survivor per 128
rows and query.
"""

from __future__ import annotations

from . import roofline

NAMES = ["scan_u8_exact_kernel"]


def matcher():
    """A predicate on trace names that accepts the uint8 stage 1's launches."""
    return lambda name: any(n in name for n in NAMES)


def u8_scan_bytes(n: int, dim: int, b: int) -> int:
    return n * dim + 4 * n + b * (dim + 8) + -(-n // 128) * b * 4


def u8_scan_ops(n: int, dim: int, b: int) -> int:
    """Its int8 multiply-adds, counted as two operations each."""
    return 2 * n * b * dim


def u8_scan_bound_s(n: int, dim: int, b: int) -> float:
    p = roofline.peaks()
    return max(u8_scan_bytes(n, dim, b) / p["hbm_bytes_per_s"], u8_scan_ops(n, dim, b) / p["int8_ops_per_s"])
