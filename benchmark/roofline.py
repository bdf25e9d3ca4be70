"""The yardstick of the kernels' roofline shares: the card's peaks
(`peaks.json`), the kernels' names in a trace (`kernels.json`), and each
kernel's operations and bytes from the shapes of its call.

A kernel's bound is the least time the card could take for the work the
call needs, the larger of bytes over the HBM rate and operations over the
peak rate; its roofline share is that bound over the kernel's measured time.
Bytes count each input read once and each output written once, over the
unpadded rows, whatever the kernel reads again or pads.
"""

from __future__ import annotations

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)


def kernel_matcher(kernel: str):
    """A predicate on trace names that accepts the named kernel's launches."""
    with open(os.path.join(_HERE, "kernels.json")) as f:
        names = json.load(f)[kernel]["names"]
    return lambda name: any(n in name for n in names)


def k1_bytes(n: int, dim: int, b: int) -> int:
    """K1, the packed int8 chunk-min scan: n int8 rows of dim lanes with an
    f32 scale and an f32 cached term each, b int8 queries with two f32
    channels each, and one int32 survivor per 128 rows and query."""
    return n * dim + 8 * n + b * (dim + 8) + -(-n // 128) * b * 4


def k1_ops(n: int, dim: int, b: int) -> int:
    """K1's int8 multiply-adds, counted as two operations each."""
    return 2 * n * b * dim


def k1_bound_s(n: int, dim: int, b: int) -> float:
    p = peaks()
    return max(k1_bytes(n, dim, b) / p["hbm_bytes_per_s"], k1_ops(n, dim, b) / p["int8_ops_per_s"])
