"""The yardstick of K7, the ADC chunk-min scan of Flat+PQ
(`adc_chunkmin_kernel` in `csrc/adc_scan_chunkmin.cuh`): its name in a
trace and its bytes from the shape of its call, in `roofline.py`'s manner
and on its peaks (`roofline.peaks()`).

Bytes count each input read once and each output written once: the n
permuted packed codes of m / 2 bytes (4-bit codes, two a byte), the int8
lookup of m x 16 bytes a query, 8 bytes of scale and norm a query, and a
survivor of 8 bytes (an f32 minimum, an int32 position) per chunk of 32
rows and query, over the ceil(n / 256) * 256 positions the survivors cover.
Its lookup-adds (n x b x m) lie far below the card's integer peak, so the
bound is the bytes'.  The one-hot method's own floor (2 n b m 16 int8
operations) is not its bound: a cheaper method would read past 100%.
"""

from __future__ import annotations

from . import roofline

NAMES = ["adc_chunkmin_kernel"]  # not K11's adc_chunkmin_binned_kernel
CHUNK = 32
_TILE = 256  # the survivors cover a whole number of 256-row tiles


def matcher():
    """A predicate on trace names that accepts K7's launches."""
    return lambda name: any(n in name for n in NAMES)


def k7_bytes(n: int, m: int, b: int) -> int:
    chunks = -(-n // _TILE) * _TILE // CHUNK
    return n * -(-m // 2) + b * m * 16 + 8 * b + 8 * chunks * b


def k7_bound_s(n: int, m: int, b: int) -> float:
    return k7_bytes(n, m, b) / roofline.peaks()["hbm_bytes_per_s"]
