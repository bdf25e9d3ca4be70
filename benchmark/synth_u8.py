"""uint8 rows for a configuration that states `"dtype": "uint8"`.

The rows are Gist-derived, not SIFT: each is a Gist-spectrum row of
`synth.py` (its frozen `gist_spectrum`, cropped to the configuration's
width), scaled by `spectrum_scale(dim)`, truncated toward zero and clipped to
0-255 (the upstream table's `as u8` cast), and cast to uint8.  Their value
distribution, tie rate and the 7-bit control's gap are those of this data,
whatever widths a configuration borrows from a uint8 source such as BIGANN.

The rows are defined unit by unit: unit u (rows u * UNIT_ROWS onward) is
drawn whole from its own `torch.Generator`, seeded from (seed, u), and
transformed by a product of its own.  A row's bits then depend on the seed
and its index alone: a set of n rows is the first n rows of any longer set.
The maker fills one unit at a time and holds at most one unit in float32 (a
whole float32 copy of 100,000,000 x 128 rows would be 51.2 GB).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import synth

UNIT_ROWS = 65536


def spectrum_scale(dim: int) -> int:
    """The constant every row is scaled by, from the frozen spectrum alone:
    floor(255 / max_j (mu_j + 4 sd_j)) over the first `dim` coordinates,
    where mu_j and sd_j are the mean and standard deviation of coordinate j
    under the spectrum (775 at width 128).  Four deviations above the mean
    of the widest coordinate map to 255, so few values saturate."""
    mu, scales, vt = synth.gist_spectrum(dim)
    sd = np.sqrt(((scales.astype(np.float64)[:, None] * vt.astype(np.float64)) ** 2).sum(0))
    return math.floor(255.0 / float((mu.astype(np.float64) + 4.0 * sd).max()))


def make_device(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """(n, dim) uint8 rows drawn on `device` from `seed`, one unit at a
    time."""
    device = torch.device(device)
    scale = float(spectrum_scale(dim))
    mu_h, scales_h, vt_h = synth.gist_spectrum(dim)
    mu = torch.from_numpy(mu_h).to(device)
    scales = torch.from_numpy(scales_h).to(device)
    vt = torch.from_numpy(vt_h).to(device)
    gen = torch.Generator(device=device)
    out = torch.empty((n, dim), dtype=torch.uint8, device=device)
    for u0 in range(0, n, UNIT_ROWS):
        gen.manual_seed(synth.sub_seed(seed, f"u8.{u0 // UNIT_ROWS}"))
        z = torch.randn((UNIT_ROWS, len(scales_h)), generator=gen, device=device)
        unit = torch.addmm(mu, z * scales, vt).mul_(scale).trunc_().clamp_(0.0, 255.0).to(torch.uint8)
        out[u0 : u0 + UNIT_ROWS] = unit[: n - u0]
    return out
