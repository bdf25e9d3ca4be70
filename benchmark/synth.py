"""Gist-spectrum synthetic rows: the benchmark's only data source.

A frozen copy of the port's `bench/synth.py` (`gist_spectrum`, `make_device`),
so that no later change to the program moves the benchmark's data.  The
spectrum is the PCA of the repository's real Gist slices (`data/gist_1000.bin`
and `data/gist_test.bin`, 2,000 x 960): mean, square-rooted eigenvalues and
basis, computed once in float64 and stored in `data/gist_spectrum.npz`, so the
rows do not depend on a host's LAPACK.  Rows are Gaussians in that basis,
scaled by the spectrum and clipped at 0 like real Gist; at dim 960 they
reproduce real Gist's distance contrast.

`make_device(n, dim, seed, device)` draws them on `device` from a
`torch.Generator` seeded with `seed`, in blocks of 65,536 rows: the same
arguments on the same device give the same bits.  `sub_seed` derives the
independent seeds of a run (rows, queries, order) from its `--seed`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_SPECTRUM = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "gist_spectrum.npz")
_BLOCK_ROWS = 65536


def gist_spectrum(dim: int):
    """(mean, scales, basis) of the Gist slices, cropped to `dim` <= 960
    coordinates: (dim,), (960,), (960, dim) float32."""
    with np.load(_SPECTRUM) as z:
        mu, scales, vt = z["mu"], z["scales"], z["vt"]
    if not 0 < dim <= mu.shape[0]:
        raise ValueError(f"dim must be in 1..{mu.shape[0]}, got {dim}")
    return mu[:dim], scales, np.ascontiguousarray(vt[:, :dim])


def make_device(n: int, dim: int, seed: int, device, block_rows: int = _BLOCK_ROWS) -> torch.Tensor:
    """(n, dim) float32 Gist-spectrum rows drawn on `device` from a
    `torch.Generator` seeded with `seed`, one block of rows at a time."""
    device = torch.device(device)
    mu_h, scales_h, vt_h = gist_spectrum(dim)
    mu = torch.from_numpy(mu_h).to(device)
    scales = torch.from_numpy(scales_h).to(device)
    vt = torch.from_numpy(vt_h).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for r0 in range(0, n, block_rows):
        rows = min(block_rows, n - r0)
        z = torch.randn((rows, len(scales_h)), generator=gen, device=device)
        torch.addmm(mu, z * scales, vt, out=out[r0 : r0 + rows]).clamp_(min=0.0)
    return out


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (`tag`) of a run seeded with `seed`:
    any whole number, as large as the caller likes, gives independent
    streams per tag."""
    words = [ord(c) for c in tag]
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *words]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
