"""Gist-spectrum synthetic data (port of bench/synth.py and of the device
generator in bench.py).

`gist_spectrum` is a PCA model of the committed real Gist slice
(data/gist_1000.bin + data/gist_test.bin): rows drawn as Gaussians in its
basis, scaled by its spectrum and clipped to >= 0 like real Gist, reproduce
real-Gist distance contrast at dim 960.  `make_device` draws them on a
device from a seeded `torch.Generator` (the counterpart of the reference's
`jax.random` generator in bench.py; the two give different rows from one
seed, with the same distribution).
"""

from __future__ import annotations

import os

import numpy as np
import torch

_SPECTRUM_CACHE: dict = {}


def gist_spectrum(dim: int, data_dir: str | None = None):
    """(mean, sqrt-eigenvalue scales, basis) of the committed Gist fixture
    slice, cropped to the first `dim` coordinates.  A pure function of the
    fixture bytes."""
    if dim in _SPECTRUM_CACHE:
        return _SPECTRUM_CACHE[dim]
    if data_dir is None:
        data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")
    parts = []
    for name in ("gist_1000.bin", "gist_test.bin"):
        a = np.fromfile(os.path.join(data_dir, name), dtype=np.float32)
        parts.append(a.reshape(-1, 960)[:, :dim])
    x = np.concatenate(parts).astype(np.float64)
    mu = x.mean(0)
    _, sv, vt = np.linalg.svd(x - mu, full_matrices=False)
    scales = sv / np.sqrt(len(x))
    out = (mu.astype(np.float32), scales.astype(np.float32), vt.astype(np.float32))
    _SPECTRUM_CACHE[dim] = out
    return out


def make_device(n: int, dim: int, seed: int, device, block_rows: int = 65536) -> torch.Tensor:
    """(n, dim) f32 Gist-spectrum rows drawn on `device` from a
    `torch.Generator` seeded with `seed`, in blocks of `block_rows` (the
    Gaussian block is the only transient)."""
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
