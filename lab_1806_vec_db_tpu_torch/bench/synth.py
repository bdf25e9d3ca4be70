"""Gist-spectrum synthetic data (port of bench/synth.py and of the device
generator in bench.py).

`gist_spectrum` is a PCA model of the committed real Gist slice
(data/gist_1000.bin + data/gist_test.bin): rows drawn as Gaussians in its
basis, scaled by its spectrum and clipped to >= 0 like real Gist, reproduce
real-Gist distance contrast at dim 960.  `make_device` draws them on a
device from a seeded `torch.Generator` (the counterpart of the reference's
`jax.random` generator in bench.py; the two give different rows from one
seed, with the same distribution).

`make_fill` is the lean-tier ingest's generator (bench.py:make_fill): row
id r always gives the same row, so blocks can be regenerated after the f32
data is gone; `exact_gt_blocked` computes exact ground truth that way.
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


_KEY_ROWS = 16384  # rows per generator key: divides every lean block size used


def make_fill(seed: int, dim: int, device):
    """Row-addressable Gist-spectrum generator -> (fill, queries).

    `fill(row0, rows)` returns rows [row0, row0 + rows) as an f32 tensor on
    `device`.  Every aligned group of 16,384 rows draws its Gaussians from its
    own `torch.Generator` seeded from (seed, group), so a row's values depend
    only on its id, never on the block boundaries of the call.
    `queries(n)` draws n query rows from a separate seed."""
    device = torch.device(device)
    mu_h, scales_h, vt_h = gist_spectrum(dim)
    mu = torch.from_numpy(mu_h).to(device)
    scales = torch.from_numpy(scales_h).to(device)
    vt = torch.from_numpy(vt_h).to(device)

    def group(g: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed((seed << 32) + 1 + g)
        z = torch.randn((_KEY_ROWS, len(scales_h)), generator=gen, device=device)
        return torch.addmm(mu, z * scales, vt).clamp_(min=0.0)

    def fill(row0: int, rows: int) -> torch.Tensor:
        g0, g1 = row0 // _KEY_ROWS, -(-(row0 + rows) // _KEY_ROWS)
        if g1 - g0 == 1:
            blk = group(g0)
        else:
            blk = torch.cat([group(g) for g in range(g0, g1)])
        off = row0 - g0 * _KEY_ROWS
        return blk[off : off + rows]

    def queries(n_queries: int) -> torch.Tensor:
        return make_device(n_queries, dim, (seed << 32) + (1 << 31), device)

    return fill, queries


def exact_gt_blocked(fill, n: int, queries: torch.Tensor, k: int, dist: str,
                     block_rows: int = 131072) -> torch.Tensor:
    """Exact f32 top-k ids (B, k) int32 over rows [0, n) of `fill`, without
    ever holding the whole set: regenerate each block, scan it exactly
    (`topk.knn_scan`), merge a running top-k."""
    from ..ops import distance as D
    from ..ops import topk as T

    B = queries.shape[0]
    best_d = torch.full((B, k), float("inf"), device=queries.device)
    best_i = torch.full((B, k), T.INVALID_ID, dtype=torch.int32, device=queries.device)
    for row0 in range(0, n, block_rows):
        rows = min(block_rows, n - row0)
        v = fill(row0, rows)
        td, ti = T.knn_scan(queries, v, D.dist_cache(v, dist), rows, k, dist)
        ti = torch.where(ti >= 0, ti + row0, ti)
        best_d, best_i = T.merge_topk(best_d, best_i, td, ti, k)
    return best_i
