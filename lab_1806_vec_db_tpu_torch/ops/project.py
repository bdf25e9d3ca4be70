"""PCA projection for the reduced-width stage-1 scan (port of
lab_1806_vec_db_tpu/ops/project.py).

The exact scan's cost is linear in `dim`; on strongly low-rank data most
lanes carry little of the distance signal between near neighbours.
Projecting the rows onto their top `d_red` principal directions (one
(dim, dim) moment product on the device + a float64 `eigh` of that small
matrix on the host) gives a stage-1 scan (K1) over `d_red` lanes instead of
`dim`; K2's exact rerank then restores exact distances for the returned
top-k, the same two-stage contract as the int8 mirror's (models/flat.py).
The projected mirror itself is `models/mirror.py`'s.

For `l2sqr` the rows are centered first (the mean cancels in differences);
for `cosine` the raw second moment is used and rows are projected
uncentered.  The moment product is a plain f32 `torch.matmul` (TF32 is off
package-wide), as the reference leaves it to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

_LANES = 128  # K1 reads its mirror in 128-byte boxes: D must be a multiple


def proj_lanes(d_red: int) -> int:
    """Lanes of the projected int8 mirror: `d_red` rounded up to a multiple
    of 128 (zero lanes are dot-transparent)."""
    return -(-int(d_red) // _LANES) * _LANES


def pca_fit(vecs: torch.Tensor, n_valid: int, d_red: int, dist: str):
    """Top-`d_red` principal directions of the first `n_valid` rows of the
    (cap, dim) tensor (later rows are ignored).

    Returns ((dim, d_red) f32 projection, (dim,) f32 mean to subtract
    before projecting, zeros for cosine) as numpy: the eigendecomposition
    runs on the host in float64, and the trailing `d_red` eigenvectors are
    taken in descending eigenvalue order, as the reference takes them."""
    x = vecs[: int(n_valid)].float()
    n = max(float(n_valid), 1.0)
    c = x.T @ x
    mu = x.sum(0) / n
    if dist == "l2sqr":
        c = c - n * torch.outer(mu, mu)
    else:
        mu = torch.zeros_like(mu)
    c_host = c.cpu().numpy().astype(np.float64)
    _, eigvecs = np.linalg.eigh((c_host + c_host.T) / 2.0)
    proj = eigvecs[:, -int(d_red):][:, ::-1].astype(np.float32)
    return np.ascontiguousarray(proj), mu.cpu().numpy().astype(np.float32)


def project(x: torch.Tensor, proj: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(B, dim) rows -> (B, d_red) f32 projected (and centered) rows."""
    return (x.float() - mu[None, :]) @ proj

