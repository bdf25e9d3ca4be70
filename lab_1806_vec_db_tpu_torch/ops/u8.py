"""uint8 compute: exact u8 distances and u8 k-means (port of
lab_1806_vec_db_tpu/ops/u8.py).

uint8 rows are a native compute type, not an ingest cast: the cross
products run as int8 x int8 -> int32 GEMMs with EXACT integer results
(f32 sums would round above 2^24; dim 960 u8 dot products reach 6.2e7).
uint8 values do not fit int8, so rows are centered by 128, which is exact,
and the cross term is rebuilt from per-row sums:

    a = a8 + 128,  b = b8 + 128          (a8, b8 in [-128, 127])
    dot(a, b) = a8.b8 + 128 (sum(a8) + sum(b8)) + dim 128^2

l2sqr(a, b) = ip_a + ip_b - 2 dot(a, b) is then exact int32 (at most
960 * 255^2 ~ 6.2e7 < 2^31); cosine divides the exact dot by f32 norms.

The reference leaves the int8 GEMM to XLA, outside any Pallas kernel; here
it is `torch._int_mm` on both devices (an exact integer product on the CPU
too).  Its CUDA shape rules (more than 16 rows, inner and outer sizes that
are multiples of 8) are met by zero-padding the CENTERED int8 operands: a
zero column adds nothing to a8.b8, and the correction keeps the real dim.

k-means is split as `ops/kmeans.py` splits it: a k-means++ init from an
explicit `torch.Generator` (`kmeanspp_init_u8`), then Lloyd (`lloyd_u8`)
with the reference's overflow discipline: f32 per-cluster sums, means cast
back to u8 by truncation and saturation (the reference's `as u8`), and the
tol stop on the quantized centroids, so the fixed point is a true u8 one.
"""

from __future__ import annotations

import torch

from . import distance as D
from .topk import INVALID_ID, merge_topk, smallest_positions

_ROWS = 65536  # rows per block of the k-means steps (bounds their transients)


def u8_channels(x_u8: torch.Tensor):
    """(N, dim) uint8 rows -> (x8 (N, dim) int8 centered by 128, ip (N,)
    int32 exact dot(x, x), s8 (N,) int32 exact sum(x8))."""
    xi = x_u8.to(torch.int32)
    x8 = (xi - 128).to(torch.int8)
    ip = (xi * xi).sum(-1, dtype=torch.int32)
    s8 = (xi - 128).sum(-1, dtype=torch.int32)
    return x8, ip, s8


def centre(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 rows -> the same rows centred by 128 as int8, x8 = u - 128
    (exact): the bits with the top one flipped."""
    return x_u8.bitwise_xor(128).view(torch.int8)


def centred_sums(x8: torch.Tensor):
    """(N, dim) centred int8 rows -> (n8 (N,) int32 exact |x8|^2, s8 (N,)
    int32 exact sum(x8))."""
    xi = x8.to(torch.int32)
    return (xi * xi).sum(-1, dtype=torch.int32), xi.sum(-1, dtype=torch.int32)


def ip_from_centred(n8: torch.Tensor, s8: torch.Tensor, dim: int) -> torch.Tensor:
    """|u|^2 of uint8 rows from their centred sums: |x8 + 128|^2 = n8 + 256
    s8 + dim 128^2, exact int32."""
    return n8 + 256 * s8 + dim * 128 * 128


def _pad8(x: torch.Tensor, rows_min: int = 0) -> torch.Tensor:
    """Zero rows and columns up to multiples of 8 (and at least `rows_min`
    rows)."""
    rows = max(rows_min, -(-x.shape[0] // 8) * 8)
    return torch.nn.functional.pad(x, (0, -x.shape[1] % 8, 0, rows - x.shape[0]))


def cross_i32(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """Exact (A, B) int32 products a8 @ b8.T of int8 rows (`torch._int_mm`
    on operands zero-padded to its shape rules)."""
    A, Bn = a8.shape[0], b8.shape[0]
    if A == 0 or Bn == 0:
        return torch.zeros((A, Bn), dtype=torch.int32, device=a8.device)
    return torch._int_mm(_pad8(a8, 24), _pad8(b8).T)[:A, :Bn]


def dots_u8(a8, s8a, b8, s8b) -> torch.Tensor:
    """Exact (A, B) int32 dot products of the original u8 rows from their
    centered channels: one int8 GEMM plus rank-1 corrections."""
    dim = a8.shape[-1]
    return cross_i32(a8, b8) + 128 * (s8a[:, None] + s8b[None, :]) + dim * 128 * 128


def pairwise_u8_i32(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """Exact (A, B) int32 squared-L2 distances between uint8 rows."""
    a8, ipa, s8a = u8_channels(a_u8)
    b8, ipb, s8b = u8_channels(b_u8)
    return ipa[:, None] + ipb[None, :] - 2 * dots_u8(a8, s8a, b8, s8b)


def _norm(ip: torch.Tensor) -> torch.Tensor:
    """sqrt(f32(ip)) rounded once (taken in f64: torch's vectorised f32
    sqrt on the CPU is off by an ulp on some inputs)."""
    return ip.float().double().sqrt().float()


def _dist_from_dot(dot, ipa, ipb, dist: str) -> torch.Tensor:
    """(A, B) f32 distances from exact int32 dots and the rows' ip."""
    if dist == "l2sqr":
        return (ipa[:, None] + ipb[None, :] - 2 * dot).float()
    return 1.0 - dot.float() / (_norm(ipa)[:, None] * _norm(ipb)[None, :]).clamp_min(1e-10)


def pairwise_u8(a_u8: torch.Tensor, b_u8: torch.Tensor, dist: str) -> torch.Tensor:
    """(A, B) f32 distances between uint8 rows: l2sqr exact integers, cosine
    the exact dot over f32 norms (the reference's u8 semantics,
    src/distance/mod.rs:79-95)."""
    D.check_dist(dist)
    a8, ipa, s8a = u8_channels(a_u8)
    b8, ipb, s8b = u8_channels(b_u8)
    return _dist_from_dot(dots_u8(a8, s8a, b8, s8b), ipa, ipb, dist)


def knn_scan_u8(queries_u8, base8, base_ip, base_s8, n_valid: int, k: int, dist: str, block: int = 131072):
    """Exact brute-force u8 kNN: the base's centered channels scanned
    `block` rows at a time (one int8 GEMM each) with a running top-k.
    Returns ((B, k) f32 ascending, (B, k) int32 ids), -1 where fewer than k
    rows exist; ties go to the lower id."""
    D.check_dist(dist)
    B = queries_u8.shape[0]
    dev = base8.device
    q8, qip, qs8 = u8_channels(queries_u8.to(dev))
    n = min(int(n_valid), base8.shape[0])
    best_d = torch.full((B, k), float("inf"), device=dev)
    best_i = torch.full((B, k), INVALID_ID, dtype=torch.int32, device=dev)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        dot = dots_u8(q8, qs8, base8[r0:r1], base_s8[r0:r1])
        d = _dist_from_dot(dot, qip, base_ip[r0:r1], dist)
        kk = min(k, r1 - r0)
        td, pos = smallest_positions(d, kk)
        best_d, best_i = merge_topk(best_d, best_i, td, (pos + r0).to(torch.int32), k)
    return best_d, torch.where(torch.isfinite(best_d), best_i, INVALID_ID)


def find_nearest_u8(vectors_u8: torch.Tensor, centroids_u8: torch.Tensor, dist: str) -> torch.Tensor:
    """Nearest-u8-centroid ids (N,) int32, ties to the lowest index
    (k_means.rs:40-57)."""
    return pairwise_u8(vectors_u8, centroids_u8, dist).argmin(1).to(torch.int32)


def kmeanspp_init_u8(data_u8: torch.Tensor, n_valid: int, k: int, dist: str,
                     generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeds -> (k, dim) uint8: data rows, so exactly
    representable.  The first is a uniform valid row; each next one is drawn
    with probability proportional to its exact u8 distance to the nearest
    seed so far (uniform over the valid rows when every such distance is
    0, k_means.rs:80-82)."""
    D.check_dist(dist)
    n_pad = data_u8.shape[0]
    dev = data_u8.device
    valid = torch.arange(n_pad, device=dev) < n_valid
    first = int(torch.randint(0, max(int(n_valid), 1), (1,), generator=generator, device=dev)[0])
    cent = torch.zeros((k, data_u8.shape[1]), dtype=torch.uint8, device=dev)
    cent[0] = data_u8[first]
    weight = torch.full((n_pad,), float("inf"), device=dev)
    for i in range(1, k):
        weight = torch.minimum(weight, pairwise_u8(data_u8, cent[i - 1 : i], dist)[:, 0])
        w = torch.where(valid & torch.isfinite(weight) & (weight > 0.0), weight, 0.0)
        probs = w if bool(w.sum() > 0.0) else valid.float()
        cent[i] = data_u8[int(torch.multinomial(probs, 1, generator=generator)[0])]
    return cent


def lloyd_u8(data_u8: torch.Tensor, n_valid: int, centroids_u8: torch.Tensor, max_iter: int, tol: float,
             dist: str) -> torch.Tensor:
    """Lloyd iterations from u8 `centroids_u8` -> (k, dim) uint8.

    Each round assigns every valid row to its nearest centroid (exact u8
    distances, ties to the lowest index), sums the clusters in f32, casts
    each mean back to u8 by truncation and saturation, keeps an empty
    cluster's centroid, and stops after `max_iter` rounds or once the
    largest squared move of a QUANTIZED centroid is below `tol`
    (k_means.rs:113-160)."""
    D.check_dist(dist)
    c = centroids_u8.clone()
    k, dim = c.shape
    dev = data_u8.device
    n = min(int(n_valid), data_u8.shape[0])
    for _ in range(max_iter):
        c8, cip, cs8 = u8_channels(c)
        counts = torch.zeros(k, dtype=torch.float32, device=dev)
        sums = torch.zeros((k, dim), dtype=torch.float32, device=dev)
        for r0 in range(0, n, _ROWS):
            blk = data_u8[r0 : min(r0 + _ROWS, n)]
            b8, bip, bs8 = u8_channels(blk)
            a = _dist_from_dot(dots_u8(b8, bs8, c8, cs8), bip, cip, dist).argmin(1)
            counts.index_add_(0, a, torch.ones(len(blk), device=dev))
            sums.index_add_(0, a, blk.float())
        mean = sums / counts.clamp_min(1.0)[:, None]
        new_u8 = mean.trunc().clamp_(0.0, 255.0).to(torch.uint8)
        new_c = torch.where(counts[:, None] > 0, new_u8, c)
        diff = float(((new_c.float() - c.float()) ** 2).sum(1).max())
        c = new_c
        if diff < tol:
            break
    return c


def kmeans_fit_u8(data_u8: torch.Tensor, n_valid: int, k: int, max_iter: int, tol: float, dist: str,
                  generator: torch.Generator) -> torch.Tensor:
    """Fit k u8 centroids -> (k, dim) uint8: `kmeanspp_init_u8` then
    `lloyd_u8` (the reference's `kmeans_fit_u8`, k_means.rs:95-162)."""
    init = kmeanspp_init_u8(data_u8, n_valid, k, dist, generator)
    return lloyd_u8(data_u8, n_valid, init, max_iter, tol, dist)
