"""Product quantization (port of lab_1806_vec_db_tpu/ops/pq.py).

The reference's PQ/ADC machinery (src/distance/pq_table.rs):
- the uneven `div_ceil` group split over dim (pq_table.rs:38-53);
- codebook training as one batched k-means over the m zero-padded subspace
  slices (pq_table.rs:141-191 trains each group on a dim slice; padding the
  slice axis to the widest group lets all groups train together);
- encode: per-group distance GEMM + argmin -> (N, m) uint8 codes
  (pq_table.rs:66-91); 4-bit codes pack two per byte, low nibble first;
- the per-query lookup table: partial squared distances (l2sqr) or partial
  dot products (cosine) (pq_table.rs:195-224);
- ADC: the sum of table entries picked by the codes, with the cosine norm
  rebuilt from cached centroid squared norms (pq_table.rs:239-301).

`adc_scan` here is the plain f32 gather form: the ordering self-test's scan
and the tests' oracle.  Search goes through `ops/adc.py` (kernels K7-K9).
Zero-padding the subspace axis is distance-transparent.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kmeans as KM
from . import topk as T


def pq_groups(dim: int, m: int) -> list[tuple[int, int]]:
    """Uneven group split, the rule of pq_table.rs:38-53."""
    if not (dim > 0 and m > 0 and dim >= m):
        raise ValueError(f"need 0 < m <= dim, got dim={dim}, m={m}")
    groups = []
    current = 0
    while current < dim:
        remaining_groups = m - len(groups)
        group_size = -(-(dim - current) // remaining_groups)  # div_ceil
        groups.append((current, current + group_size))
        current += group_size
    return groups


def group_gather_indices(dim: int, m: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(m, dsub_max) gather indices into the dim axis + validity mask."""
    groups = pq_groups(dim, m)
    dsub_max = max(e - s for s, e in groups)
    idx = np.zeros((m, dsub_max), dtype=np.int64)
    mask = np.zeros((m, dsub_max), dtype=bool)
    for g, (s, e) in enumerate(groups):
        w = e - s
        idx[g, :w] = np.arange(s, e)
        mask[g, :w] = True
    return idx, mask, dsub_max


def regroup(data: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, dim) -> (m, N, dsub_max) zero-padded subspace slices."""
    sliced = data[:, idx]  # (N, m, dsub_max)
    sliced = torch.where(mask[None], sliced, 0.0)
    return sliced.permute(1, 0, 2).contiguous()


def train_codebooks(grouped: torch.Tensor, n_valid: int, k: int, max_iter: int, tol: float,
                    dist: str, generator: torch.Generator) -> torch.Tensor:
    """All m codebooks in one batched k-means: (m, N, dsub) -> (m, k, dsub)."""
    init = KM.kmeanspp_init(grouped, n_valid, k, dist, generator)
    return KM.lloyd(grouped, n_valid, init, max_iter, tol, dist)


def encode(grouped: torch.Tensor, codebooks: torch.Tensor, dist: str) -> torch.Tensor:
    """(m, N, dsub) x (m, k, dsub) -> (N, m) uint8 codes (nearest centroid
    per subspace, ties to the lowest index)."""
    codes = KM._pairwise_b(grouped.float(), codebooks.float(), dist).argmin(-1)  # (m, N)
    return codes.T.to(torch.uint8)


def build_lookup(q_grouped: torch.Tensor, codebooks: torch.Tensor, dist: str) -> torch.Tensor:
    """Per-query lookup table: (m, B, dsub) x (m, k, dsub) -> (B, m, k).
    l2sqr entries are partial squared distances, cosine entries partial dot
    products (pq_table.rs:204-213)."""
    cb = codebooks.float()
    qg = q_grouped.float()
    dots = torch.bmm(qg, cb.transpose(1, 2)).permute(1, 0, 2)  # (B, m, k)
    if dist == "cosine":
        return dots.contiguous()
    q_sq = (qg * qg).sum(-1)  # (m, B)
    c_sq = (cb * cb).sum(-1)  # (m, k)
    d = q_sq.T[:, :, None] + c_sq[None, :, :] - 2.0 * dots
    return d.clamp_min(0.0)


def centroid_sqnorm_cache(codebooks: torch.Tensor) -> torch.Tensor:
    """(m, k) dot(c, c) cache for the cosine norm (pq_table.rs:163-170)."""
    cb = codebooks.float()
    return (cb * cb).sum(-1)


def adc_lookup_codes(codes: torch.Tensor, lookup: torch.Tensor, cb_sqnorm, dist: str,
                     q_norms=None) -> torch.Tensor:
    """ADC distances for per-query candidate code lists: codes (B, C, m),
    lookup (B, m, k), q_norms (B,) (cosine) -> (B, C) f32 (the scalar loop
    of pq_table.rs:252-299)."""
    B, C, m = codes.shape
    k = lookup.shape[-1]
    flat_idx = codes.long() + torch.arange(m, device=codes.device) * k  # (B, C, m)
    g = torch.gather(lookup.reshape(B, m * k), 1, flat_idx.reshape(B, C * m))
    s = g.reshape(B, C, m).sum(-1)
    if dist == "l2sqr":
        return s
    c_sq = cb_sqnorm.reshape(-1)[flat_idx].sum(-1)
    return 1.0 - s / (c_sq.sqrt() * q_norms[:, None]).clamp_min(1e-10)


def adc_scan(lookup: torch.Tensor, codes: torch.Tensor, n_valid: int, cb_sqnorm: torch.Tensor,
             q_norms: torch.Tensor, k_out: int, dist: str, block: int | None = None):
    """Full f32 ADC scan + top-k over (N, m) unpacked codes, blocked so the
    (B, block, m) gather stays near 512 MB (flat_index.rs:84-104).
    Returns ((B, k_out) f32 ascending, (B, k_out) int32 ids), -1 padded."""
    B, m, k = lookup.shape
    n_pad = codes.shape[0]
    if block is None:
        block = max(128, (1 << 27) // max(B * m, 1))
    lut_flat = lookup.reshape(B, m * k)
    offs = torch.arange(m, device=codes.device) * k
    cb_flat = cb_sqnorm.reshape(-1)
    best_d = torch.full((B, 0), float("inf"), device=lookup.device)
    best_i = torch.full((B, 0), -1, dtype=torch.int32, device=lookup.device)
    for start in range(0, n_pad, block):
        tile = codes[start : start + block]
        flat_idx = tile.long() + offs[None, :]  # (nb, m)
        s = lut_flat[:, flat_idx].sum(-1)  # (B, nb)
        if dist == "l2sqr":
            d = s
        else:
            norm0 = cb_flat[flat_idx].sum(-1).sqrt()[None, :]
            d = 1.0 - s / (norm0 * q_norms[:, None]).clamp_min(1e-10)
        ids = torch.arange(start, start + tile.shape[0], dtype=torch.int32, device=d.device)
        d = torch.where(ids[None, :] < n_valid, d, float("inf"))
        best_d, best_i = T.merge_topk(best_d, best_i, d, ids.expand(B, -1), k_out)
    return T._pad_k(best_d, best_i, k_out)


def pack_codes_4bit(codes: np.ndarray) -> np.ndarray:
    """(N, m) 4-bit codes -> (N, ceil(m/2)) bytes, low nibble first
    (pq_table.rs:74-83)."""
    n, m = codes.shape
    if m % 2 == 1:
        codes = np.concatenate([codes, np.zeros((n, 1), dtype=codes.dtype)], axis=1)
    lo = codes[:, 0::2].astype(np.uint8)
    hi = codes[:, 1::2].astype(np.uint8)
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_codes_4bit(packed: np.ndarray, m: int) -> np.ndarray:
    """(N, ceil(m/2)) packed bytes -> (N, m) codes (pq_table.rs:55-65)."""
    out = np.empty((packed.shape[0], packed.shape[1] * 2), dtype=np.uint8)
    out[:, 0::2] = packed & 0xF
    out[:, 1::2] = packed >> 4
    return out[:, :m]


def unpack_codes_4bit_dev(packed: torch.Tensor, m: int) -> torch.Tensor:
    """Device-side nibble unpack: (..., ceil(m/2)) bytes -> (..., m) uint8."""
    p = packed.to(torch.uint8)
    out = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(*p.shape[:-1], p.shape[-1] * 2)
    return out[..., :m]
