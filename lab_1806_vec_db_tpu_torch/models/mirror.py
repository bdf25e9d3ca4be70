"""The int8 scan mirrors that K1 reads (`ops/scan.py`), and their format.

A `ScanMirror` is (rows, lanes) int8 rows, lanes the width rounded up to a
multiple of 128 (zero lanes are dot-transparent), and two (rows,) f32
channels.  Its four rules live here alone:

- layout: mirror row i holds original row perm[i].  The full tier's int8
  mirror takes `scan_perm(cap)`, the reference's seeded permutation, so
  the same rows give the same bytes: K1 keeps one survivor per strided
  128-row group, which a cluster-sorted storage order would starve
  ("scan").  A lean ingest may give its own order ("sorted", IVF's).  The
  PCA mirror is in row order (perm None, "rows");
- channels: `quantize`, K1's unified convention (cosine: scale s/|x|,
  cache 0); the PCA mirror quantizes rows projected through its fixed fit;
- sentinels: a row holding no valid row has scale 0 and cache +_BIG, so it
  loses every comparison (K1 has no positional mask);
- decoding: `decode` maps survivors back through perm, dropping ids >= n.

`U8Mirror` is the uint8 tables' mirror (`models/u8.py`), for the exact
integer variant of K1 (`ops/scan.py`'s module doc), a type of its own: row order,
the rows centred by 128 (x8 = u - 128), int32 channels n8 = |x8|^2 and s8 =
sum(x8) (the library path's), its rows a whole number of K1's chunks; a
row holding no valid row is a zero row at n8 = `S.U8_SENTINEL`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import distance as D
from ..ops import project as PJ
from ..ops import scan as S
from ..ops import topk as T
from ..ops import u8 as U8
from ..ops.scan import _BIG

_BLOCK_ROWS = 65536  # rows per block of a build: bounds its transients
_U8_BLOCK_ROWS = 262144  # rows per block of a uint8 mirror's build (its int32 transients: 128 MB at 128 lanes)


def scan_perm(cap: int) -> np.ndarray:
    return np.random.default_rng(cap ^ 0x5EED).permutation(cap).astype(np.int32)


def quantize(x: torch.Tensor, cache: torch.Tensor, lanes: int, dist: str):
    """Rows and their `D.dist_cache` -> (q8 (rows, lanes) int8, scale, cache)."""
    q8, scale = T.quantize_rows_int8(x)
    if lanes != q8.shape[1]:
        q8 = torch.nn.functional.pad(q8, (0, lanes - q8.shape[1]))
    if dist == "cosine":
        return q8, scale / cache.clamp_min(1e-20), torch.zeros_like(cache)
    return q8, scale, cache


def project_quantize(x: torch.Tensor, proj: torch.Tensor, mu: torch.Tensor, dist: str):
    """`quantize` of the rows projected through a PCA fit (`PJ.project`)."""
    xp = PJ.project(x, proj, mu)
    return quantize(xp, D.dist_cache(xp, dist), PJ.proj_lanes(proj.shape[1]), dist)


def _sentinel(valid: torch.Tensor, scale: torch.Tensor, cache: torch.Tensor):
    return torch.where(valid, scale, 0.0), torch.where(valid, cache, _BIG)


class ScanMirror:
    """`q8`, `scale`, `cache`, `perm` ((rows,) int32 on the device, or None)
    and the PCA mirror's fit `proj` (dim, d_red) and `mu` (dim,); `n` valid
    original rows.  Unpacks as (q8, scale, cache, perm), the JAX tuple."""

    def __init__(self, dist: str, n: int, perm: np.ndarray | None, layout: str, device,
                 proj=None, mu=None):
        """The permutation (uploaded before the rows) and its host inverse;
        `build` and `empty` make the rows and channels."""
        self.dist, self.n, self.proj, self.mu = dist, int(n), proj, mu
        self.layout = "rows" if perm is None else layout
        self.perm = self.inv = None  # inv: original row -> mirror row
        if perm is not None:
            self.perm = torch.from_numpy(perm).to(device)
            self.inv = np.empty(len(perm), np.int32)
            self.inv[perm] = np.arange(len(perm), dtype=np.int32)

    @classmethod
    def build(cls, vecs, cache, n: int, dist: str, perm: np.ndarray | None = None, proj=None, mu=None):
        """The mirror of the (cap, dim) f32 rows `vecs` (with their cache),
        the first `n` valid, built one block of mirror rows at a time."""
        cap, dev = vecs.shape[0], vecs.device
        m = cls(dist, n, perm, "scan", dev, proj, mu)
        m.q8 = torch.empty((cap, PJ.proj_lanes(vecs.shape[1] if proj is None else proj.shape[1])),
                           dtype=torch.int8, device=dev)
        m.scale = torch.empty(cap, dtype=torch.float32, device=dev)
        m.cache = torch.empty(cap, dtype=torch.float32, device=dev)
        for s0 in range(0, cap, _BLOCK_ROWS):
            s1 = min(s0 + _BLOCK_ROWS, cap)
            src = slice(s0, s1) if m.perm is None else m.perm[s0:s1].long()
            q8v, scv, cav = m._quantize(vecs[src], cache[src])
            m.q8[s0:s1], m.scale[s0:s1], m.cache[s0:s1] = q8v, scv, cav
        # `_sentinel` a channel at a time: each old channel goes before the next is made
        valid = m._orig() < n
        m.scale = torch.where(valid, m.scale, 0.0)
        m.cache = torch.where(valid, m.cache, _BIG)
        return m

    @classmethod
    def empty(cls, cap: int, lanes: int, dist: str, n: int, perm: np.ndarray, layout: str, device):
        """A mirror of sentinels only, for `write_rows` to fill."""
        m = cls(dist, n, perm, layout, device)
        m.q8 = torch.zeros((cap, lanes), dtype=torch.int8, device=device)
        m.scale = torch.zeros(cap, dtype=torch.float32, device=device)
        m.cache = torch.full((cap,), _BIG, dtype=torch.float32, device=device)
        return m

    def __iter__(self):
        return iter((self.q8, self.scale, self.cache, self.perm))

    @property
    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.q8, self.scale, self.cache, self.perm, self.proj, self.mu) if t is not None]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)

    def _quantize(self, x, cache):
        if self.proj is not None:
            return project_quantize(x, self.proj, self.mu, self.dist)
        return quantize(x, cache, self.q8.shape[1], self.dist)

    def _orig(self) -> torch.Tensor:  # the original row of each mirror row
        return self.perm if self.perm is not None else torch.arange(len(self.scale), device=self.q8.device)

    def _rows(self, ids: np.ndarray) -> torch.Tensor:  # the mirror rows of original rows
        rows = ids if self.inv is None else self.inv[ids]
        return torch.from_numpy(rows.astype(np.int64)).to(self.q8.device)

    def write_rows(self, rows: np.ndarray, vals: torch.Tensor, cache_v: torch.Tensor, n: int) -> None:
        """Write original rows `rows` (host ids) from their f32 values and
        cache in place; rows >= `n` become sentinels."""
        slots = self._rows(rows)
        q8v, scv, cav = self._quantize(vals, cache_v)
        scv, cav = _sentinel(torch.from_numpy(rows < n).to(self.q8.device), scv, cav)
        self.q8.index_copy_(0, slots, q8v)
        self.scale.index_copy_(0, slots, scv)
        self.cache.index_copy_(0, slots, cav)
        self.n = int(n)

    def take(self, ids: np.ndarray, valid: torch.Tensor | None = None):
        """(q8, scale, cache) of original rows `ids` (host ids), gathered in
        that order; sentinels where the device mask `valid` is False."""
        rows = self._rows(ids)
        q8, scale, cache = self.q8[rows], self.scale[rows], self.cache[rows]
        return (q8, scale, cache) if valid is None else (q8, *_sentinel(valid, scale, cache))

    def survivors(self, q: torch.Tensor, r: int, n_valid: int | None = None):
        """Stage 1: the queries (projected on the PCA mirror) quantized, K1,
        the exact top-r survivors -> ((B, r) f32, (B, r) int32 mirror rows,
        -1 padded) for `decode`.  `n_valid` masks the rows >= n_valid for
        this call alone (two (rows,) channel copies, made only if it cuts)."""
        scale, cache = self.scale, self.cache
        if n_valid is not None and n_valid < self.n:
            scale, cache = _sentinel(self._orig() < n_valid, scale, cache)
        if self.proj is not None:
            q = PJ.project(q, self.proj, self.mu)
        return S.scan_candidates_int8_packed(q, self.q8, scale, cache, r, self.dist)

    def decode(self, cand: torch.Tensor, n: int) -> torch.Tensor:
        """Mirror rows -> original row ids, -1 where < 0 or >= n."""
        if self.perm is None:
            return torch.where(cand < n, cand, T.INVALID_ID)
        return T.decode_perm(cand, self.perm, n)


class U8Mirror:
    """The uint8 mirror, a type of its own (it shares no channel, sentinel
    or search rule with `ScanMirror`): `q8` (rows, lanes) int8 the centred
    rows, zero past `n` and past the width `dim`; `cache` (rows,) int32 n8,
    U8_SENTINEL past `n`; `s8` (rows,) int32; rows a multiple of 2048 (K1
    pads nothing); in row order, so a mirror row is its original row.  `ip`
    (|u|^2, for the library path) is made on first use."""

    def __init__(self, dist: str, n: int, dim: int):
        self.dist, self.n, self.dim = dist, int(n), int(dim)
        self.q8 = self.cache = self.s8 = self._ip = None

    @classmethod
    def build(cls, rows: torch.Tensor, n: int, dist: str, device) -> "U8Mirror":
        """The mirror of the first `n` uint8 `rows` ((>= n, dim), on the host
        or the device), built `_U8_BLOCK_ROWS` rows at a time: no copy of the
        whole table in a wider type."""
        dim = rows.shape[1]
        m = cls(dist, n, dim)
        n_rows = max(1, -(-int(n) // S._NB)) * S._NB
        m.q8 = torch.zeros((n_rows, PJ.proj_lanes(dim)), dtype=torch.int8, device=device)
        m.cache = torch.full((n_rows,), S.U8_SENTINEL, dtype=torch.int32, device=device)
        m.s8 = torch.zeros(n_rows, dtype=torch.int32, device=device)
        for r0 in range(0, int(n), _U8_BLOCK_ROWS):
            r1 = min(r0 + _U8_BLOCK_ROWS, int(n))
            x8 = U8.centre(rows[r0:r1].to(device))
            m.q8[r0:r1, :dim] = x8
            m.cache[r0:r1], m.s8[r0:r1] = U8.centred_sums(x8)
        return m

    @property
    def tensors(self) -> list[torch.Tensor]:
        return [t for t in (self.q8, self.cache, self.s8, self._ip) if t is not None]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors)

    def channels(self):
        """(x8 (rows, dim) int8, ip (rows,) int32, s8 (rows,) int32): the
        library path's (`ops/u8.py:knn_scan_u8`) view; ip is 2^30 past n."""
        if self._ip is None:
            ip = U8.ip_from_centred(self.cache, self.s8, self.dim)
            self._ip = torch.where(torch.arange(len(ip), device=ip.device) < self.n, ip, 2**30).to(torch.int32)
        return self.q8[:, : self.dim], self._ip, self.s8

    def host_rows(self) -> np.ndarray:
        """The first n rows as host uint8, from the centred rows (exact)."""
        return self.q8[: self.n, : self.dim].view(torch.uint8).bitwise_xor(128).cpu().numpy()

    def queries(self, q_u8: torch.Tensor):
        """(B, dim) uint8 queries -> (q8 (B, lanes) int8 centred, qn8 (B,) int32)."""
        q8 = U8.centre(q_u8)
        qn8, _ = U8.centred_sums(q8)
        lanes = self.q8.shape[1]
        if lanes != q8.shape[1]:
            q8 = torch.nn.functional.pad(q8, (0, lanes - q8.shape[1]))
        return q8.contiguous(), qn8

    def survivors(self, q8: torch.Tensor, qn8: torch.Tensor, r: int):
        """Stage 1: the uint8 stage 1 kernel and the exact top-r groups ->
        ((B, r) f32 values of no use here, (B, r) int32 rows of each group's
        minimum)."""
        return S.select_survivors(S.scan_chunkmin_u8_packed(q8, qn8, self.q8, self.cache), r)

    def rescan(self, q8: torch.Tensor, qn8: torch.Tensor, cand: torch.Tensor, k: int):
        """The exact top-k over the rows of the groups `cand` -> ((B, k) f32,
        (B, k) int32 mirror rows)."""
        return S.rescan_u8_groups(q8, qn8, self.q8, self.cache, S.u8_group_rows(cand), k)

    def decode(self, rows: torch.Tensor) -> torch.Tensor:
        """Mirror rows -> original row ids (the same, row order), -1 at >= n."""
        return torch.where(rows < self.n, rows, T.INVALID_ID)
