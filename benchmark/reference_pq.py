"""The plain reference of Flat+PQ search: a PQ table's encode, its ADC
distance and the search that reranks its candidates exactly, in float64.

Plain PyTorch only, on the CPU or the card.  It imports nothing of the
program: given a table's codebooks (m, k, dsub) (and its rotation and centre
where the table has them) and the rows, it works everything out again.
The PQ semantics are the upstream's (lab-1806-vec-db `src/distance/
pq_table.rs`):

- the dim axis splits into m groups of div_ceil widths (`groups`);
- a row's code in a group is its nearest centroid (squared L2, or the
  cosine distance, ties to the lowest index), in the training space:
  (x - centre) @ rotation where the table has them;
- the lookup of a query holds, per group and centroid, the partial squared
  distance (l2sqr) or the partial dot product (cosine);
- ADC: l2sqr, the sum of the entries the codes pick; cosine,
  1 - sum(dots) / (sqrt(sum |c|^2) |q|).

Two plans of the search (k answers, ef candidates):

- `row_plan`, the upstream's `flat_index.rs:84-104`: every row's ADC
  distance, the best max(ef, k) rows (ties to the lower row id), reranked by
  their exact distance (`reference.distances`), the k best;
- `chunk_plan`, the JAX package's accelerator plan, which the port runs: the
  lookup rounded to int8 a query row (s = max|row| / 127, 1 where that is 0;
  q = round half to even of lut / s; the cosine |c|^2 column on a scale of
  its own, floored at 1e-30), the rows in the table's scan permutation
  (position p holds row perm[p], `np.random.default_rng(0xC0DE5)`), one
  candidate per 32 positions (its ADC minimum, the lowest position on ties;
  positions past the rows read +inf, survivors cover ceil(N / 256) * 256
  positions), the best max(ef, k) chunks (a stable order: the lower chunk on
  ties), decoded through perm and reranked exactly.

Both take `codes` and `lut` in place of the reference's own, so that each
step can be held to the program's on the program's inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

CHUNK = 32  # positions per candidate of the chunk plan
SCAN_SEED = 0xC0DE5  # the seed of the table's scan permutation
_TILE = 256  # the chunk plan's survivors cover a whole number of 256-position tiles
_ROW_BLOCK = 32768  # rows per block of an ADC pass (bounds the one-hot)
_QUERY_BLOCK = 128  # queries per block of a plan (bounds its (queries, n) ADC matrix)


def groups(dim: int, m: int) -> list[tuple[int, int]]:
    """The (start, end) of each of the m groups: each takes div_ceil of the
    lanes left over the groups left."""
    out, cur = [], 0
    while cur < dim:
        width = -(-(dim - cur) // (m - len(out)))
        out.append((cur, cur + width))
        cur += width
    return out


class Table:
    """A PQ table's codebooks and transform, in float64 on `device`."""

    def __init__(self, codebooks, dim: int, dist: str, rotation=None, center=None, device="cpu"):
        self.device = torch.device(device)
        f64 = lambda a: None if a is None else torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                                                device=self.device)
        self.codebooks = f64(codebooks)  # (m, k, dsub_max), zero past a group's width
        self.rotation, self.center = f64(rotation), f64(center)
        self.dim, self.dist = int(dim), dist
        self.m, self.k = self.codebooks.shape[:2]
        self.groups = groups(self.dim, self.m)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, torch.float64)
        if self.center is not None:
            x = x - self.center
        return x if self.rotation is None else x @ self.rotation

    def _parts(self, x: torch.Tensor):
        """(n, dim) transformed rows -> each group's (n, width) slice with
        its (k, width) centroids."""
        for g, (s, e) in enumerate(self.groups):
            yield g, x[:, s:e], self.codebooks[g, :, : e - s]

    def encode(self, rows: torch.Tensor, block: int = 65536) -> torch.Tensor:
        """(n, dim) rows -> (n, m) int64 codes."""
        out = torch.empty((rows.shape[0], self.m), dtype=torch.int64, device=self.device)
        for r0 in range(0, rows.shape[0], block):
            x = self.transform(rows[r0 : r0 + block])
            for g, xs, c in self._parts(x):
                if self.dist == "l2sqr":
                    d = ((xs[:, None, :] - c[None, :, :]) ** 2).sum(-1)
                else:
                    den = (xs.norm(dim=1)[:, None] * c.norm(dim=1)[None, :]).clamp_min(1e-10)
                    d = 1.0 - (xs @ c.T) / den
                out[r0 : r0 + block, g] = d.argmin(1)  # the lowest index on ties
        return out

    def lookup(self, queries: torch.Tensor):
        """(B, dim) queries -> ((B, m, k) lookup, (B,) norms of the
        transformed queries, used by cosine)."""
        q = self.transform(queries)
        lut = torch.empty((q.shape[0], self.m, self.k), dtype=torch.float64, device=self.device)
        for g, qs, c in self._parts(q):
            if self.dist == "l2sqr":
                lut[:, g] = ((qs[:, None, :] - c[None, :, :]) ** 2).sum(-1)
            else:
                lut[:, g] = qs @ c.T
        return lut, q.norm(dim=1)

    def centroid_sqnorms(self) -> torch.Tensor:
        """(m, k) |c|^2 of each centroid."""
        return (self.codebooks**2).sum(-1)


def round_lut(lut: torch.Tensor):
    """The chunk plan's int8 lookup: (B, m, k) -> ((B, m, k) integers held in
    float64, (B,) scales); the value of an entry is integer x scale."""
    B = lut.shape[0]
    s = lut.reshape(B, -1).abs().amax(1) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.round(lut / s[:, None, None]), s


def round_column(col: torch.Tensor):
    """The chunk plan's int8 cosine column: (m, k) |c|^2 -> (integers,
    scale)."""
    s = (col.abs().amax() / 127.0).clamp_min(1e-30)
    return torch.round(col / s), s


class Lut:
    """What an ADC pass reads: the (B, m, k) lookup (or its integers) with
    (B,) scales (ones for a float lookup), and for cosine the (m, k) |c|^2
    column (or its integers) with its scale and the (B,) query norms."""

    def __init__(self, values, scales, q_norms, column=None, column_scale=1.0):
        self.values, self.scales, self.q_norms = values.double(), scales.double(), q_norms.double()
        self.column = None if column is None else column.double()
        self.column_scale = column_scale

    @classmethod
    def of(cls, table: Table, queries: torch.Tensor, rounded: bool) -> "Lut":
        """The reference's own lookup of `queries`: float (the row plan), or
        rounded to int8 (the chunk plan)."""
        lut, q_norms = table.lookup(queries)
        col = table.centroid_sqnorms() if table.dist == "cosine" else None
        if not rounded:
            return cls(lut, torch.ones_like(q_norms), q_norms, col)
        values, scales = round_lut(lut)
        if col is None:
            return cls(values, scales, q_norms)
        return cls(values, scales, q_norms, *round_column(col))


def adc(lut: Lut, codes: torch.Tensor, dist: str) -> torch.Tensor:
    """ADC distances (B, n) float64 of (n, m) codes: a one-hot product, in
    which the sums of integers are exact."""
    B, m, k = lut.values.shape
    dev = lut.values.device
    flat = lut.values.reshape(B, m * k).T  # (m k, B)
    out = torch.empty((B, codes.shape[0]), dtype=torch.float64, device=dev)
    offs = torch.arange(m, device=dev) * k
    for r0 in range(0, codes.shape[0], _ROW_BLOCK):
        c = codes[r0 : r0 + _ROW_BLOCK].to(dev, torch.int64) + offs
        oh = torch.zeros((c.shape[0], m * k), dtype=torch.float64, device=dev)
        oh.scatter_(1, c, 1.0)
        s = (oh @ flat).T * lut.scales[:, None]
        if dist == "cosine":
            c_sq = (oh @ lut.column.reshape(-1)) * lut.column_scale
            s = 1.0 - s / (c_sq.clamp_min(0.0).sqrt()[None, :] * lut.q_norms[:, None]).clamp_min(1e-10)
        out[:, r0 : r0 + c.shape[0]] = s
        del oh
    return out


def scan_perm(n: int) -> np.ndarray:
    """The table's scan permutation: position p holds row perm[p]."""
    return np.random.default_rng(SCAN_SEED).permutation(n)


def rerank(rows: torch.Tensor, queries: torch.Tensor, cand: torch.Tensor, k: int, dist: str):
    """The k best of (B, C) candidate rows (-1 absent) by their exact float64
    distance -> ((B, k) float64 ascending, (B, k) int64), the earlier
    candidate first on ties."""
    dev = rows.device
    cand = cand.to(dev, torch.int64)
    q = queries.to(dev)
    d = reference.distances(rows, q, torch.arange(q.shape[0], device=dev), cand, dist)
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(cand, 1, order[:, :k])


def _by_query_block(lut: Lut, plan):
    """Run `plan(lut_block, q0, q1)` -> dict of (b, ...) tensors over blocks
    of `_QUERY_BLOCK` queries (bounds the (b, n) ADC matrix), and join the
    blocks."""
    parts = []
    for q0 in range(0, lut.values.shape[0], _QUERY_BLOCK):
        q1 = min(q0 + _QUERY_BLOCK, lut.values.shape[0])
        col = lut.column
        parts.append(plan(Lut(lut.values[q0:q1], lut.scales[q0:q1], lut.q_norms[q0:q1], col,
                              lut.column_scale), q0, q1))
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def row_plan(table: Table, rows: torch.Tensor, queries: torch.Tensor, k: int, ef: int, codes=None,
             lut: Lut | None = None) -> dict:
    """The upstream's search -> {"cand", "cand_adc" (B, max(ef, k)), "ids",
    "dists" (B, k)}.  `codes` (n, m) and `lut` default to the reference's
    own (`Table.encode`, a float `Lut.of`)."""
    codes = table.encode(rows) if codes is None else codes
    lut = Lut.of(table, queries, rounded=False) if lut is None else lut
    c = min(max(ef, k), rows.shape[0])

    def plan(lb, q0, q1):
        cand_adc, cand = torch.sort(adc(lb, codes, table.dist), dim=1, stable=True)
        cand_adc, cand = cand_adc[:, :c], cand[:, :c]
        dists, ids = rerank(rows, queries[q0:q1], cand, k, table.dist)
        return {"cand": cand, "cand_adc": cand_adc, "ids": ids, "dists": dists}

    return _by_query_block(lut, plan)


def chunk_plan(table: Table, rows: torch.Tensor, queries: torch.Tensor, k: int, ef: int, codes=None,
               lut: Lut | None = None, perm=None) -> dict:
    """The accelerator plan -> {"minima", "min_pos" (B, S): each chunk's ADC
    minimum and its position; "chunks" (B, max(ef, k)) the chunks kept;
    "cand", "cand_adc", "ids", "dists" as `row_plan`'s}.  `codes`, `lut`
    and `perm` default to the reference's own (`Table.encode`, a rounded
    `Lut.of`, `scan_perm`)."""
    n = rows.shape[0]
    codes = table.encode(rows) if codes is None else codes
    lut = Lut.of(table, queries, rounded=True) if lut is None else lut
    dev = lut.values.device
    perm_t = torch.as_tensor(scan_perm(n) if perm is None else np.asarray(perm), dtype=torch.int64).to(dev)
    by_pos = codes.to(dev)[perm_t]
    S = -(-n // _TILE) * _TILE // CHUNK
    c = min(max(ef, k), S)

    def plan(lb, q0, q1):
        d = adc(lb, by_pos, table.dist)  # (b, n) in position order
        d = torch.nn.functional.pad(d, (0, S * CHUNK - n), value=float("inf")).reshape(-1, S, CHUNK)
        minima, arg = d.min(2)  # the first minimum: the lowest position
        del d
        min_pos = torch.arange(S, device=dev)[None, :] * CHUNK + arg
        cand_adc, chunks = torch.sort(minima, dim=1, stable=True)
        cand_adc, chunks = cand_adc[:, :c], chunks[:, :c]
        pos = torch.gather(min_pos, 1, chunks)
        cand = torch.where(torch.isfinite(cand_adc), perm_t[pos.clamp_max(n - 1)], -1)
        dists, ids = rerank(rows, queries[q0:q1], cand, k, table.dist)
        return {"minima": minima, "min_pos": min_pos, "chunks": chunks, "cand": cand,
                "cand_adc": cand_adc, "ids": ids, "dists": dists}

    return _by_query_block(lut, plan)
