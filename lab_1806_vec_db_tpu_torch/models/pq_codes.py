"""PQ codes-resident index: serve kNN from PQ codes alone (port of
models/pq_codes.py).

The scale tier: the device holds 4-bit PQ codes (160 B/row at m = 320), a
small coarse code table (16 B/row at coarse_m = 32) and an 8 B/row
permutation, never the f32 rows; exact rows are regenerated from the row
source on demand.  Search is three stages:

  stage 0  K7 (`ops/adc.py:adc_scan_chunkmin`) over the coarse codes of
           every row, with a chunk that shrinks at small N so the n / chunk
           survivors stay >= 8 c0, then the top-c0 pool per query;
  stage 1  K8 in its ids shape (`adc_dists_for_ids`, bf16 LUT) over the
           main codes of the pooled candidates, gathered through the
           inverse permutation, then the top-ef;
  refine   exact f32 distances of the ef finalists from the row source
           (`refine_blocked`), a candidate without one keeping its ADC
           distance, then the exact top-k.

Both code tables live on the device under one seeded permutation of the
VALID rows (capacity padding stays at the tail, so K7's position mask is
the validity mask); the chunk-min survivors need de-clustered storage order.

Layout: the device codes are row-major (rows, cw) uint8, the coarse table's
cw padded to a multiple of 4 bytes (K7 reads 4-byte words; zero bytes are
code 0 of zero LUT columns).  The reference keeps the coarse codes
transposed at rest, (cw, rows) int8, so that a 16-byte row is not padded to
the TPU's 128-byte lanes; the H100 has no lane padding.  `load` takes
either layout; `save` writes row-major uint8 with `codes_c_transposed`
False, which the reference loads and searches as it is.

No counterpart here: the reference's `traced_gen` source and its
`_refine_traced_jit`, the block-keyed one-program refine with a static
per-block window S (its spill past S is why the per-element ADC fallback
exists).  A block source goes through `fill`, which never spills; the
fallback stays for candidates without an exact row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import adc as A
from ..ops import pq as P
from ..ops import topk as T
from ..utils import serde
from ..utils.config import PQConfig
from ..utils.device import resolve
from .pq_table import PQTable

_BLOCK = 131072
_CAP_MULT = 16384  # capacity granule of the permuted code tables
_ENCODE_ELEMS = 1 << 26  # elements of the (m, rows, k) distance transient of one encode step


def _cw4(cw: int) -> int:
    return -(-cw // 4) * 4


def pack_encode(pq: PQTable, v: torch.Tensor) -> torch.Tensor:
    """(rows, dim) rows in the original space -> (rows, ceil(m / 2)) uint8
    packed 4-bit codes (the table's transform, nearest centroid per group,
    low nibble first), in row steps that bound the distance transient: the
    encode of the reference's `_pack_scatter_jit`."""
    m = pq.config.m
    _, cb, _ = pq.device()
    step = max(256, _ENCODE_ELEMS // (m * pq.k))
    out = torch.empty((v.shape[0], (m + 1) // 2), dtype=torch.uint8, device=v.device)
    for s in range(0, v.shape[0], step):
        c = P.encode(P.regroup(pq._transform(v[s : s + step]), pq._gidx, pq._gmask), cb,
                     pq.config.dist)
        if m % 2:
            c = torch.nn.functional.pad(c, (0, 1))
        out[s : s + c.shape[0]] = c[:, 0::2] | (c[:, 1::2] << 4)
    return out


def _rows(x, dev) -> torch.Tensor:
    """A row source's output (a tensor or a numpy array) as f32 on `dev`."""
    return torch.as_tensor(x).to(dev, torch.float32)


def sample_rows_from_fill(fill, n: int, sample_rows: int, block_rows: int, dev) -> torch.Tensor:
    """The training sample of the codes tiers: strided rows of up to 8 blocks
    spread over [0, n) (the reference's `np.linspace` choice)."""
    n_blocks = -(-n // block_rows)
    blocks = sorted({int(b) for b in np.linspace(0, n_blocks - 1, min(8, n_blocks))})
    per = -(-sample_rows // len(blocks))
    parts = []
    for b in blocks:
        row0 = b * block_rows
        v = _rows(fill(row0, min(block_rows, n - row0)), dev)
        parts.append(v[:: max(1, v.shape[0] // per)][:per])
    return torch.cat(parts)[:sample_rows]


def refine_blocked(fill, block_rows: int, n: int, dim: int, dist: str, q: torch.Tensor,
                   ids: torch.Tensor, row_gen=None):
    """Exact f32 distances of the (B, ef) candidate ids (+inf where -1), or
    None when no exact row source exists (ADC distances then stand).

    Shared by both codes tiers.  `row_gen(ids) -> rows` regenerates exactly
    the candidate rows; else `fill(row0, rows)` regenerates each block that
    holds a candidate.  l2sqr is the sum of squared differences (no cached
    norms), so a returned distance is exact f32 of its row."""
    B, ef = ids.shape
    dev = q.device
    flat = ids.reshape(-1)
    valid = flat >= 0
    if row_gen is not None:
        rows = _rows(row_gen(flat.clamp_min(0)), dev)
    elif fill is not None:
        rows = torch.zeros((flat.shape[0], dim), dtype=torch.float32, device=dev)
        flat_h = flat.cpu().numpy()
        for b in np.unique(flat_h[flat_h >= 0] // block_rows):
            row0 = int(b) * block_rows
            sel = torch.from_numpy(np.flatnonzero((flat_h >= row0) & (flat_h < row0 + block_rows))).to(dev)
            v = _rows(fill(row0, min(block_rows, n - row0)), dev)
            rows[sel] = v[(flat[sel] - row0).long()]
    else:
        return None
    rows = rows.reshape(B, ef, dim)
    qf = q.float()
    if dist == "cosine":
        dots = torch.einsum("bd,bed->be", qf, rows)
        rn = torch.linalg.vector_norm(rows, dim=-1)
        qn = torch.linalg.vector_norm(qf, dim=-1, keepdim=True)
        d = 1.0 - dots / (qn * rn).clamp_min(1e-10)
    else:
        d = ((rows - qf[:, None, :]) ** 2).sum(-1)
    return torch.where(valid.reshape(B, ef), d, float("inf"))


class PQCodesIndex:
    """Codes-resident kNN index (see the module docstring)."""

    def __init__(self, pq: PQTable, coarse: PQTable, n: int, dim: int, dist: str, fill=None,
                 row_gen=None, block_rows: int = _BLOCK, device="cuda"):
        self.pq = pq
        self.coarse = coarse
        self.n = int(n)
        self.dim = int(dim)
        self.dist = dist
        self.torch_device = resolve(device)
        self._fill = fill
        self._row_gen = row_gen
        self._block_rows = int(block_rows)
        self._codes: torch.Tensor | None = None  # (cap, ceil(m/2)) uint8, PERMUTED
        self._codes_c: torch.Tensor | None = None  # (cap, cw4) coarse, same permutation
        self._perm: torch.Tensor | None = None  # (cap,) int32 position -> row id
        self._inv: torch.Tensor | None = None  # (cap,) int32 row id -> position

    def _set_perm(self, perm: np.ndarray) -> None:
        inv = np.empty(len(perm), np.int32)
        inv[perm] = np.arange(len(perm), dtype=np.int32)
        self._perm = torch.from_numpy(np.ascontiguousarray(perm, np.int32)).to(self.torch_device)
        self._inv = torch.from_numpy(inv).to(self.torch_device)

    # ---- build ----
    @classmethod
    def build_from_fill(cls, fill, n: int, dim: int, dist: str, pq_config: PQConfig | None = None,
                        coarse_m: int = 32, sample_rows: int = 25_000, seed: int = 0,
                        block_rows: int = _BLOCK, row_gen=None, device="cuda") -> "PQCodesIndex":
        """Stream `fill(row0, rows)` (its rows moved to `device`): train both
        PQ tables on a strided multi-block sample (the coarse one rotated),
        then encode every block into the permuted packed code tables and
        drop the f32 rows.  Device cost per row: ceil(m/2) + cw4(ceil(mc/2))
        + 8 bytes."""
        if pq_config is None:
            pq_config = PQConfig(n_bits=4, m=320, dist=dist, k_means_size=sample_rows)
        if pq_config.n_bits != 4:
            raise ValueError("the codes tier serves 4-bit (packed) tables")
        dev = resolve(device)
        sample = sample_rows_from_fill(fill, n, sample_rows, block_rows, dev)
        pq = PQTable.train(sample, pq_config, seed=seed)
        # the coarse table always trains rotated: its subspaces are wide and
        # unrotated ADC ordering collapses on correlated data
        ccfg = PQConfig(n_bits=4, m=coarse_m, dist=dist, k_means_size=pq_config.k_means_size,
                        rotate=True)
        coarse = PQTable.train(sample, ccfg, seed=seed + 1)
        del sample

        self = cls(pq, coarse, n, dim, dist, fill=fill, row_gen=row_gen, block_rows=block_rows,
                   device=dev)
        cap = -(-n // _CAP_MULT) * _CAP_MULT
        # permute the valid rows only: K7 masks by position < n
        self._set_perm(np.concatenate([np.random.default_rng(cap ^ 0xC0DE5).permutation(n),
                                       np.arange(n, cap)]).astype(np.int32))
        cw, cwc = (pq.config.m + 1) // 2, (coarse_m + 1) // 2
        codes = torch.zeros((cap, cw), dtype=torch.uint8, device=dev)
        codes_c = torch.zeros((cap, _cw4(cwc)), dtype=torch.uint8, device=dev)
        for row0 in range(0, n, block_rows):
            rows = min(block_rows, n - row0)
            v = _rows(fill(row0, rows), dev)
            slots = self._inv[row0 : row0 + rows].long()
            codes[slots] = pack_encode(pq, v)
            codes_c[slots, :cwc] = pack_encode(coarse, v)
            del v
        self._codes, self._codes_c = codes, codes_c
        return self

    def __len__(self) -> int:
        return self.n

    def index_bytes(self) -> int:
        total = self.pq.device_bytes() + self.coarse.device_bytes()
        for t in (self._codes, self._codes_c, self._perm, self._inv):
            if t is not None:
                total += t.numel() * t.element_size()
        return total

    # ---- serde (the reference's external-vec-set shape: codes persist,
    # the row source re-attaches on load) ----
    def save(self, path) -> None:
        cwc = (self.coarse.config.m + 1) // 2
        arrays = {"codes": self._codes.cpu().numpy(),
                  "codes_c": np.ascontiguousarray(self._codes_c[:, :cwc].cpu().numpy()),
                  "perm": self._perm.cpu().numpy()}
        pq_arrays, pq_meta = self.pq.state()
        arrays.update({"main_" + k: v for k, v in pq_arrays.items()})
        c_arrays, c_meta = self.coarse.state()
        arrays.update({"coarse_" + k: v for k, v in c_arrays.items()})
        meta = {"kind": "pq_codes", "n": self.n, "dim": self.dim, "dist": self.dist,
                "block_rows": self._block_rows, "main": pq_meta["pq"], "coarse": c_meta["pq"],
                "codes_c_transposed": False}
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, fill=None, row_gen=None, device="cuda") -> "PQCodesIndex":
        """Re-attach a saved codes tier (either package's checkpoint).  The
        exact-refine row source (fill / row_gen) is runtime state and must be
        passed back in; without one, results carry ADC distances."""
        arrays, meta = serde.load_arrays(path)
        if meta.get("kind") != "pq_codes":
            raise ValueError(f"{path} is not a PQCodesIndex checkpoint")

        def sub(prefix):
            return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}

        dev = resolve(device)
        pq = PQTable.from_state(sub("main_"), {"pq": meta["main"]}, device=dev)
        coarse = PQTable.from_state(sub("coarse_"), {"pq": meta["coarse"]}, device=dev)
        self = cls(pq, coarse, meta["n"], meta["dim"], meta["dist"], fill=fill, row_gen=row_gen,
                   block_rows=meta["block_rows"], device=dev)
        codes_c = arrays["codes_c"]
        if meta.get("codes_c_transposed", False):
            codes_c = codes_c.T  # (cw, cap) int8 at rest in the reference
        codes_c = np.ascontiguousarray(codes_c).view(np.uint8)
        cwc = codes_c.shape[1]
        self._codes = torch.from_numpy(np.ascontiguousarray(arrays["codes"]).view(np.uint8)).to(dev)
        self._codes_c = torch.nn.functional.pad(torch.from_numpy(codes_c), (0, _cw4(cwc) - cwc)).to(dev)
        self._set_perm(arrays["perm"])
        return self

    # ---- search ----
    def _queries(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            return torch.atleast_2d(queries).to(self.torch_device, torch.float32)
        return torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.torch_device)

    def stage0_chunk(self, c0: int) -> int:
        """Stage 0's chunk: 32, halved (down to 8) while the n / chunk
        survivors would be fewer than 8 c0."""
        chunk = 32
        while chunk > 8 and self.n // chunk < 8 * c0:
            chunk //= 2
        return chunk

    def stage0(self, q: torch.Tensor, c0: int) -> torch.Tensor:
        """The coarse pool: (B, c0) int32 row ids (-1 padded) from K7 over
        every row's coarse codes."""
        lut_c, qn_c = self.coarse.create_lookup(q)
        _, _, cb_sq_c = self.coarse.device()
        _, ids0 = A.adc_scan_chunkmin(lut_c, self._codes_c, self._perm, self.n, cb_sq_c, qn_c, c0,
                                      self.dist, packed=True, chunk=self.stage0_chunk(c0),
                                      selector="approx")
        return ids0

    def stage1(self, q: torch.Tensor, ids0: torch.Tensor, ef: int):
        """Main-table ADC of the pool (K8 ids through the inverse
        permutation) -> the top-ef ((B, ef) ADC distances, int32 row ids)."""
        lut_m, qn_m = self.pq.create_lookup(q)
        _, _, cb_sq_m = self.pq.device()
        pos = torch.where(ids0 >= 0, self._inv[ids0.clamp_min(0).long()], -1)
        d1 = A.adc_dists_for_ids(lut_m, qn_m, self._codes, cb_sq_m, pos, self.dist,
                                 self.pq.config.m, packed=True)
        return T.select_smallest(d1, ids0, ef)

    def refine(self, q: torch.Tensor, ids: torch.Tensor):
        return refine_blocked(self._fill, self._block_rows, self.n, self.dim, self.dist, q, ids,
                              row_gen=self._row_gen)

    def knn_batch(self, queries, k: int, ef: int = 200, c0: int = 2048):
        """(B, dim) queries -> ((B, k) exact-f32 distances ascending, (B, k)
        int32 ids, -1 where missing), on the index's device."""
        q = self._queries(queries)
        c0 = min(c0, self.n)
        ef = min(ef, c0)
        kk = min(k, ef)
        td1, ti1 = self.stage1(q, self.stage0(q, c0), ef)
        d_ex = self.refine(q, ti1)
        # a candidate without an exact row keeps its ADC distance
        d_ex = td1 if d_ex is None else torch.where(torch.isfinite(d_ex), d_ex, td1)
        td, ti = T.topk_smallest(d_ex, ti1, kk)
        return T._pad_k(td, ti, k)
