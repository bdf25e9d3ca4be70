"""Padded device-resident vector storage (port of models/store.py).

- canonical storage is a host numpy array with geometric capacity growth
  (push / batch_push / swap_remove, the `_round_cap` ladder);
- the device view is a fixed-capacity (cap, dim) f32 tensor plus its
  per-row distance cache, refreshed incrementally: a small write is applied
  as in-place `index_copy_` row writes instead of a re-upload;
- the scan mirrors K1 reads, each a `mirror.ScanMirror` built on first use
  and written row by row after: the permuted int8 mirror (`device_int8`)
  and, in the "pca" scan mode, the PCA-projected one (`device_proj_int8`);
- the rerank rows (`device_rerank`) ARE the f32 device tensor: K2 reads
  rows in place, so the reference's second (cap*SR, 128) slab copy is gone;
- the bf16 traversal copy (`device_traversal`) serves the HNSW graph
  search of the CPU route and the "bf16" scan mode, built on first use.

The LEAN tier (`from_device_blocks`) streams f32 blocks from a generator and
keeps only the int8 mirror (randomly permuted, or any layout the caller
gives, e.g. IVF's cluster-sorted one) and a bf16 (n, dim) rerank tensor
indexed by original id: about 3 bytes a lane instead of the full tier's 9.
Its f32 accessors, mutation and serde raise; exact returned distances come
from regenerating the blocks that hold the result rows (`refine_distances`).
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .mirror import ScanMirror, scan_perm
from ..ops import distance as D
from ..ops import project as PJ
from ..ops import topk as T
from ..utils.device import resolve
from ..utils.profiling import span

_MIN_CAP = 8


_SCAN_MODES = ("int8", "pca", "bf16", "exact")


@dataclass(frozen=True)
class ScanMode:
    """The Flat planner's scan mode (`models/flat.py`).  The store holds it
    (`VecStore.scan_mode`), so every planner over the store reads the same
    value: Flat, and HNSW's scan route.

    `scan` is "int8" (the default), "pca", "bf16" or "exact": the
    reference's VECDB_TPU_SCAN, whose other name for "bf16", "2stage", is
    accepted and stored as "bf16".  `pca_dim` is the "pca" mode's projected
    width (the reference's VECDB_TPU_PCA_DIM).  An unknown mode or a
    pca_dim < 1 raises ValueError."""

    scan: str = "int8"
    pca_dim: int = 256

    def __post_init__(self):
        scan = "bf16" if self.scan == "2stage" else self.scan
        if scan not in _SCAN_MODES:
            raise ValueError(f"unknown scan mode {self.scan!r} (expected one of {_SCAN_MODES} "
                             "or '2stage')")
        if int(self.pca_dim) <= 0:
            raise ValueError(f"pca_dim must be positive, got {self.pca_dim}")
        object.__setattr__(self, "scan", scan)
        object.__setattr__(self, "pca_dim", int(self.pca_dim))


def _round_cap(n: int) -> int:
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


class VecStore:
    # lean-tier state, read through the class defaults by every full-tier
    # construction path: the retained block generator (exact rows)
    _tier = "full"
    _fill = None
    _fill_block_rows = 0
    _dev_rerank: torch.Tensor | None = None  # the lean tier's bf16 rows
    # the planners' scan mode (class default; assigned per store)
    scan_mode = ScanMode()

    def __init__(self, dim: int, dist: str, capacity: int = 0, dtype=np.float32,
                 device="cuda"):
        D.check_dist(dist)
        self.torch_device = resolve(device)
        self.dim = int(dim)
        self.dist = dist
        self.dtype = np.dtype(dtype)
        self._n = 0
        self._cap = _round_cap(max(capacity, _MIN_CAP))
        self._data: np.ndarray | None = np.zeros((self._cap, dim), dtype=self.dtype)
        self._init_device_state()
        self._dev_full_dirty = True

    def _init_device_state(self) -> None:
        self._dev: torch.Tensor | None = None
        self._dev_cache: torch.Tensor | None = None
        self._int8_mirror: ScanMirror | None = None
        self._pca_mirror: ScanMirror | None = None
        self._dev_bf16: torch.Tensor | None = None  # traversal copy
        self._int8_ok: tuple[bool, int] | None = None  # (verdict, n at test)
        self._dirty_rows: set[int] = set()
        # concurrent searches (readers of the table) share the store: the
        # lazy device sync and mirror build run under this lock, once
        self._lock = threading.RLock()

    @classmethod
    def from_device(cls, vecs: torch.Tensor, dist: str) -> "VecStore":
        """Ingest an (n, dim) tensor already on its device as the canonical
        data: no host round trip.  The host copy materializes lazily on
        first host-side access (serde, mutation)."""
        n, dim = vecs.shape
        D.check_dist(dist)
        store = cls.__new__(cls)
        store.torch_device = resolve(vecs.device)
        store.dim = int(dim)
        store.dist = dist
        store.dtype = np.dtype(np.float32)
        store._n = int(n)
        # static ingest: round capacity to a 16384 multiple (keeps every
        # kernel tile whole) instead of the next power of two, which at
        # n = 1e6 wastes 4.9% of every scan on zero rows
        store._cap = -(-int(n) // 16384) * 16384 if n >= 65536 else _round_cap(max(n, _MIN_CAP))
        store._data = None
        store._init_device_state()
        if store._cap == n:
            dev = vecs.float().contiguous()
        else:
            dev = torch.zeros((store._cap, dim), dtype=torch.float32, device=store.torch_device)
            dev[:n] = vecs
        store._dev = dev
        store._dev_cache = D.dist_cache(dev, dist)
        store._dev_full_dirty = False
        return store

    @classmethod
    def from_numpy(cls, vectors: np.ndarray, dist: str, dtype=None, device="cuda") -> "VecStore":
        vectors = np.asarray(vectors)
        dtype = dtype or vectors.dtype
        store = cls(vectors.shape[1], dist, capacity=len(vectors), dtype=dtype, device=device)
        if len(vectors):
            store.batch_push(vectors)
        return store

    # ---- the lean tier ----
    @property
    def tier(self) -> str:
        """"full" (f32 rows on the device + derived mirrors) or "lean" (the
        int8 mirror + bf16 rerank rows only; see `from_device_blocks`)."""
        return self._tier

    def _require_full(self, what: str) -> None:
        if self._tier == "lean":
            raise RuntimeError(
                f"{what} requires the full store tier; this store was ingested with "
                "from_device_blocks (lean tier: int8 scan mirror + bf16 rerank rows, no f32 copy)")

    @classmethod
    def from_device_blocks(cls, fill, n: int, dim: int, dist: str,
                           block_rows: int = 131072, assign_fn=None, perm: np.ndarray | None = None,
                           cap: int | None = None, keep_fill: bool = True,
                           device="cuda") -> "VecStore":
        """Memory-LEAN ingest for sets whose f32 form does not fit the
        device: stream `fill(row0, rows) -> (rows, dim) f32 tensor`, build
        ONLY the int8 mirror and a bf16 (n_pad, dim) rerank tensor
        indexed by original id, and drop each f32 block.

        The mirror is the full tier's quantization (same bytes for the same
        rows), scattered to `perm`'s layout: mirror slot i holds original row
        perm[i] (default: the full tier's seeded random permutation of `cap`
        = n rounded up to 16384).  A custom `perm` / `cap` (slots of ids >= n
        are never written and keep the losing sentinel) gives the mirror the
        layout "sorted" (`mirror_layout`), which the Flat scan refuses.
        `assign_fn(v, row0)` runs on each f32 block before it is dropped
        (IVF's cluster assignment).  The int8 ordering self-test runs on the
        first block's first 4096 rows.  With `keep_fill` the generator is
        kept for exact rows (`exact_rows`, `refine_distances`); `fill` must
        then return the same rows for the same row ids, whatever the block
        boundaries."""
        D.check_dist(dist)
        dev = resolve(device)
        store = cls.__new__(cls)
        store.torch_device = dev
        store.dim = int(dim)
        store.dist = dist
        store.dtype = np.dtype(np.float32)
        store._n = int(n)
        store._cap = int(cap) if cap is not None else -(-int(n) // 16384) * 16384
        if store._cap < n:
            raise ValueError(f"cap {store._cap} < n {n}")
        store._data = None
        store._init_device_state()
        store._dev_full_dirty = False
        store._tier = "lean"
        cap = store._cap
        if perm is not None:
            perm = np.asarray(perm, dtype=np.int32)
            if perm.shape != (cap,):
                raise ValueError(f"perm shape {perm.shape} != ({cap},)")
        mirror = ScanMirror.empty(cap, PJ.proj_lanes(dim), dist, n, scan_perm(cap) if perm is None else perm,
                                  "scan" if perm is None else "sorted", dev)
        # indexed by ORIGINAL id (< n): no mirror layout padding
        rerank = torch.zeros((-(-int(n) // 16384) * 16384, dim), dtype=torch.bfloat16, device=dev)
        verdict = None
        for row0 in range(0, n, block_rows):
            rows = min(block_rows, n - row0)
            v = fill(row0, rows).to(dev, torch.float32)
            if verdict is None:
                m = min(rows, 4096)
                verdict = T.int8_ordering_selftest(v[:m], m, dist) >= 0.95
            if assign_fn is not None:
                assign_fn(v, row0)
            mirror.write_rows(np.arange(row0, row0 + rows), v, D.dist_cache(v, dist), n)
            rerank[row0 : row0 + rows] = v.to(torch.bfloat16)
            del v
        store._int8_mirror = mirror
        store._dev_rerank = rerank
        store._int8_ok = (True if verdict is None else bool(verdict), max(n, 1))
        if keep_fill:
            store._fill = fill
            store._fill_block_rows = int(block_rows)
        return store

    @property
    def mirror_layout(self) -> str:
        """The int8 mirror's `layout`: "sorted" for a lean store ingested in
        its caller's order, else "scan" (built or not)."""
        return self._int8_mirror.layout if self._tier == "lean" else "scan"

    @property
    def distance_precision(self) -> str:
        """"f32" when an exact row source exists (the full tier, or a lean
        tier that kept its generator), else the lean rerank rows' dtype name
        ("bfloat16"): selection-grade distances only."""
        if self._tier != "lean" or self._fill is not None:
            return "f32"
        return str(self._dev_rerank.dtype).replace("torch.", "")

    def exact_rows(self, ids) -> torch.Tensor | None:
        """Exact f32 rows for a small id set, in order, on the store's
        device: a gather on the full tier; on the lean tier, regenerate only
        the `block_rows`-aligned blocks that hold requested ids.  None when no
        exact source exists (lean, keep_fill=False).  Negative ids give zero
        rows."""
        ids_h = np.asarray(ids, np.int64).ravel()
        if self._tier != "lean":
            vecs, _ = self.device()
            return vecs[torch.from_numpy(np.maximum(ids_h, 0)).to(self.torch_device)]
        if self._fill is None:
            return None
        br = self._fill_block_rows
        out = torch.zeros((len(ids_h), self.dim), dtype=torch.float32, device=self.torch_device)
        valid = ids_h >= 0
        for b in np.unique(ids_h[valid] // br):
            row0 = int(b) * br
            rows = min(br, self._n - row0)
            v = self._fill(row0, rows).to(self.torch_device, torch.float32)
            sel = np.nonzero(valid & (ids_h >= row0) & (ids_h < row0 + rows))[0]
            out[torch.from_numpy(sel).to(self.torch_device)] = v[
                torch.from_numpy(ids_h[sel] - row0).to(self.torch_device)]
            del v
        return out

    def refine_distances(self, queries, ids) -> np.ndarray | None:
        """Exact f32 distances d(queries[b], row ids[b, j]) of a final (B, k)
        result set as numpy, +inf where the id is < 0; None when no exact
        source exists."""
        ids_h = np.asarray(ids)
        rows = self.exact_rows(ids_h)
        if rows is None:
            return None
        B, k = ids_h.shape
        if isinstance(queries, torch.Tensor):
            q = torch.atleast_2d(queries).to(self.torch_device, torch.float32)
        else:
            q = torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.torch_device)
        rows = rows.view(B, k, self.dim)
        if self.dist == "l2sqr":
            diff = rows - q[:, None, :]
            d = (diff * diff).sum(-1)
        else:
            dots = (rows * q[:, None, :]).sum(-1)
            qn = (q * q).sum(-1).sqrt()[:, None]
            rn = (rows * rows).sum(-1).sqrt()
            d = 1.0 - dots / (qn * rn).clamp_min(1e-30)
        return np.where(ids_h >= 0, d.cpu().numpy(), np.inf)

    def refine_result(self, queries, d: np.ndarray, ids: np.ndarray):
        """A final (B, k) result of a search over the lean tier's bf16 rows
        with its distances made exact f32 and each row re-sorted by them
        (stable); (d, ids) unchanged when no exact source exists."""
        refined = self.refine_distances(queries, ids)
        if refined is None:
            return d, ids
        order = np.argsort(refined, axis=1, kind="stable")
        return np.take_along_axis(refined, order, 1), np.take_along_axis(ids, order, 1)

    def device_bytes(self) -> int:
        """Bytes of this store's live device tensors: the f32 rows (which
        are also the rerank rows on the full tier), the distance cache, the
        int8 mirror with its channels and permutation, the PCA mirror with
        its projection, the bf16 traversal copy, and the lean tier's bf16
        rerank rows."""
        tensors = [self._dev, self._dev_cache, self._dev_bf16, self._dev_rerank]
        return (sum(t.numel() * t.element_size() for t in tensors if t is not None)
                + sum(m.nbytes for m in self._mirrors()))

    def _mirrors(self) -> list[ScanMirror]:
        return [m for m in (self._int8_mirror, self._pca_mirror) if m is not None]

    def free_search_caches(self) -> None:
        """Release every derived device tensor (the int8 and PCA mirrors, the
        bf16 traversal copy); they rebuild on demand (the PCA mirror with a
        new fit).  No-op on the lean tier, where the mirror and the rerank
        rows ARE the data."""
        if self._tier == "lean":
            return
        self.free_scan_mirrors()
        self._dev_bf16 = None

    def free_scan_mirrors(self) -> None:
        """Release the int8 and PCA scan mirrors (rebuilt on demand).  No-op
        on the lean tier."""
        if self._tier == "lean":
            return
        self._int8_mirror = self._pca_mirror = None

    def _host(self) -> np.ndarray:
        """The (cap, dim) host array, materialized from the device tensor on
        first access for device-born stores."""
        self._require_full("host data access")
        if self._data is None:
            host = np.zeros((self._cap, self.dim), dtype=self.dtype)
            if self._n:
                host[: self._n] = self._dev[: self._n].cpu().numpy().astype(self.dtype)
            self._data = host
        return self._data

    # ---- host-side mutation ----
    def __len__(self) -> int:
        return self._n

    @property
    def n(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._cap

    def numpy(self) -> np.ndarray:
        """Valid rows as a host array view (n, dim)."""
        return self._host()[: self._n]

    def __getitem__(self, i: int) -> np.ndarray:
        if not (0 <= i < self._n):
            raise IndexError(i)
        return self._host()[i]

    def _grow_to(self, n: int) -> None:
        if n <= self._cap:
            return
        new_cap = _round_cap(n)
        new = np.zeros((new_cap, self.dim), dtype=self.dtype)
        new[: self._n] = self._host()[: self._n]
        self._data = new
        self._cap = new_cap
        self._dev = None
        self._dev_cache = None
        self._dev_bf16 = None
        self._pca_mirror = None
        self._dev_full_dirty = True
        self._dirty_rows.clear()

    def push(self, vec) -> int:
        self._require_full("push()")
        vec = np.asarray(vec, dtype=self.dtype).reshape(-1)
        if vec.shape[0] != self.dim:
            raise ValueError(f"Dimension mismatch: {vec.shape[0]} != {self.dim}")
        self._grow_to(self._n + 1)
        idx = self._n
        self._host()[idx] = vec
        self._n += 1
        self._mark_dirty(idx)
        return idx

    def batch_push(self, vecs) -> list[int]:
        self._require_full("batch_push()")
        vecs = np.asarray(vecs, dtype=self.dtype)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"Dimension mismatch: {vecs.shape} vs dim={self.dim}")
        start = self._n
        self._grow_to(self._n + len(vecs))
        self._host()[start : start + len(vecs)] = vecs
        self._n += len(vecs)
        for i in range(start, self._n):
            self._mark_dirty(i)
        return list(range(start, self._n))

    def swap_remove(self, i: int) -> None:
        """Remove row i by moving the last row into it."""
        self._require_full("swap_remove()")
        if not (0 <= i < self._n):
            raise IndexError(i)
        last = self._n - 1
        data = self._host()
        if i != last:
            data[i] = data[last]
            self._mark_dirty(i)
        data[last] = 0
        self._mark_dirty(last)
        self._n = last

    def _mark_dirty(self, row: int) -> None:
        if self._dev_full_dirty:
            return
        self._dirty_rows.add(row)
        # full rebuild once a big fraction changed: incremental row writes
        # win until the dirty set approaches half the data
        if len(self._dirty_rows) > max(16384, self._cap // 2):
            self._dev_full_dirty = True
            self._dirty_rows.clear()

    # ---- device view ----
    def device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(vectors (cap, dim) f32, dist_cache (cap,) f32), synced."""
        self._require_full("device() (the f32 canonical copy)")
        with self._lock:
            if self._dev is None or self._dev_full_dirty:
                host = np.zeros((self._cap, self.dim), dtype=np.float32)
                host[: self._n] = self._host()[: self._n].astype(np.float32)
                self._dev = torch.from_numpy(host).to(self.torch_device)
                self._dev_cache = D.dist_cache(self._dev, self.dist)
                self._int8_mirror = self._pca_mirror = None
                self._dev_bf16 = None
                self._int8_ok = None
                self._dev_full_dirty = False
                self._dirty_rows.clear()
            elif self._dirty_rows:
                self._sync_rows()
            return self._dev, self._dev_cache

    def _sync_rows(self) -> None:
        """Write the dirty rows into every live device tensor in place
        (`index_copy_` instead of the reference's donated functional scatter:
        no second copy of any (cap, ...) buffer), the live mirrors included
        (`ScanMirror.write_rows`)."""
        rows = np.array(sorted(self._dirty_rows), dtype=np.int64)
        vals = torch.from_numpy(self._host()[rows].astype(np.float32)).to(self.torch_device)
        rows_t = torch.from_numpy(rows).to(self.torch_device)
        cache_v = D.dist_cache(vals, self.dist)
        self._dev.index_copy_(0, rows_t, vals)
        self._dev_cache.index_copy_(0, rows_t, cache_v)
        if self._dev_bf16 is not None:
            self._dev_bf16.index_copy_(0, rows_t, vals.to(torch.bfloat16))
        for m in self._mirrors():
            m.write_rows(rows, vals, cache_v, self._n)
        self._dirty_rows.clear()

    def device_rerank(self) -> torch.Tensor:
        """The rows K2 reads: the synced f32 (cap, dim) tensor itself, or the
        lean tier's bf16 (n_pad, dim) rows."""
        if self._tier == "lean":
            return self._dev_rerank
        return self.device()[0]

    def device_traversal(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(vectors (cap, dim) bf16, dist_cache (cap,) f32), synced.  The
        bf16 copy serves the graph traversal of the CPU route only; its
        distances are approximate (~1e-2 relative), so callers rerank the
        final beam against the exact f32 rows (`device()`)."""
        with self._lock:
            vecs, cache = self.device()
            if self._dev_bf16 is None:
                self._dev_bf16 = vecs.to(torch.bfloat16)
            return self._dev_bf16, cache

    def device_int8(self) -> ScanMirror:
        """The scan-permuted int8 mirror (`ScanMirror`: (cap, dim_pad) int8
        rows, (cap,) scale, cache and int32 perm; dim_pad is dim rounded up
        to a multiple of 128), synced and cached.  The lean tier returns the
        mirror it was ingested with (immutable)."""
        if self._tier == "lean":
            return self._int8_mirror
        with self._lock:
            vecs, cache = self.device()
            if self._int8_mirror is None:
                with span("store.mirror"):
                    self._int8_mirror = ScanMirror.build(vecs, cache, self._n, self.dist, scan_perm(self._cap))
            return self._int8_mirror

    def device_proj_int8(self, d_red: int) -> ScanMirror:
        """The PCA-projected int8 mirror (`ScanMirror` in row order, with its
        fit `proj` (dim, d_red) and `mu` (dim,); proj_lanes(d_red) lanes),
        synced and cached.

        The projection is fitted once from the rows present at the first
        call, then held fixed: later row writes are projected through it in
        the row sync (the mirror only orders stage-1 candidates; the exact
        rerank does not depend on the fit).  A full rebuild (capacity
        growth, bulk upload) or a different `d_red` refits."""
        self._require_full("the PCA mirror")
        with self._lock:
            vecs, cache = self.device()  # syncs dirty rows into the mirror too
            if self._pca_mirror is None or self._pca_mirror.proj.shape[1] != d_red:
                proj, mu = (torch.from_numpy(a).to(self.torch_device)
                            for a in PJ.pca_fit(vecs, self._n, d_red, self.dist))
                self._pca_mirror = ScanMirror.build(vecs, cache, self._n, self.dist, proj=proj, mu=mu)
            return self._pca_mirror

    def int8_reliable(self) -> bool:
        """Whether per-row int8 quantization preserves neighbor ORDER on this
        data (`topk.int8_ordering_selftest`).  False in the pathological
        regime; callers then use the exact scan.  Re-evaluated once the row
        count drifts >= 25% from the tested size."""
        if self._int8_ok is not None:
            verdict, n_at = self._int8_ok
            if n_at > 0 and abs(self._n - n_at) <= n_at // 4:
                return verdict
        if self._n < 64:
            self._int8_ok = (True, max(self._n, 1))  # tiny sets: exact path anyway
        else:
            vecs, _ = self.device()
            with span("store.selftest"):
                score = T.int8_ordering_selftest(vecs, self._n, self.dist)
            self._int8_ok = (score >= 0.95, self._n)
            if not self._int8_ok[0]:
                print(
                    f"[vecdb-torch] int8 ordering self-test scored {score:.2f}"
                    " (<0.95): neighbor gaps are small relative to vector"
                    " magnitudes, falling back to exact f32 scans",
                    file=sys.stderr,
                )
        return self._int8_ok[0]

    # ---- conversions ----
    def to_type(self, dtype) -> "VecStore":
        """dtype conversion via f32 mediation."""
        self._require_full("to_type()")
        out = VecStore(self.dim, self.dist, capacity=self._n, dtype=dtype, device=self.torch_device)
        if self._n:
            out.batch_push(self._host()[: self._n].astype(np.float32).astype(dtype))
        return out

    def random_sample(self, size: int, rng: np.random.Generator) -> np.ndarray:
        """Sample `size` rows without replacement."""
        self._require_full("random_sample()")
        size = min(size, self._n)
        sel = rng.choice(self._n, size=size, replace=False)
        return self._host()[np.sort(sel)].copy()

    # ---- serde ----
    def state_arrays(self, include_vectors: bool = True) -> dict[str, np.ndarray]:
        self._require_full("serialization")
        out = {}
        if include_vectors:
            out["vectors"] = self._host()[: self._n].copy()
        return out
