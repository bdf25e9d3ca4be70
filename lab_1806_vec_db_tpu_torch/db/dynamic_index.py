"""Runtime Flat | HNSW | FlatU8 dispatch (port of db/dynamic_index.py).

The runtime-dtype dispatch is the DB-layer face of the reference's
DynamicVecSet (src/vec_set.rs:237-263): float32 tables hold a Flat index
that can be upgraded to HNSW, uint8 tables the exact u8 Flat index
(`models/u8.py`), which never casts the set to f32 and refuses HNSW.
The float32 indexes search in the table's scan mode (a `ScanMode`, the
reference's VECDB_TPU_SCAN / VECDB_TPU_PCA_DIM; see `models/flat.py`): it is
set on the index's store whenever the index is made (creation, an HNSW
build, a load), and a downgrade to Flat keeps the store.

The mesh mirror (the reference's VECDB_TPU_MESH opt-in, here the explicit
`mesh` argument, `VecDB(dir, mesh=...)`): with a mesh set, every table
kind mirrors its rows as a `parallel/sharded.py:ShardedFlatIndex` (f32
Flat and HNSW tables their rows, uint8 tables their rows cast to f32,
whose f32 distances are the exact integer ones at these magnitudes), built
lazily at the first search, and every search, single or batched, with or
without ef or PQ, is the mirror's exact sharded scan.  Any write or
remove drops the mirror (`note_mutation`).  On a CUDA store the shards on
the store's device are views of its rows, not copies.
"""

from __future__ import annotations

import numpy as np

from ..models import FlatIndex, FlatIndexU8, HNSWIndex
from ..models.store import ScanMode
from ..utils.candidates import pairs_from_arrays
from ..utils.config import HNSWConfig


class DynamicIndex:
    def __init__(self, dim: int, dist: str, data_type: str = "float32", device="cuda",
                 scan_mode: ScanMode = ScanMode(), mesh=None):
        self.scan_mode = scan_mode
        self.mesh = mesh  # a parallel.sharded.Mesh or None
        self._mirror = None  # (ShardedFlatIndex, n rows) while the mesh mirror is live
        if data_type == "uint8":
            self.inner: FlatIndex | FlatIndexU8 | HNSWIndex = FlatIndexU8(dim, dist, device=device)
        elif data_type == "float32":
            self._set_f32(FlatIndex(dim, dist, device=device))
        else:
            raise ValueError(f"Unsupported data_type: {data_type!r}")
        self.data_type = data_type

    def _set_f32(self, index: FlatIndex | HNSWIndex) -> None:
        """Hold a float32 index, searching in the table's scan mode."""
        index.store.scan_mode = self.scan_mode
        self.inner = index

    # ---- the mesh mirror ----
    def note_mutation(self) -> None:
        """Drop the mesh mirror (any row write or remove)."""
        self._mirror = None

    def _sharded_flat(self):
        """The ShardedFlatIndex mirror when a mesh is set, rebuilt lazily
        after writes (db/dynamic_index.py:60-81 of the JAX package); None
        without a mesh or rows."""
        if self.mesh is None:
            return None
        n = len(self.inner)
        if n == 0:
            return None
        if self._mirror is not None and self._mirror[1] == n:
            return self._mirror[0]
        from ..parallel.sharded import ShardedFlatIndex

        if self.data_type == "uint8":
            rows = self.inner.store.to_f32()
        else:
            rows = self.inner.store.device()[0][:n]
        mirror = ShardedFlatIndex(self.mesh, rows, self.dist)
        self._mirror = (mirror, n)
        return mirror

    def _mirror_knn(self, mirror, query, k: int):
        d, i = mirror.knn_batch(np.asarray(query, np.float32)[None, :], k)
        return pairs_from_arrays(d[0], i[0], k)

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def dist(self) -> str:
        return self.inner.dist

    def __len__(self) -> int:
        return len(self.inner)

    @property
    def is_hnsw(self) -> bool:
        return isinstance(self.inner, HNSWIndex)

    # ---- mutation ----
    def add(self, vec) -> int:
        self.note_mutation()
        return self.inner.add(vec)

    def batch_add(self, vecs) -> list[int]:
        self.note_mutation()
        return self.inner.batch_add(vecs)

    # ---- index lifecycle ----
    def build_hnsw(self, ef_construction: int | None, seed: int | None = None) -> None:
        """Upgrade Flat -> HNSW with a bulk build; no-op if already HNSW
        (metadata_vec_table.rs:84-98)."""
        if self.is_hnsw:
            return
        if self.data_type == "uint8":
            raise RuntimeError("HNSW index requires a float32 table")
        self.note_mutation()
        flat: FlatIndex = self.inner
        cfg = HNSWConfig(max_elements=len(flat))
        if ef_construction is not None:
            cfg.ef_construction = ef_construction
        vectors = flat.store.numpy().astype(np.float32, copy=True)
        if len(vectors):
            self._set_f32(HNSWIndex.build(vectors, flat.dist, cfg, seed=seed, device=flat.device))
        else:
            self._set_f32(HNSWIndex(flat.dim, flat.dist, cfg, seed, device=flat.device))

    def clear_hnsw(self) -> None:
        """Downgrade HNSW -> Flat keeping the vec set
        (metadata_vec_table.rs:100-106)."""
        if self.is_hnsw:
            self.note_mutation()
            self.inner = FlatIndex.from_store(self.inner.store)

    # ---- search dispatch (dynamic_index.rs:61-93); with a mesh every form
    # is the mirror's exact sharded scan, which meets each contract (ef and
    # PQ are recall knobs the exact scan does not need) ----
    def knn(self, query, k: int):
        mirror = self._sharded_flat()
        if mirror is not None:
            return self._mirror_knn(mirror, query, k)
        return self.inner.knn(query, k)

    def knn_with_ef(self, query, k: int, ef: int):
        mirror = self._sharded_flat()
        if mirror is not None:
            return self._mirror_knn(mirror, query, k)
        # Flat ignores ef (dynamic_index.rs:75-80)
        return self.inner.knn_with_ef(query, k, ef)

    def knn_pq(self, query, k: int, ef: int, pq):
        mirror = self._sharded_flat()
        if mirror is not None:
            return self._mirror_knn(mirror, query, k)
        return self.inner.knn_pq(query, k, ef, pq)

    def knn_batch(self, queries, k: int):
        mirror = self._sharded_flat()
        if mirror is not None:
            return mirror.knn_batch(queries, k)
        return self.inner.knn_batch(queries, k)

    def knn_with_ef_batch(self, queries, k: int, ef: int):
        mirror = self._sharded_flat()
        if mirror is not None:
            return mirror.knn_batch(queries, k)
        if self.is_hnsw:
            return self.inner.knn_with_ef_batch(queries, k, ef)
        return self.knn_batch(queries, k)

    def knn_pq_batch(self, queries, k: int, ef: int, pq):
        mirror = self._sharded_flat()
        if mirror is not None:
            return mirror.knn_batch(queries, k)
        return self.inner.knn_pq_batch(queries, k, ef, pq)

    # ---- serde ----
    def state(self) -> tuple[dict, dict]:
        return self.inner.state(include_vectors=True)

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, device="cuda",
                   scan_mode: ScanMode = ScanMode(), mesh=None) -> "DynamicIndex":
        self = cls.__new__(cls)
        self.data_type = "float32"
        self.scan_mode = scan_mode
        self.mesh = mesh
        self._mirror = None
        if meta["algorithm"] == "HNSW":
            self._set_f32(HNSWIndex.from_state(arrays, meta, device=device))
        elif meta["algorithm"] == "FlatU8":
            self.inner = FlatIndexU8.from_state(arrays, meta, device=device)
            self.data_type = "uint8"
        else:
            self._set_f32(FlatIndex.from_state(arrays, meta, device=device))
        return self
