"""Metadata-carrying vector table (port of db/table.py).

Host-side metadata rows parallel to index rows + a DynamicIndex, with the
reference's lifecycle invariants:
- delete removes matching rows via swap_remove on metadata and store alike;
- search routing: (ef, pq) -> knn_pq, ef -> knn_with_ef, else knn; then the
  upper_bound filter and the metadata join.

float32 Flat and HNSW tables, each with an optional PQ table (the ADC
sidecar that `batch_search` with ef routes through), and uint8 Flat tables
are ported.  Checkpoints are the JAX package's single-file npz + JSON
format, PQ arrays and meta included, so a table saved by either package
loads in the other.
"""

from __future__ import annotations

import numpy as np

from .dynamic_index import DynamicIndex
from ..models.pq_table import PQTable, table_config
from ..models.store import ScanMode
from ..utils import serde
from ..utils.profiling import span


class MetadataVecTable:
    def __init__(self, dim: int, dist: str, seed: int | None = None,
                 data_type: str = "float32", device="cuda", scan_mode: ScanMode = ScanMode(),
                 mesh=None):
        self.metadata: list[dict[str, str]] = []
        self.inner = DynamicIndex(dim, dist, data_type, device=device, scan_mode=scan_mode,
                                  mesh=mesh)
        self.pq = None
        self._seed = seed

    @property
    def data_type(self) -> str:
        return self.inner.data_type

    def _cast_rows(self, vecs) -> np.ndarray:
        """Cast input rows to the table dtype.  uint8 tables apply the
        reference's `as u8` semantics: round toward zero, saturate
        (src/scalar.rs:19-35); NaN becomes 0."""
        if self.data_type == "uint8":
            a = np.atleast_2d(np.asarray(vecs, dtype=np.float64))
            return np.clip(np.trunc(np.nan_to_num(a)), 0, 255).astype(np.uint8)
        return np.atleast_2d(np.asarray(vecs, dtype=np.float32))

    def __len__(self) -> int:
        return len(self.inner)

    @property
    def dim(self) -> int:
        return self.inner.dim

    @property
    def dist(self) -> str:
        return self.inner.dist

    # ---- writes ----
    def add(self, vec, metadata: dict[str, str]) -> None:
        self.clear_pq_table()
        self.metadata.append(dict(metadata))
        self.inner.add(self._cast_rows(vec)[0])

    def batch_add(self, vec_list, metadata_list) -> None:
        if len(vec_list) != len(metadata_list):
            raise ValueError("Length mismatch for vec_list and metadata_list")
        if len(vec_list) == 0:
            return
        self.clear_pq_table()
        self.metadata.extend(dict(m) for m in metadata_list)
        self.inner.batch_add(self._cast_rows(vec_list))

    def delete(self, pattern: dict[str, str]) -> int:
        """Delete rows whose metadata matches all pattern keys exactly."""
        self.clear_hnsw_index()
        self.clear_pq_table()
        matches = [
            i
            for i, m in enumerate(self.metadata)
            if all(m.get(k) == v for k, v in pattern.items())
        ]
        flat = self.inner.inner
        self.inner.note_mutation()
        for i in reversed(matches):
            # swap_remove on metadata + vec store, mirroring the reference
            last = len(self.metadata) - 1
            self.metadata[i] = self.metadata[last]
            self.metadata.pop()
            flat.store.swap_remove(i)
        return len(matches)

    # ---- index lifecycle ----
    def build_hnsw_index(self, ef_construction: int | None = None) -> None:
        self.inner.build_hnsw(ef_construction, seed=self._seed)

    def clear_hnsw_index(self) -> None:
        self.inner.clear_hnsw()

    def has_hnsw_index(self) -> bool:
        return self.inner.is_hnsw

    def build_pq_table(self, train_proportion=None, n_bits=None, m=None) -> None:
        """Train a PQ table on the table's rows, with the reference's
        defaults and checks (`models/pq_table.py:table_config`), float32
        tables only.  It trains on the store's device rows in place."""
        if self.pq is not None:
            return
        if self.data_type == "uint8":
            raise RuntimeError("PQ table requires a float32 table")
        cfg = table_config(len(self), self.dim, self.dist, train_proportion, n_bits, m)
        vecs, _ = self.inner.inner.store.device()
        self.pq = PQTable.train(vecs, cfg, seed=self._seed or 0, n_valid=len(self))

    def clear_pq_table(self) -> None:
        self.pq = None

    def has_pq_table(self) -> bool:
        return self.pq is not None

    # ---- search ----
    def search(self, query, k: int, ef: int | None = None,
               upper_bound: float | None = None) -> list[tuple[dict[str, str], float]]:
        if len(self) == 0:
            return []
        with span("db.cast"):
            query = self._cast_rows(query)[0]
        if ef is not None and self.pq is not None:
            results = self.inner.knn_pq(query, k, ef, self.pq)
        elif ef is not None:
            results = self.inner.knn_with_ef(query, k, ef)
        else:
            results = self.inner.knn(query, k)
        with span("db.join"):
            ub = float("inf") if upper_bound is None else upper_bound
            return [
                (dict(self.metadata[p.index]), p.distance)
                for p in results
                if p.distance <= ub
            ]

    def batch_search(self, queries, k: int, ef: int | None = None,
                     upper_bound: float | None = None) -> list[list[tuple[dict[str, str], float]]]:
        """Batched search: one device dispatch carries the whole query
        batch.  Routing matches `search`."""
        with span("db.cast"):
            queries = self._cast_rows(queries)
        if len(self) == 0:
            return [[] for _ in range(len(queries))]
        if ef is not None and self.pq is not None:
            d, ids = self.inner.knn_pq_batch(queries, k, ef, self.pq)
        elif ef is not None and self.inner.is_hnsw:
            d, ids = self.inner.knn_with_ef_batch(queries, k, ef)
        else:
            # through DynamicIndex, so a mesh mirror serves batches too
            d, ids = self.inner.knn_batch(queries, k)
        with span("db.join"):
            ub = float("inf") if upper_bound is None else upper_bound
            out = []
            for qi in range(len(queries)):
                row = []
                for dist_val, idx in zip(d[qi], ids[qi]):
                    if idx >= 0 and dist_val <= ub:
                        row.append((dict(self.metadata[int(idx)]), float(dist_val)))
                out.append(row)
            return out

    def extract_data(self) -> list[tuple[list[float], dict[str, str]]]:
        vecs = self.inner.inner.store.numpy()
        return [
            (vecs[i].astype(float).tolist(), dict(self.metadata[i]))
            for i in range(len(self))
        ]

    # ---- serde (single-file checkpoint) ----
    def save(self, path) -> None:
        arrays, meta = self.inner.state()
        if self.pq is not None:
            pq_arrays, pq_meta = self.pq.state()
            arrays.update(pq_arrays)
            meta.update(pq_meta)
        meta["metadata"] = self.metadata
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, device="cuda", seed: int | None = None,
             scan_mode: ScanMode = ScanMode(), mesh=None) -> "MetadataVecTable":
        arrays, meta = serde.load_arrays(path)
        self = cls.__new__(cls)
        self.inner = DynamicIndex.from_state(arrays, meta, device=device, scan_mode=scan_mode,
                                             mesh=mesh)
        self.metadata = [dict(m) for m in meta.get("metadata", [])]
        self.pq = PQTable.from_state(arrays, meta, device=device) if "pq" in meta else None
        self._seed = seed
        return self
