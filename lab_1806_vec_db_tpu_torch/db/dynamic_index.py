"""Runtime index dispatch (port of db/dynamic_index.py): float32 Flat tables.

HNSW, uint8 (FlatU8) tables and the sharded VECDB_TPU_MESH mirror are not
ported yet; asking for them raises NotImplementedError naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

from ..models import FlatIndex

HNSW_TODO = "HNSW is not ported yet (ROADMAP.md queue 1, items 5-6: HNSW search and build)"
U8_TODO = "uint8 tables are not ported yet (ROADMAP.md queue 1, item 12: u8)"


class DynamicIndex:
    def __init__(self, dim: int, dist: str, data_type: str = "float32", device="cuda"):
        if data_type == "uint8":
            raise NotImplementedError(U8_TODO)
        if data_type != "float32":
            raise ValueError(f"Unsupported data_type: {data_type!r}")
        self.inner = FlatIndex(dim, dist, device=device)
        self.data_type = data_type

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
        return False

    # ---- mutation ----
    def add(self, vec) -> int:
        return self.inner.add(vec)

    def batch_add(self, vecs) -> list[int]:
        return self.inner.batch_add(vecs)

    # ---- index lifecycle ----
    def build_hnsw(self, ef_construction: int | None, seed: int | None = None) -> None:
        raise NotImplementedError(HNSW_TODO)

    def clear_hnsw(self) -> None:
        """Flat tables have no graph to clear."""

    # ---- search dispatch ----
    def knn(self, query, k: int):
        return self.inner.knn(query, k)

    def knn_with_ef(self, query, k: int, ef: int):
        # Flat ignores ef
        return self.knn(query, k)

    def knn_pq(self, query, k: int, ef: int, pq):
        return self.inner.knn_pq(query, k, ef, pq)

    def knn_batch(self, queries, k: int):
        return self.inner.knn_batch(queries, k)

    def knn_with_ef_batch(self, queries, k: int, ef: int):
        return self.knn_batch(queries, k)

    def knn_pq_batch(self, queries, k: int, ef: int, pq):
        return self.inner.knn_pq_batch(queries, k, ef, pq)

    # ---- serde ----
    def state(self) -> tuple[dict, dict]:
        return self.inner.state(include_vectors=True)

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, device="cuda") -> "DynamicIndex":
        if meta["algorithm"] == "HNSW":
            raise NotImplementedError(f"loading an HNSW checkpoint: {HNSW_TODO}")
        if meta["algorithm"] == "FlatU8":
            raise NotImplementedError(f"loading a FlatU8 checkpoint: {U8_TODO}")
        self = cls.__new__(cls)
        self.inner = FlatIndex.from_state(arrays, meta, device=device)
        self.data_type = "float32"
        return self
