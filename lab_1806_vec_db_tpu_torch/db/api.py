"""Public Python API.

Parity contract: the reference's stub file `lab_1806_vec_db.pyi` and PyO3
module (src/pyo3/mod.rs): class `VecDB` + free function `calc_dist`, string
distance names {"l2sqr", "cosine"} (default "cosine"), ValueError for bad
distance names, RuntimeError for operational failures.

The reference releases the GIL around every call (pyo3/mod.rs:81 etc.); here
the heavy work happens inside PyTorch device calls, which release the GIL
during execution, so concurrent Python threads overlap the same way.

Port of lab_1806_vec_db_tpu/db/api.py.  `VecDB(dir, device="cuda")` serves
float32 Flat and HNSW tables, with or without a PQ table, and uint8 Flat
tables (exact integer distances) on the given device, and raises
RuntimeError when that device is unavailable.  `VecDB(dir, seed=s)` makes
its tables' HNSW builds and PQ training reproducible, and `VecDB(dir,
scan="pca", pca_dim=256)` picks the Flat planner's scan mode and
`VecDB(dir, mesh=4)` serves every search from an exact scan sharded over a
mesh of 4 shards (see `VecDB`).
"""

from __future__ import annotations

from .manager import VecDBManager
from ..models.store import ScanMode
from ..ops.distance import calc_dist_host


def calc_dist(a, b, dist: str = "cosine") -> float:
    """Distance between two vectors; dist in {"l2sqr", "cosine"}
    (pyo3/mod.rs:43-48)."""
    return calc_dist_host(a, b, dist)


def _runtime_wrap(fn):
    """Map internal errors to RuntimeError like the PyO3 layer maps anyhow
    errors (pyo3/mod.rs:85-86), letting ValueError pass through."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (ValueError, RuntimeError, TypeError):
            raise
        except KeyError as e:
            raise RuntimeError(str(e.args[0]) if e.args else str(e)) from e
        except Exception as e:  # pragma: no cover
            raise RuntimeError(str(e)) from e

    return wrapper


class VecDB:
    """Vector Database. Prefer using this to manage multiple tables.

    Ensures (parity with the reference's guarantees, pyo3/mod.rs:50-54):
    - Auto-save: saved to disk in the background when dirty and on close.
    - Parallelism: the GIL is released during device execution.
    - Thread-safe: read and write operations are atomic.
    - Unique: only one manager per database directory (flock-enforced).
    """

    def __init__(self, dir: str, device="cuda", seed: int | None = None, scan: str = "int8",
                 pca_dim: int = 256, mesh=None) -> None:
        """Extension over the reference stub: `device` places the tables;
        `seed`, when given, seeds every table this VecDB creates or opens,
        so an HNSW build draws the same levels (and builds the same graph)
        and PQ training the same codebooks each time.  None, the default,
        draws HNSW levels from fresh entropy as the reference does (PQ
        training then uses seed 0).  `scan` is the float32 tables' scan
        mode ("int8", the default, "pca", "bf16" / "2stage" or "exact"; the
        reference's VECDB_TPU_SCAN) and `pca_dim` the "pca" mode's
        projected width (its VECDB_TPU_PCA_DIM); an unknown mode raises
        ValueError before the directory is touched.  `mesh` (the reference's
        VECDB_TPU_MESH), None by default, is an int or a
        `parallel.sharded.Mesh`: with it every table mirrors its rows as a
        `ShardedFlatIndex` over the mesh (an int n: `make_mesh(n,
        device=device)`, n shards), and every search is that mirror's exact
        sharded scan; any write drops the mirror until the next search."""
        self._inner = VecDBManager(dir, device=device, seed=seed,
                                   scan_mode=ScanMode(scan, pca_dim), mesh=mesh)

    @_runtime_wrap
    def create_table_if_not_exists(
        self, key: str, dim: int, dist: str = "cosine", data_type: str = "float32"
    ) -> bool:
        """Extension over the reference stub: `data_type` selects the table
        dtype, "float32" or "uint8".  A uint8 table stores rows cast by
        truncation and saturation to 0-255, searches them exactly, and
        refuses HNSW and PQ (RuntimeError)."""
        return self._inner.create_table_if_not_exists(key, dim, dist, data_type)

    @_runtime_wrap
    def get_len(self, key: str) -> int:
        return self._inner.get_len(key)

    @_runtime_wrap
    def get_dim(self, key: str) -> int:
        return self._inner.get_dim(key)

    @_runtime_wrap
    def get_dist(self, key: str) -> str:
        return self._inner.get_dist(key)

    @_runtime_wrap
    def delete_table(self, key: str) -> bool:
        return self._inner.delete_table(key)

    def get_all_keys(self) -> list[str]:
        return self._inner.get_all_keys()

    def contains_key(self, key: str) -> bool:
        return self._inner.contains_key(key)

    def get_cached_tables(self) -> list[str]:
        return self._inner.get_cached_tables()

    def contains_cached(self, key: str) -> bool:
        return self._inner.contains_cached(key)

    @_runtime_wrap
    def remove_cached_table(self, key: str) -> None:
        self._inner.remove_cached_table(key)

    @_runtime_wrap
    def add(self, key: str, vec, metadata) -> None:
        self._inner.add(key, vec, metadata)

    @_runtime_wrap
    def batch_add(self, key: str, vec_list, metadata_list) -> None:
        self._inner.batch_add(key, vec_list, metadata_list)

    @_runtime_wrap
    def delete(self, key: str, pattern) -> int:
        return self._inner.delete(key, pattern)

    @_runtime_wrap
    def search(self, key: str, query, k: int, ef: int | None = None, upper_bound: float | None = None):
        return self._inner.search(key, query, k, ef, upper_bound)

    @_runtime_wrap
    def batch_search(
        self,
        key: str,
        queries,
        k: int,
        ef: int | None = None,
        upper_bound: float | None = None,
    ):
        """Extension (not in the reference API): search a whole batch of
        queries in one device dispatch.  Returns a list (per query)
        of (metadata, distance) lists."""
        return self._inner.batch_search(key, queries, k, ef, upper_bound)

    @_runtime_wrap
    def extract_data(self, key: str):
        return self._inner.extract_data(key)

    @_runtime_wrap
    def build_hnsw_index(self, key: str, ef_construction: int | None = None) -> None:
        self._inner.build_hnsw_index(key, ef_construction)

    @_runtime_wrap
    def clear_hnsw_index(self, key: str) -> None:
        self._inner.clear_hnsw_index(key)

    @_runtime_wrap
    def has_hnsw_index(self, key: str) -> bool:
        return self._inner.has_hnsw_index(key)

    @_runtime_wrap
    def build_pq_table(
        self,
        key: str,
        train_proportion: float | None = None,
        n_bits: int | None = None,
        m: int | None = None,
    ) -> None:
        self._inner.build_pq_table(key, train_proportion, n_bits, m)

    @_runtime_wrap
    def clear_pq_table(self, key: str) -> None:
        self._inner.clear_pq_table(key)

    @_runtime_wrap
    def has_pq_table(self, key: str) -> bool:
        return self._inner.has_pq_table(key)

    def force_save(self) -> None:
        self._inner.force_save()

    def close(self) -> None:
        """Flush and release the directory lock.  Not part of the reference
        API (Rust Drop does this); exposed for deterministic shutdown."""
        self._inner.close_if_open()

    def __enter__(self) -> "VecDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
