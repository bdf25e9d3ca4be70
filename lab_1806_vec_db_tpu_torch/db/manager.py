"""Multi-table embedded database manager (port of db/manager.py).

Parity target: `VecDBManager` (reference: src/database/mod.rs:283-535):
- directory + exclusive `db.lock` flock enforcing single-process ownership
  (mod.rs:21-30); a second open raises
- `brief.toml` catalog key -> filename with sanitized, collision-suffixed
  unique filenames (mod.rs:36-45, 83-106); filenames validated on load
  (mod.rs:114-137)
- lazy table cache with documented lock order brief -> tables (mod.rs:282)
- per-table background saver (60 s) + 5 s catalog saver (mod.rs:161-163,
  305-310), atomic writes, flush on close/exit (mod.rs:523-535)
"""

from __future__ import annotations

import atexit
import os
import threading
import tomllib
import weakref

from .table import MetadataVecTable
from .thread_save import ThreadSavingManager
from ..ops.distance import check_dist
from ..models.store import ScanMode
from ..utils.device import resolve
from ..utils.profiling import span

TABLE_SAVE_INTERVAL = 60.0  # mod.rs:161-163
BRIEF_SAVE_INTERVAL = 5.0  # mod.rs:305-310


def sanitize_key(key: str) -> str:
    """Filename sanitization (mod.rs:36-45): keep [a-zA-Z0-9_-] and
    non-ASCII, replace the rest with '_', cap at 32 chars."""
    out = []
    for ch in key:
        if ch.isascii() and (ch.isalnum() or ch in "_-"):
            out.append(ch)
        elif ch.isascii() or ch.isspace() or not ch.isprintable():
            out.append("_")
        else:
            out.append(ch)
    return "".join(out[:32])


def _toml_escape(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


class _Brief:
    """key -> filename catalog (mod.rs:57-143)."""

    def __init__(self):
        self.tables: dict[str, str] = {}
        self.filenames: set[str] = set()

    def contains(self, key: str) -> bool:
        return key in self.tables

    def insert(self, key: str) -> str:
        base = sanitize_key(key)
        index = 0
        while True:
            filename = f"{base}.db" if index == 0 else f"{base}_{index}.db"
            if filename not in self.filenames:
                break
            index += 1
        self.filenames.add(filename)
        self.tables[key] = filename
        return filename

    def remove(self, key: str) -> str | None:
        filename = self.tables.pop(key, None)
        if filename is not None:
            self.filenames.discard(filename)
        return filename

    def save(self, path: str) -> None:
        from ..utils.serde import atomic_write_bytes

        lines = []
        for key, filename in sorted(self.tables.items()):
            lines.append(f"[tables.{_toml_escape(key)}]")
            lines.append(f"filename = {_toml_escape(filename)}")
            lines.append("")
        atomic_write_bytes(path, "\n".join(lines).encode("utf-8"))

    @classmethod
    def load(cls, path: str) -> "_Brief":
        with open(path, "rb") as f:
            data = tomllib.load(f)
        brief = cls()
        for key, entry in data.get("tables", {}).items():
            filename = entry["filename"]
            if not filename.endswith(".db"):
                raise RuntimeError(f"Filename should end with '.db': {filename}")
            if "/" in filename or "\\" in filename:
                raise RuntimeError(
                    f"Should not contain path separators in filename: {filename}"
                )
            if filename in brief.filenames:
                raise RuntimeError("Duplicate filenames in the brief")
            brief.tables[key] = filename
            brief.filenames.add(filename)
        return brief


def _acquire_lock(lock_path: str):
    """Exclusive advisory lock (mod.rs:21-30)."""
    import fcntl

    f = open(lock_path, "w")
    try:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        f.close()
        raise RuntimeError("Failed to acquire lock for VecDBManager")
    return f


class VecDBManager:
    def __init__(self, dir: str, device="cuda", seed: int | None = None,
                 scan_mode: ScanMode = ScanMode(), mesh=None):
        # fail before touching the directory when the device is unavailable
        self.device = resolve(device)
        self.seed = seed
        self.scan_mode = scan_mode
        if isinstance(mesh, int):
            from ..parallel.sharded import make_mesh

            mesh = make_mesh(mesh, device=self.device)
        self.mesh = mesh
        self.dir = os.path.abspath(dir)
        os.makedirs(self.dir, exist_ok=True)
        self._lock_file = _acquire_lock(os.path.join(self.dir, "db.lock"))
        brief_path = os.path.join(self.dir, "brief.toml")
        if os.path.exists(brief_path):
            brief, mark = _Brief.load(brief_path), False
        else:
            brief, mark = _Brief(), True
        self._brief_mgr = ThreadSavingManager(
            brief, brief_path, BRIEF_SAVE_INTERVAL, mark
        )
        # lock order: brief -> tables (mod.rs:282)
        self._tables_lock = threading.Lock()
        self._tables: dict[str, ThreadSavingManager] = {}
        self._closed = False
        self._atexit = atexit.register(weakref.WeakMethod(self.close_if_open))

    # ---- internals ----
    @property
    def _brief(self) -> _Brief:
        return self._brief_mgr.obj

    def _table_mgr(self, key: str) -> ThreadSavingManager:
        """Lazy-load a table (mod.rs:400-413)."""
        with self._brief_mgr.read():
            with self._tables_lock:
                if key not in self._brief.tables:
                    raise KeyError(f"Table {key} not found")
                if key not in self._tables:
                    path = os.path.join(self.dir, self._brief.tables[key])
                    table = MetadataVecTable.load(path, device=self.device, seed=self.seed,
                                                  scan_mode=self.scan_mode, mesh=self.mesh)
                    self._tables[key] = ThreadSavingManager(
                        table, path, TABLE_SAVE_INTERVAL, False
                    )
                return self._tables[key]

    # ---- catalog ----
    def get_all_keys(self) -> list[str]:
        with self._brief_mgr.read():
            return list(self._brief.tables.keys())

    def contains_key(self, key: str) -> bool:
        with self._brief_mgr.read():
            return self._brief.contains(key)

    def get_cached_tables(self) -> list[str]:
        with self._tables_lock:
            return list(self._tables.keys())

    def contains_cached(self, key: str) -> bool:
        with self._tables_lock:
            return key in self._tables

    def remove_cached_table(self, key: str) -> None:
        with self._tables_lock:
            mgr = self._tables.pop(key, None)
        if mgr is not None:
            mgr.close()

    def create_table_if_not_exists(
        self, key: str, dim: int, dist: str, data_type: str = "float32"
    ) -> bool:
        check_dist(dist)
        with self._brief_mgr.write() as brief:
            with self._tables_lock:
                if brief.contains(key):
                    return False
                filename = brief.insert(key)
                path = os.path.join(self.dir, filename)
                table = MetadataVecTable(dim, dist, self.seed, data_type=data_type, device=self.device,
                                         scan_mode=self.scan_mode, mesh=self.mesh)
                mgr = ThreadSavingManager(table, path, TABLE_SAVE_INTERVAL, True)
                self._tables[key] = mgr
                return True

    def delete_table(self, key: str) -> bool:
        with self._brief_mgr.write() as brief:
            with self._tables_lock:
                filename = brief.remove(key)
                if filename is None:
                    return False
                mgr = self._tables.pop(key, None)
            if mgr is not None:
                mgr.sync_save(stop_thread=True)
            path = os.path.join(self.dir, filename)
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            return True

    # ---- per-table ops ----
    def get_len(self, key: str) -> int:
        mgr = self._table_mgr(key)
        with mgr.read():
            return len(mgr.obj)

    def get_dim(self, key: str) -> int:
        mgr = self._table_mgr(key)
        with mgr.read():
            return mgr.obj.dim

    def get_dist(self, key: str) -> str:
        mgr = self._table_mgr(key)
        with mgr.read():
            return mgr.obj.dist

    def add(self, key: str, vec, metadata: dict[str, str]) -> None:
        mgr = self._table_mgr(key)
        with mgr.write() as table:
            if len(vec) != table.dim:
                raise ValueError("Dimension mismatch for vec")
            table.add(vec, metadata)

    def batch_add(self, key: str, vec_list, metadata_list) -> None:
        if len(vec_list) != len(metadata_list):
            raise ValueError("Length mismatch for vec_list and metadata_list")
        mgr = self._table_mgr(key)
        with mgr.write() as table:
            if any(len(v) != table.dim for v in vec_list):
                raise ValueError("Dimension mismatch for vec_list")
            table.batch_add(vec_list, metadata_list)

    def delete(self, key: str, pattern: dict[str, str]) -> int:
        mgr = self._table_mgr(key)
        with mgr.write() as table:
            return table.delete(pattern)

    def build_hnsw_index(self, key: str, ef_construction: int | None = None) -> None:
        mgr = self._table_mgr(key)
        with mgr.write() as table:
            table.build_hnsw_index(ef_construction)

    def clear_hnsw_index(self, key: str) -> None:
        mgr = self._table_mgr(key)
        with mgr.write() as table:
            table.clear_hnsw_index()

    def has_hnsw_index(self, key: str) -> bool:
        mgr = self._table_mgr(key)
        with mgr.read():
            return mgr.obj.has_hnsw_index()

    def build_pq_table(
        self,
        key: str,
        train_proportion: float | None = None,
        n_bits: int | None = None,
        m: int | None = None,
    ) -> None:
        mgr = self._table_mgr(key)
        with mgr.write() as table:
            table.build_pq_table(train_proportion, n_bits, m)

    def clear_pq_table(self, key: str) -> None:
        mgr = self._table_mgr(key)
        with mgr.write() as table:
            table.clear_pq_table()

    def has_pq_table(self, key: str) -> bool:
        mgr = self._table_mgr(key)
        with mgr.read():
            return mgr.obj.has_pq_table()

    def search(
        self,
        key: str,
        query,
        k: int,
        ef: int | None = None,
        upper_bound: float | None = None,
    ) -> list[tuple[dict[str, str], float]]:
        with span("db.search"):
            mgr = self._table_mgr(key)
            with mgr.read():
                return mgr.obj.search(query, k, ef, upper_bound)

    def batch_search(
        self,
        key: str,
        queries,
        k: int,
        ef: int | None = None,
        upper_bound: float | None = None,
    ):
        with span("db.batch_search"):
            mgr = self._table_mgr(key)
            with mgr.read():
                return mgr.obj.batch_search(queries, k, ef, upper_bound)

    def extract_data(self, key: str):
        mgr = self._table_mgr(key)
        with mgr.read():
            return mgr.obj.extract_data()

    # ---- persistence lifecycle ----
    def force_save(self) -> None:
        self._brief_mgr.sync_save(stop_thread=False)
        with self._tables_lock:
            mgrs = list(self._tables.values())
        for mgr in mgrs:
            mgr.sync_save(stop_thread=False)

    def close_if_open(self) -> None:
        if not self._closed:
            self.close()

    def close(self) -> None:
        """Flush everything and release the lock (mod.rs:523-535)."""
        if self._closed:
            return
        self._closed = True
        self._brief_mgr.close()
        with self._tables_lock:
            mgrs = list(self._tables.items())
            self._tables.clear()
        for _, mgr in mgrs:
            mgr.close()
        try:
            import fcntl

            fcntl.flock(self._lock_file.fileno(), fcntl.LOCK_UN)
        except OSError:
            pass
        self._lock_file.close()

    def __del__(self):
        try:
            self.close_if_open()
        except Exception:
            pass
