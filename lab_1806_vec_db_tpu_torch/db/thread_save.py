"""Background auto-saving.

Parity target: `ThreadSavingManager` (reference: src/database/thread_save.rs):
- a daemon thread wakes every `interval` (condvar with timeout,
  thread_save.rs:47-66) and saves iff the dirty mark is set
- writes are atomic: tmp file then replace (thread_save.rs:11-21; our
  `utils.serde.save_arrays` does tmp + os.replace)
- `sync_save(stop_thread)` flushes on demand and on close
  (thread_save.rs:77-90)
- mutating accessors set the dirty mark (thread_save.rs:109-113)

The guarded object is behind a many-readers/one-writer lock, matching the
reference's `RwLock<MetadataVecTable>` (src/database/mod.rs:157): concurrent
searches on one table run truly in parallel (each releases the GIL inside
the batched device calls), while writes are exclusive.

Lock order mirrors the reference's documented discipline
(thread_save.rs:27): mark -> obj -> stop_cond.
"""

from __future__ import annotations

import threading


class RwLock:
    """Writer-preferring many-readers/one-writer lock.

    Python's stdlib has no RwLock; this is the standard condvar
    construction.  Writer preference (new readers wait while a writer is
    queued) matches parking_lot's policy — the reference's `RwLock`
    (std on linux = writer-nonstarving futex) — and keeps the dirty-mark
    writers from starving under a heavy search load.  Non-reentrant: the
    DB layer only takes it in non-nested `with` blocks.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    class _ReadGuard:
        __slots__ = ("_rw",)

        def __init__(self, rw: "RwLock"):
            self._rw = rw

        def __enter__(self):
            self._rw.acquire_read()
            return self._rw

        def __exit__(self, *exc):
            self._rw.release_read()
            return False

    def read_locked(self) -> "_ReadGuard":
        return self._ReadGuard(self)


class ThreadSavingManager:
    """Wraps an object exposing `save(path)` with periodic dirty-marked
    background saves, shared read access, and exclusive write access."""

    def __init__(self, obj, target: str, interval: float, mark: bool):
        self.obj = obj
        self.target = target
        self._obj_lock = RwLock()
        self._mark_lock = threading.Lock()
        self._mark = mark
        self._stop = False
        self._stop_cond = threading.Condition(threading.Lock())
        self._thread = threading.Thread(
            target=self._loop, args=(interval,), daemon=True
        )
        self._thread.start()

    def _loop(self, interval: float) -> None:
        while True:
            with self._stop_cond:
                self._stop_cond.wait_for(lambda: self._stop, timeout=interval)
                if self._stop:
                    return
            self._save_if_dirty()

    def _save_if_dirty(self) -> None:
        with self._mark_lock:
            if not self._mark:
                return
            # save() only reads the object, so the saver shares the lock
            # with concurrent searches and excludes only writers
            self._obj_lock.acquire_read()
            try:
                self.obj.save(self.target)
            finally:
                self._obj_lock.release_read()
            self._mark = False

    def sync_save(self, stop_thread: bool) -> None:
        self._save_if_dirty()
        if stop_thread:
            with self._stop_cond:
                self._stop = True
                self._stop_cond.notify_all()

    # ---- guarded access ----
    def read(self):
        """Context manager for SHARED read access — concurrent readers
        (searches) proceed in parallel (mod.rs:157 RwLock semantics)."""
        return self._obj_lock.read_locked()

    class _WriteGuard:
        def __init__(self, mgr: "ThreadSavingManager"):
            self.mgr = mgr

        def __enter__(self):
            # lock order mark -> obj, matching _save_if_dirty and the
            # reference's documented discipline (thread_save.rs:27) —
            # acquiring obj first here deadlocks against the saver thread
            mgr = self.mgr
            mgr._mark_lock.acquire()
            try:
                mgr._obj_lock.acquire_write()
                mgr._mark = True
            finally:
                mgr._mark_lock.release()
            return mgr.obj

        def __exit__(self, *exc):
            self.mgr._obj_lock.release_write()
            return False

    def write(self) -> "_WriteGuard":
        """Context manager for EXCLUSIVE write access; sets the dirty mark."""
        return self._WriteGuard(self)

    def close(self) -> None:
        self.sync_save(stop_thread=True)
        self._thread.join(timeout=5.0)
