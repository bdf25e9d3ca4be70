"""`VecDB`, the package's public API: one table in a fresh directory under
`TMPDIR`, filled by one `batch_add` of host rows with the metadata
`{"id": "<row>"}`, searched by `batch_search` ("batch" traffic) or `search`
("single").  Set-up ends with `force_save()`, so the background saver finds
nothing dirty in the window; `close()` flushes nothing more and the directory
is removed."""

from __future__ import annotations

import shutil
import tempfile

import numpy as np

KEY = "bench"


class System:
    def __init__(self, ctx):
        from lab_1806_vec_db_tpu_torch import VecDB

        cfg = ctx.config
        rows = ctx.make_rows().cpu().numpy()
        self.n = len(rows)
        self.dir = tempfile.mkdtemp(prefix="vecdb_bench_")
        self.db = VecDB(self.dir, device=ctx.device, scan=cfg["scan"])
        self.db.create_table_if_not_exists(KEY, cfg["dim"], cfg["dist"])
        self.db.batch_add(KEY, rows, [{"id": str(i)} for i in range(self.n)])
        del rows
        self.k = ctx.traffic["k"]
        self.single = ctx.traffic["call"] == "single"

    def call(self, q):
        if self.single:
            return self.db.search(KEY, q, self.k)
        return self.db.batch_search(KEY, q, self.k)

    def ready(self):
        self.db.force_save()

    def answers(self, raw, k: int):
        """(ids (b, k) int64, distances (b, k) float64, malformed (b,) bool):
        a hit's row is the one its metadata names; metadata that names no
        row makes the answer malformed."""
        if self.single:
            raw = [raw]
        ids = np.full((len(raw), k), -1, np.int64)
        dists = np.full((len(raw), k), np.inf)
        bad = np.zeros(len(raw), bool)
        for a, hits in enumerate(raw):
            for j, (meta, d) in enumerate(hits[:k]):
                s = meta.get("id") if isinstance(meta, dict) and len(meta) == 1 else None
                if isinstance(s, str) and s.isdigit() and int(s) < self.n:
                    ids[a, j], dists[a, j] = int(s), d
                else:
                    bad[a] = True
            bad[a] |= len(hits) > k
        return ids, dists, bad

    def close(self):
        self.db.close()
        self.db = None
        shutil.rmtree(self.dir, ignore_errors=True)


def setup(ctx) -> System:
    return System(ctx)


def target(traffic) -> tuple:
    """(class, method name) that `System.call` goes through for `traffic`:
    `VecDB.batch_search` ("batch") or `VecDB.search` ("single")."""
    from lab_1806_vec_db_tpu_torch import VecDB

    return VecDB, "search" if traffic["call"] == "single" else "batch_search"
