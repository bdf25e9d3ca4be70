"""`FlatIndex`, the index layer: rows made on the device from the seed and
ingested in place (`VecStore.from_device`), searched by `knn_batch` ("batch"
traffic, host float32 queries in, host arrays out) or `knn` ("single")."""

from __future__ import annotations

import numpy as np


class System:
    def __init__(self, ctx):
        from lab_1806_vec_db_tpu_torch.models import FlatIndex, VecStore
        from lab_1806_vec_db_tpu_torch.models.store import ScanMode

        cfg = ctx.config
        store = VecStore.from_device(ctx.make_rows(), cfg["dist"])
        store.scan_mode = ScanMode(cfg["scan"])
        self.index = FlatIndex.from_store(store)
        self.k = ctx.traffic["k"]
        self.single = ctx.traffic["call"] == "single"

    def call(self, q):
        if self.single:
            return self.index.knn(q, self.k)
        return self.index.knn_batch(q, self.k)

    def answers(self, raw, k: int):
        """(ids (b, k) int64, distances (b, k) float64, malformed (b,) bool)."""
        if self.single:
            raw = (np.array([[p.distance for p in raw]], np.float64),
                   np.array([[p.index for p in raw]], np.int64))
        d, i = raw
        d, i = np.asarray(d, np.float64), np.asarray(i, np.int64)
        if d.shape[1] < k:
            pad = ((0, 0), (0, k - d.shape[1]))
            d, i = np.pad(d, pad, constant_values=np.inf), np.pad(i, pad, constant_values=-1)
        return i[:, :k], d[:, :k], np.zeros(len(i), bool)

    def close(self):
        self.index = None


def setup(ctx) -> System:
    return System(ctx)


def target(traffic) -> tuple:
    """(class, method name) that `System.call` goes through for `traffic`:
    `FlatIndex.knn_batch` ("batch") or `FlatIndex.knn` ("single")."""
    from lab_1806_vec_db_tpu_torch.models import FlatIndex

    return FlatIndex, "knn" if traffic["call"] == "single" else "knn_batch"
