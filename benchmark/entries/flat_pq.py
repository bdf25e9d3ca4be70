"""`FlatIndex` with a PQ table, the upstream's Flat+PQ search: rows made on
the device from the seed and ingested in place (`VecStore.from_device`, as
`flat_index` does), a `PQTable` trained on the store's device rows through
the table's defaults (`models/pq_table.py:table_config`, what
`VecDB.build_pq_table()` trains: the configuration's `pq` states them and
set-up refuses a table that differs), searched by `knn_pq_batch` at the
configuration's `ef` ("batch" traffic) or `knn_pq` ("single"), whose answers
are `flat_index`'s."""

from __future__ import annotations

from benchmark import synth
from benchmark.entries import flat_index


class System(flat_index.System):
    """`flat_index`'s answers over `FlatIndex.knn_pq_batch` / `knn_pq`."""

    def __init__(self, ctx):
        from lab_1806_vec_db_tpu_torch.models import FlatIndex, PQTable, VecStore
        from lab_1806_vec_db_tpu_torch.models.pq_table import table_config

        cfg = ctx.config
        self.index = FlatIndex.from_store(VecStore.from_device(ctx.make_rows(), cfg["dist"]))
        n = len(self.index)
        pq = cfg["pq"]
        config = table_config(n, cfg["dim"], cfg["dist"])
        if config != table_config(n, cfg["dim"], cfg["dist"], pq["train_proportion"], pq["n_bits"], pq["m"]):
            raise ValueError(f"the table's defaults give {config}, not the configuration's pq {pq}")
        vecs, _ = self.index.store.device()
        self.pq = PQTable.train(vecs, config, seed=synth.sub_seed(ctx.seed, "pq"), n_valid=n)
        self.ef = cfg["ef"]
        self.k = ctx.traffic["k"]
        self.single = ctx.traffic["call"] == "single"

    def call(self, q):
        if self.single:
            return self.index.knn_pq(q, self.k, self.ef, self.pq)
        return self.index.knn_pq_batch(q, self.k, self.ef, self.pq)

    def close(self):
        self.index = self.pq = None


def setup(ctx) -> System:
    return System(ctx)


def target(traffic) -> tuple:
    """`FlatIndex.knn_pq_batch` ("batch") or `FlatIndex.knn_pq` ("single")."""
    from lab_1806_vec_db_tpu_torch.models import FlatIndex

    return FlatIndex, "knn_pq" if traffic["call"] == "single" else "knn_pq_batch"
