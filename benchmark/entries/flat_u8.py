"""`FlatIndexU8`, the exact uint8 Flat index: rows made on the device from the
seed and ingested there (`FlatIndexU8.from_device`, no host copy; the entry
keeps no reference to the rows), searched by `knn_batch` ("batch" traffic,
host uint8 queries in, host arrays out) or `knn` ("single"), whose answers
are `flat_index`'s."""

from __future__ import annotations

from benchmark.entries import flat_index


class System(flat_index.System):
    """`flat_index`'s calls and answers over a `FlatIndexU8`."""

    def __init__(self, ctx):
        from lab_1806_vec_db_tpu_torch.models import FlatIndexU8

        self.index = FlatIndexU8.from_device(ctx.make_rows(), ctx.config["dist"])
        self.k = ctx.traffic["k"]
        self.single = ctx.traffic["call"] == "single"


def setup(ctx) -> System:
    return System(ctx)


def target(traffic) -> tuple:
    """`FlatIndexU8.knn_batch` ("batch") or `FlatIndexU8.knn` ("single")."""
    from lab_1806_vec_db_tpu_torch.models import FlatIndexU8

    return FlatIndexU8, "knn" if traffic["call"] == "single" else "knn_batch"
