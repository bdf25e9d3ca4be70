"""A test-only entry: the port's exact uint8 Flat index (`FlatIndexU8`) as it
is built today, from rows copied to the host (`from_numpy`), searched by
`knn_batch` ("batch" traffic) or `knn` ("single").  No committed cell uses it,
so it stays out of `entries/`; the tests run it on `bench_cells.u8_cell()` to
show that the harness holds a uint8 program served by an entry of its own."""

from benchmark.entries import flat_index


class System(flat_index.System):
    """`flat_index`'s calls and answers over a `FlatIndexU8`, whose
    `knn_batch` and `knn` return what `FlatIndex`'s do."""

    def __init__(self, ctx):
        from lab_1806_vec_db_tpu_torch.models import FlatIndexU8

        self.index = FlatIndexU8.from_numpy(ctx.make_rows().cpu().numpy(), ctx.config["dist"], device=ctx.device)
        self.k = ctx.traffic["k"]
        self.single = ctx.traffic["call"] == "single"


def setup(ctx) -> System:
    return System(ctx)


def target(traffic) -> tuple:
    """`FlatIndexU8.knn_batch` ("batch") or `FlatIndexU8.knn` ("single")."""
    from lab_1806_vec_db_tpu_torch.models import FlatIndexU8

    return FlatIndexU8, "knn" if traffic["call"] == "single" else "knn_batch"
