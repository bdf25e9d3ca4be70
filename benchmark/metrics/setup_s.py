"""Seconds from process start to the first timed call: imports, the kernel
library's build or load, the data made, ingest, index build, warm-up and,
for a `VecDB`, the table's first save."""


def read(run):
    return run.setup_s
