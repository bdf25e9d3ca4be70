"""Share of the traced window's uint8 searches that took the exact route:
the count of `u8.scan` spans over the count of `u8.knn_batch` spans
(gist_u8_100m.b1000), 1.0 where no call fell back to the library path.
None where the route's module (`models/u8.py`) is not loaded or the window
holds no `u8.knn_batch` span."""

import sys

ROUTE_MODULE = "lab_1806_vec_db_tpu_torch.models.u8"


def _count(trace, name: str) -> int:
    t0, t1 = trace.window
    return sum(1 for n, s, _ in trace.host if n == name and t0 <= s <= t1)


def read(run):
    if run.trace is None or ROUTE_MODULE not in sys.modules:
        return None
    calls = _count(run.trace, "u8.knn_batch")
    if not calls:
        return None
    return _count(run.trace, "u8.scan") / calls
