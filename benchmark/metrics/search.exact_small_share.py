"""Share of `VecDB.search` calls in the traced window that took the exact
small-batch kernel: the count of `scan.exact_small` spans over the count of
`db.search` spans (vecdb_cos200k.single).  None where the program has no
such route (its module `ops/scan_small.py` is not loaded) or the window
holds no `db.search` span."""

import sys

ROUTE_MODULE = "lab_1806_vec_db_tpu_torch.ops.scan_small"


def _count(trace, name: str) -> int:
    t0, t1 = trace.window
    return sum(1 for n, s, _ in trace.host if n == name and t0 <= s <= t1)


def read(run):
    if run.trace is None or ROUTE_MODULE not in sys.modules:
        return None
    searches = _count(run.trace, "db.search")
    if not searches:
        return None
    return _count(run.trace, "scan.exact_small") / searches
