"""Share of stage-1 searches in the traced window whose survivor select took
the hand-written kernel: the count of `scan.select` spans over the count of
`flat.k1` spans (gist1m_flat.b1000).  None where the program has no such
route (its module `ops/survivors.py` is not loaded) or the window holds no
`flat.k1` span."""

import sys

ROUTE_MODULE = "lab_1806_vec_db_tpu_torch.ops.survivors"


def _count(trace, name: str) -> int:
    t0, t1 = trace.window
    return sum(1 for n, s, _ in trace.host if n == name and t0 <= s <= t1)


def read(run):
    if run.trace is None or ROUTE_MODULE not in sys.modules:
        return None
    searches = _count(run.trace, "flat.k1")
    if not searches:
        return None
    return _count(run.trace, "scan.select") / searches
