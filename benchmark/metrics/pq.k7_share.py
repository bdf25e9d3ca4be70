"""Share of the traced window's Flat+PQ searches that took K7's route: the
count of `pq.k7` spans over the count of `flat.knn_pq_batch` spans
(gist1m_pq.b1000), 1.0 where every call scanned through K7.  None where
the PQ table's module (`models/pq_table.py`) is not loaded or the window
holds no `flat.knn_pq_batch` span."""

import sys

ROUTE_MODULE = "lab_1806_vec_db_tpu_torch.models.pq_table"


def _count(trace, name: str) -> int:
    t0, t1 = trace.window
    return sum(1 for n, s, _ in trace.host if n == name and t0 <= s <= t1)


def read(run):
    if run.trace is None or ROUTE_MODULE not in sys.modules:
        return None
    calls = _count(run.trace, "flat.knn_pq_batch")
    if not calls:
        return None
    return _count(run.trace, "pq.k7") / calls
