"""Card-idle ms a call whose gap's middle lies inside the span
`flat.knn_pq_batch`: the upload, the host's work between launches and the
fetch's sync, where the card waits on the host (gist1m_pq.b1000).  None
where the window holds no `flat.knn_pq_batch` span."""

from benchmark import spans


def read(run):
    if run.trace is None or not spans.merged(run.trace, "flat.knn_pq_batch"):
        return None
    return spans.idle_seconds_in(run.trace, "flat.knn_pq_batch") / run.calls * 1e3
