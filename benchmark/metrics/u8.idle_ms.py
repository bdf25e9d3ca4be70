"""Card-idle ms a call whose gap's middle lies inside the span
`u8.knn_batch`: the upload, the centring and the fetch's sync, where the
card waits on the host (gist_u8_100m.b1000).  None where the window holds
no `u8.knn_batch` span."""

from benchmark import spans


def read(run):
    if run.trace is None or not spans.merged(run.trace, "u8.knn_batch"):
        return None
    return spans.idle_seconds_in(run.trace, "u8.knn_batch") / run.calls * 1e3
