"""Host ms a call inside the span `u8.fetch`: the results' copies to the
host, where the host waits for the card (gist_u8_100m.b1000).  None where
the window holds no `u8.knn_batch` span."""

from benchmark import spans


def read(run):
    if run.trace is None or not spans.merged(run.trace, "u8.knn_batch"):
        return None
    return spans.span_seconds(run.trace, "u8.fetch") / run.calls * 1e3
