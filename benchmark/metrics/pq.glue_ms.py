"""Device milliseconds a call of every traced operation on the card other
than K7: the lookup's build and rounding, the top-ef sort of the chunk
minima and their decode, K2's rerank and top-k, the copies
(gist1m_pq.b1000).  None where the trace holds no launch of K7."""

from benchmark import roofline_pq


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    k = roofline_pq.matcher()
    if not run.trace.device_count(k):
        return None
    return run.trace.device_seconds(lambda n: not k(n)) / run.calls * 1e3
