"""K7's share of its roofline (%): its byte bound at the cell's (rows, m,
batch) (`roofline_pq.k7_bound_s`) over its mean traced time a launch
(gist1m_pq.b1000).  None where the trace holds no launch of it."""

from benchmark import roofline_pq


def read(run):
    if run.trace is None:
        return None
    k = roofline_pq.matcher()
    launches = run.trace.device_count(k)
    if not launches:
        return None
    t = run.trace.device_seconds(k) / launches
    b = 1 if run.traffic["call"] == "single" else run.traffic["batch"]
    return 100.0 * roofline_pq.k7_bound_s(run.config["rows"], run.config["pq"]["m"], b) / t
