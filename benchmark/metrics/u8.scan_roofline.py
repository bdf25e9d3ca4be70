"""The uint8 stage 1's share of its roofline (%): its bound at the cell's
(rows, dim, batch) (`roofline_u8.u8_scan_bound_s`) over its mean traced time
a launch (gist_u8_100m.b1000).  None where the trace holds no launch of it."""

from benchmark import roofline_u8


def read(run):
    if run.trace is None:
        return None
    k = roofline_u8.matcher()
    launches = run.trace.device_count(k)
    if not launches:
        return None
    t = run.trace.device_seconds(k) / launches
    b = 1 if run.traffic["call"] == "single" else run.traffic["batch"]
    return 100.0 * roofline_u8.u8_scan_bound_s(run.config["rows"], run.config["dim"], b) / t
