"""Device milliseconds a call of every traced operation on the card other
than the uint8 stage 1: the survivor select, the rescan of the chosen
groups, the copies (gist_u8_100m.b1000).  None where the trace holds no
launch of the uint8 stage 1."""

from benchmark import roofline_u8


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    k = roofline_u8.matcher()
    if not run.trace.device_count(k):
        return None
    return run.trace.device_seconds(lambda n: not k(n)) / run.calls * 1e3
