"""What several metric readers (`metrics/<metric>.py`) share: one quantity
read the same way in cells whose end-to-end metrics differ."""

from __future__ import annotations

from . import roofline


def queries_per_s(run):
    """Queries answered by the window's calls over the window's seconds
    (host clock: from the first call's start to the last call's end)."""
    return run.queries / run.window_s


def idle_share(run):
    """1 - (union of the card's traced operations) / the traced window."""
    if run.trace is None or not run.trace.device:
        return None
    return run.trace.idle_share


def launches_per_call(run):
    """Operations on the card (kernels, copies, memsets) per call in the
    traced window: the fixed cost of one search's plan."""
    if run.trace is None or not run.trace.device:
        return None
    return run.trace.device_count() / run.calls


def flat_glue_ms(run):
    """Device milliseconds per call of every traced operation on the card
    that is neither K1 nor K2: the Flat planner's quantize, top-r sort, id
    decode and top-k, and the query and result copies."""
    if run.trace is None or not run.trace.device:
        return None
    k1, k2 = roofline.kernel_matcher("k1"), roofline.kernel_matcher("k2")
    if not run.trace.device_count(k1):
        return None
    return run.trace.device_seconds(lambda n: not (k1(n) or k2(n))) / run.calls * 1e3


def k1_roofline(run):
    """K1's share of its roofline in %: the bound of one launch at the cell's
    (rows, dim, batch) (`roofline.k1_bound_s`) over K1's mean traced time a
    launch."""
    if run.trace is None:
        return None
    k1 = roofline.kernel_matcher("k1")
    launches = run.trace.device_count(k1)
    if not launches:
        return None
    t = run.trace.device_seconds(k1) / launches
    b = 1 if run.traffic["call"] == "single" else run.traffic["batch"]
    return 100.0 * roofline.k1_bound_s(run.config["rows"], run.config["dim"], b) / t
