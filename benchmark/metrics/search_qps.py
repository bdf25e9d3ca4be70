"""Single queries a second, one caller in a closed loop (host clock, the whole window): the inverse of a search's mean latency."""

from benchmark.readers import queries_per_s as read  # noqa: F401
