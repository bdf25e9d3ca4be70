"""K1's share of its roofline (%) at B = 1000, 1M x 960."""

from benchmark.readers import k1_roofline as read  # noqa: F401
