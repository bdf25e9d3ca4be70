"""The Flat planner's device ms a call outside K1 and K2, at B = 1000."""

from benchmark.readers import flat_glue_ms as read  # noqa: F401
