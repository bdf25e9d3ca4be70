"""Card-idle ms a call whose gap's middle lies inside the span `flat.knn_batch` (B = 1000)."""

from benchmark.spans import planner_idle_ms as read  # noqa: F401
