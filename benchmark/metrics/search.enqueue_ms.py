"""Host ms a `VecDB.search` inside the span `scan.knn_scan`: enqueuing the exact scan."""

from benchmark.spans import enqueue_ms as read  # noqa: F401
