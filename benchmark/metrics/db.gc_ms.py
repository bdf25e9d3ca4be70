"""Host ms a `VecDB.search` inside the span `py.gc.full` within `db.search`: the search's full collections."""

from benchmark.spans import gc_ms as read  # noqa: F401
