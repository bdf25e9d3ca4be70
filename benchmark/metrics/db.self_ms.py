"""Host ms a `VecDB.search` inside `db.search` and outside its `flat.*` spans: lock, cast, join."""

from benchmark.spans import db_self_ms as read  # noqa: F401
