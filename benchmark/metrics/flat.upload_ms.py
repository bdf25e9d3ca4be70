"""Host ms a call inside the span `flat.upload`: the 3.84 MB query copy at B = 1000."""

from benchmark.spans import upload_ms as read  # noqa: F401
