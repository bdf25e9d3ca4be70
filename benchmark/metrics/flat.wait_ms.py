"""Host ms a call inside the span `flat.fetch`: the host waiting for the card at B = 1000."""

from benchmark.spans import fetch_ms as read  # noqa: F401
