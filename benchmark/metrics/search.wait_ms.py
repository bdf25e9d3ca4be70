"""Host ms a `VecDB.search` inside the span `flat.fetch`: the host waiting for the card."""

from benchmark.spans import fetch_ms as read  # noqa: F401
