"""The card's idle share in the traced window of gist1m_pq.b1000."""

from benchmark.readers import idle_share as read  # noqa: F401
