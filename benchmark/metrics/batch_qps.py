"""Queries a second of gist1m_flat.b1000's batches (host clock, the whole window)."""

from benchmark.readers import queries_per_s as read  # noqa: F401
