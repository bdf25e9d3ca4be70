"""The card's idle share in the traced window of vecdb_cos200k.single."""

from benchmark.readers import idle_share as read  # noqa: F401
