"""The card's idle share in the traced window of gist_u8_100m.b1000."""

from benchmark.readers import idle_share as read  # noqa: F401
