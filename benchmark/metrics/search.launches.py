"""Operations on the card per `VecDB.search` in the traced window (vecdb_cos200k.single)."""

from benchmark.readers import launches_per_call as read  # noqa: F401
