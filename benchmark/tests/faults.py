"""Planted faults and call counts on the method an entry names as its target
(`target(traffic) -> (class, method name)`, see `core.py`).  The faults act
on what the target returns, whatever the entry: a (distances, ids) pair of
(b, k) arrays, one answer's list of hits (each a `CandidatePair` or a
(metadata, distance) pair), or a list of such answers, one a query."""

import numpy as np

from benchmark import core

FAULTS = ("state_unchanged", "half_batch_left_out", "answer_altered")


def faults_of(traffic: dict) -> list:
    """The faults a cut cell of `traffic` can have: a single-query call has
    no half batch, and one card no exchange between chips."""
    return [f for f in FAULTS if not (f == "half_batch_left_out" and traffic["call"] == "single")]


def _arrays(res) -> bool:
    return isinstance(res, tuple) and len(res) == 2 and all(isinstance(a, np.ndarray) for a in res)


def _halve(res):
    """Half of the batch's answers left out."""
    if _arrays(res):
        d, i = res
        return d[: len(d) // 2], i[: len(i) // 2]
    return res[: len(res) // 2]


def _alter_first(res, n: int):
    """The first hit of the first answer names the next of the `n` rows."""
    if _arrays(res):
        d, i = res
        i = i.copy()
        i[0, 0] = (i[0, 0] + 1) % n
        return d, i
    if isinstance(res, list):  # answers, or one answer's hits
        return [_alter_first(res[0], n)] + res[1:]
    if isinstance(res, tuple):  # a (metadata, distance) hit, the metadata naming its row
        meta, d = res
        return {"id": str((int(meta["id"]) + 1) % n)}, d
    return type(res)((res.index + 1) % n, res.distance)  # a CandidatePair


def plant(monkeypatch, target: tuple, fault: str, n: int) -> None:
    """Break the target's method of a table of `n` rows with `fault`."""
    cls, method = target
    real = getattr(cls, method)
    first = []

    def broken(self, *a, **kw):
        res = real(self, *a, **kw)
        if fault == "state_unchanged":  # every call returns the first call's answers
            if not first:
                first.append(res)
            return first[0]
        if fault == "half_batch_left_out":
            return _halve(res)
        return _alter_first(res, n)

    monkeypatch.setattr(cls, method, broken)


def count_calls(monkeypatch, target: tuple) -> list:
    """Wrap the target's method to count its calls -> a list that gains one
    entry a call."""
    cls, method = target
    real = getattr(cls, method)
    calls = []

    def counted(self, *a, **kw):
        calls.append(None)
        return real(self, *a, **kw)

    monkeypatch.setattr(cls, method, counted)
    return calls


def expected_calls(cell, out) -> int:
    """The calls a run of `cell` makes: its warm-up calls and the window's."""
    pool, batch = cell.traffic["pool"], cell.traffic["batch"]
    return min(core.WARM_CALLS, pool // batch) + out["result"]["attempted"] // batch
