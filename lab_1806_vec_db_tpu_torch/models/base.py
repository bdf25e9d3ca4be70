"""Index capability protocols.

Parity target: the reference's à-la-carte capability trait family
(src/index_algorithm/mod.rs:35-154).  In Python these are structural
`Protocol`s — every index implements the subset it supports, and the DB
layer dispatches on them, matching the reference's trait-bound design:

| Reference trait (mod.rs)          | Protocol here        |
|-----------------------------------|----------------------|
| IndexIter (:35-52)                | IndexIter            |
| IndexBuilder (:55-83)             | IndexBuilder         |
| IndexKNN (:86-91)                 | IndexKNN             |
| IndexKNNWithEf (:94-104)          | IndexKNNWithEf       |
| IndexFromVecSet (:107-118)        | (classmethod constructors on each index) |
| IndexSerde (:120-141)             | IndexSerde           |
| IndexSerdeExternalVecSet (:143-148)| IndexSerde (external_vectors arg) |
| IndexPQ (:150-154)                | IndexPQ              |
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from ..utils.candidates import CandidatePair


@runtime_checkable
class IndexIter(Protocol):
    @property
    def dim(self) -> int: ...

    @property
    def dist(self) -> str: ...

    def __len__(self) -> int: ...


@runtime_checkable
class IndexBuilder(Protocol):
    def add(self, vec) -> int: ...

    def batch_add(self, vecs) -> list[int]: ...


@runtime_checkable
class IndexKNN(Protocol):
    def knn(self, query, k: int) -> list[CandidatePair]: ...

    def knn_batch(self, queries: np.ndarray, k: int): ...


@runtime_checkable
class IndexKNNWithEf(Protocol):
    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]: ...


@runtime_checkable
class IndexSerde(Protocol):
    def save(self, path, include_vectors: bool = True) -> None: ...

    @classmethod
    def load(cls, path, external_vectors=None): ...


@runtime_checkable
class IndexPQ(Protocol):
    def knn_pq(self, query, k: int, ef: int, pq) -> list[CandidatePair]: ...
