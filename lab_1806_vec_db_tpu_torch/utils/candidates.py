"""Search results and ground truth.

Host-side result containers matching the reference's semantics:
- `CandidatePair` ordered by (distance, index)
  (reference: src/index_algorithm/candidate_pair.rs:10-40)
- recall@k against exact ground truth
  (reference: src/index_algorithm/candidate_pair.rs:127-140)
- `GroundTruth` persistence (reference: src/index_algorithm/candidate_pair.rs:157-191;
  our format is npz instead of bincode)

On device, "a ResultSet" is simply a pair of `(dists, ids)` arrays kept
sorted by the top-k kernels; these classes exist at the host API boundary.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True, order=False)
class CandidatePair:
    index: int
    distance: float

    def sort_key(self):
        return (self.distance, self.index)


def pairs_from_arrays(dists, ids, k: int | None = None) -> list[CandidatePair]:
    """Convert device result arrays to host CandidatePairs.

    Drops padded slots (id < 0 / non-finite distance), sorts by
    (distance, index) like the reference's BTreeSet ordering, and truncates
    to k.
    """
    dists = np.asarray(dists).reshape(-1)
    ids = np.asarray(ids).reshape(-1)
    valid = (ids >= 0) & np.isfinite(dists)
    out = [CandidatePair(int(i), float(d)) for i, d in zip(ids[valid], dists[valid])]
    out.sort(key=CandidatePair.sort_key)
    if k is not None:
        out = out[:k]
    return out


def recall(gt_indices, result_indices) -> float:
    """recalled / len(gt) (reference: candidate_pair.rs:127-140)."""
    gt = list(gt_indices)
    pred = set(int(i) for i in result_indices)
    if not gt:
        return 0.0
    return sum(1 for i in gt if int(i) in pred) / len(gt)


class GroundTruth:
    """Exact kNN indices for each test query.

    Stored as an (n_queries, k) int array in an npz file (the reference
    stores a bincode Vec<GroundTruthRow>; the shape and semantics match).
    """

    def __init__(self, rows: np.ndarray):
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim != 2:
            raise ValueError("GroundTruth rows must be (n_queries, k)")
        self.rows = rows

    def __len__(self) -> int:
        return self.rows.shape[0]

    @property
    def k(self) -> int:
        return self.rows.shape[1]

    def __getitem__(self, i: int) -> np.ndarray:
        return self.rows[i]

    def recall(self, i: int, result_indices) -> float:
        return recall(self.rows[i], result_indices)

    def batch_recall(self, result_ids: np.ndarray) -> float:
        """Mean recall@k over all queries; result_ids is (n_queries, >=1)."""
        result_ids = np.asarray(result_ids)
        total = 0.0
        for i in range(len(self)):
            total += recall(self.rows[i], result_ids[i])
        return total / max(len(self), 1)

    def save(self, path: str | os.PathLike) -> None:
        np.savez(os.fspath(path), rows=self.rows)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "GroundTruth":
        with np.load(os.fspath(path)) as z:
            return cls(z["rows"])
