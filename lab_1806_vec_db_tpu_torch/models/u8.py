"""uint8 vector storage and the exact uint8 Flat search (port of
lab_1806_vec_db_tpu/models/u8.py).

`U8VecSet` keeps the canonical rows as host uint8 (4x smaller than an f32
cast; the reference's `VecSet<u8>`, src/vec_set.rs:15-203) and mirrors them
on the device as the centered-int8 channels of `ops/u8.py`, so searches run
EXACT integer distances through int8 GEMMs and never cast the set to f32.
`FlatIndexU8` is the u8 Flat index (flat_index.rs:17-57).  Checkpoints are
the JAX package's: algorithm "FlatU8", the rows under "vectors_u8".
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .store import _round_cap
from ..ops import distance as D
from ..ops import u8 as U8
from ..utils import io as IO
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays
from ..utils.device import resolve

_MIN_CAP = 8
_POISON_IP = 2**30  # ip of capacity-padding rows: they lose every l2sqr comparison


class U8VecSet:
    """Growable uint8 row storage with device-mirrored int8 channels."""

    def __init__(self, dim: int, dist: str = "l2sqr", capacity: int = 0, device="cuda"):
        D.check_dist(dist)
        self.torch_device = resolve(device)
        self.dim = int(dim)
        self.dist = dist
        self._n = 0
        self._cap = _round_cap(max(capacity, _MIN_CAP))
        self._data = np.zeros((self._cap, self.dim), np.uint8)
        self._dev: tuple | None = None  # (x8 int8, ip int32, s8 int32), (cap, ...)
        # concurrent searches share the set: the lazy device sync runs under
        # this lock, once
        self._lock = threading.Lock()

    @classmethod
    def from_numpy(cls, vectors: np.ndarray, dist: str = "l2sqr", device="cuda") -> "U8VecSet":
        vectors = np.atleast_2d(np.asarray(vectors))
        if vectors.dtype != np.uint8:
            raise ValueError(f"U8VecSet requires uint8 rows, got {vectors.dtype}")
        vs = cls(vectors.shape[1], dist, capacity=len(vectors), device=device)
        if len(vectors):
            vs.batch_push(vectors)
        return vs

    def __len__(self) -> int:
        return self._n

    def numpy(self) -> np.ndarray:
        return self._data[: self._n]

    def __getitem__(self, i: int) -> np.ndarray:
        if not (0 <= i < self._n):
            raise IndexError(i)
        return self._data[i]

    # ---- mutation (vec_set.rs:116-137) ----
    def _grow_to(self, n: int) -> None:
        if n <= self._cap:
            return
        self._cap = _round_cap(n)
        new = np.zeros((self._cap, self.dim), np.uint8)
        new[: self._n] = self._data[: self._n]
        self._data = new

    def push(self, vec) -> int:
        return self.batch_push(np.asarray(vec, np.uint8)[None, :])[0]

    def batch_push(self, vecs: np.ndarray) -> list[int]:
        vecs = np.atleast_2d(np.asarray(vecs))
        if vecs.dtype != np.uint8:
            raise ValueError(f"U8VecSet requires uint8 rows, got {vecs.dtype}")
        if vecs.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: {vecs.shape[1]} != {self.dim}")
        n0 = self._n
        self._grow_to(n0 + len(vecs))
        self._data[n0 : n0 + len(vecs)] = vecs
        self._n += len(vecs)
        self._dev = None
        return list(range(n0, self._n))

    def swap_remove(self, i: int) -> None:
        """Remove row i by moving the last row into it (vec_set.rs:131-137)."""
        if not (0 <= i < self._n):
            raise IndexError(i)
        last = self._n - 1
        if i != last:
            self._data[i] = self._data[last]
        self._data[last] = 0
        self._n = last
        self._dev = None

    def random_sample(self, size: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform row sample without replacement (vec_set.rs:154-163)."""
        size = min(size, self._n)
        sel = rng.choice(self._n, size=size, replace=False)
        return self._data[np.sort(sel)]

    def to_f32(self) -> np.ndarray:
        """Dtype conversion (`VecSet::to_type`, vec_set.rs:142-149)."""
        return self._data[: self._n].astype(np.float32)

    # ---- device mirror ----
    def device(self):
        """Synced (x8 (cap, dim) int8, ip (cap,) int32, s8 (cap,) int32);
        capacity-padding rows carry ip 2^30."""
        with self._lock:
            if self._dev is None:
                x8, ip, s8 = U8.u8_channels(torch.from_numpy(self._data).to(self.torch_device))
                row = torch.arange(self._cap, device=self.torch_device)
                self._dev = (x8, torch.where(row < self._n, ip, _POISON_IP).to(torch.int32), s8)
            return self._dev

    def device_bytes(self) -> int:
        """Bytes of the live device channels (0 before the first sync)."""
        return sum(t.numel() * t.element_size() for t in self._dev or ())

    # ---- raw binary round trip (scalar.rs:89-105 for u8) ----
    def save_raw(self, path) -> None:
        IO.save_raw(path, self._data[: self._n])

    @classmethod
    def load_raw(cls, path, dim: int, dist: str = "l2sqr", limit: int | None = None,
                 device="cuda") -> "U8VecSet":
        return cls.from_numpy(IO.load_raw(path, dim, dtype="uint8", limit=limit), dist, device=device)


class FlatIndexU8:
    """Exact brute-force kNN over a u8 vector set: the u8 instantiation of
    the reference's generic FlatIndex (flat_index.rs:17-57)."""

    algorithm = "FlatU8"

    def __init__(self, dim: int, dist: str = "l2sqr", capacity: int = 0, device="cuda"):
        self.store = U8VecSet(dim, dist, capacity, device=device)

    @classmethod
    def from_numpy(cls, vectors: np.ndarray, dist: str = "l2sqr", device="cuda") -> "FlatIndexU8":
        idx = cls.__new__(cls)
        idx.store = U8VecSet.from_numpy(vectors, dist, device=device)
        return idx

    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def dist(self) -> str:
        return self.store.dist

    @property
    def device(self) -> torch.device:
        return self.store.torch_device

    def __len__(self) -> int:
        return len(self.store)

    def index_bytes(self) -> int:
        return self.store.device_bytes()

    def add(self, vec) -> int:
        return self.store.push(vec)

    def batch_add(self, vecs) -> list[int]:
        return self.store.batch_push(vecs)

    def _knn_device(self, queries: torch.Tensor, k: int):
        """kNN of (B, dim) uint8 queries already on the device -> ((B, k)
        f32, (B, k) int32) tensors there, -1 padded."""
        x8, ip, s8 = self.store.device()
        return U8.knn_scan_u8(queries, x8, ip, s8, len(self.store), k, self.dist)

    def knn_batch(self, queries, k: int):
        """((B, k) f32 distances ascending, (B, k) int32 ids) as numpy, -1
        padded; exact integers for l2sqr."""
        queries = np.atleast_2d(np.asarray(queries))
        if queries.dtype != np.uint8:
            raise ValueError(f"u8 index takes uint8 queries, got {queries.dtype}")
        B = len(queries)
        if len(self.store) == 0:
            return np.full((B, k), np.inf, np.float32), np.full((B, k), -1, np.int32)
        d, i = self._knn_device(torch.from_numpy(np.ascontiguousarray(queries)).to(self.device), k)
        return d.cpu().numpy(), i.cpu().numpy()

    def knn(self, query, k: int) -> list[CandidatePair]:
        d, i = self.knn_batch(np.asarray(query, np.uint8)[None, :], k)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]:
        # Flat ignores ef (dynamic_index.rs:75-80)
        return self.knn(query, k)

    # ---- serde (flat_index.rs:72-83: the set plus the dist tag) ----
    def state(self, include_vectors: bool = True) -> tuple[dict, dict]:
        arrays = {"vectors_u8": self.store.numpy().copy()} if include_vectors else {}
        meta = {"algorithm": "FlatU8", "dim": self.dim, "dist": self.dist, "n": len(self.store)}
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, external_vectors=None, device="cuda") -> "FlatIndexU8":
        vecs = arrays.get("vectors_u8", external_vectors)
        if vecs is None:
            raise ValueError("FlatIndexU8 state has no vectors and none were provided")
        idx = cls(meta["dim"], meta["dist"], device=device)
        if len(vecs):
            idx.store.batch_push(np.asarray(vecs, np.uint8))
        return idx

    def save(self, path, include_vectors: bool = True) -> None:
        arrays, meta = self.state(include_vectors)
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, external_vectors=None, device="cuda") -> "FlatIndexU8":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, external_vectors, device=device)
