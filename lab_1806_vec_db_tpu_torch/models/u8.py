"""uint8 vector storage and the exact uint8 Flat search (port of
lab_1806_vec_db_tpu/models/u8.py).

`U8VecSet` keeps the canonical rows as host uint8 (4x smaller than an f32
cast; the reference's `VecSet<u8>`, src/vec_set.rs:15-203) and mirrors them
on the device as a `mirror.U8Mirror`: the rows centred by 128 and their
int32 sums, built block by block, so searches run EXACT integer distances
and never cast the set to f32.  A set ingested on the device
(`from_device`) has no host copy until a host-side access asks for one.
`FlatIndexU8` is the u8 Flat index (flat_index.rs:17-57).  Checkpoints are
the JAX package's: algorithm "FlatU8", the rows under "vectors_u8".

A search takes one of two routes, chosen by `exact_route`:

- the exact route (l2sqr on the card, width <= 129, at least k * 128 rows,
  k <= the select kernel's 1024): the uint8 stage 1 (`ops/scan.py`,
  `csrc/scan_u8_exact.cu`) keeps one (d << 7) | level survivor per 128-row
  group, the select kernel takes the k least groups, whose 128 rows each
  are scored again exactly (`U8Mirror.rescan`): exact distances, ties to
  the lower id where the k groups hold them;
- the library path (`ops/u8.py:knn_scan_u8`: int8 GEMMs through
  `torch._int_mm` and a running top-k) for every other call: cosine, wider
  rows, the CPU, small tables.

Spans: `u8.knn_batch` (a call), inside it `u8.upload`, `u8.scan` (stage 1
and the select, whose `scan.select` it holds), `u8.rescan`, `u8.fetch`;
`u8.ingest` (a mirror's build).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .mirror import U8Mirror
from .store import _round_cap
from ..ops import distance as D
from ..ops import scan as S
from ..ops import survivors as SV
from ..ops import u8 as U8
from ..utils import io as IO
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays
from ..utils.device import resolve
from ..utils.profiling import span

_MIN_CAP = 8


def exact_route(dist: str, device: torch.device, dim: int, n: int, k: int) -> bool:
    """The rule that sends a search to the exact route (module doc): l2sqr,
    a CUDA set, a width the integer packing holds exactly
    (`S.u8_exact_width`), at least k 128-row groups' worth of rows, and k
    within the select kernel's buffer."""
    return (dist == "l2sqr" and device.type == "cuda" and S.u8_exact_width(dim) and n >= k * 128
            and 1 <= k <= SV.R_MAX)


class U8VecSet:
    """Growable uint8 row storage with a device mirror (`U8Mirror`)."""

    def __init__(self, dim: int, dist: str = "l2sqr", capacity: int = 0, device="cuda"):
        D.check_dist(dist)
        self.torch_device = resolve(device)
        self.dim = int(dim)
        self.dist = dist
        self._n = 0
        self._cap = _round_cap(max(capacity, _MIN_CAP))
        self._host = np.zeros((self._cap, self.dim), np.uint8)  # None until asked for (`from_device`)
        self._mirror: U8Mirror | None = None
        # concurrent searches share the set: the lazy mirror build and host
        # copy run under this lock, once
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

    @classmethod
    def from_device(cls, rows: torch.Tensor, dist: str = "l2sqr") -> "U8VecSet":
        """A set of the (n, dim) uint8 `rows` already on their device: the
        mirror is built from them in place, block by block, with no host
        round trip, and the set keeps no reference to them; the host copy
        is made from the mirror on the first host-side access."""
        if rows.dtype != torch.uint8 or rows.dim() != 2:
            raise ValueError(f"U8VecSet requires (n, dim) uint8 rows, got {rows.dtype} {tuple(rows.shape)}")
        vs = cls(rows.shape[1], dist, device=rows.device)
        vs._n, vs._cap, vs._host = rows.shape[0], max(rows.shape[0], _MIN_CAP), None
        with span("u8.ingest"):
            vs._mirror = U8Mirror.build(rows, vs._n, dist, vs.torch_device)
        return vs

    def __len__(self) -> int:
        return self._n

    @property
    def _data(self) -> np.ndarray:
        """The (cap, dim) host rows, made from the mirror on first use."""
        with self._lock:
            if self._host is None:
                host = np.zeros((self._cap, self.dim), np.uint8)
                host[: self._n] = self._mirror.host_rows()
                self._host = host
            return self._host

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
        old = self._data
        self._cap = _round_cap(n)
        new = np.zeros((self._cap, self.dim), np.uint8)
        new[: self._n] = old[: self._n]
        self._host = new

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
        self._mirror = None
        return list(range(n0, self._n))

    def swap_remove(self, i: int) -> None:
        """Remove row i by moving the last row into it (vec_set.rs:131-137)."""
        if not (0 <= i < self._n):
            raise IndexError(i)
        data = self._data
        last = self._n - 1
        if i != last:
            data[i] = data[last]
        data[last] = 0
        self._n = last
        self._mirror = None

    def random_sample(self, size: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform row sample without replacement (vec_set.rs:154-163)."""
        size = min(size, self._n)
        sel = rng.choice(self._n, size=size, replace=False)
        return self._data[np.sort(sel)]

    def to_f32(self) -> np.ndarray:
        """Dtype conversion (`VecSet::to_type`, vec_set.rs:142-149)."""
        return self._data[: self._n].astype(np.float32)

    # ---- device mirror ----
    def mirror(self) -> U8Mirror:
        """The synced device mirror, built from the host rows on first use
        after a mutation."""
        with self._lock:
            if self._mirror is None:
                with span("u8.ingest"):
                    self._mirror = U8Mirror.build(torch.from_numpy(self._host), self._n, self.dist,
                                                  self.torch_device)
            return self._mirror

    def device(self):
        """Synced (x8 (rows, dim) int8, ip (rows,) int32, s8 (rows,) int32),
        the library path's channels (`U8Mirror.channels`); rows past n
        carry ip 2^30."""
        return self.mirror().channels()

    def device_bytes(self) -> int:
        """Bytes of the live device mirror (0 before the first sync)."""
        return self._mirror.nbytes if self._mirror is not None else 0

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

    @classmethod
    def from_device(cls, rows: torch.Tensor, dist: str = "l2sqr") -> "FlatIndexU8":
        """An index of (n, dim) uint8 rows already on their device
        (`U8VecSet.from_device`: no host round trip)."""
        idx = cls.__new__(cls)
        idx.store = U8VecSet.from_device(rows, dist)
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
        f32, (B, k) int32) tensors there, -1 padded; the route by
        `exact_route`."""
        if exact_route(self.dist, self.device, self.dim, len(self.store), k):
            return self._knn_exact(queries, k)
        x8, ip, s8 = self.store.device()
        return U8.knn_scan_u8(queries, x8, ip, s8, len(self.store), k, self.dist)

    def _knn_exact(self, queries: torch.Tensor, k: int):
        """The exact route (module doc) on any device (CPU tensors run the
        plain versions); l2sqr, at least k * 128 rows."""
        m = self.store.mirror()
        with span("u8.scan"):
            q8, qn8 = m.queries(queries)
            _, cand = m.survivors(q8, qn8, k)
        with span("u8.rescan"):
            d, rows = m.rescan(q8, qn8, cand, k)
        return d, m.decode(rows)

    def knn_batch(self, queries, k: int):
        """((B, k) f32 distances ascending, (B, k) int32 ids) as numpy, -1
        padded; exact integers for l2sqr."""
        with span("u8.knn_batch"):
            queries = np.atleast_2d(np.asarray(queries))
            if queries.dtype != np.uint8:
                raise ValueError(f"u8 index takes uint8 queries, got {queries.dtype}")
            B = len(queries)
            if len(self.store) == 0:
                return np.full((B, k), np.inf, np.float32), np.full((B, k), -1, np.int32)
            with span("u8.upload"):
                q = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
            d, i = self._knn_device(q, k)
            with span("u8.fetch"):
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
