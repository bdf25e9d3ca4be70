"""Sharded indexes over a mesh of devices (port of parallel/sharded.py).

The JAX package has one controller: one Python process drives every chip of
a `jax.sharding.Mesh` through `shard_map`, each chip scans its row shard and
keeps a local top-k, and a `lax.all_gather` merges the per-chip bests.  The
PyTorch counterpart of a single-controller mesh is one process and an
explicit tuple of devices (`Mesh`): each shard's tensors live on that
shard's device, each shard's body is launched in turn (CUDA launches are
asynchronous, so shards on different cards overlap where a body does not
wait on the host), and the per-shard (B, k) bests are copied to the lead
device, concatenated in shard order and merged there (`_merge`, the
all-gather + top-k).  This is the layout of FAISS's `IndexShards`.  A mesh
may repeat a device: one card, or the CPU, then holds every shard.

Shard geometry is the reference's: shard = max(ceil(n / size), 8) rows,
shard s owns the contiguous rows [s * shard, s * shard + n_local[s]), and a
local id i is global id i + s * shard.  The IVF-PQ tier splits by
ceil(n / size) alone, as the reference's does.  Checkpoints keep the
canonical, unsharded rows in the `utils/serde.py` npz format with the
reference's `kind` tags, so a checkpoint re-places onto any mesh size and
loads in either package.

Kernels on these paths: the sharded HNSW's level-0 beam search runs the
fused loop on a CUDA shard (K4 `beam_pre`, K5 `beam_post`), the sharded
IVF-PQ's per-shard search K11 (`adc_chunkmin_binned`) and the overflow K7
(`adc_scan_chunkmin`).  The Flat, PQFlat and IVF bodies are plain PyTorch,
as they are XLA (not Pallas) in the reference.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..models.hnsw import BEAM_EXPAND, HNSWIndex, _make_node_dist, _pow2, _upper_links_fn
from ..models.ivf import DEFAULT_N_PROBES, _assign, _build_posting, _fit_centroids, _sorted_layout
from ..models.ivfpq import _BLOCKPAD, IVFPQIndex, _layout_encode
from ..models.pq_codes import _rows, refine_blocked
from ..models.pq_table import PQTable
from ..models.store import VecStore
from ..ops import beam as BM
from ..ops import distance as D
from ..ops import kmeans as KM
from ..ops import pq as P
from ..ops import topk as T
from ..utils import serde
from ..utils.config import HNSWConfig, IVFConfig, PQConfig
from ..utils.device import resolve

@dataclass(frozen=True)
class Mesh:
    """The devices of a sharded index, shard s on devices[s]; the lead
    device holds the queries' results and merges the shards' bests."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def __str__(self) -> str:
        return "[" + ", ".join(str(d) for d in self.devices) + "]"


def make_mesh(n_shards: int | None = None, device="cuda", devices=None) -> Mesh:
    """A mesh of `n_shards` shards (the counterpart of the reference's
    `make_mesh`, sharded.py:49-53).  `device="cuda"` places shard s on
    cuda:(s % torch.cuda.device_count()) (None shards: one per card), an
    indexed device such as "cuda:1" or "cpu" every shard on that device
    (None shards: one).  `devices=` gives the devices outright and may
    repeat one.  A mesh never holds fewer shards than asked for, and a CUDA
    mesh without a card raises (`utils/device.py:resolve`)."""
    if devices is not None:
        devs = tuple(resolve(d) for d in devices)
        if n_shards is not None and n_shards != len(devs):
            raise ValueError(f"n_shards={n_shards} but {len(devs)} devices were given")
    else:
        dev = resolve(device)
        if dev.type == "cuda" and dev.index is None:
            count = torch.cuda.device_count()
            n = count if n_shards is None else n_shards
            devs = tuple(torch.device("cuda", s % count) for s in range(max(n, 0)))
        else:
            devs = (dev,) * (1 if n_shards is None else max(n_shards, 0))
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(devs)


def _on(dev: torch.device):
    """Make `dev` the current CUDA device for a shard's launches."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _geometry(n: int, size: int) -> tuple[int, tuple[int, ...]]:
    """(shard rows, n_local per shard): the reference's shard_base split."""
    shard = max(-(-n // size), 8)
    return shard, tuple(int(min(max(n - s * shard, 0), shard)) for s in range(size))


def _as_rows(base) -> torch.Tensor:
    """Rows as an f32 tensor: a tensor stays where it is (its shards may be
    views of it), a host array is copied once."""
    if isinstance(base, torch.Tensor):
        return base if base.dtype == torch.float32 else base.float()
    return torch.from_numpy(np.array(base, dtype=np.float32, copy=True))


def shard_base(mesh: Mesh, base, dist: str):
    """Split (n, dim) rows over the mesh -> (rows per shard, dist_cache per
    shard, n_local per shard, shard size).  A shard on the device of the
    rows it comes from is a view of them; elsewhere it is copied there."""
    rows = _as_rows(base)
    shard, n_local = _geometry(rows.shape[0], mesh.size)
    parts, caches = [], []
    for s, dev in enumerate(mesh.devices):
        lo = min(s * shard, rows.shape[0])
        part = rows[lo : lo + n_local[s]]
        part = part if part.device == dev else part.to(dev)
        parts.append(part)
        caches.append(D.dist_cache(part, dist))
    return tuple(parts), tuple(caches), n_local, shard


def _queries(queries) -> torch.Tensor:
    if isinstance(queries, torch.Tensor):
        return torch.atleast_2d(queries).float()
    return torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32)))


def _empty(B: int, k: int, dev):
    """The bests of a shard without rows: +inf / -1."""
    return (torch.full((B, k), float("inf"), device=dev),
            torch.full((B, k), T.INVALID_ID, dtype=torch.int32, device=dev))


def _merge(mesh: Mesh, parts, offsets, k: int):
    """The all-gather + top-k: each shard's local (B, kk) bests to global
    ids (-1 stays -1 with distance +inf), copied to the lead device,
    concatenated along axis 1 in shard order, and a stable top-k, so ties
    go to the lower shard.  Returns ((B, k) f32, (B, k) int32) on the lead
    device, -1 / +inf padded."""
    ds, ids = [], []
    for (d, i), off in zip(parts, offsets):
        i = i.to(torch.int32)
        gi = torch.where(i >= 0, i + int(off), T.INVALID_ID)
        ds.append(torch.where(gi >= 0, d.float(), float("inf")).to(mesh.lead))
        ids.append(gi.to(mesh.lead))
    bd, bi = T.topk_smallest(torch.cat(ds, 1), torch.cat(ids, 1), k)
    return T._pad_k(bd, bi, k)


def _numpy(d, i):
    return d.cpu().numpy(), i.cpu().numpy()


def _bytes(tensors) -> int:
    """Bytes of the tensors (a shard that views the caller's rows counts
    its own span of them)."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _probe_scan(q, base, cache, posting, lens, probe, k: int, dist: str):
    """Exact top-k over the union of each query's probed lists, list by
    list: the rows of list l are gathered once and scored against the
    queries probing it in one f32 product (the cached-norm formula of
    `topk.knn_gathered`), each (query, probe) keeps its stable top-k, and
    a stable top-k over the probes in probe order gives the same selection
    as the reference's `knn_gathered` over the (B, p * lmax) gathered
    candidates (sharded.py:335-343), ties to the earlier probe, then to
    the lower row, without the (B, p * lmax, dim) gather.

    q (B, dim); base / cache the shard's rows; posting (nlist, lmax) local
    ids, lens (nlist,) host; probe (B, p).  -> ((B, k), (B, k) int32)."""
    B, p = probe.shape
    dev = q.device
    out_d = torch.full((B, p, k), float("inf"), device=dev)
    out_i = torch.full((B, p, k), T.INVALID_ID, dtype=torch.int32, device=dev)
    flat = probe.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=posting.shape[0]).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts)])
    qf = q.float()
    q_cache = D.dist_cache(qf, dist)
    for l in np.flatnonzero(counts):
        n_l = int(lens[l])
        if n_l == 0:
            continue
        sel = order[starts[l] : starts[l + 1]]
        qb, j = sel // p, sel % p
        ids = posting[l, :n_l].long()
        dots = qf[qb] @ base[ids].float().T
        if dist == "l2sqr":
            d = (q_cache[qb][:, None] + cache[ids][None, :] - 2.0 * dots).clamp_min_(0.0)
        else:
            d = 1.0 - dots / (q_cache[qb][:, None] * cache[ids][None, :]).clamp_min(1e-10)
        kk = min(k, n_l)
        td, tp = torch.sort(d, dim=1, stable=True)
        out_d[qb, j, :kk] = td[:, :kk]
        out_i[qb, j, :kk] = ids[tp[:, :kk]].to(torch.int32)
    bd, bi = T.topk_smallest(out_d.view(B, p * k), out_i.view(B, p * k), k)
    return T._pad_k(bd, bi, k)


def _load_checkpoint(path, kind: str, external_base):
    """Shared load prologue (sharded.py:134-155): read the npz, check the
    kind tag, resolve the canonical rows (inline or external)."""
    arrays, meta = serde.load_arrays(path)
    if meta.get("kind") != kind:
        raise ValueError(f"{path} is not a {kind} checkpoint (kind={meta.get('kind')!r})")
    if "base" in arrays:
        base = arrays["base"]
    else:
        if external_base is None:
            raise ValueError(f"{path} was saved without vectors; pass external_base")
        base = _as_rows(external_base)[: int(meta["n"])]  # a tensor keeps its device
    if tuple(base.shape) != (int(meta["n"]), int(meta["dim"])):
        raise ValueError(f"base shape {base.shape} != checkpointed ({meta['n']}, {meta['dim']})")
    return arrays, meta, base


def _host_rows(parts, n: int) -> np.ndarray:
    """The canonical (n, dim) rows of a sharded base."""
    return torch.cat([p.cpu() for p in parts])[:n].numpy()


class ShardedFlatIndex:
    """Exact kNN over rows sharded across the mesh (sharded.py:158-207)."""

    def __init__(self, mesh: Mesh, base, dist: str):
        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.n, self.dim = int(base.shape[0]), int(base.shape[1])
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, dist)
        self._scan = None  # per-shard bf16 copies of the two-stage path

    def index_bytes(self) -> int:
        return _bytes([*self.base, *self.cache, *(self._scan or ())])

    def save(self, path, include_vectors: bool = True) -> None:
        arrays = {"base": _host_rows(self.base, self.n)} if include_vectors else {}
        serde.save_arrays(path, arrays, dict(kind="sharded_flat", dist=self.dist, n=self.n,
                                             dim=self.dim))

    @classmethod
    def load(cls, path, mesh: Mesh, external_base=None) -> "ShardedFlatIndex":
        _, meta, base = _load_checkpoint(path, "sharded_flat", external_base)
        return cls(mesh, base, meta["dist"])

    def _knn_device(self, queries, k: int, exact: bool = True):
        """Tensor-in / tensor-out search -> ((B, k), (B, k)) on the lead
        device.  exact=True: the blocked f32 scan (`topk.knn_scan`) on each
        shard; exact=False: the two-stage path, bf16 candidates
        (`topk.scan_candidates`, r = min(max(8k, 64), shard)) then their
        exact distances (sharded.py:104-131)."""
        q = _queries(queries)
        B = q.shape[0]
        if not exact and self._scan is None:
            self._scan = tuple(b.to(torch.bfloat16) for b in self.base)
        r = min(max(8 * k, 64), self.shard)
        parts = []
        for s, dev in enumerate(self.mesh.devices):
            n_l = self.n_local[s]
            if n_l == 0:
                parts.append(_empty(B, k, dev))
                continue
            with _on(dev):
                qs = q.to(dev)
                if exact:
                    parts.append(T.knn_scan(qs, self.base[s], self.cache[s], n_l, k, self.dist))
                else:
                    _, cand = T.scan_candidates(qs, self._scan[s], self.cache[s], n_l, r, self.dist)
                    dd, ii = T.exact_distances_sorted(qs, self.base[s], cand, self.dist,
                                                      base_cache=self.cache[s])
                    parts.append((dd[:, :k], ii[:, :k]))
        return _merge(self.mesh, parts, [s * self.shard for s in range(self.mesh.size)], k)

    def knn_batch(self, queries, k: int, exact: bool = True):
        """Batched kNN -> ((B, k) f32, (B, k) int32) numpy, -1 padded."""
        return _numpy(*self._knn_device(queries, k, exact))


def kmeans_step_sharded(data, n_local, centroids, dist: str, mesh: Mesh) -> torch.Tensor:
    """One Lloyd step, data-parallel over the mesh (sharded.py:793-819):
    each shard assigns its first n_local[s] rows (the rest are padding and
    masked out) and builds its partial sums and counts with `index_add_`;
    the partials are summed on the lead device (the psum).  An empty
    cluster keeps its centroid.  `data` holds each shard's rows on its
    device (`ShardedFlatIndex.base`).  Returns (k, dim) f32 on the lead."""
    c = torch.as_tensor(centroids).to(mesh.lead, torch.float32)
    k, dim = c.shape
    counts = torch.zeros(k, device=mesh.lead)
    sums = torch.zeros((k, dim), device=mesh.lead)
    for s, dev in enumerate(mesh.devices):
        n_l = int(n_local[s])
        if n_l == 0:
            continue
        with _on(dev):
            x = data[s][:n_l].float()
            a = KM.find_nearest(x, c.to(dev), dist).long()
            cnt = torch.zeros(k, device=dev).index_add_(0, a, torch.ones(n_l, device=dev))
            sm = torch.zeros((k, dim), device=dev).index_add_(0, a, x)
        counts += cnt.to(mesh.lead)
        sums += sm.to(mesh.lead)
    return torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], c)


class ShardedPQFlatIndex:
    """PQ-accelerated exact-reranked kNN over sharded rows
    (sharded.py:210-303): one table, replicated; its codes split along the
    row axis with the rows; each shard runs the plain ADC scan to top-ef
    (`ops/pq.py:adc_scan`), then the exact top-k of those candidates
    (`topk.knn_gathered`), then the merge."""

    def __init__(self, mesh: Mesh, base, pq_table: PQTable, dist: str):
        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.pq = pq_table
        self.n, self.dim = int(base.shape[0]), int(base.shape[1])
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, dist)
        codes = torch.from_numpy(np.ascontiguousarray(pq_table.codes))
        self.codes = tuple(codes[min(s * self.shard, self.n) :][: self.n_local[s]].to(dev)
                           for s, dev in enumerate(mesh.devices))
        cb_sq = pq_table.device()[2]
        self.cb_sq = {dev: cb_sq.to(dev) for dev in set(mesh.devices)}

    def _knn_device(self, queries, k: int, ef: int | None = None):
        q = _queries(queries).to(self.pq.torch_device)
        B = q.shape[0]
        ef = max(ef or k, k)
        lookup, q_norms = self.pq.create_lookup(q)
        parts = []
        for s, dev in enumerate(self.mesh.devices):
            n_l = self.n_local[s]
            if n_l == 0:
                parts.append(_empty(B, k, dev))
                continue
            with _on(dev):
                _, cand = P.adc_scan(lookup.to(dev), self.codes[s], n_l, self.cb_sq[dev],
                                     q_norms.to(dev), ef, self.dist)
                parts.append(T.knn_gathered(q.to(dev), self.base[s], cand, k, self.dist,
                                            base_cache=self.cache[s]))
        return _merge(self.mesh, parts, [s * self.shard for s in range(self.mesh.size)], k)

    def knn_batch(self, queries, k: int, ef: int | None = None):
        return _numpy(*self._knn_device(queries, k, ef))

    def index_bytes(self) -> int:
        return self.pq.device_bytes() + _bytes([*self.base, *self.cache, *self.codes])

    def save(self, path, include_vectors: bool = True) -> None:
        pq_arrays, pq_meta = self.pq.state()
        arrays = dict(pq_arrays)
        if include_vectors:
            arrays["base"] = _host_rows(self.base, self.n)
        serde.save_arrays(path, arrays, dict(kind="sharded_pq_flat", dist=self.dist, n=self.n,
                                             dim=self.dim, **pq_meta))

    @classmethod
    def load(cls, path, mesh: Mesh, external_base=None) -> "ShardedPQFlatIndex":
        arrays, meta, base = _load_checkpoint(path, "sharded_pq_flat", external_base)
        return cls(mesh, base, PQTable.from_state(arrays, meta, device=mesh.lead), meta["dist"])


class ShardedIVFIndex:
    """IVF sharded over the mesh (sharded.py:306-486).  Replicated
    centroids, trained by k-means++ and Lloyd on a host-drawn sample
    (`models/ivf.py:_fit_centroids`), then `refine_steps` rounds of
    `kmeans_step_sharded` over every row; `centroids=` skips training.
    Each shard holds its own posting segments over its contiguous rows,
    padded to a common lmax; a search probes the same lists on every shard
    and scans only that shard's segment of each."""

    def __init__(self, mesh: Mesh, base, dist: str, config: IVFConfig, seed: int = 0,
                 refine_steps: int = 2, centroids=None):
        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.config = config
        self.n, self.dim = int(base.shape[0]), int(base.shape[1])
        self.default_n_probes = DEFAULT_N_PROBES
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, dist)
        if centroids is None:
            n_train = min(config.k_means_size or self.n, self.n)
            rng = np.random.default_rng(seed)
            sel = rng.choice(self.n, size=n_train, replace=False) if n_train < self.n else np.arange(self.n)
            rows = _as_rows(base)
            train = rows if n_train == self.n else rows[torch.from_numpy(sel).to(rows.device)]
            train = train.to(mesh.lead)
            cents = _fit_centroids(train, n_train, config, dist, seed)
            for _ in range(refine_steps):
                cents = kmeans_step_sharded(self.base, self.n_local, cents, dist, mesh)
        else:
            cents = torch.from_numpy(np.asarray(centroids, np.float32)).to(mesh.lead)
        self.centroids = cents
        self._assign = np.concatenate([_assign(self.base[s], cents.to(dev), dist)
                                       for s, dev in enumerate(mesh.devices)])
        self._place_postings()

    def _place_postings(self) -> None:
        """Per-shard posting segments from the assignment vector, padded to
        a common lmax (sharded.py:414-434): shard s's segment of list l
        holds exactly the list-l rows living on shard s, as local ids."""
        postings, self._lens = [], []
        for s in range(self.mesh.size):
            lo = s * self.shard
            post, counts = _build_posting(self._assign[lo : lo + self.n_local[s]], self.config.k)
            postings.append(post)
            self._lens.append(counts)
        lmax = max(max(p.shape[1] for p in postings), 1)
        self.posting = []
        for p, dev in zip(postings, self.mesh.devices):
            post = np.full((self.config.k, lmax), -1, np.int32)
            post[:, : p.shape[1]] = p
            self.posting.append(torch.from_numpy(post).to(dev))

    def save(self, path, include_vectors: bool = True) -> None:
        arrays = {"centroids": self.centroids.cpu().numpy(),
                  "assign": np.asarray(self._assign, np.int32)}
        if include_vectors:
            arrays["base"] = _host_rows(self.base, self.n)
        c = self.config
        serde.save_arrays(path, arrays, dict(
            kind="sharded_ivf", dist=self.dist, n=self.n, dim=self.dim, k=c.k,
            k_means_size=c.k_means_size, k_means_max_iter=c.k_means_max_iter,
            k_means_tol=c.k_means_tol))

    @classmethod
    def load(cls, path, mesh: Mesh, external_base=None) -> "ShardedIVFIndex":
        """Re-place a checkpoint onto `mesh`, of any size: the centroids and
        the (n,) assignment are global; the posting segments are rebuilt."""
        arrays, meta, base = _load_checkpoint(path, "sharded_ivf", external_base)
        self = cls.__new__(cls)
        self.mesh = mesh
        self.dist = meta["dist"]
        self.config = IVFConfig(k=int(meta["k"]), k_means_size=meta.get("k_means_size"),
                                k_means_max_iter=int(meta["k_means_max_iter"]),
                                k_means_tol=float(meta["k_means_tol"]))
        self.n, self.dim = base.shape
        self.default_n_probes = DEFAULT_N_PROBES
        self.base, self.cache, self.n_local, self.shard = shard_base(mesh, base, self.dist)
        self.centroids = torch.from_numpy(np.asarray(arrays["centroids"], np.float32)).to(mesh.lead)
        self._assign = np.asarray(arrays["assign"], np.int32)
        self._place_postings()
        return self

    def _knn_device(self, queries, k: int, n_probes: int | None = None):
        n_probes = min(n_probes or self.default_n_probes, self.config.k)
        q = _queries(queries).to(self.mesh.lead)
        B = q.shape[0]
        # the probed lists are the same on every shard
        _, probe = KM.find_n_nearest(q, self.centroids, n_probes, self.dist)
        parts = []
        for s, dev in enumerate(self.mesh.devices):
            if self.n_local[s] == 0:
                parts.append(_empty(B, k, dev))
                continue
            with _on(dev):
                parts.append(_probe_scan(q.to(dev), self.base[s], self.cache[s], self.posting[s],
                                         self._lens[s], probe.to(dev), k, self.dist))
        return _merge(self.mesh, parts, [s * self.shard for s in range(self.mesh.size)], k)

    def knn_batch(self, queries, k: int, n_probes: int | None = None):
        return _numpy(*self._knn_device(queries, k, n_probes))

    def index_bytes(self) -> int:
        return _bytes([*self.base, *self.cache, *self.posting, self.centroids])


class _HNSWShard:
    """One shard's graph in the stacked layout: f32 rows (>= 1 row), their
    dist cache, level-0 links, the upper levels highest first as (links,
    pos) with pos == -1 where the node is not on that level, the entry
    point (-1: empty) and the valid row count."""

    def __init__(self, vecs, dist, links0, uppers, entry: int, n_local: int, dev):
        self.vecs = vecs.to(dev, torch.float32)
        self.vcache = D.dist_cache(self.vecs, dist)
        self.links0 = torch.from_numpy(np.ascontiguousarray(links0, np.int32)).to(dev)
        self.uppers = [(torch.from_numpy(np.ascontiguousarray(lk, np.int32)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(pos, np.int32)).to(dev))
                       for lk, pos in uppers]
        self.entry = int(entry)
        self.n_local = int(n_local)


class ShardedHNSWIndex:
    """HNSW sharded over the mesh (sharded.py:489-790): an independent
    graph per contiguous row shard (`HNSWIndex.build` on the shard's device
    with seed + s), searched by greedy descent through the upper levels
    and the level-0 beam search (`ops/beam.py:beam_search`: the fused K4 /
    K5 loop on a CUDA shard, the classic loop on the CPU) over the exact
    f32 rows, so the head of the beam is the answer; then the merge."""

    def __init__(self, mesh: Mesh, base, dist: str, config: HNSWConfig, seed: int = 0,
                 parallel: bool = True):
        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.config = config
        self.seed = seed  # saved: a rebuild on another mesh size repeats the graphs
        self.n, self.dim = int(base.shape[0]), int(base.shape[1])
        self.shard, n_local = _geometry(self.n, mesh.size)
        rows = base if isinstance(base, torch.Tensor) else np.asarray(base, np.float32)

        def build_shard(s: int) -> HNSWIndex:
            lo = min(s * self.shard, self.n)
            part, dev = rows[lo : lo + n_local[s]], mesh.devices[s]
            with _on(dev):
                if isinstance(part, torch.Tensor) and part.device == dev and len(part):
                    # rows already on the shard's device: no host round trip
                    return HNSWIndex.build_from_store(VecStore.from_device(part, dist), config,
                                                      seed=seed + s)
                part = part.cpu().numpy() if isinstance(part, torch.Tensor) else part
                return HNSWIndex.build(part, dist, config, seed=seed + s, device=dev)

        # parallel: a thread per distinct device builds that device's shards
        # in order, so the builds on different cards overlap (shards sharing a
        # card gain nothing from threads); per-shard seeds are fixed, so a
        # parallel build equals a serial one
        by_dev: dict = {}
        for s, dev in enumerate(mesh.devices):
            by_dev.setdefault(dev, []).append(s)
        if parallel and len(by_dev) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(by_dev)) as ex:
                built = list(ex.map(lambda ss: [build_shard(s) for s in ss], by_dev.values()))
            subs = [None] * mesh.size
            for ss, ixs in zip(by_dev.values(), built):
                for s, ix in zip(ss, ixs):
                    subs[s] = ix
        else:
            subs = [build_shard(s) for s in range(mesh.size)]
        self.default_ef = subs[0].config.default_ef

        cap = max(ix.store.capacity for ix in subs)
        m0, m = subs[0].config.max_m0, subs[0].config.m
        size = mesh.size
        links0 = np.full((size, cap, m0), -1, np.int32)
        entries = np.full((size,), -1, np.int32)
        n_loc = np.zeros((size,), np.int32)
        for s, ix in enumerate(subs):
            links0[s, : ix.links0.shape[0]] = ix.links0
            if ix.entry_point is not None:
                entries[s] = ix.entry_point
            n_loc[s] = len(ix.store)
        l_max = max((ix.enter_level or 0) for ix in subs)
        uppers = []
        for level in range(l_max, 0, -1):  # highest level first
            on = [level <= (ix.enter_level or 0) for ix in subs]
            n_rows = max(max((ix.upper[level - 1].n if o else 0) for ix, o in zip(subs, on)), 1)
            lk = np.full((size, n_rows, m), -1, np.int32)
            pos = np.full((size, cap), -1, np.int32)
            for s, (ix, o) in enumerate(zip(subs, on)):
                if o:
                    ul = ix.upper[level - 1]
                    lk[s, : ul.n] = ul.links[: ul.n]
                    pos[s, : len(ul.pos)] = ul.pos
            uppers.append((lk, pos))
        vecs = [ix.store.device()[0] for ix in subs]
        self._place(vecs, links0, uppers, entries, n_loc)

    def _place(self, vecs, links0, uppers, entries, n_local) -> None:
        """Hold the stacked per-shard arrays (host, for checkpoints) and put
        each shard's slice on its device."""
        self.links0 = np.ascontiguousarray(links0, np.int32)
        self.uppers = [(np.ascontiguousarray(lk, np.int32), np.ascontiguousarray(pos, np.int32))
                       for lk, pos in uppers]
        self.entries = np.ascontiguousarray(entries, np.int32)
        self.n_local = np.ascontiguousarray(n_local, np.int32)
        self._shards = [
            _HNSWShard(torch.as_tensor(vecs[s]), self.dist, self.links0[s],
                       [(lk[s], pos[s]) for lk, pos in self.uppers], self.entries[s],
                       self.n_local[s], dev)
            for s, dev in enumerate(self.mesh.devices)]

    def save(self, path, include_vectors: bool = True) -> None:
        """One npz of the stacked per-shard topology (sharded.py:661-685),
        with the stacked rows unless the base is stored externally."""
        size, cap = self.links0.shape[:2]
        arrays = {"links0": self.links0, "entries": self.entries, "n_local": self.n_local}
        for lvl, (lk, pos) in enumerate(self.uppers):
            arrays[f"upper_links_{lvl}"] = lk
            arrays[f"upper_pos_{lvl}"] = pos
        if include_vectors:
            vecs = np.zeros((size, cap, self.dim), np.float32)
            for s, sh in enumerate(self._shards):
                vecs[s, : sh.n_local] = sh.vecs[: sh.n_local].cpu().numpy()
            arrays["vecs"] = vecs
        serde.save_arrays(path, arrays, dict(
            kind="sharded_hnsw", dist=self.dist, n=self.n, dim=self.dim, shard=self.shard,
            n_dev=size, cap=int(cap), n_uppers=len(self.uppers), default_ef=self.default_ef,
            ef_construction=self.config.ef_construction, M=self.config.M, seed=int(self.seed)))

    @classmethod
    def load(cls, path, mesh: Mesh, external_base=None) -> "ShardedHNSWIndex":
        """Re-place a checkpoint on `mesh`.  On a mesh of the size it was
        saved on, the stacked topology loads as it is (pass `external_base`,
        the original (n, dim) rows, for a checkpoint without vectors).  On
        another size the per-shard graphs cannot be re-split: they are
        rebuilt from the rows with the saved config and seeds, with a
        warning, and the saved default_ef carries over (sharded.py:700-744)."""
        arrays, meta = serde.load_arrays(path)
        if meta.get("kind") != "sharded_hnsw":
            raise ValueError(f"{path} is not a sharded HNSW checkpoint")
        n_dev, n, dim, shard = int(meta["n_dev"]), int(meta["n"]), int(meta["dim"]), int(meta["shard"])
        cfg = HNSWConfig(ef_construction=int(meta["ef_construction"]), M=int(meta["M"]))
        if mesh.size != n_dev:
            if "vecs" in arrays:
                base = np.zeros((n, dim), np.float32)
                for s in range(n_dev):
                    lo = min(s * shard, n)
                    hi = min(lo + shard, n)
                    base[lo:hi] = arrays["vecs"][s, : hi - lo]
            elif external_base is not None:
                base = _as_rows(external_base)[:n]
            else:
                raise ValueError(f"checkpoint was sharded over {n_dev} devices; the mesh has "
                                 f"{mesh.size}, and no vectors are available to rebuild from "
                                 "(pass external_base)")
            warnings.warn(f"sharded HNSW checkpoint ({n_dev} devices) opened on a {mesh.size}-device "
                          "mesh: rebuilding per-shard graphs from rows (topology is per-shard and "
                          "cannot be re-split)", stacklevel=2)
            rebuilt = cls(mesh, base, meta["dist"], cfg, seed=int(meta.get("seed", 0)))
            rebuilt.default_ef = int(meta["default_ef"])
            return rebuilt
        self = cls.__new__(cls)
        self.mesh = mesh
        self.dist = meta["dist"]
        self.n, self.dim, self.shard = n, dim, shard
        self.default_ef = int(meta["default_ef"])
        self.config = cfg
        self.seed = int(meta.get("seed", 0))
        cap = int(meta["cap"])
        if "vecs" in arrays:
            vecs = arrays["vecs"]
        else:
            if external_base is None:
                raise ValueError(f"{path} was saved without vectors; pass external_base")
            rows = _as_rows(external_base)
            vecs = [torch.zeros((cap, dim), device=rows.device) for _ in range(n_dev)]
            for s in range(n_dev):
                lo = min(s * shard, n)
                hi = min(lo + shard, n)
                vecs[s][: hi - lo] = rows[lo:hi]
        uppers = [(arrays[f"upper_links_{lvl}"], arrays[f"upper_pos_{lvl}"])
                  for lvl in range(int(meta["n_uppers"]))]
        self._place([torch.as_tensor(v) for v in vecs], arrays["links0"], uppers,
                    arrays["entries"], arrays["n_local"])
        return self

    def _knn_device(self, queries, k: int, ef: int, expand: int | None = None):
        """(sharded.py:493-554, 775-787): per shard, greedy descent from the
        entry through the upper levels (pos == -1 holds position on a level
        the shard lacks), the level-0 beam search with the reference's
        iteration and ring budgets, the head k of the beam kept where the id
        is a valid row; then the merge."""
        q = _queries(queries)
        B = q.shape[0]
        ef = max(ef, k)
        expand = expand or BEAM_EXPAND
        iters = (2 * ef + 64 + expand - 1) // expand + 16
        ring = _pow2(min(2 * ef + 64, 4 * ef))
        parts = []
        for sh, dev in zip(self._shards, self.mesh.devices):
            if sh.n_local == 0:
                parts.append(_empty(B, k, dev))
                continue
            with _on(dev):
                qs = q.to(dev)
                nd = _make_node_dist(qs, D.dist_cache(qs, self.dist), sh.vecs, sh.vcache, self.dist)
                cur = torch.full((B,), max(sh.entry, 0), dtype=torch.int32, device=dev)
                for links_l, pos_l in sh.uppers:  # highest level first
                    cur = BM.greedy_descent(cur, nd, _upper_links_fn(links_l, pos_l), 256)
                links0 = sh.links0
                bd, bi = BM.beam_search(cur, nd, lambda ids: links0[ids.long()], ef, iters, expand,
                                        ring)
                dd, ii = bd[:, :k], bi[:, :k]
                ok = (ii >= 0) & (ii < sh.n_local)
                parts.append((torch.where(ok, dd, float("inf")), torch.where(ok, ii, T.INVALID_ID)))
        return _merge(self.mesh, parts, [s * self.shard for s in range(self.mesh.size)], k)

    def knn_with_ef_batch(self, queries, k: int, ef: int, expand: int | None = None):
        return _numpy(*self._knn_device(queries, k, ef, expand))

    def knn_batch(self, queries, k: int):
        return self.knn_with_ef_batch(queries, k, self.default_ef)

    def index_bytes(self) -> int:
        return _bytes([t for sh in self._shards
                       for t in (sh.vecs, sh.vcache, sh.links0, *(x for u in sh.uppers for x in u))])


class ShardedIVFPQIndex:
    """The IVF-PQ codes tier sharded over the mesh (sharded.py:826-1172).

    One PQ table and one coarse quantizer, trained globally on a strided
    sample (replicated), every row assigned once; then per shard a
    cluster-sorted code layout over its contiguous rows at the common
    (lpad, overflow capacity) (`models/ivfpq.py:_layout_encode` with
    force_lpad / ov_pad_min), held as an `IVFPQIndex` on the shard's
    device that shares the table and the centroids.  Each shard's codes
    stay row-major (slots, cw4), the port's layout.  A search runs each
    shard's K11 over its probed lists and K7 over its overflow segment, the
    exact refine of its top-ef on GLOBAL ids through `row_gen` (an entry
    without an exact row keeps its ADC distance), then the merge.

    Checkpoints hold the global state (codebooks, centroids, the (n,)
    assignment) and re-place onto any mesh size by re-encoding."""

    def __init__(self, mesh: Mesh, base, dist: str, nlist: int = 64,
                 pq_config: PQConfig | None = None, sample_rows: int = 25_000, seed: int = 0,
                 block_rows: int = 131072, row_gen=None):
        rows = _as_rows(base)
        n, dim = rows.shape
        if row_gen is None:
            row_gen = _row_gen_of(rows)
        self._init_from_fill(mesh, lambda row0, r: rows[row0 : row0 + r], int(n), int(dim), dist,
                             nlist, pq_config, sample_rows, seed, block_rows, row_gen)

    @classmethod
    def from_fill(cls, mesh: Mesh, fill, n: int, dim: int, dist: str, nlist: int = 64,
                  pq_config: PQConfig | None = None, sample_rows: int = 25_000, seed: int = 0,
                  block_rows: int = 131072, row_gen=None) -> "ShardedIVFPQIndex":
        """Build from a block source `fill(row0, rows)`; `row_gen(ids) ->
        rows` regenerates rows by global id for the encode and the exact
        refine (without it the ADC distances stand, as in the reference)."""
        self = cls.__new__(cls)
        self._init_from_fill(mesh, fill, n, dim, dist, nlist, pq_config, sample_rows, seed,
                             block_rows, row_gen)
        return self

    def _init_from_fill(self, mesh, fill, n, dim, dist, nlist, pq_config, sample_rows, seed,
                        block_rows, row_gen) -> None:
        D.check_dist(dist)
        self.mesh = mesh
        self.dist = dist
        self.n, self.dim = int(n), int(dim)
        self.nlist = int(nlist)
        self.seed = int(seed)
        self._row_gen = row_gen
        self._block_rows = int(block_rows)
        if pq_config is None:
            pq_config = PQConfig(n_bits=4, m=-(-dim // 3), dist=dist, k_means_size=sample_rows)
        if pq_config.n_bits != 4:
            raise ValueError("the IVF-PQ tier serves 4-bit (packed) tables")
        lead = mesh.lead
        # the global training sample, strided over the whole set
        step = max(1, n // max(sample_rows, 1))
        parts, got = [], 0
        for row0 in range(0, n, self._block_rows):
            r = min(self._block_rows, n - row0)
            parts.append(_rows(fill(row0, r), lead)[::step][: max(1, r // step)])
            got += parts[-1].shape[0]
            if got >= sample_rows:
                break
        sample = torch.cat(parts)[:sample_rows]
        del parts
        self.pq = PQTable.train(sample, pq_config, seed=seed)
        cents = _fit_centroids(sample, sample.shape[0],
                               IVFConfig(k=nlist, k_means_max_iter=12, k_means_tol=1e-4), dist,
                               seed + 2)
        del sample
        self.centroids = cents.cpu().numpy()
        # one coarse assignment of every row
        assign = np.empty(n, np.int32)
        for row0 in range(0, n, self._block_rows):
            r = min(self._block_rows, n - row0)
            assign[row0 : row0 + r] = _assign(_rows(fill(row0, r), lead), cents, dist)
        self._assign = assign
        self._place(fill)

    def _place(self, fill) -> None:
        """Per-shard layout + encode on the current mesh at the common
        (lpad, overflow capacity) (sharded.py:1011-1072)."""
        size = self.mesh.size
        self.shard = shard = -(-self.n // size)
        self._lo_hi = [(min(s * shard, self.n), min((s + 1) * shard, self.n)) for s in range(size)]
        # pass 1: each shard's natural lpad and overflow size -> common maxima
        lpads, ov_lens = [], []
        for lo, hi in self._lo_hi:
            posting, counts = _build_posting(self._assign[lo:hi], self.nlist)
            lp, _, ov = _sorted_layout(posting, counts, self.nlist, cap_quantile=0.95)
            lpads.append(lp)
            ov_lens.append(len(ov))
        self.lpad = max(lpads)
        self.ov_cap = max(-(-max(max(ov_lens), 1) // _BLOCKPAD) * _BLOCKPAD, _BLOCKPAD)
        # pass 2: encode each shard at the common layout
        self._pq_on = {dev: (self.pq if dev == self.pq.torch_device
                             else PQTable.from_state(*self.pq.state(), device=dev))
                       for dev in set(self.mesh.devices)}
        self._subs: list[IVFPQIndex | None] = []
        for s, (dev, (lo, hi)) in enumerate(zip(self.mesh.devices, self._lo_hi)):
            if hi <= lo:
                self._subs.append(None)
                continue
            fill_s = (lambda lo: lambda row0, r: fill(lo + row0, r))(lo)
            gen_s = None if self._row_gen is None else (lambda lo: lambda ids: self._row_gen(ids + lo))(lo)
            pq = self._pq_on[dev]
            with _on(dev):
                lp, cm, co, sid, lens, ovc = _layout_encode(
                    fill_s, hi - lo, pq, self._assign[lo:hi], self.nlist, self.seed + 17 * s,
                    self._block_rows, row_gen=gen_s, device=dev, force_lpad=self.lpad,
                    ov_pad_min=self.ov_cap)
            sub = IVFPQIndex(pq, self.centroids, hi - lo, self.dim, self.dist, lp, lens,
                             self.ov_cap, block_rows=self._block_rows, device=dev)
            sub.ov_valid = ovc  # the overflow scan plans for the capacity, masks to the valid rows
            sub._codes, sub._codes_ov = cm, co
            sub._slot_id = torch.from_numpy(sid).to(dev)
            self._subs.append(sub)
        self.last_dropped: list = []

    def index_bytes(self) -> int:
        """Device bytes: each device's table once, every shard's codes,
        slot map, centroids and lens."""
        total = sum(pq.device_bytes() for pq in self._pq_on.values())
        for sub in self._subs:
            if sub is not None:
                total += sub.index_bytes() - sub.pq.device_bytes()
        return total

    def _knn_device(self, queries, k: int, n_probes: int = 8, ef: int = 128,
                    qb: int | None = None, chunk: int = 16):
        """(sharded.py:832-911, 1080-1114): the auto chunk (a survivor grid
        dense enough for the mean valid rows per list) and qb, then per
        shard the probe -> bin -> K11 -> overflow K7 -> top-ef, the refine
        on global ids, the shard's top-k; then the merge.  The auto chunk
        is rounded down to a power of two, a chunk K11 serves (the
        reference's mean_len // 16 can be 12, which its own lpad % chunk
        assertion refuses)."""
        mean_len = max(1, self.n // (self.mesh.size * self.nlist))
        chunk = max(1, min(chunk, mean_len // 16))
        chunk = 1 << (chunk.bit_length() - 1)
        q = _queries(queries)
        B = q.shape[0]
        n_probes = min(n_probes, self.nlist)
        if qb is None:
            mean = B * n_probes / self.nlist
            qb = int(min(512, max(32, -(-2 * mean // 32) * 32)))
        kk = min(k, ef)
        luts = {}
        parts = []
        self.last_dropped = []
        for sub, dev, (lo, _) in zip(self._subs, self.mesh.devices, self._lo_hi):
            if sub is None:
                parts.append(_empty(B, kk, dev))
                continue
            with _on(dev):
                qs = q.to(dev)
                if dev not in luts:
                    luts[dev] = self._pq_on[dev].create_lookup(qs)
                lookup, q_norms = luts[dev]
                td1, ti1 = sub.search_candidates(qs, lookup, q_norms, kk, n_probes, ef, qb, chunk)
                self.last_dropped.append(sub.last_dropped)
                gids = torch.where(ti1 >= 0, ti1 + lo, T.INVALID_ID)
                d_ex = None
                if self._row_gen is not None:
                    d_ex = refine_blocked(None, self._block_rows, self.n, self.dim, self.dist, qs,
                                          gids, row_gen=self._row_gen)
                # spilled or absent refine entries keep their ADC distance
                d_ex = td1 if d_ex is None else torch.where(torch.isfinite(d_ex), d_ex, td1)
                parts.append(T.topk_smallest(d_ex, gids, kk))
        return _merge(self.mesh, parts, [0] * self.mesh.size, k)

    def knn_batch(self, queries, k: int, n_probes: int = 8, ef: int = 128,
                  qb: int | None = None, chunk: int = 16):
        return _numpy(*self._knn_device(queries, k, n_probes, ef, qb, chunk))

    def save(self, path, include_vectors: bool = False) -> None:
        """The mesh-independent global state; the rows stay with the row
        source (`include_vectors` is accepted for the other classes'
        signature and stores nothing, as in the reference)."""
        arrays = {"centroids": self.centroids, "assign": np.asarray(self._assign, np.int32)}
        pq_arrays, pq_meta = self.pq.state()
        arrays.update({"main_" + key: v for key, v in pq_arrays.items()})
        serde.save_arrays(path, arrays, dict(
            kind="sharded_ivfpq", dist=self.dist, n=self.n, dim=self.dim, nlist=self.nlist,
            seed=self.seed, block_rows=self._block_rows, main=pq_meta["pq"]))

    @classmethod
    def load(cls, path, mesh: Mesh, fill=None, row_gen=None,
             external_base=None) -> "ShardedIVFPQIndex":
        """Re-place a checkpoint onto `mesh` of any size, re-encoding each
        shard from `fill` (or from `external_base`, which also gives the
        refine's rows unless `row_gen` is passed)."""
        arrays, meta = serde.load_arrays(path)
        if meta.get("kind") != "sharded_ivfpq":
            raise ValueError(f"{path} is not a ShardedIVFPQIndex checkpoint")
        if fill is None:
            if external_base is None:
                raise ValueError("pass `fill` (block source) or `external_base` to re-encode the "
                                 "per-shard code segments")
            rows = _as_rows(external_base)
            fill = lambda row0, r: rows[row0 : row0 + r]
            if row_gen is None:
                row_gen = _row_gen_of(rows)
        self = cls.__new__(cls)
        self.mesh = mesh
        self.dist = meta["dist"]
        self.n, self.dim = int(meta["n"]), int(meta["dim"])
        self.nlist = int(meta["nlist"])
        self.seed = int(meta["seed"])
        self._block_rows = int(meta["block_rows"])
        self._row_gen = row_gen
        self.pq = PQTable.from_state({key[5:]: v for key, v in arrays.items() if key.startswith("main_")},
                                     {"pq": meta["main"]}, device=mesh.lead)
        self.centroids = np.asarray(arrays["centroids"], np.float32)
        self._assign = np.asarray(arrays["assign"], np.int32)
        self._place(fill)
        return self


def _row_gen_of(rows: torch.Tensor):
    """Regenerate rows by global id from materialized rows (ids clipped into
    range; the refine masks the -1 entries)."""
    n = rows.shape[0]
    return lambda ids: rows[ids.to(rows.device).clamp(0, n - 1).long()]
