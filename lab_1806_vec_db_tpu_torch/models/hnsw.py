"""HNSW index: batched graph search + freeze-and-patch bulk build (port of
models/hnsw.py).

Parity target: `HNSWIndex` (reference: src/index_algorithm/hnsw_index.rs).

- Storage: level-0 links are a (cap, max_m0) int32 matrix (-1 padded), each
  upper level a compact (n_l_cap, M) matrix plus a (cap,) id -> row map, on
  the host and mirrored on the store's device.
- Search, two physical plans behind `knn_with_ef_batch`:
  * route "graph": greedy descent through the upper levels on K2, then the
    level-0 beam: K3 (`ops/traverse.py`, the whole search in one kernel)
    when E * L == 128 (M = 16, E = 4), else the fused lock-step loop
    K4 -> K2 -> K5 (`ops/beam.py`).  On the CPU the graph route is the
    classic lock-step loop over the bf16 traversal copy plus an exact
    rerank, the reference's CPU path;
  * route "scan": the Flat two-stage plan (K1 + K2) with `ef` as the
    stage-1 depth.  "auto" picks it on CUDA, the graph on the CPU.
- PQ search (`knn_pq_batch`, with a `PQTable`): routes "mirror" (K1 + K2),
  "scan" (the ADC scan K7 or K8 / K9 + K2) and "graph" (ADC node distances
  K8 / K9 in the fused loop K4 -> K8/K9 -> K5, or the classic loop with K6
  when `fused=False`); "auto" picks "mirror" on CUDA, "graph" on the CPU.
- Build: the reference's freeze-and-patch chunks (add_parallel,
  hnsw_index.rs:399-457).  A chunk's level-0 candidate pool is a scan of
  the frozen prefix (K1 over the permuted int8 mirror on CUDA, the exact f32
  scan on the CPU), upper-level pools an exact member GEMM; intra-chunk
  peers are patched in with exact distances, links are selected with the
  batched heuristic (`ops/graph.py`), and reverse links are arranged in
  batched rounds.  Levels are drawn from `np.random.default_rng(seed)` as
  the reference draws them, so a seed gives the same levels in both
  packages.
- Config derivation matches hnsw_index.rs:495-537: max_m0 = 2*M,
  ef_construction >= max_m0, default_ef = ef_construction/2.

Known divergence (the reference's, documented there): the candidate list fed
to the neighbor heuristic is the top `HEURISTIC_CAND` (64) of the pool.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import native
from .flat import FlatIndex
from .store import VecStore
from ..ops import adc as A
from ..ops import beam as BM
from ..ops import distance as D
from ..ops import gather as G
from ..ops import graph as GR
from ..ops import topk as T
from ..ops import traverse as TR
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays
from ..utils.config import HNSWConfig

HEURISTIC_CAND = 64
BEAM_EXPAND = 4  # beam entries expanded per lock-step iteration (search)
CHUNK_LADDER = (1, 4, 16, 64, 256, 1024, 4096)
BULK_LINKS_MIN = 4096  # batch size from which level-0 links go device-canonical

_INF = float("inf")

def _pad_ladder(n: int) -> int:
    for c in CHUNK_LADDER:
        if n <= c:
            return c
    return CHUNK_LADDER[-1]


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _budgets(ef: int) -> tuple[int, int]:
    """(iteration budget, ring slots) of a level-0 search: expanding
    BEAM_EXPAND per step with ~2x churn, and a ring that holds every
    expansion."""
    e = BEAM_EXPAND
    return (2 * ef + 64 + e - 1) // e + 16, _pow2(min(2 * ef + 64, 4 * ef))


def links_rows(links0: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The (cap, L) level-0 links cut or -1 padded to n_rows rows: K3 reads a
    links row per row of its `base`, and a lean store's bf16 rows are n
    rounded up to 16,384 where the graph has the full store's capacity.
    Every link is an id < n, so the cut drops only empty rows."""
    if links0.shape[0] >= n_rows:
        return links0[:n_rows]
    return torch.cat([links0, links0.new_full((n_rows - links0.shape[0], links0.shape[1]), -1)])


def _upper_links_fn(links_l, pos_l):
    def lf(ids):
        rows = pos_l[ids.long()]
        out = links_l[rows.clamp_min(0).long()]
        return torch.where((rows >= 0)[..., None], out, -1)

    return lf


def _make_node_dist(q, q_cache, vecs, vcache, dist):
    """Node distances of the CPU graph route on the bf16 traversal copy:
    bf16 products summed in f32 (exact products of bf16 values), the f32
    norm caches; ~1e-2 relative, for ordering only (the beam is reranked
    exactly).  Ids of -1 read the last row, as in the reference; callers
    mask them."""
    qt = q.to(vecs.dtype).float()

    def nd(ids):
        idx = ids.long()
        dots = torch.bmm(vecs[idx].float(), qt[:, :, None])[:, :, 0]
        vc = vcache[idx]
        if dist == "l2sqr":
            return (q_cache[:, None] + vc - 2.0 * dots).clamp_min(0.0)
        return 1.0 - dots / (q_cache[:, None] * vc).clamp_min(1e-10)

    return nd


def _make_adc_node_dist(lookup, q_norms, codes, cb_sq, dist: str, m: int, packed: bool):
    """ADC node distances of the PQ traversal: K8 (k = 16) or K9 (k = 256)
    in their ids shape on CUDA, their plain versions (the same bf16 LUT) on
    the CPU.  Ids of -1 give +inf.  The LUT is rounded to bf16 once per
    batch (a contiguous copy: the l2sqr lookup is a permuted view), not at
    each of the search's calls."""
    lut = lookup.to(torch.bfloat16).contiguous()
    return lambda ids: A.adc_dists_for_ids(lut, q_norms, codes, cb_sq, ids, dist, m, packed)


def _exact_to(q, q_cache, v, vcache, dist):
    """Exact f32 distances by the cached-norm formula: q (c, dim) against
    v (c, C, dim) -> (c, C)."""
    dots = torch.bmm(v, q[:, :, None])[:, :, 0]
    if dist == "l2sqr":
        return (q_cache[:, None] + vcache - 2.0 * dots).clamp_min(0.0)
    return 1.0 - dots / (q_cache[:, None] * vcache).clamp_min(1e-10)


def _select_links(vecs, vcache, chunk_vec, chunk_cache, beam_d, beam_i, pids, plevels,
                  level: int, peer_d, limit: int, dist: str, n_cand: int):
    """Merge the frozen-graph pool with the intra-chunk peers, keep the
    best `n_cand`, recompute their distances exactly, and run the selection
    heuristic -> (c, limit) selected ids.  The patch step of add_parallel
    (hnsw_index.rs:427-438) fused with connect_new_links's forward selection
    (hnsw_index.rs:226-235)."""
    c = pids.shape[0]
    dev = pids.device
    # peers: j earlier than i in chunk order, level_j >= level
    order = torch.arange(c, device=dev)
    earlier = order[None, :] < order[:, None]
    need = plevels >= level
    peer_mask = earlier & (plevels[None, :] >= level) & need[:, None]
    pd = torch.where(peer_mask, peer_d, _INF)
    pi = torch.where(peer_mask, pids[None, :].expand(c, c), -1)
    all_d = torch.cat([beam_d, pd], 1)
    all_i = torch.cat([beam_i, pi], 1)
    # a peer may also be in the pool (the chunk is in the store before the
    # scan): keep the earliest copy
    dup = GR.later_duplicates(all_i)
    all_d = torch.where(dup, _INF, all_d)
    all_i = torch.where(dup, -1, all_i)

    sd, pos = torch.sort(all_d, dim=1, stable=True)
    sd, pos = sd[:, :n_cand], pos[:, :n_cand]
    cand_i = torch.where(torch.isfinite(sd), torch.gather(all_i, 1, pos), -1)

    safe = cand_i.clamp_min(0).long()
    cand_d = _exact_to(chunk_vec.float(), chunk_cache, vecs[safe].float(), vcache[safe], dist)
    cand_d = torch.where(cand_i >= 0, cand_d, _INF)
    cand_i, cand_d = GR.sort_candidates(cand_i, cand_d)
    pair = GR.pairwise_among(vecs, cand_i, dist)
    sel, _ = GR.heuristic_select(cand_i, cand_d, pair, limit)
    return sel


def _member_knn(q, q_cache, vecs, vcache, mem_ids, n_mem: int, k: int, dist: str):
    """Exact kNN of the chunk among an upper level's members: mem_ids
    (n_pad,) int32 (-1 padded), n_mem valid.  Returns ((c, k) f32 ascending,
    (c, k) int32 node ids)."""
    safe = mem_ids.clamp_min(0).long()
    d = D.pairwise(q.float(), vecs[safe].float(), dist, q_cache=q_cache, base_cache=vcache[safe])
    col = torch.arange(d.shape[1], device=d.device)
    d = torch.where((col < n_mem) & (mem_ids >= 0)[None, :], d, _INF)
    bd, bi = T.topk_smallest(d, mem_ids[None, :].expand_as(d), min(k, d.shape[1]))
    return T._pad_k(bd, bi, k)


class _UpperLevel:
    """Compact link storage for one level >= 1, with its device mirror."""

    def __init__(self, m: int, cap_total: int, device, init_cap: int = 16):
        self.m = m
        self.n = 0
        self.cap = max(16, _pow2(init_cap))
        self.ids = np.full(self.cap, -1, np.int32)
        self.links = np.full((self.cap, m), -1, np.int32)
        self.pos = np.full(cap_total, -1, np.int32)
        self.torch_device = device
        self._dev_links = None
        self._dev_pos = None
        self.dirty = True

    def ensure_member(self, node: int) -> int:
        if self.pos[node] >= 0:
            return int(self.pos[node])
        if self.n == self.cap:
            self.cap *= 2
            new_ids = np.full(self.cap, -1, np.int32)
            new_ids[: self.n] = self.ids[: self.n]
            self.ids = new_ids
            new_links = np.full((self.cap, self.m), -1, np.int32)
            new_links[: self.n] = self.links[: self.n]
            self.links = new_links
        row = self.n
        self.ids[row] = node
        self.pos[node] = row
        self.n += 1
        self.dirty = True
        return row

    def grow_total(self, cap_total: int) -> None:
        if cap_total > len(self.pos):
            new_pos = np.full(cap_total, -1, np.int32)
            new_pos[: len(self.pos)] = self.pos
            self.pos = new_pos
            self.dirty = True

    def device(self):
        if self.dirty or self._dev_links is None:
            self._dev_links = torch.tensor(self.links, device=self.torch_device)
            self._dev_pos = torch.tensor(self.pos, device=self.torch_device)
            self.dirty = False
        return self._dev_links, self._dev_pos


@dataclass
class _InnerConfig:
    """Computed config (hnsw_index.rs:74-96)."""

    dim: int
    dist: str
    m: int
    max_m0: int
    ef_construction: int
    default_ef: int
    inv_log_m: float


class HNSWIndex:
    algorithm = "HNSW"

    def __init__(self, dim: int, dist: str, config: HNSWConfig | None = None,
                 seed: int | None = None, device="cuda"):
        config = config or HNSWConfig()
        m = min(config.M, 10_000)
        max_m0 = m * 2
        efc = max(config.ef_construction, max_m0)
        self.config = _InnerConfig(dim=dim, dist=dist, m=m, max_m0=max_m0, ef_construction=efc,
                                   default_ef=efc // 2, inv_log_m=1.0 / math.log(m))
        self.store = VecStore(dim, dist, capacity=max(config.max_elements, 8), device=device)
        self._reset_graph(self.store.capacity)
        self.rng = np.random.default_rng(seed)

    def _reset_graph(self, cap: int) -> None:
        self.levels = np.zeros(cap, np.int32)
        self.links0 = np.full((cap, self.config.max_m0), -1, np.int32)
        self.upper: list[_UpperLevel] = []  # index l-1 => level l
        self.entry_point: int | None = None
        self.enter_level: int | None = None
        self._dev_links0: torch.Tensor | None = None
        self._links0_dirty_rows: set[int] = set()
        self._links0_full_dirty = True
        # bulk-build mode: the DEVICE links matrix is canonical and the host
        # copy is stale until _exit_links_bulk downloads it once
        self._links0_canonical_dev = False

    # ---- basic accessors ----
    @property
    def dim(self) -> int:
        return self.config.dim

    @property
    def dist(self) -> str:
        return self.config.dist

    @property
    def device(self) -> torch.device:
        return self.store.torch_device

    def __len__(self) -> int:
        return len(self.store)

    def set_default_ef(self, ef: int) -> None:
        if ef <= 0:
            raise ValueError("ef must be positive")
        self.config.default_ef = ef

    # ---- capacity management ----
    def _grow(self, n_needed: int) -> None:
        if self._links0_canonical_dev and n_needed > self.store.capacity:
            # a capacity change reallocates the links matrix: fold the
            # device-canonical copy back first
            self._exit_links_bulk()
            self._grow(n_needed)
            self._enter_links_bulk()
            return
        self.store._grow_to(n_needed)
        cap = self.store.capacity
        if cap > len(self.levels):
            new_levels = np.zeros(cap, np.int32)
            new_levels[: len(self.levels)] = self.levels
            self.levels = new_levels
            new_links = np.full((cap, self.config.max_m0), -1, np.int32)
            new_links[: self.links0.shape[0]] = self.links0
            self.links0 = new_links
            for ul in self.upper:
                ul.grow_total(cap)
            self._dev_links0 = None
            self._links0_full_dirty = True
            self._links0_dirty_rows.clear()

    def index_bytes(self) -> int:
        """Device-memory footprint: every resident device buffer of the
        index (the store's tensors, level-0 links, each upper level's links
        and id -> row map)."""
        tensors = [self._dev_links0]
        for ul in self.upper:
            tensors += [ul._dev_links, ul._dev_pos]
        return self.store.device_bytes() + sum(
            t.numel() * t.element_size() for t in tensors if t is not None)

    def _enter_links_bulk(self) -> None:
        """Make the device links matrix canonical for a bulk insert."""
        if self._links0_canonical_dev:
            return
        self._links0_device()  # sync any host dirt into the device copy
        self._links0_canonical_dev = True

    def _exit_links_bulk(self) -> None:
        """Download the device-canonical links back to the host (once)."""
        if not self._links0_canonical_dev:
            return
        self.links0 = self._dev_links0.cpu().numpy().copy()
        self._links0_canonical_dev = False
        self._links0_full_dirty = False
        self._links0_dirty_rows.clear()

    def _links0_device(self) -> torch.Tensor:
        if self._links0_canonical_dev:
            return self._dev_links0
        if self._dev_links0 is None or self._links0_full_dirty:
            self._dev_links0 = torch.tensor(self.links0, device=self.device)
            self._links0_full_dirty = False
            self._links0_dirty_rows.clear()
        elif self._links0_dirty_rows:
            rows = np.fromiter(self._links0_dirty_rows, dtype=np.int64)
            self._dev_links0.index_copy_(0, torch.from_numpy(rows).to(self.device),
                                         torch.tensor(self.links0[rows], device=self.device))
            self._links0_dirty_rows.clear()
        return self._dev_links0

    def _write_links0(self, rows: np.ndarray, values: np.ndarray) -> None:
        if self._links0_canonical_dev:
            # the device is canonical: write there, leave the host copy stale
            self._dev_links0.index_copy_(0, torch.tensor(rows, dtype=torch.int64, device=self.device),
                                         torch.tensor(values, device=self.device))
            return
        self.links0[rows] = values
        if self._links0_full_dirty:
            return
        self._links0_dirty_rows.update(int(r) for r in rows)
        if len(self._links0_dirty_rows) > max(2048, self.links0.shape[0] // 8):
            self._links0_full_dirty = True
            self._links0_dirty_rows.clear()

    def _rand_level(self) -> int:
        u = max(self.rng.random(), 1e-12)
        return int(math.floor(-math.log(u) * self.config.inv_log_m))

    # ---- build ----
    def add(self, vec) -> int:
        return self.batch_add(np.asarray(vec, dtype=np.float32)[None, :])[0]

    def _in_chunks(self, n_graph: int, n_new: int, insert) -> None:
        """Feed `n_new` new rows to `insert(lo, hi)` (offsets into the new
        rows), joining a graph of `n_graph` nodes, in freeze-and-patch chunks (hnsw_index.rs:459-475).  Chunks
        grow with the graph (floor 256, cap the ladder's 4096): the intra-
        chunk patch uses exact pairwise distances, so a chunk as large as the
        current graph still selects near-exact links.  Bulk inserts keep the
        level-0 links on the device: reverse-arrange rounds then gather and
        write link rows there, not through the host."""
        bulk = n_new >= BULK_LINKS_MIN
        if bulk:
            self._enter_links_bulk()
        try:
            cur = 0
            while cur < n_new:
                size = min(max(n_graph + cur, 256), CHUNK_LADDER[-1], n_new - cur)
                insert(cur, cur + size)
                cur += size
        finally:
            if bulk:
                self._exit_links_bulk()

    def batch_add(self, vecs) -> list[int]:
        vecs = np.atleast_2d(np.asarray(vecs, dtype=np.float32))
        n0 = len(self.store)
        if len(vecs) >= BULK_LINKS_MIN:
            self._grow(n0 + len(vecs))  # pre-size: no mid-bulk reallocation
        self._in_chunks(n0, len(vecs), lambda lo, hi: self._insert_chunk(vecs[lo:hi]))
        return list(range(n0, n0 + len(vecs)))

    @classmethod
    def build(cls, vectors: np.ndarray, dist: str, config: HNSWConfig | None = None,
              seed: int | None = None, device="cuda") -> "HNSWIndex":
        """Bulk build (hnsw_index.rs:595-611)."""
        config = config or HNSWConfig()
        if config.max_elements == 0:
            config = HNSWConfig(max_elements=len(vectors), ef_construction=config.ef_construction,
                                M=config.M)
        index = cls(vectors.shape[1], dist, config, seed, device=device)
        index.batch_add(vectors)
        return index

    @classmethod
    def build_from_store(cls, store: VecStore, config: HNSWConfig | None = None,
                         seed: int | None = None) -> "HNSWIndex":
        """Bulk build over a pre-filled store (e.g. `VecStore.from_device`):
        no vector crosses the host boundary.  Rows [0, n) join the graph in
        the same chunks as `build`'s, each searching the prefix below it, so
        the graph equals `build`'s for the same rows and seed.  A lean-tier
        store is refused: the build reads the f32 rows."""
        store._require_full("HNSWIndex.build_from_store")
        index = cls(store.dim, store.dist, config or HNSWConfig(), seed, device=store.torch_device)
        index.store = store
        index._reset_graph(store.capacity)
        index._in_chunks(0, len(store), index._insert_prefilled)
        return index

    def _join(self, ids: np.ndarray) -> np.ndarray:
        """Draw levels for new ids, register upper-level membership; returns
        the levels."""
        levels = np.array([self._rand_level() for _ in ids], dtype=np.int32)
        self.levels[ids] = levels
        for i, lv in zip(ids, levels):
            for lvl in range(1, lv + 1):
                self._upper(lvl).ensure_member(int(i))
        return levels

    def _insert_prefilled(self, lo: int, hi: int) -> None:
        """Insert rows [lo, hi) that are ALREADY in the store (no push)."""
        self._link_new(np.arange(lo, hi, dtype=np.int32))

    def _insert_chunk(self, vecs: np.ndarray) -> None:
        self._grow(len(self.store) + len(vecs))
        self._link_new(np.array(self.store.batch_push(vecs), dtype=np.int32))

    def _link_new(self, ids: np.ndarray) -> None:
        levels = self._join(ids)
        if self.entry_point is None:
            # the first vector is the entry point (hnsw_index.rs:542-551)
            self.entry_point = int(ids[0])
            self.enter_level = int(levels[0])
            if len(ids) > 1:
                self._insert_ids(ids[1:], levels[1:])
            return
        self._insert_ids(ids, levels)

    def _upper(self, level: int) -> _UpperLevel:
        while len(self.upper) < level:
            # pre-sized to ~2x the expected occupancy n/M^l
            lvl = len(self.upper) + 1
            expect = self.store.capacity // max(self.config.m**lvl, 1)
            self.upper.append(_UpperLevel(self.config.m, self.store.capacity, self.device,
                                          init_cap=2 * expect))
        return self.upper[level - 1]

    def _level0_pool(self, q, vecs, vcache, n_prev: int, r: int):
        """(c, r) candidate pool of the frozen prefix: on CUDA (past 4r rows,
        where int8 keeps neighbor order) K1 over the permuted mirror with
        the whole chunk in one launch, the in-flight chunk masked out (so
        same-chunk rows do not crowd the prefix out of survivor groups) and
        the ids decoded; else the exact f32 scan.  The pool only needs
        approximate ORDER: `_select_links` recomputes exact distances."""
        if q.is_cuda and n_prev > 4 * r and self.store.int8_reliable():
            mirror = self.store.device_int8()
            bd, bi = mirror.survivors(q, r, n_valid=n_prev)
            bi = mirror.decode(bi, n_prev)
            return torch.where(bi >= 0, bd, _INF), bi
        return T.knn_scan(q, vecs, vcache, n_prev, r, self.dist)

    def _insert_ids(self, ids: np.ndarray, levels: np.ndarray) -> None:
        """Scan-based chunk insert.  The level-0 pool is a scan of the frozen
        prefix [0, min(ids)) (the reference's inversion of add_parallel's
        graph search: a scan gives exact-grade pools faster than a
        traversal); upper-level pools are exact member GEMMs.  Only the
        selected links (c x m int32) come back to the host."""
        n_prev = int(ids.min())
        cfg = self.config
        c = len(ids)
        c_pad = _pad_ladder(c)
        vecs, vcache = self.store.device()
        dev = vecs.device
        # padded chunk: dummy rows repeat the entry point, results ignored
        pids = np.full(c_pad, self.entry_point, np.int32)
        pids[:c] = ids
        plevels = np.full(c_pad, -1, np.int32)
        plevels[:c] = levels
        pids_dev = torch.tensor(pids, device=dev)
        plevels_dev = torch.tensor(plevels, device=dev)
        q = vecs[pids_dev.long()]
        q_cache = vcache[pids_dev.long()]

        efc = cfg.ef_construction
        pools = {0: self._level0_pool(q, vecs, vcache, n_prev, min(efc, self.store.capacity))}
        for level in range(1, int(levels.max()) + 1 if c else 1):
            if not (plevels >= level).any():
                continue
            ul = self._upper(level)
            mem = ul.ids[: ul.n]
            mem = mem[(mem >= 0) & (mem < n_prev)]
            if len(mem) == 0:
                continue
            n_pad = _pow2(len(mem))
            mem_p = np.full(n_pad, -1, np.int32)
            mem_p[: len(mem)] = mem
            pools[level] = _member_knn(q, q_cache, vecs, vcache, torch.tensor(mem_p, device=dev),
                                       len(mem), min(efc, n_pad), cfg.dist)

        # intra-chunk patch distances (hnsw_index.rs:430-437)
        peer_d = D.pairwise(q, q, cfg.dist)

        for level in sorted(pools, reverse=True):
            bd, bi = pools[level]
            need = plevels >= level
            if not need.any():
                continue
            sel = _select_links(vecs, vcache, q, q_cache, bd, bi, pids_dev, plevels_dev, level,
                                peer_d, cfg.m, cfg.dist,
                                min(HEURISTIC_CAND, bd.shape[1] + c_pad)).cpu().numpy()
            limit = cfg.max_m0 if level == 0 else cfg.m
            rev_edges = self._forward_links(level, ids, sel, need[:c])
            if rev_edges:  # reverse links: batched arrange (hnsw_index.rs:204-239)
                self._apply_reverse(level, rev_edges, limit)

        # entry point update (hnsw_index.rs:448-455)
        for r in range(c):
            if int(levels[r]) > self.enter_level:
                self.enter_level = int(levels[r])
                self.entry_point = int(ids[r])

    def _forward_links(self, level: int, ids, sel, need) -> dict[int, list[int]]:
        """Write the forward links of the chunk rows that reach `level`
        (initially limited to m even at level 0, hnsw_index.rs:230-233) and
        return the reverse edges grouped by pivot, each pivot's adds in
        ascending chunk-row order."""
        cfg = self.config
        rows_idx = np.nonzero(need)[0]
        if not len(rows_idx):
            return {}
        Sl = sel[rows_idx].astype(np.int32)
        nodes = ids[rows_idx].astype(np.int32)
        # drop invalid and self (a padding row could inject it)
        valid = (Sl >= 0) & (Sl != nodes[:, None])
        order = np.argsort(~valid, axis=1, kind="stable")
        Sc = np.where(np.take_along_axis(valid, order, axis=1),
                      np.take_along_axis(Sl, order, axis=1), -1)
        if level == 0:
            padded = np.full((len(rows_idx), cfg.max_m0), -1, np.int32)
            padded[:, : min(Sc.shape[1], cfg.max_m0)] = Sc[:, : cfg.max_m0]
            self._write_links0(nodes, padded)
        else:
            ul = self._upper(level)
            ww = min(Sc.shape[1], cfg.m)
            for i, node in enumerate(nodes):
                rrow = ul.ensure_member(int(node))
                ul.links[rrow] = -1
                ul.links[rrow, :ww] = Sc[i, :ww]
            ul.dirty = True
        pv = Sl[valid]
        nd = np.repeat(nodes, valid.sum(1))
        o2 = np.argsort(pv, kind="stable")
        pv_s, nd_s = pv[o2], nd[o2]
        if not len(pv_s):
            return {}
        starts = np.concatenate(([0], np.nonzero(np.diff(pv_s))[0] + 1))
        bounds = np.append(starts, len(pv_s))
        return {int(pv_s[s]): nd_s[bounds[i] : bounds[i + 1]].tolist()
                for i, s in enumerate(starts)}

    _REV_ADD_CAP = 64  # max new candidates folded into one arrange round
    _REV_PIVOT_CAP = 4096  # max pivots per arrange call (bounds the transients)

    def _take_round(self, pending: dict, order) -> dict:
        """Pop one round: up to _REV_PIVOT_CAP pivots, up to _REV_ADD_CAP adds
        each (the rest of an add list waits for a later round)."""
        round_edges = {}
        for p in order:
            if p not in pending:
                continue
            adds = pending[p]
            round_edges[p] = adds[: self._REV_ADD_CAP]
            if len(adds) > self._REV_ADD_CAP:
                pending[p] = adds[self._REV_ADD_CAP :]
            else:
                del pending[p]
            if len(round_edges) >= self._REV_PIVOT_CAP:
                break
        return round_edges

    def _apply_reverse(self, level: int, rev_edges: dict[int, list[int]], limit: int) -> None:
        """Batched reverse-link arrangement in rounds of at most
        _REV_ADD_CAP adds per pivot, close to the reference's incremental
        arrange semantics."""
        cfg = self.config
        pending = {p: list(v) for p, v in rev_edges.items()}
        vecs, _ = self.store.device()
        dev = vecs.device

        if level == 0 and self._links0_canonical_dev:
            # device-canonical links: each round gathers its pivot rows from
            # the device matrix, arranges, and writes them back in place, so
            # a pivot whose add list spans rounds reads its previous round's
            # output.  Rounds take pivots in ascending add-count order so
            # each round's add width stays tight.
            cap = self._dev_links0.shape[0]
            order = sorted(pending, key=lambda p: len(pending[p]))
            while pending:
                round_edges = self._take_round(pending, order)
                pivots = sorted(round_edges)
                A_pad = _pow2(max(len(v) for v in round_edges.values()))
                # column 0 = pivot id, rest = adds; padding pivots use the
                # out-of-range id `cap` (never written)
                piv_new = np.full((_pow2(len(pivots)), 1 + A_pad), -1, np.int32)
                piv_new[:, 0] = cap
                for idx, p in enumerate(pivots):
                    piv_new[idx, 0] = p
                    piv_new[idx, 1 : 1 + len(round_edges[p])] = round_edges[p]
                GR.arrange_links_inplace(vecs, self._dev_links0, torch.tensor(piv_new, device=dev),
                                         cfg.dist, cfg.max_m0)
            return

        ul = self._upper(level) if level > 0 else None
        width = cfg.max_m0 if level == 0 else cfg.m
        while pending:
            round_edges = self._take_round(pending, list(pending))
            pivots = sorted(round_edges)
            P = len(pivots)
            A_pad = _pow2(max(len(v) for v in round_edges.values()))
            P_pad = _pow2(P)
            new_ids = np.full((P_pad, A_pad), -1, np.int32)
            piv = np.zeros(P_pad, np.int32)
            rows = np.full((P_pad, width), -1, np.int32)
            for idx, p in enumerate(pivots):
                piv[idx] = p
                new_ids[idx, : len(round_edges[p])] = round_edges[p]
                rows[idx] = self.links0[p] if level == 0 else ul.links[ul.ensure_member(p)]
            # padding rows: the first pivot with no adds (result ignored)
            piv[P:] = pivots[0]
            rows[P:] = rows[0]
            out = GR.arrange_links_batch(vecs, torch.tensor(rows, device=dev),
                                         torch.tensor(piv, device=dev),
                                         torch.tensor(new_ids, device=dev), cfg.dist, width)
            new_rows = out.cpu().numpy()[:P]
            # committed before the next round, so a pivot whose add list
            # spans rounds reads this round's output
            if level == 0:
                self._write_links0(np.array(pivots), new_rows)
            else:
                for idx, p in enumerate(pivots):
                    ul.links[ul.ensure_member(p)] = new_rows[idx]
                ul.dirty = True

    # ---- search ----
    def _queries(self, queries) -> torch.Tensor:
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        return torch.from_numpy(q).to(self.device)

    def _descend(self, q, node_dist, iters: int = 256) -> torch.Tensor:
        """Greedy descent from the entry point through levels enter..1."""
        cur = torch.full((q.shape[0],), self.entry_point, dtype=torch.int32, device=q.device)
        for level in range(self.enter_level, 0, -1):
            links_l, pos_l = self._upper(level).device()
            cur = BM.greedy_descent(cur, node_dist, _upper_links_fn(links_l, pos_l), iters)
        return cur

    def _graph_knn_device(self, q, ef: int):
        """Tensor-in / tensor-out graph search over the rerank rows (the
        exact f32 rows, or a lean store's bf16 rows): greedy upper descent
        on K2, then the level-0 beam: K3 when E * L == 128 (M = 16 -> L =
        32, E = 4), else the fused lock-step loop (K4 -> K2 -> K5).  Returns
        ((B, ef) dists over those rows ascending, ids)."""
        expand = BEAM_EXPAND
        iters, ring = _budgets(ef)
        base = self.store.device_rerank()
        links0 = self._links0_device()
        nd = lambda ids: G.gather_dists(q, base, ids, self.dist)
        cur = self._descend(q, nd)
        L0 = links0.shape[1]
        if expand * L0 == TR.EL:
            return TR.traverse(q, base, links_rows(links0, base.shape[0]), cur, ef, L0, E=expand,
                               R=min(ring, 256), max_iters=iters, dist=self.dist)
        return BM.beam_search(cur, nd, lambda ids: links0[ids.long()], ef, iters, expand, ring)

    def _graph_result(self, q, bd, bi, k: int):
        """The graph route's (B, k) numpy answer from the beam's (B, ef)
        (dists, ids).  On a lean store the beam scored the bf16 rows: the
        reference's lean branch makes the top k's distances exact f32 from
        the retained generator (`VecStore.refine_result`: exact rows, then a
        stable sort by the refined distances), and leaves the bf16
        distances standing when the store kept none (keep_fill=False)."""
        d, i = bd[:, :k].cpu().numpy(), bi[:, :k].cpu().numpy()
        if self.store.tier == "lean":
            return self.store.refine_result(q, d, i)
        return d, i

    def knn_with_ef_batch(self, queries, k: int, ef: int, route: str = "auto"):
        """Batched kNN with the reference's contract (hnsw_index.rs:624-633):
        approximate top-k whose recall grows with `ef`, exact returned
        distances.  Returns ((B, k) f32, (B, k) int32) numpy, -1 padded.

        route="graph": greedy descent + the level-0 beam search.  On CUDA
        the beam runs on the kernels (`_graph_knn_device`) over the exact
        f32 rows, so the beam distances are the exact distances; over a
        lean store's bf16 rows (a graph attached to it), then the top k
        refined exactly (`_graph_result`).  On the
        CPU it is the classic loop on the bf16 traversal copy, then an exact
        rerank of the ef beam.
        route="scan": the Flat two-stage plan in the store's scan mode
        (`VecStore.scan_mode`; K1 + K2 by default) with `ef` as the stage-1
        survivor count.
        route="auto": scan on CUDA, graph on the CPU (the CPU tests exercise
        the true traversal), as the reference routes on TPU and CPU."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = queries.shape[0]
        if route not in ("auto", "graph", "scan"):
            raise ValueError(f"unknown route {route!r} (auto|graph|scan)")
        if len(self.store) == 0 or self.entry_point is None:
            return np.full((B, k), np.inf, np.float32), np.full((B, k), -1, np.int32)
        ef = max(ef, k)
        q = self._queries(queries)
        if route == "auto":
            route = "scan" if q.is_cuda else "graph"
        if route == "scan":
            d, i = FlatIndex.from_store(self.store)._knn_device(q, k, rerank_depth=ef)
            return d.cpu().numpy(), i.cpu().numpy()
        if q.is_cuda:
            return self._graph_result(q, *self._graph_knn_device(q, ef), k)
        iters, ring = _budgets(ef)

        links0 = self._links0_device()
        vecs, vcache = self.store.device()
        vecs_t, _ = self.store.device_traversal()
        nd = _make_node_dist(q, D.dist_cache(q, self.dist), vecs_t, vcache, self.dist)
        cur = self._descend(q, nd)
        _, bi = BM.beam_search(cur, nd, lambda ids: links0[ids.long()], ef, iters, BEAM_EXPAND, ring)
        d, i = T.knn_gathered(q, vecs, bi, k, self.dist, base_cache=vcache)
        return d.cpu().numpy(), i.cpu().numpy()

    def traversal_stats(self, queries, k: int, ef: int):
        """Graph-route search that also reports the NOVEL rows scored per
        query: greedy descent on K2, then the lock-step loop on K4 -> K2 ->
        K5 on CUDA (the classic loop on the CPU), at any M.  Returns (dists
        (B, k), ids (B, k), rows_scored (B,) int32) numpy."""
        iters, ring = _budgets(ef)
        q = self._queries(queries)
        base = self.store.device_rerank()
        links0 = self._links0_device()
        nd = lambda ids: G.gather_dists(q, base, ids, self.dist)
        cur = self._descend(q, nd)
        bd, bi, rows = BM.beam_search(cur, nd, lambda ids: links0[ids.long()], ef, iters,
                                      BEAM_EXPAND, ring, with_stats=True)
        return bd[:, :k].cpu().numpy(), bi[:, :k].cpu().numpy(), rows.cpu().numpy()

    def knn_batch(self, queries, k: int):
        return self.knn_with_ef_batch(queries, k, self.config.default_ef)

    def knn(self, query, k: int) -> list[CandidatePair]:
        d, i = self.knn_batch(query, k)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]:
        """Single-query search on the store's device.  A host f32 store
        takes the native engine (`native.hnsw_knn_single`: the serial
        best-first search over the host rows and links), as the reference
        serves it; a CUDA store takes the batch path with B = 1 on the card,
        where its rows live."""
        if len(self.store) == 0 or self.entry_point is None:
            return []
        if self.store.dtype == np.float32 and self.store.torch_device.type == "cpu":
            ids, dists = native.hnsw_knn_single(self, np.asarray(query, np.float32), k, ef)
            return [CandidatePair(int(i_), float(d_)) for i_, d_ in zip(ids, dists)]
        d, i = self.knn_with_ef_batch(np.asarray(query, np.float32), k, ef)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_pq_batch(self, queries, k: int, ef: int, pq, expand: int | None = None,
                     route: str = "auto", fused: bool = True):
        """HNSW search with ADC distances + exact rerank (hnsw_index.rs:672-697).
        Returns ((B, k) f32, (B, k) int32) numpy, -1 padded.

        route="graph": greedy descent and the level-0 beam on ADC node
        distances (K8 / K9 ids shape), then an exact rerank of the ef beam
        (K2 on CUDA, `knn_gathered` on the CPU).  The beam is the fused loop
        K4 -> K8/K9 -> K5 on CUDA, or with `fused=False` the classic loop
        with K6; the CPU runs the classic loop.  Budgets are the
        reference's: expand BEAM_EXPAND on CUDA, 1 on the CPU,
        (2 ef + 64) / expand + 16 iterations, the default ring.
        route="scan": the PQ table's full ADC scan (K7, or K8 / K9) keeping
        ef candidates + K2's exact rerank, on either device.
        route="mirror": the Flat two-stage plan (K1 + K2) on the store's
        int8 mirror with ef as the stage-1 depth.
        route="auto": "mirror" on CUDA (a better quantized representation
        than 4-bit ADC, and the full-tier store always holds its mirror),
        "graph" on the CPU, so the tests exercise the reference algorithm."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        B = queries.shape[0]
        if len(self.store) == 0 or self.entry_point is None:
            return np.full((B, k), np.inf, np.float32), np.full((B, k), -1, np.int32)
        if route not in ("auto", "graph", "scan", "mirror"):
            raise ValueError(f"unknown route {route!r} (auto|graph|scan|mirror)")
        ef = max(ef, k)
        q = self._queries(queries)
        on_cuda = q.is_cuda
        if route == "auto":
            route = "mirror" if on_cuda else "graph"
        if route == "mirror":
            d, i = FlatIndex.from_store(self.store)._knn_device(q, k, rerank_depth=ef)
            return d.cpu().numpy(), i.cpu().numpy()
        # the scan and graph candidate orderings are ADC: the loud check
        pq.warn_if_unreliable(f"HNSWIndex.knn_pq route={route!r}")
        lookup, q_norms = pq.create_lookup(q)
        if route == "scan":
            _, cand = pq.adc_scan(lookup, q_norms, ef)
            d, i = G.rerank_topk(q, self.store.device_rerank(), cand, k, self.dist)
            return d.cpu().numpy(), i.cpu().numpy()
        codes, _, cb_sq = pq.device()
        cap = self.store.capacity
        if codes.shape[0] < cap:  # pad to the store's capacity so gathers stay in bounds
            codes = torch.nn.functional.pad(codes, (0, 0, 0, cap - codes.shape[0]))
        links0 = self._links0_device()
        if expand is None:
            expand = BEAM_EXPAND if on_cuda else 1
        iters = (2 * ef + 64 + expand - 1) // expand + 16
        nd = _make_adc_node_dist(lookup, q_norms, codes, cb_sq, self.dist, pq.config.m, pq.packed)
        cur = self._descend(q, nd)
        _, bi = BM.beam_search(cur, nd, lambda ids: links0[ids.long()], ef, iters, expand,
                               fused=fused)
        if on_cuda:
            d, i = G.rerank_topk(q, self.store.device_rerank(), bi[:, :ef], k, self.dist)
        else:
            vecs, vcache = self.store.device()
            d, i = T.knn_gathered(q, vecs, bi, k, self.dist, base_cache=vcache)
        return d.cpu().numpy(), i.cpu().numpy()

    def knn_pq(self, query, k: int, ef: int, pq) -> list[CandidatePair]:
        d, i = self.knn_pq_batch(query, k, ef, pq)
        return pairs_from_arrays(d[0], i[0], k)

    # ---- serde (hnsw_index.rs:635-670; the JAX package's npz keys) ----
    def state(self, include_vectors: bool = True) -> tuple[dict, dict]:
        n = len(self.store)
        arrays = self.store.state_arrays(include_vectors)
        arrays["hnsw_levels"] = self.levels[:n].copy()
        arrays["hnsw_links0"] = self.links0[:n].copy()
        for lvl, ul in enumerate(self.upper, start=1):
            arrays[f"hnsw_upper_ids_{lvl}"] = ul.ids[: ul.n].copy()
            arrays[f"hnsw_upper_links_{lvl}"] = ul.links[: ul.n].copy()
        meta = {
            "algorithm": "HNSW",
            "dim": self.dim,
            "dist": self.dist,
            "n": n,
            "hnsw": {
                "M": self.config.m,
                "ef_construction": self.config.ef_construction,
                "default_ef": self.config.default_ef,
                "entry_point": self.entry_point,
                "enter_level": self.enter_level,
                "num_upper_levels": len(self.upper),
            },
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, external_vectors=None, external_store=None,
                   device="cuda") -> "HNSWIndex":
        """Rebuild from serialized topology.  Vector source, in priority
        order: arrays["vectors"], `external_store` (a populated VecStore, on
        its own device), or `external_vectors` (host array, the reference's
        IndexSerdeExternalVecSet shape, mod.rs:143-148)."""
        h = meta["hnsw"]
        cfg = HNSWConfig(max_elements=meta["n"], ef_construction=h["ef_construction"], M=h["M"])
        vecs = arrays.get("vectors", external_vectors)
        if vecs is None and external_store is None:
            raise ValueError("HNSWIndex state has no vectors and none were provided")
        if vecs is not None:
            index = cls(meta["dim"], meta["dist"], cfg, device=device)
            index.store.batch_push(np.asarray(vecs))
        else:
            if len(external_store) != meta["n"]:
                raise ValueError(f"external store has {len(external_store)} rows, index "
                                 f"topology expects {meta['n']}")
            index = cls(meta["dim"], meta["dist"], cfg, device=external_store.torch_device)
            index.store = external_store
            index._reset_graph(external_store.capacity)
        n = meta["n"]
        index.levels[:n] = arrays["hnsw_levels"]
        index.links0[:n] = arrays["hnsw_links0"]
        index._links0_full_dirty = True
        index.config.default_ef = h["default_ef"]
        index.entry_point = h["entry_point"]
        index.enter_level = h["enter_level"]
        for lvl in range(1, h["num_upper_levels"] + 1):
            ul = index._upper(lvl)
            links = arrays[f"hnsw_upper_links_{lvl}"]
            for row, node in enumerate(arrays[f"hnsw_upper_ids_{lvl}"]):
                ul.links[ul.ensure_member(int(node))] = links[row]
            ul.dirty = True
        return index

    def save(self, path, include_vectors: bool = True) -> None:
        arrays, meta = self.state(include_vectors)
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, external_vectors=None, external_store=None, device="cuda") -> "HNSWIndex":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, external_vectors, external_store, device=device)
