"""IVF (inverted file) index (port of models/ivf.py).

Parity target: `IVFIndex` (reference: src/index_algorithm/ivf_index.rs).  The
coarse quantizer is k-means (`ops/kmeans.py`: `kmeanspp_init` + `lloyd` from
a seeded `torch.Generator`); the posting lists are a padded (k, Lmax) int32
matrix, -1 padded.  As in the reference, `ef` means the number of probed
lists (ivf_index.rs:137-142) and the default is 4 probes.

Two search routes (`knn_batch`):
- BINNED (a CUDA store, B >= 32, the int8 self-test passed):
  `_knn_device_binned` scans each probed list once against the block of
  queries probing it: centroid top-p, `ops/binning.bin_queries`, K10 over
  the cluster-sorted int8 mirror (`ops/scan_binned.py`), a per-query regroup
  and exact stable top-r of the packed survivors, K1 over the shared
  overflow segment, then K2's exact rerank (bf16 rows on the lean tier).
- GATHERED (small batches, the CPU): the union of each query's probed
  posting lists streamed through K2 512 ids at a time
  (`gather.rerank_topk_blocked`), or on a CPU full-tier store
  `topk.knn_gathered`.

The reference also carries `_FUSED_HBM_BUDGET` and a fused / split pair of
jitted programs (one device program while the arguments fit a 16 GB TPU,
else the rerank as its own program).  Both exist only for the TPU's program
dispatch and memory limit; the port runs one eager path, so they have no
counterpart.  Nor does the reference's batch padding: its bins are built
for B_pad = 128-multiple queries with the pad rows routed to a sentinel
list, while K10 reads query rows through the bins, so the port bins the B
real queries alone and gets the same bins and slots for every real list.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .store import VecStore
from ..ops import binning as BN
from ..ops import gather as G
from ..ops import kmeans as KM
from ..ops import scan as S
from ..ops import scan_binned as SB
from ..ops import topk as T
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays
from ..utils.config import IVFConfig

DEFAULT_N_PROBES = 4
_QB = SB.QB  # queries per list bin of the binned scan
_LPAD_MULT = 512  # list segments pad to this (K10's tile)
_LCAP_QUANTILE = 0.9  # lists are capped at this length quantile (padded); the
# remainder spills to the overflow segment that every query scans
_ASSIGN_ROWS = 131072  # rows per block of the cluster assignment


def _build_posting(assign: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Posting lists from cluster assignments: (k, Lmax) int32 (-1 padded)
    with each list's ids ascending, and the (k,) lengths."""
    n = len(assign)
    counts = np.bincount(assign, minlength=k).astype(np.int32)
    l_max = max(int(counts.max()), 1)
    posting = np.full((k, l_max), -1, dtype=np.int32)
    if n:
        order = np.argsort(assign, kind="stable").astype(np.int32)
        start = np.zeros(k, dtype=np.int64)
        start[1:] = np.cumsum(counts)[:-1]
        cols = np.arange(n, dtype=np.int64) - start[assign[order]]
        posting[assign[order], cols] = order
    return posting, counts


def _sorted_layout(posting: np.ndarray, posting_len: np.ndarray, k: int,
                   cap_quantile: float | None = None,
                   force_lpad: int | None = None) -> tuple[int, np.ndarray, np.ndarray]:
    """Cluster-sorted mirror layout for the binned scan -> (lpad, perm_pad,
    ov_ids): list l owns the `lpad`-row segment [l * lpad, (l + 1) * lpad)
    (perm_pad[slot] = original id, -1 on pads).  Lists are capped at the
    `cap_quantile` length (None: `_LCAP_QUANTILE`, read at call time; IVF-PQ
    takes 0.95), padded to `_LPAD_MULT`; the tails spill to the overflow
    segment `ov_ids`, which every query scans, so spilled rows stay findable
    for any probe set.  `force_lpad` overrides the quantile-derived segment
    length: the sharded IVF-PQ tier puts every shard on the longest shard's
    lpad so the shards share one layout."""
    lens = posting_len
    if force_lpad is not None:
        lpad = int(force_lpad)
    else:
        q = _LCAP_QUANTILE if cap_quantile is None else cap_quantile
        l_q = int(np.quantile(lens, q)) if len(lens) else 1
        lpad = max(_LPAD_MULT, -(-l_q // _LPAD_MULT) * _LPAD_MULT)
    perm_pad = np.full((k * lpad,), -1, dtype=np.int32)
    ov_ids = []
    for l in range(k):
        c = int(lens[l])
        kept = min(c, lpad)
        perm_pad[l * lpad : l * lpad + kept] = posting[l, :kept]
        if c > lpad:
            ov_ids.append(posting[l, lpad:c])
    ov = np.concatenate(ov_ids).astype(np.int32) if ov_ids else np.zeros((0,), np.int32)
    return lpad, perm_pad, ov


def _fit_centroids(train: torch.Tensor, n_train: int, config: IVFConfig, dist: str,
                   seed: int) -> torch.Tensor:
    """k-means++ seeds from a `torch.Generator` seeded with `seed`, then
    Lloyd iterations -> (k, dim) f32 on train's device."""
    gen = torch.Generator(device=train.device).manual_seed(seed)
    init = KM.kmeanspp_init(train, n_train, config.k, dist, gen)
    return KM.lloyd(train, n_train, init, config.k_means_max_iter, config.k_means_tol, dist)


def _assign(vecs: torch.Tensor, centroids: torch.Tensor, dist: str) -> np.ndarray:
    """Nearest-centroid ids of every row, in blocks (bounds the (rows, k)
    distance transient) -> host int32."""
    out = [KM.find_nearest(vecs[r0 : r0 + _ASSIGN_ROWS], centroids, dist)
           for r0 in range(0, vecs.shape[0], _ASSIGN_ROWS)]
    return torch.cat(out).cpu().numpy() if out else np.zeros((0,), np.int32)


def _storage_ptr(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class IVFIndex:
    algorithm = "IVF"

    def __init__(self, store: VecStore, config: IVFConfig, centroids: np.ndarray,
                 posting: np.ndarray, posting_len: np.ndarray):
        self.store = store
        self.config = config
        self.centroids = np.array(centroids, dtype=np.float32)
        self.posting = np.array(posting, dtype=np.int32)
        self.posting_len = np.array(posting_len, dtype=np.int32)
        self.default_n_probes = DEFAULT_N_PROBES
        self._dev_centroids: torch.Tensor | None = None
        self._dev_posting: torch.Tensor | None = None
        # (q8_sorted, scale_sorted, cache_sorted, perm_pad, lpad, overflow)
        # for the binned scan; built on the first binned search
        self._dev_binned: tuple | None = None
        # bin-overflow telemetry (see _note_drops)
        self._pending_drop_count: torch.Tensor | None = None
        self.last_dropped_pairs = 0
        self.dropped_pairs_total = 0

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
        """Device bytes this index holds: the store's tensors, the centroid
        and posting matrices, and the binned scan's sorted mirror and
        overflow segment once built.  A tensor that shares the store's
        memory (the ingest-sorted lean mirror and its overflow slice, used
        in place) is counted once."""
        total = self.store.device_bytes()
        shared = self.store.mirror_layout == "sorted"
        seen = {_storage_ptr(t) for t in self.store.device_int8().tensors} if shared else set()
        extra = [self._dev_centroids, self._dev_posting]
        if self._dev_binned is not None:
            q8s, sc, ca, perm_pad, _, ov = self._dev_binned
            extra += [q8s, sc, ca, perm_pad, *(ov or ())]
        for t in extra:
            if t is None or _storage_ptr(t) in seen:
                continue
            seen.add(_storage_ptr(t))
            total += t.numel() * t.element_size()
        return total

    # ---- build (ivf_index.rs:64-107) ----
    @classmethod
    def from_numpy(cls, vectors: np.ndarray, dist: str, config: IVFConfig, seed: int = 0,
                   device="cuda") -> "IVFIndex":
        vectors = np.asarray(vectors, dtype=np.float32)
        n = len(vectors)
        store = VecStore.from_numpy(vectors, dist, device=device)
        rng = np.random.default_rng(seed)
        if config.k_means_size is not None and config.k_means_size < n:
            sel = rng.choice(n, size=config.k_means_size, replace=False)
            train = vectors[sel]
        else:
            train = vectors
        train_dev = torch.from_numpy(np.ascontiguousarray(train)).to(store.torch_device)
        centroids = _fit_centroids(train_dev, len(train), config, dist, seed)
        assign = _assign(store.device()[0][:n], centroids, dist)
        posting, counts = _build_posting(assign, config.k)
        return cls(store, config, centroids.cpu().numpy(), posting, counts)

    @classmethod
    def from_store(cls, store: VecStore, config: IVFConfig, seed: int = 0) -> "IVFIndex":
        """Build over an existing (possibly device-born) full-tier store: the
        k-means and the assignment run on the store's device."""
        n = len(store)
        vecs, _ = store.device()
        n_train = config.k_means_size if config.k_means_size is not None and config.k_means_size < n else n
        # device-born rows are already in random order: train on a prefix
        centroids = _fit_centroids(vecs[:n_train], n_train, config, store.dist, seed)
        posting, counts = _build_posting(_assign(vecs[:n], centroids, store.dist), config.k)
        return cls(store, config, centroids.cpu().numpy(), posting, counts)

    @classmethod
    def from_device_blocks(cls, fill, n: int, dim: int, dist: str, config: IVFConfig, seed: int = 0,
                           block_rows: int = 131072, mirror: str = "scan", device="cuda") -> "IVFIndex":
        """Memory-LEAN build (see `VecStore.from_device_blocks`): k-means
        trains on the first block of `fill`, every block is assigned while it
        is f32 on the device, and only the int8 mirror and the bf16 rerank
        rows persist.

        mirror="scan": the store keeps the random-permutation mirror (the
        Flat scan can use it); the first binned search gathers a second,
        cluster-sorted copy.  mirror="sorted": two passes over `fill` (assign
        only, then quantize straight into the cluster-sorted slots), so the
        binned search reads the store's mirror in place; pad slots get
        filler ids n..cap-1 that are never written (they keep the losing
        sentinel).  Such a store serves only IVF: the Flat scan refuses it."""
        if mirror not in ("scan", "sorted"):
            raise ValueError(f"mirror must be 'scan' or 'sorted', got {mirror!r}")
        from ..utils.device import resolve

        dev = resolve(device)
        n_train = min(config.k_means_size or block_rows, n, block_rows)
        train = fill(0, n_train).to(dev, torch.float32)
        centroids = _fit_centroids(train, n_train, config, dist, seed)
        del train
        assign = np.empty(n, np.int32)

        def assign_fn(v, row0):
            assign[row0 : row0 + v.shape[0]] = _assign(v, centroids, dist)

        kw = dict(block_rows=block_rows, device=dev)
        if mirror == "sorted":
            # pass A: assignment only; a row's sorted slot depends on the
            # whole posting layout
            for row0 in range(0, n, block_rows):
                assign_fn(fill(row0, min(block_rows, n - row0)).to(dev, torch.float32), row0)
            posting, counts = _build_posting(assign, config.k)
            lpad, perm_pad, ov_h = _sorted_layout(posting, counts, config.k)
            kl = config.k * lpad
            cap = kl + len(ov_h)
            perm_full = np.empty(cap, np.int32)
            perm_full[:kl] = perm_pad
            perm_full[kl:] = ov_h
            pad_slots = np.flatnonzero(perm_full < 0)
            perm_full[pad_slots] = np.arange(n, cap, dtype=np.int32)
            store = VecStore.from_device_blocks(fill, n, dim, dist, perm=perm_full, cap=cap, **kw)
            return cls(store, config, centroids.cpu().numpy(), posting, counts)
        store = VecStore.from_device_blocks(fill, n, dim, dist, assign_fn=assign_fn, **kw)
        posting, counts = _build_posting(assign, config.k)
        return cls(store, config, centroids.cpu().numpy(), posting, counts)

    # ---- search (ivf_index.rs:143-154) ----
    def _device(self):
        if self._dev_centroids is None:
            self._dev_centroids = torch.from_numpy(self.centroids).to(self.device)
            self._dev_posting = torch.from_numpy(self.posting).to(self.device)
        return self._dev_centroids, self._dev_posting

    def _device_sorted(self):
        """The cluster-sorted int8 mirror of the binned scan, built once:
        (q8, scale, cache, perm_pad, lpad, overflow), overflow = (q8, scale,
        cache, original ids) of the spilled rows or None.

        Each posting list is one contiguous `lpad`-row segment; pad rows
        carry scale 0 and cache +BIG.  Lists are capped at a length quantile
        (k-means lists are skewed: padding all to the longest would multiply
        memory and work) and the tails form the overflow segment.  A store
        ingested with mirror="sorted" IS this layout: its tensors are used in
        place (K10 reads only the first k * lpad rows, the overflow is a
        slice after them).  Otherwise the rows are gathered from the
        permuted mirror into a second copy."""
        if self._dev_binned is not None:
            return self._dev_binned
        k = self.config.k
        lpad, perm_pad, ov_h = _sorted_layout(self.posting, self.posting_len, k)
        dev = self.device
        pp = torch.from_numpy(perm_pad).to(dev)
        mirror = self.store.device_int8()
        if mirror.layout == "sorted":
            q8_all, scales, cache, _ = mirror
            kl = k * lpad
            if kl + len(ov_h) != self.store.capacity:
                # the recomputed layout must be the one the ingest used, or
                # the survivors would decode to wrong ids
                raise ValueError(
                    f"sorted-mirror layout mismatch: recomputed k*lpad+overflow = {kl + len(ov_h)} "
                    f"but the store was ingested with capacity {self.store.capacity}; this IVFIndex "
                    "was not built over this store's posting layout")
            ov = None
            if len(ov_h):
                sl = slice(kl, kl + len(ov_h))
                ov = (q8_all[sl], scales[sl], cache[sl], torch.from_numpy(ov_h).to(dev))
            self._dev_binned = (q8_all, scales, cache, pp, lpad, ov)
            return self._dev_binned
        # the mirror is scan-permuted: gather a sorted copy, pad rows sentinels
        binned = mirror.take(np.maximum(perm_pad, 0), pp >= 0)
        ov = (*mirror.take(ov_h), torch.from_numpy(ov_h).to(dev)) if len(ov_h) else None
        self._dev_binned = (*binned, pp, lpad, ov)
        return self._dev_binned

    def _queries(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            return torch.atleast_2d(queries).to(self.device, torch.float32)
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        return torch.from_numpy(q).to(self.device)

    def _scan_inputs(self, q: torch.Tensor, n_probes: int):
        """The binned scan's query side -> (probe_ids (B, p), slots (B, p),
        K10's arguments (q8, qs2, qc, bins, mirror, scale, cache, lpad))."""
        q8s, scale_s, cache_s, _, lpad, _ = self._device_sorted()
        centroids, _ = self._device()
        _, probe_ids = KM.find_n_nearest(q, centroids, n_probes, self.dist)
        bins, slots = BN.bin_queries(probe_ids, self.config.k, _QB)
        q8, qs2, qc = S.quantize_queries(q, q8s.shape[1], self.dist)
        return probe_ids, slots, (q8, qs2, qc, bins, q8s, scale_s, cache_s, lpad)

    def _binned_candidates(self, q: torch.Tensor, k: int, n_probes: int):
        """Candidate stage of the binned search -> ((B, C) int32 original
        ids, -1 padded; device count of dropped (query, list) pairs)."""
        perm_pad, lpad, overflow = self._device_sorted()[3:]
        nlist = self.config.k
        B = q.shape[0]
        spl = lpad // SB._GS  # survivors per list
        probe_ids, slots, args = self._scan_inputs(q, n_probes)
        packed = SB.scan_chunkmin_int8_binned(*args)

        # regroup: query b's survivors of probe j sit in column slots[b, j]
        # of list probe_ids[b, j]'s (spl, QB) block
        lists = probe_ids.long()
        pkq = packed.view(nlist, spl, _QB).transpose(1, 2).reshape(nlist * _QB, spl)
        cand_pk = pkq[(lists * _QB + slots.clamp_min(0).long()).view(-1)].view(B, n_probes, spl)
        dropped = slots < 0
        big_bits = int(np.float32(3.0e38).view(np.int32))
        cand_pk = torch.where(dropped[:, :, None], big_bits, cand_pk).view(B, n_probes * spl)

        # deeper rerank than the full scan: the pool holds in-list rows whose
        # true distances are close, so int8 ordering noise needs headroom.
        # The reference takes this top-r with approx_min_k on a TPU; here it
        # is an exact stable sort (ties: lower position first, as lax.top_k)
        r = min(max(8 * k, 64), n_probes * spl)
        sel_d, pos = torch.sort(cand_pk.view(torch.float32), dim=1, stable=True)
        sel_d, pos = sel_d[:, :r], pos[:, :r]
        pk_sel = torch.gather(cand_pk, 1, pos)
        # survivor m of list l: sorted row l*lpad + (m//128)*512 + m%128 + low*128
        m = pos % spl
        rows = (torch.gather(lists, 1, pos // spl) * lpad + (m // SB._SPT) * SB._TILE + m % SB._SPT
                + (pk_sel & (SB._GS - 1)).long() * SB._SPT)
        orig = perm_pad[rows.clamp(0, perm_pad.shape[0] - 1)]
        orig = torch.where(sel_d >= 1.0e38, T.INVALID_ID, orig)

        if overflow is not None:
            # spilled rows of over-long lists: every query scans them with
            # K1 (its plain version on the CPU)
            q8_ov, scale_ov, cache_ov, perm_ov = overflow
            n_ov = q8_ov.shape[0]
            r_ov = min(max(4 * k, 32), n_ov)
            _, bi_ov = S.scan_candidates_int8_packed(q, q8_ov, scale_ov, cache_ov, r_ov, self.dist)
            orig_ov = torch.where(bi_ov >= 0, perm_ov[bi_ov.clamp(0, n_ov - 1).long()], T.INVALID_ID)
            orig = torch.cat([orig, orig_ov], 1)
        return orig.contiguous(), dropped.sum()

    def _knn_device_binned(self, queries, k: int, n_probes: int):
        """Batched binned IVF search on the store's device, no host sync:
        the reference's per-query list scan (ivf_index.rs:143-154) inverted
        into per-LIST scans over the queries probing each list, then K2's
        exact rerank of the candidates.  A bin that overflows (> 128 queries
        probing one list) drops those (query, list) pairs only; the count is
        read lazily by `_note_drops`.  Returns ((B, k) f32, (B, k) int32)."""
        q = self._queries(queries)
        n_probes = min(n_probes, self.config.k)
        orig, n_dropped = self._binned_candidates(q, k, n_probes)
        self._pending_drop_count = n_dropped
        return G.rerank_topk(q, self.store.device_rerank(), orig, k, self.dist)

    def _note_drops(self) -> None:
        """Fold the last binned batch's drop count into the counters (one
        scalar read, after the results were fetched)."""
        nd = self._pending_drop_count
        if nd is None:
            return
        self._pending_drop_count = None
        n = int(nd)
        self.last_dropped_pairs = n
        self.dropped_pairs_total += n
        if n:
            logging.getLogger(__name__).warning(
                "binned IVF: %d (query, list) probe pairs dropped by bin overflow (> %d queries "
                "probing one list); recall on the affected queries is degraded: lower the batch "
                "size or raise nlist for this workload (total dropped: %d)",
                n, _QB, self.dropped_pairs_total)

    def knn_batch(self, queries, k: int, n_probes: int | None = None):
        """Batched kNN -> ((B, k) f32 dists, (B, k) int32 ids) numpy, -1
        padded.  The binned route on a CUDA store for B >= 32 when the int8
        self-test passed; else each query's probed posting lists."""
        n_probes = n_probes or self.default_n_probes
        q = self._queries(queries)
        if q.is_cuda and q.shape[0] >= 32 and self.store.int8_reliable():
            d, i = self._knn_device_binned(q, k, n_probes)
            d, i = d.cpu().numpy(), i.cpu().numpy()
            self._note_drops()
            return d, i
        centroids, posting = self._device()
        _, probe_ids = KM.find_n_nearest(q, centroids, n_probes, self.dist)
        cand = posting[probe_ids.long()].reshape(q.shape[0], -1)
        if q.is_cuda or self.store.tier == "lean":
            # probe unions can span most of the set: stream them through K2
            d, i = G.rerank_topk_blocked(q, self.store.device_rerank(), cand, k, self.dist)
        else:
            vecs, cache = self.store.device()
            d, i = T.knn_gathered(q, vecs, cand, k, self.dist, base_cache=cache)
        return d.cpu().numpy(), i.cpu().numpy()

    def knn(self, query, k: int) -> list[CandidatePair]:
        d, i = self.knn_batch(query, k, self.default_n_probes)
        return pairs_from_arrays(d[0], i[0], k)

    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]:
        """`ef` is the number of probes (ivf_index.rs:137-142)."""
        d, i = self.knn_batch(query, k, ef)
        return pairs_from_arrays(d[0], i[0], k)

    # ---- serde (the JAX package's npz keys) ----
    def state(self, include_vectors: bool = True) -> tuple[dict, dict]:
        arrays = self.store.state_arrays(include_vectors)
        arrays.update(ivf_centroids=self.centroids, ivf_posting=self.posting,
                      ivf_posting_len=self.posting_len)
        meta = {
            "algorithm": "IVF", "dim": self.dim, "dist": self.dist, "n": len(self.store),
            "ivf": {"k": self.config.k, "k_means_size": self.config.k_means_size,
                    "k_means_max_iter": self.config.k_means_max_iter,
                    "k_means_tol": self.config.k_means_tol},
        }
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, external_vectors=None, device="cuda") -> "IVFIndex":
        vecs = arrays.get("vectors", external_vectors)
        if vecs is None:
            raise ValueError("IVFIndex state has no vectors and none were provided")
        store = VecStore.from_numpy(np.asarray(vecs), meta["dist"], device=device)
        return cls(store, IVFConfig.from_dict(meta["ivf"]), arrays["ivf_centroids"],
                   arrays["ivf_posting"], arrays["ivf_posting_len"])

    def save(self, path, include_vectors: bool = True) -> None:
        arrays, meta = self.state(include_vectors)
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, external_vectors=None, device="cuda") -> "IVFIndex":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, external_vectors, device=device)
