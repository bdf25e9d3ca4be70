"""Flat (brute-force) index (port of models/flat.py).

The planner is the reference's, in the store's scan mode
(`VecStore.scan_mode`, a `ScanMode`: the reference's `VECDB_TPU_SCAN` and
`VECDB_TPU_PCA_DIM`, set by `FlatIndex(..., scan=, pca_dim=)` or by the DB
layer):
- the exact f32 scan (`topk.knn_scan`) at n <= 65,536 rows, in the "exact"
  mode, or when the int8 ordering self-test fails ("int8" / "pca" modes);
- "int8" (the default): the store's permuted int8 mirror's stage 1
  (`mirror.ScanMirror.survivors`: K1, the packed int8 chunk-min scan, then
  an exact top-r over its survivors), its `decode`, and K2, the exact rerank
  gather, with a top-k;
- "pca" (where pca_dim < dim; else it is "int8", as in the reference): the
  same over the store's PCA-projected mirror (row order) with projected
  queries and a deeper top-r;
- "bf16" (the reference's "2stage" too): the reference's XLA candidate pass
  (`topk.scan_candidates`, a bf16 product and an exact top-r over the bf16
  traversal copy), then K2.

`knn` (one query) is the exact scan on the store's device: a batch of one
on a CUDA store, whose rows stay on the card; on a host store, the native
engine's serial exact scan (`models/native.py`), as the reference serves
it.  A lean store takes `knn_batch`.

On a CUDA store both stages launch the hand-written kernels; on a CPU store
they run the kernels' plain PyTorch versions, the same algorithm (the JAX
package's CPU path is a different, bf16 XLA scan).

`knn_pq_batch` (Flat+PQ) is the PQ table's ADC scan (K7, or K8 / K9) with
ef candidates, then K2's exact rerank.

On a lean-tier store (`VecStore.from_device_blocks`) the two-stage plan is
the only one (there is no f32 copy to scan exactly): K2 reads the bf16
rerank rows, and `knn_batch` refines the final (B, k) distances to exact
f32 from the regenerated blocks when the store kept its generator.  A store
whose mirror is cluster-sorted (IVF's scale layout) is refused: K1 keeps one
survivor per strided 128-row group, which that layout would starve.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .store import ScanMode, VecStore
from ..ops import gather as G
from ..ops import topk as T
from ..utils import serde
from ..utils.candidates import CandidatePair, pairs_from_arrays
from ..utils.profiling import span

# Below this row count the planner takes the single-pass exact f32 scan:
# K1 keeps one survivor per 128 mirror rows, so at small n the candidate
# pool caps at n/128 whatever the rerank depth.
_EXACT_BELOW = 65536
# stage-1 candidates per requested neighbor (floor 32), growing with
# log2(n / 1M) past 1.5M rows
_RERANK_MULT = 4
# the "pca" mode's stage-1 candidates per requested neighbor (floor 128):
# the reference's VECDB_TPU_RERANK_PCA default
_RERANK_MULT_PCA = 16


class FlatIndex:
    algorithm = "Flat"

    def __init__(self, dim: int, dist: str, capacity: int = 0, device="cuda",
                 scan: str = "int8", pca_dim: int = 256):
        """`scan` / `pca_dim` set the new store's `ScanMode` (see the module
        doc); an unknown mode raises ValueError."""
        mode = ScanMode(scan, pca_dim)
        self.store = VecStore(dim, dist, capacity, device=device)
        self.store.scan_mode = mode

    # ---- construction ----
    @classmethod
    def from_numpy(cls, vectors: np.ndarray, dist: str, device="cuda", scan: str = "int8",
                   pca_dim: int = 256) -> "FlatIndex":
        idx = cls(vectors.shape[1], dist, capacity=len(vectors), device=device, scan=scan,
                  pca_dim=pca_dim)
        if len(vectors):
            idx.store.batch_push(vectors)
        return idx

    @classmethod
    def from_store(cls, store: VecStore) -> "FlatIndex":
        """The planner over `store`, in the store's scan mode."""
        if store.mirror_layout == "sorted":
            raise ValueError(
                "store's int8 mirror is cluster-sorted (binned-IVF scale layout); "
                "FlatIndex requires the randomly-permuted layout")
        idx = cls.__new__(cls)
        idx.store = store
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
        """Device-memory footprint of this index (the store's tensors; Flat
        has no topology)."""
        return self.store.device_bytes()

    def add(self, vec) -> int:
        return self.store.push(vec)

    def batch_add(self, vecs) -> list[int]:
        return self.store.batch_push(vecs)

    # ---- search ----
    def knn_batch(self, queries, k: int, exact: bool | None = None):
        """Batched kNN -> ((B, k) f32 dists, (B, k) int32 ids) as numpy,
        -1 padded.  Returned distances are exact f32 on both paths;
        `exact=True` forces the single-pass exact scan (ground truth).  On
        the lean tier the rerank reads bf16 rows; the final distances are
        then refined to exact f32 (and re-sorted) when the store kept its
        generator, else they stay bf16-grade (`store.distance_precision`)."""
        with span("flat.knn_batch"):
            q = self._queries(queries)
            d, i = self._knn_device(q, k, exact)
            with span("flat.fetch"):
                d, i = d.cpu().numpy(), i.cpu().numpy()
            if self.store.tier == "lean":
                return self.store.refine_result(q, d, i)
            return d, i

    @property
    def uses_pca(self) -> bool:
        """Whether the two-stage plan scans the PCA mirror: the "pca" mode
        at pca_dim < dim (else "pca" is "int8", as in the reference)."""
        mode = self.store.scan_mode
        return mode.scan == "pca" and mode.pca_dim < self.dim

    def rerank_depth(self, k: int, rerank_depth: int | None = None) -> int:
        """Stage-1 survivor count r of the two-stage plan."""
        n = len(self.store)
        if self.uses_pca:
            if rerank_depth is not None:
                return min(max(rerank_depth, k, 128), n)
            return min(max(_RERANK_MULT_PCA * k, 128), n)
        mult = _RERANK_MULT
        if n > 1_500_000:  # log2 depth growth past ~1M rows
            mult = _RERANK_MULT * max(1, int(np.log2(n / 1_000_000)) + 1)
        if rerank_depth is not None:
            return min(max(rerank_depth, k, 32), n)
        return min(max(mult * k, 32), n)

    def _queries(self, queries) -> torch.Tensor:
        """(B, dim) f32 on the store's device.  A host array's upload is the
        span `flat.upload`; a tensor is taken as already uploaded."""
        if isinstance(queries, torch.Tensor):
            return torch.atleast_2d(queries).to(self.device, torch.float32)
        with span("flat.upload"):
            q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
            return torch.from_numpy(q).to(self.device)

    def _knn_device(self, queries, k: int, exact: bool | None = None,
                    rerank_depth: int | None = None):
        """Device-resident kNN: ((B, k) f32, (B, k) int32) tensors on the
        store's device, no host sync on the two-stage path.  Accepts numpy
        or an already-uploaded (B, dim) tensor.  `rerank_depth` overrides
        the stage-1 survivor count."""
        q = self._queries(queries)
        n = len(self.store)
        lean = self.store.tier == "lean"
        scan = self.store.scan_mode.scan
        if exact is None:
            exact = not lean and (scan == "exact" or n <= _EXACT_BELOW)
            if not exact and scan in ("int8", "pca"):
                # the int8 ordering self-test (both mirrors are int8)
                exact = not self.store.int8_reliable()
        if exact:
            if lean:
                raise RuntimeError(
                    "exact f32 scan unavailable on a lean-tier store (no f32 device copy), and "
                    "the int8 self-test failed or exact=True was asked, so the quantized stage 1 "
                    "cannot stand in for it")
            with span("flat.exact"):
                vecs, cache = self.store.device()
                return T.knn_scan(q, vecs, cache, n, k, self.dist)
        r = self.rerank_depth(k, rerank_depth)
        route = "flat.pca" if self.uses_pca else "flat.int8" if scan in ("int8", "pca") else "flat.bf16"
        with span(route):
            if scan in ("int8", "pca"):
                mirror = (self.store.device_proj_int8(self.store.scan_mode.pca_dim) if self.uses_pca
                          else self.store.device_int8())
                with span("flat.k1"):
                    _, cand = mirror.survivors(q, r)
                with span("flat.decode"):
                    cand = mirror.decode(cand, n)
            else:  # "bf16" ("exact" took the branch above)
                scan_vecs, scan_cache = self.store.device_traversal()
                _, cand = T.scan_candidates(q, scan_vecs, scan_cache, n, r, self.dist)
            with span("flat.k2"):
                return G.rerank_topk(q, self.store.device_rerank(), cand, k, self.dist)

    def knn(self, query, k: int) -> list[CandidatePair]:
        """Single-query search through the exact scan on the store's device.
        A host f32 store takes the native engine's exact serial scan
        (`native.flat_knn_single`), as the reference serves it; a CUDA store
        scans on the card, where its rows live.  A lean store has no f32
        rows and takes `knn_batch`'s refined two-stage plan."""
        with span("flat.knn"):
            if self.store.tier == "lean":
                d, i = self.knn_batch(query, k)
                return pairs_from_arrays(d[0], i[0], k)
            if self.store.dtype == np.float32 and self.device.type == "cpu":
                with span("flat.native"):
                    ids, dists = native.flat_knn_single(self.store, np.asarray(query, np.float32), k)
                    return [CandidatePair(int(i_), float(d_)) for i_, d_ in zip(ids, dists)]
            d, i = self._knn_device(query, k, exact=True)
            with span("flat.fetch"):
                d, i = d[0].cpu().numpy(), i[0].cpu().numpy()
            return pairs_from_arrays(d, i, k)

    def knn_with_ef(self, query, k: int, ef: int) -> list[CandidatePair]:
        """Flat search ignores ef."""
        return self.knn(query, k)

    def knn_pq_batch(self, queries, k: int, ef: int, pq):
        """ADC scan + exact rerank (flat_index.rs:84-104): the PQ table's
        scan keeps max(ef, k) candidates (K7, or K8 / K9 on small sets and
        n_bits = 8), K2 reranks them exactly.  Returns ((B, k) f32, (B, k)
        int32) numpy, -1 padded.  Spans: `flat.knn_pq_batch`, inside it
        `flat.upload`, `pq.lookup`, `pq.adc` (`pq.k7` or `pq.dense`),
        `flat.k2`, `flat.fetch`."""
        with span("flat.knn_pq_batch"):
            d, i = self._knn_pq_device(queries, k, ef, pq)
            with span("flat.fetch"):
                return d.cpu().numpy(), i.cpu().numpy()

    def _knn_pq_device(self, queries, k: int, ef: int, pq):
        pq.warn_if_unreliable("FlatIndex.knn_pq (ADC candidate ordering)")
        q = self._queries(queries)
        k_out = max(ef, k)
        lookup, q_norms, lut = pq.scan_lookup(q, k_out)
        _, cand = pq.adc_scan(lookup, q_norms, k_out, lut=lut)
        with span("flat.k2"):
            return G.rerank_topk(q, self.store.device_rerank(), cand, k, self.dist)

    def knn_pq(self, query, k: int, ef: int, pq) -> list[CandidatePair]:
        d, i = self.knn_pq_batch(query, k, ef, pq)
        return pairs_from_arrays(d[0], i[0], k)

    # ---- serde (the JAX package's checkpoint format) ----
    def state(self, include_vectors: bool = True) -> tuple[dict, dict]:
        arrays = self.store.state_arrays(include_vectors)
        meta = {"algorithm": "Flat", "dim": self.dim, "dist": self.dist, "n": len(self.store)}
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, external_vectors: np.ndarray | None = None,
                   device="cuda"):
        vecs = arrays.get("vectors", external_vectors)
        if vecs is None:
            raise ValueError("FlatIndex state has no vectors and none were provided")
        return cls.from_numpy(np.asarray(vecs), meta["dist"], device=device)

    def save(self, path, include_vectors: bool = True) -> None:
        arrays, meta = self.state(include_vectors)
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, external_vectors: np.ndarray | None = None, device="cuda") -> "FlatIndex":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, external_vectors, device=device)
