"""IVF-PQ index: probed-list ADC search over codes-resident storage (port of
models/ivfpq.py).

Inverted file + product quantization from three pieces of the port:

  - cluster-sorted packed 4-bit codes (the binned IVF's sorted layout,
    `models/ivf.py:_sorted_layout`, lists capped at the 0.95 length
    quantile): each posting list is one contiguous lpad-row segment, the
    tails spill to a shared, shuffled overflow segment;
  - K11 (`ops/adc.py:adc_chunkmin_binned`): each probed list scanned once
    against only the queries binned to it (`ops/binning.py`), at the main
    table's full m, with a chunk-min; the overflow segment through K7 for
    every query, so spilled rows stay findable for any probe set;
  - the exact refine of the ef finalists from the row source
    (`models/pq_codes.py:refine_blocked`).

Survivors stay in slot space until after the top-ef (a slot -> id decode
of the whole (B, p * lpad / chunk) candidate matrix would be a gather per
element); the overflow K7 decodes positions to global slots kl + i.

Layout: the device codes are row-major (slots, cw4) uint8, cw padded to a
multiple of 4 bytes (the kernels read 4-byte words; no padding at m = 320).
The reference keeps them transposed at rest, (cw, slots) int8, because
cw = 160 on the TPU's 128-byte int8 lanes pads to 256 bytes a row; the
H100 has no lane padding, and K11 reads its 512-row tiles whole either way.
`load` takes either layout; `save` writes row-major uint8 with
`codes_transposed` False, which the reference loads and searches.

No counterpart here: the reference's `_ivfpq_search_jit` (one XLA program
against per-call dispatch cost; its own test shows it equals the unfused
path), `_tset_chunk`, `_transpose_split` and the transposed write of
`_encode_cols_jit` (TPU lane-padding work), and `traced_gen` with its
block-keyed refine.  `force_lpad` / `ov_pad_min` of `_layout_encode` and
`ov_valid` serve the sharded tier (`parallel/sharded.py:ShardedIVFPQIndex`),
whose shards share one (lpad, overflow capacity).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import adc as A
from ..ops import binning as BN
from ..ops import kmeans as KM
from ..ops import topk as T
from ..utils import serde
from ..utils.config import IVFConfig, PQConfig
from ..utils.device import resolve
from .ivf import _assign, _build_posting, _fit_centroids, _sorted_layout
from .pq_codes import _cw4, _rows, pack_encode, refine_blocked, sample_rows_from_fill
from .pq_table import PQTable

_BLOCK = 131072
_BLOCKPAD = 512  # overflow segment padded to K7's tile multiple
_LCAP_QUANTILE = 0.95  # an overflow row costs every query, a padded list row only its bin's


def _layout_encode(fill, n: int, pq: PQTable, assign: np.ndarray, nlist: int, seed: int,
                   block_rows: int, row_gen=None, device="cuda", force_lpad: int | None = None,
                   ov_pad_min: int = 0):
    """Cluster-sorted layout + packed-code encode -> (lpad, codes_main
    (nlist * lpad, cw4) uint8, codes_ov (ov_pad, cw4), slot_id (slots,) host
    int32, lens (nlist,) host, ov_count).  `force_lpad` fixes the segment
    length and `ov_pad_min` floors the overflow capacity (the sharded
    tier's common layout).

    With `row_gen` the codes are encoded in slot order (the rows owning
    each chunk of slots regenerated, encoded and written as one contiguous
    span; pad slots carry row 0's codes, masked by lens / ov_count at
    search); else each `fill` block is encoded and scattered to its rows'
    slots (pad slots stay zero).  Both give the same codes on valid slots."""
    dev = resolve(device)
    posting, counts = _build_posting(assign, nlist)
    lpad, perm_pad, ov_h = _sorted_layout(posting, counts, nlist, cap_quantile=_LCAP_QUANTILE,
                                          force_lpad=force_lpad)
    kl = nlist * lpad
    # every query scans the overflow rows with a chunk-min: de-cluster them
    ov_h = np.asarray(ov_h, np.int32)
    np.random.default_rng(seed ^ 0x0F10).shuffle(ov_h)
    ov_pad = max(ov_pad_min, -(-max(len(ov_h), 1) // _BLOCKPAD) * _BLOCKPAD)
    slots_total = kl + ov_pad
    slot_id = np.full(slots_total, -1, np.int32)
    slot_id[:kl] = perm_pad
    slot_id[kl : kl + len(ov_h)] = ov_h
    slot_id[slot_id < 0] = 0  # filler ids keep device gathers in range

    cw = (pq.config.m + 1) // 2
    codes = torch.zeros((slots_total, _cw4(cw)), dtype=torch.uint8, device=dev)
    if row_gen is not None:
        sid = torch.from_numpy(slot_id).to(dev)
        for lo in range(0, slots_total, block_rows):
            hi = min(lo + block_rows, slots_total)
            codes[lo:hi, :cw] = pack_encode(pq, _rows(row_gen(sid[lo:hi]), dev))
    else:
        inv = np.empty(n, np.int32)
        valid = np.flatnonzero(np.concatenate([perm_pad >= 0, np.ones(len(ov_h), bool)]))
        inv[np.concatenate([perm_pad[perm_pad >= 0], ov_h])] = valid
        inv_dev = torch.from_numpy(inv).to(dev)
        for row0 in range(0, n, block_rows):
            rows = min(block_rows, n - row0)
            codes[inv_dev[row0 : row0 + rows].long(), :cw] = pack_encode(pq, _rows(fill(row0, rows), dev))
    return lpad, codes[:kl], codes[kl:], slot_id, np.minimum(counts, lpad), len(ov_h)


class IVFPQIndex:
    """Codes-resident IVF-PQ (see the module docstring)."""

    def __init__(self, pq: PQTable, centroids: np.ndarray, n: int, dim: int, dist: str, lpad: int,
                 lens: np.ndarray, ov_count: int, fill=None, row_gen=None, block_rows: int = _BLOCK,
                 device="cuda"):
        self.pq = pq
        self.centroids = np.asarray(centroids, np.float32)
        self.nlist = self.centroids.shape[0]
        self.n = int(n)
        self.dim = int(dim)
        self.dist = dist
        self.lpad = int(lpad)
        self.lens = np.asarray(lens, np.int32)  # valid rows per list (<= lpad)
        self.ov_count = int(ov_count)
        # valid overflow rows: ov_count unless a shard of the sharded tier
        # plans its overflow scan for the common capacity ov_count
        self.ov_valid = self.ov_count
        self.torch_device = resolve(device)
        self._fill = fill
        self._row_gen = row_gen
        self._block_rows = int(block_rows)
        self._codes: torch.Tensor | None = None  # (nlist * lpad, cw4) uint8, cluster-sorted
        self._codes_ov: torch.Tensor | None = None  # (ov_pad, cw4) uint8
        self._slot_id: torch.Tensor | None = None  # (slots,) int32 slot -> row id
        self._lens_dev: torch.Tensor | None = None
        self._dev_centroids: torch.Tensor | None = None
        # the last search's dropped (query, list) pairs (bin overflow), a
        # device count read only when asked
        self.last_dropped: torch.Tensor | None = None

    # ---- build ----
    @classmethod
    def build_from_fill(cls, fill, n: int, dim: int, dist: str, nlist: int = 1024,
                        pq_config: PQConfig | None = None, sample_rows: int = 25_000, seed: int = 0,
                        block_rows: int = _BLOCK, row_gen=None, device="cuda") -> "IVFPQIndex":
        """Two passes over the row source (its rows moved to `device`): PQ
        training on a strided multi-block sample and the coarse k-means on
        the first min(max(64 nlist, 131072), n) rows (12 Lloyd iterations),
        then pass A assigns every row to its nearest centroid (slots depend
        on the whole posting layout) and pass B encodes into the
        cluster-sorted slots (`_layout_encode`)."""
        if pq_config is None:
            pq_config = PQConfig(n_bits=4, m=320, dist=dist, k_means_size=sample_rows)
        if pq_config.n_bits != 4:
            raise ValueError("the IVF-PQ tier serves 4-bit (packed) tables")
        dev = resolve(device)
        pq = PQTable.train(sample_rows_from_fill(fill, n, sample_rows, block_rows, dev), pq_config,
                           seed=seed)
        # >= 64 rows per centroid: noisy centroids skew the list lengths and
        # inflate the padded lpad
        n_train = min(max(64 * nlist, 131072), n)
        train = _rows(fill(0, n_train), dev)
        centroids = _fit_centroids(train, n_train, IVFConfig(k=nlist, k_means_max_iter=12,
                                                             k_means_tol=1e-4), dist, seed + 2)
        del train
        assign = np.empty(n, np.int32)
        for row0 in range(0, n, block_rows):
            rows = min(block_rows, n - row0)
            assign[row0 : row0 + rows] = _assign(_rows(fill(row0, rows), dev), centroids, dist)
        lpad, codes_main, codes_ov, slot_id, lens, ov_count = _layout_encode(
            fill, n, pq, assign, nlist, seed, block_rows, row_gen=row_gen, device=dev)
        self = cls(pq, centroids.cpu().numpy(), n, dim, dist, lpad, lens, ov_count, fill=fill,
                   row_gen=row_gen, block_rows=block_rows, device=dev)
        self._codes, self._codes_ov = codes_main, codes_ov
        self._slot_id = torch.from_numpy(slot_id).to(dev)
        return self

    def __len__(self) -> int:
        return self.n

    def index_bytes(self) -> int:
        total = self.pq.device_bytes()
        for t in (self._codes, self._codes_ov, self._slot_id, self._lens_dev, self._dev_centroids):
            if t is not None:
                total += t.numel() * t.element_size()
        return total

    def _device(self):
        """(centroids, lens, cb_sqnorm) on the device, made once."""
        if self._dev_centroids is None:
            self._dev_centroids = torch.from_numpy(self.centroids).to(self.torch_device)
            self._lens_dev = torch.from_numpy(self.lens).to(self.torch_device)
        return self._dev_centroids, self._lens_dev, self.pq.device()[2]

    # ---- serde (codes and layout persist, the row source re-attaches) ----
    def save(self, path) -> None:
        cw = (self.pq.config.m + 1) // 2
        arrays = {"codes": np.ascontiguousarray(self._codes[:, :cw].cpu().numpy()),
                  "codes_ov": np.ascontiguousarray(self._codes_ov[:, :cw].cpu().numpy()),
                  "slot_id": self._slot_id.cpu().numpy(), "centroids": self.centroids,
                  "lens": self.lens}
        pq_arrays, pq_meta = self.pq.state()
        arrays.update({"main_" + k: v for k, v in pq_arrays.items()})
        meta = {"kind": "ivfpq", "n": self.n, "dim": self.dim, "dist": self.dist, "lpad": self.lpad,
                "ov_count": self.ov_count, "block_rows": self._block_rows, "main": pq_meta["pq"],
                "codes_transposed": False}
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, fill=None, row_gen=None, device="cuda") -> "IVFPQIndex":
        """Re-attach a saved IVF-PQ tier (either package's checkpoint); pass
        the refine row source back in for exact-f32 results."""
        arrays, meta = serde.load_arrays(path)
        if meta.get("kind") != "ivfpq":
            raise ValueError(f"{path} is not an IVFPQIndex checkpoint")
        dev = resolve(device)
        pq = PQTable.from_state({k[5:]: v for k, v in arrays.items() if k.startswith("main_")},
                                {"pq": meta["main"]}, device=dev)
        self = cls(pq, arrays["centroids"], meta["n"], meta["dim"], meta["dist"], meta["lpad"],
                   arrays["lens"], meta["ov_count"], fill=fill, row_gen=row_gen,
                   block_rows=meta["block_rows"], device=dev)

        def rows(a):
            if meta.get("codes_transposed", False):
                a = a.T  # (cw, slots) int8 at rest in the reference
            a = np.ascontiguousarray(a).view(np.uint8)
            return torch.nn.functional.pad(torch.from_numpy(a), (0, _cw4(a.shape[1]) - a.shape[1])).to(dev)

        self._codes, self._codes_ov = rows(arrays["codes"]), rows(arrays["codes_ov"])
        self._slot_id = torch.from_numpy(np.ascontiguousarray(arrays["slot_id"], np.int32)).to(dev)
        return self

    # ---- search ----
    def _queries(self, queries) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            return torch.atleast_2d(queries).to(self.torch_device, torch.float32)
        return torch.from_numpy(np.atleast_2d(np.asarray(queries, np.float32))).to(self.torch_device)

    def _auto_qb(self, B: int, n_probes: int) -> int:
        """Bin width ~2x the mean per-list load, a multiple of 32 in
        [32, 512], so bin overflow drops are rare."""
        mean = B * n_probes / self.nlist
        return int(min(512, max(32, -(-2 * mean // 32) * 32)))

    def probe_and_bin(self, q: torch.Tensor, n_probes: int, qb: int):
        """Steps 1-2: the n_probes nearest centroids (exact, ties to the lower
        list) and the per-list query bins -> (probe (B, p), bins (nlist, qb),
        slots (B, p))."""
        centroids, _, _ = self._device()
        _, probe = KM.find_n_nearest(q, centroids, n_probes, self.dist)
        bins, slots = BN.bin_queries(probe, self.nlist, qb)
        return probe, bins, slots

    def k11_inputs(self, lookup, q_norms, bins, chunk: int):
        """K11's arguments for one batch: the codes, the LUT quantized as K7
        quantizes it, the lists' lengths and bins."""
        _, lens, cb_sq = self._device()
        cw4 = self._codes.shape[1]
        lut_q, scales, cs_q, cs_scale = A.chunkmin_inputs(lookup, cb_sq, self.dist, True, cw4)
        return (self._codes, lut_q, scales, q_norms.float(), cs_q, cs_scale, lens, bins, self.lpad,
                True, chunk)

    def overflow_chunk(self, k: int) -> tuple[int, int]:
        """(k_ov, chunk) of the overflow scan: k_ov = min(max(k, 32),
        ov_count) survivors; the chunk halves from 32 (down to 1) while the
        ov_count / chunk survivors would be fewer than 8 k_ov."""
        k_ov = min(max(k, 32), max(self.ov_count, 1))
        ch = 32
        while ch > 1 and self.ov_count < ch * 8 * k_ov:
            ch //= 2
        return k_ov, ch

    def search_candidates(self, q, lookup, q_norms, k: int, n_probes: int, ef: int, qb: int,
                          chunk: int):
        """Steps 1-6: probe, bin, K11, the survivor row gather, the overflow
        scan (K7), the top-ef by ADC distance, the slot -> id decode ->
        ((B, ef') ADC distances ascending, (B, ef') int32 ids, -1 where not
        finite)."""
        probe, bins, slots = self.probe_and_bin(q, n_probes, qb)
        outd, outi = A.adc_chunkmin_binned(*self.k11_inputs(lookup, q_norms, bins, chunk))
        return self.select_candidates(lookup, q_norms, k, ef, probe, slots, outd, outi)

    def select_candidates(self, lookup, q_norms, k: int, ef: int, probe, slots, outd, outi):
        """Steps 4-6 on K11's survivors (outd, outi): the survivor row gather,
        the overflow scan (K7), the top-ef, the slot -> id decode."""
        B, n_probes = probe.shape
        qb = outd.shape[1]
        SL = outd.shape[2]
        # query b's survivors of probe j: row (probe, slot) of the (nlist * qb, SL) survivors
        row = torch.where(slots >= 0, probe * qb + slots, 0).long().view(-1)
        d_cand = outd.view(self.nlist * qb, SL)[row].view(B, n_probes, SL)
        slot_cand = outi.view(self.nlist * qb, SL)[row].view(B, n_probes * SL)
        dropped = slots < 0  # bin overflow: this probe contributed nothing
        d_cand = torch.where(dropped[:, :, None], float("inf"), d_cand).view(B, n_probes * SL)
        self.last_dropped = dropped.sum()
        if self.ov_count > 0:
            _, _, cb_sq = self._device()
            kl = self.nlist * self.lpad
            ov_slots = kl + torch.arange(self._codes_ov.shape[0], dtype=torch.int32, device=outd.device)
            k_ov, ch = self.overflow_chunk(k)
            d_ov, s_ov = A.adc_scan_chunkmin(lookup, self._codes_ov, ov_slots, self.ov_valid, cb_sq,
                                             q_norms, k_ov, self.dist, packed=True, chunk=ch)
            d_cand = torch.cat([d_cand, d_ov], 1)
            slot_cand = torch.cat([slot_cand, s_ov], 1)
        # the reference takes approx_min_k(0.95) for wide rows; exact here
        td, ts = T.select_smallest(d_cand, slot_cand, min(ef, d_cand.shape[1]))
        ids = self._slot_id[ts.clamp(0, self._slot_id.shape[0] - 1).long()]
        return td, torch.where(torch.isfinite(td), ids, T.INVALID_ID)

    def refine(self, q: torch.Tensor, ids: torch.Tensor):
        """Step 7: exact f32 distances of the candidate ids from the row
        source (None without one)."""
        return refine_blocked(self._fill, self._block_rows, self.n, self.dim, self.dist, q, ids,
                              row_gen=self._row_gen)

    def knn_batch(self, queries, k: int, n_probes: int = 48, ef: int = 256, qb: int | None = None,
                  chunk: int = 16):
        """(B, dim) queries -> ((B, k) exact-f32 distances ascending, (B, k)
        int32 ids, -1 where missing), on the index's device.  `n_probes`
        follows the reference's ef-as-n_probes convention
        (ivf_index.rs:137-142); `qb` defaults to `_auto_qb`."""
        q = self._queries(queries)
        n_probes = min(n_probes, self.nlist)
        kk = min(k, ef)
        if qb is None:
            qb = self._auto_qb(q.shape[0], n_probes)
        lookup, q_norms = self.pq.create_lookup(q)
        td1, ti1 = self.search_candidates(q, lookup, q_norms, kk, n_probes, ef, qb, chunk)
        d_ex = self.refine(q, ti1)
        # a candidate without an exact row keeps its ADC distance
        d_ex = td1 if d_ex is None else torch.where(torch.isfinite(d_ex), d_ex, td1)
        td, ti = T.topk_smallest(d_ex, ti1, kk)
        return T._pad_k(td, ti, k)
