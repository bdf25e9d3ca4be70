"""PQ table: trained codebooks + encoded vector set, the ADC sidecar of an
index (port of models/pq_table.py).

Parity target: `PQTable` (reference: src/distance/pq_table.rs:110-238).  Like
the reference's, the table lives beside an index and accelerates its
distance function (metadata_vec_table.rs:17); it is not an index itself.

- Training: one batched k-means over the m subspaces (`ops/pq.py`), on a
  host array or on a device tensor restricted to its first `n_valid` rows
  without slicing the capacity padding away (no second copy of the rows).
  The sample is drawn as the reference draws it (`np.random.default_rng`);
  k-means takes a `torch.Generator` seeded with the same seed, so the
  codebooks differ from the JAX package's (jax.random draws other numbers).
- `rotate`: the reference's seeded orthogonal QR rotation (and the l2sqr
  training-mean center), computed here with the same numpy calls.
- Encode in row blocks, then the build-time ordering self-test (overlap@10
  of the f32 ADC scan against the exact scan on the training sample).
- Device views: 4-bit codes stay nibble-packed; the scan view permutes the
  rows with `np.random.default_rng(0xC0DE5)`, the reference's permutation.
- `adc_scan` takes the reference's accelerator plan on every device: K7
  (`ops/adc.py:adc_scan_chunkmin`) when k <= 16 and there are at least
  4 * k_out chunks of 32 rows (`takes_k7`), else the dense sums (K8 / K9,
  `adc_scan_pallas`).  The wrappers pick the kernel or its plain version by
  the tensor's device.  `scan_lookup` builds its operands (span
  `pq.lookup`: the lookup and, for K7, the int8 LUT); `adc_scan` is the span
  `pq.adc`, with one route span inside, `pq.k7` or `pq.dense`, whose count
  is the route's counter.
- `table_config`: the table's defaults and checks (the DB layer's
  `build_pq_table`, metadata_vec_table.rs), in one place.
- Checkpoints: the JAX package's npz keys and meta, so a table saved by
  either package loads in the other.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..ops import adc as A
from ..ops import distance as D
from ..ops import pq as P
from ..ops import topk as T
from ..utils import serde
from ..utils.config import PQConfig
from ..utils.device import resolve
from ..utils.profiling import span

# elements of the (m, rows, k) distance transient of one encode block
_ENCODE_ELEMS = 1 << 26
_SCAN_SEED = 0xC0DE5  # the scan view's permutation seed (the reference's)


def table_config(n_rows: int, dim: int, dist: str, train_proportion=None, n_bits=None,
                 m=None) -> PQConfig:
    """The PQ table a table of `n_rows` x `dim` rows trains, with the
    reference's defaults and checks (metadata_vec_table.rs): train_proportion
    0.1, n_bits 4, m = ceil(dim / 3), 20 k-means iterations, tol 1e-6.
    Raises RuntimeError as the reference does."""
    if n_rows == 0:
        raise RuntimeError("Cannot build PQ table for an empty table")
    proportion = 0.1 if train_proportion is None else train_proportion
    if not 0.0 < proportion < 1.0:
        raise RuntimeError("Train proportion must be in (0, 1)")
    n_bits = 4 if n_bits is None else n_bits
    if n_bits not in (4, 8):
        raise RuntimeError("n_bits must be 4 or 8")
    m = -(-dim // 3) if m is None else m
    if not 1 <= m <= dim:
        raise RuntimeError("m must be in 1..=dim")
    return PQConfig(n_bits=n_bits, m=m, dist=dist, k_means_size=max(int(n_rows * proportion), 1),
                    k_means_max_iter=20, k_means_tol=1e-6)


class PQTable:
    def __init__(self, config: PQConfig, dim: int, codebooks: np.ndarray, codes: np.ndarray,
                 rotation: np.ndarray | None = None, center: np.ndarray | None = None,
                 adc_quality: float | None = None, device="cuda"):
        self.config = config
        self.dim = int(dim)
        self.k = 1 << config.n_bits
        self.codebooks = np.asarray(codebooks, dtype=np.float32)  # (m, k, dsub_max)
        self.codes = np.asarray(codes, dtype=np.uint8)  # (N, m), unpacked
        self.rotation = None if rotation is None else np.asarray(rotation, np.float32)
        self.center = None if center is None else np.asarray(center, np.float32)
        self.adc_quality = adc_quality
        self.torch_device = resolve(device)
        idx, mask, self.dsub_max = P.group_gather_indices(dim, config.m)
        self._gidx = torch.from_numpy(idx).to(self.torch_device)
        self._gmask = torch.from_numpy(mask).to(self.torch_device)
        self._dev: dict[str, torch.Tensor] = {}  # device caches, counted by device_bytes

    # ---- distance-preserving input transform (config.rotate) ----
    @staticmethod
    def _make_rotation(dim: int, seed: int) -> np.ndarray:
        """Seeded random orthogonal matrix (QR of a Gaussian), f32."""
        rng = np.random.default_rng(seed ^ 0x5EED_07A7)
        q, r = np.linalg.qr(rng.standard_normal((dim, dim)))
        q *= np.sign(np.diagonal(r))  # a deterministic sign convention
        return q.astype(np.float32)

    def _transform(self, x: torch.Tensor) -> torch.Tensor:
        """The training-space transform: center (l2sqr) then rotate.  Both
        preserve the distances, so ADC distances in the transformed space
        are original-space distances."""
        x = x.float()
        if self.rotation is None:
            return x
        if "rotation" not in self._dev:
            self._dev["rotation"] = torch.tensor(self.rotation, device=self.torch_device)
            if self.center is not None:
                self._dev["center"] = torch.tensor(self.center, device=self.torch_device)
        if "center" in self._dev:
            x = x - self._dev["center"]
        return x @ self._dev["rotation"]

    # ---- training (pq_table.rs:141-191) ----
    @classmethod
    def train(cls, vectors, config: PQConfig, seed: int = 0, n_valid: int | None = None,
              device=None) -> "PQTable":
        """Train on a host array or a device tensor (then on its device; a
        host array goes to `device`, "cuda" unless given).  `n_valid`
        restricts sampling and encoding to the first n_valid rows."""
        if config.n_bits not in (4, 8):
            raise ValueError("n_bits must be 4 or 8")
        on_device = isinstance(vectors, torch.Tensor)
        dev = resolve(vectors.device if on_device and device is None else device or "cuda")
        n, dim = vectors.shape
        if n_valid is not None:
            if not 0 < n_valid <= n:
                raise ValueError(f"n_valid {n_valid} out of range (0, {n}]")
            n = n_valid
        if not 1 <= config.m <= dim:
            raise ValueError("m must be in 1..=dim")
        k = 1 << config.n_bits
        rng = np.random.default_rng(seed)
        if config.k_means_size is not None and config.k_means_size < n:
            # random_sample without replacement (vec_set.rs:154-163); the
            # device path gathers the sorted sample, as the reference does
            sel = rng.choice(n, size=config.k_means_size, replace=False)
            train = (vectors[torch.from_numpy(np.sort(sel)).to(vectors.device)] if on_device
                     else vectors[sel])
        else:
            train = vectors[:n]
        train = (train.to(dev) if on_device
                 else torch.from_numpy(np.ascontiguousarray(train, dtype=np.float32)).to(dev)).float()

        rotation = center = None
        if config.rotate:
            rotation = cls._make_rotation(dim, seed)
            if config.dist == "l2sqr":  # centering is l2-transparent, not cosine-transparent
                center_t = train.mean(0)
                center = center_t.cpu().numpy()
                train = train - center_t
            train = train @ torch.from_numpy(rotation).to(dev)

        table = cls(config, dim, np.zeros((config.m, k, 1), np.float32),
                    np.empty((0, config.m), np.uint8), rotation=rotation, center=center, device=dev)
        grouped = P.regroup(train, table._gidx, table._gmask)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cb = P.train_codebooks(grouped, grouped.shape[1], k, config.k_means_max_iter,
                               config.k_means_tol, config.dist, gen)
        table.codebooks = cb.cpu().numpy()

        # encode the whole set in row blocks; only the uint8 codes come back
        rows = max(256, _ENCODE_ELEMS // (config.m * k))
        codes = torch.empty((n, config.m), dtype=torch.uint8, device=dev)
        for s in range(0, n, rows):
            blk = vectors[s : min(s + rows, n)]
            blk = blk.to(dev) if on_device else torch.from_numpy(
                np.ascontiguousarray(blk, dtype=np.float32)).to(dev)
            codes[s : s + blk.shape[0]] = P.encode(
                P.regroup(table._transform(blk), table._gidx, table._gmask), cb, config.dist)
        table.codes = codes.cpu().numpy()

        # build-time ordering self-test: on data whose
        # neighbor gaps are tiny against the vectors' magnitudes the
        # quantized ordering can collapse silently
        table.adc_quality = table._self_test(train, grouped, cb)
        if table.adc_quality < 0.5:
            warnings.warn(
                f"PQ ADC ordering self-test scored {table.adc_quality:.3f} overlap@10 on the "
                "training sample; quantized ordering is unreliable on this data (try "
                "rotate=True, more bits, or an exact-reranked route)", stacklevel=2)
        return table

    def _self_test(self, train_t, grouped, cb, n_q: int = 256, n_base: int = 8192,
                   k: int = 10) -> float:
        """Overlap@k of the f32 ADC ordering against the exact ordering on
        the (transformed) training sample, in [0, 1]."""
        dist = self.config.dist
        s = min(train_t.shape[0], n_base)
        base_t = train_t[:s]
        q_t = base_t[:: max(1, s // n_q)][:n_q]
        codes_s = P.encode(grouped[:, :s], cb, dist)
        lookup = P.build_lookup(P.regroup(q_t, self._gidx, self._gmask), cb, dist)
        q_norms = (q_t * q_t).sum(-1).sqrt() if dist == "cosine" else torch.zeros(
            q_t.shape[0], device=q_t.device)
        kk = min(k, s)
        _, adc_ids = P.adc_scan(lookup, codes_s, s, P.centroid_sqnorm_cache(cb), q_norms, kk, dist)
        _, ex_ids = T.knn_scan(q_t, base_t, D.dist_cache(base_t, dist), s, kk, dist)
        a, e = adc_ids.cpu().numpy(), ex_ids.cpu().numpy()
        return float(np.mean([len(set(a[i]) & set(e[i])) / kk for i in range(a.shape[0])]))

    def __len__(self) -> int:
        return self.codes.shape[0]

    def device_bytes(self) -> int:
        """Device-memory footprint of the sidecar: codes (packed for 4-bit),
        the permuted scan codes and their permutation, codebooks, caches,
        rotation."""
        return sum(t.numel() * t.element_size() for t in self._dev.values())

    def warn_if_unreliable(self, context: str, threshold: float = 0.5) -> bool:
        """Warn (and return True) when the build-time self-test said the
        quantized ordering collapsed on this table's data."""
        if self.adc_quality is not None and self.adc_quality < threshold:
            warnings.warn(
                f"{context}: PQ ADC self-test overlap@10 = {self.adc_quality:.3f} (< {threshold}); "
                "quantized ordering is unreliable on this data; results may have very low "
                "recall.  Retrain with rotate=True / n_bits=8, or use an exact-reranked route.",
                stacklevel=3)
            return True
        return False

    @property
    def packed(self) -> bool:
        """4-bit tables keep their device codes nibble-packed (two codes per
        byte, the reference's in-memory layout, pq_table.rs:66-91)."""
        return self.config.n_bits == 4

    # ---- device views ----
    def device(self):
        """(codes (N, cw) uint8, codebooks (m, k, dsub), cb_sqnorm (m, k))."""
        if "codes" not in self._dev:
            host = P.pack_codes_4bit(self.codes) if self.packed else self.codes
            self._dev["codes"] = torch.from_numpy(np.ascontiguousarray(host)).to(self.torch_device)
            cb = torch.tensor(self.codebooks, device=self.torch_device)
            self._dev["codebooks"] = cb
            self._dev["cb_sqnorm"] = P.centroid_sqnorm_cache(cb)
        return self._dev["codes"], self._dev["codebooks"], self._dev["cb_sqnorm"]

    def unpack_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Gathered device code rows -> (..., m) codes."""
        return P.unpack_codes_4bit_dev(rows, self.config.m) if self.packed else rows

    def device_scan(self):
        """(permuted scan codes (N, cw) with cw padded to a multiple of 4
        bytes, perm (N,) int32): position p holds row perm[p].  The chunk-min
        keeps one survivor per 32 consecutive positions, so the rows are
        stored under a fixed seeded permutation to de-cluster their order
        (the int8 mirror's discipline).  Built at the first scan."""
        if "codes_scan" not in self._dev:
            codes, _, _ = self.device()
            n = codes.shape[0]
            perm = np.random.default_rng(_SCAN_SEED).permutation(n).astype(np.int32)
            perm_t = torch.from_numpy(perm).to(self.torch_device)
            scan = codes[perm_t.long()]
            if scan.shape[1] % 4:
                scan = torch.nn.functional.pad(scan, (0, 4 - scan.shape[1] % 4))
            self._dev["codes_scan"], self._dev["perm"] = scan.contiguous(), perm_t
        return self._dev["codes_scan"], self._dev["perm"]

    def create_lookup(self, queries: torch.Tensor):
        """(B, dim) queries -> ((B, m, k) lookup, (B,) query norms; zeros
        for l2sqr) (pq_table.rs:195-224).  Rotated tables move the query
        into the training space first."""
        _, cb, _ = self.device()
        q = self._transform(queries.to(self.torch_device))
        lookup = P.build_lookup(P.regroup(q, self._gidx, self._gmask), cb, self.config.dist)
        if self.config.dist == "cosine":
            return lookup, (q * q).sum(-1).sqrt()
        return lookup, torch.zeros(q.shape[0], device=q.device)

    def takes_k7(self, k_out: int) -> bool:
        """Whether `adc_scan` at `k_out` takes K7: k <= 16 and at least
        4 * k_out chunks of 32 rows."""
        return self.k <= 16 and -(-len(self) // A.CHUNK) >= 4 * k_out

    def scan_lookup(self, queries: torch.Tensor, k_out: int):
        """`adc_scan`'s operands for (B, dim) queries at `k_out` -> (lookup,
        q_norms, lut): `create_lookup`'s, and where `adc_scan` takes K7, its
        int8 LUT operands (`ops/adc.py:chunkmin_inputs`), else None."""
        with span("pq.lookup"):
            lookup, q_norms = self.create_lookup(queries)
            if not self.takes_k7(k_out):
                return lookup, q_norms, None
            codes_s, _ = self.device_scan()
            _, _, cb_sq = self.device()
            return lookup, q_norms, A.chunkmin_inputs(lookup, cb_sq, self.config.dist, self.packed,
                                                      codes_s.shape[1])

    def adc_scan(self, lookup, q_norms, k_out: int, lut=None):
        """Full ADC scan over the encoded set -> ((B, k_out) ADC dists,
        (B, k_out) int32 ids), the reference's accelerator plan
        (pq_table.rs scan; pallas_adc.py): K7 where `takes_k7`, with `lut`
        (`scan_lookup`'s) if given, else the dense K8 / K9 sums."""
        with span("pq.adc"):
            codes, _, cb_sq = self.device()
            n = len(self)
            if self.takes_k7(k_out):
                with span("pq.k7"):
                    codes_s, perm = self.device_scan()
                    return A.adc_scan_chunkmin(lookup, codes_s, perm, n, cb_sq, q_norms, k_out,
                                               self.config.dist, packed=self.packed, lut=lut)
            with span("pq.dense"):
                return A.adc_scan_pallas(lookup, codes, n, cb_sq, q_norms, k_out, self.config.dist,
                                         packed=self.packed)

    def adc_for_ids(self, lookup, q_norms, ids: torch.Tensor) -> torch.Tensor:
        """f32 ADC distances of (B, C) candidate ids (+inf where -1)."""
        codes, _, cb_sq = self.device()
        c = self.unpack_rows(codes[ids.clamp_min(0).long()])
        d = P.adc_lookup_codes(c, lookup, cb_sq, self.config.dist, q_norms)
        return torch.where(ids >= 0, d, float("inf"))

    # ---- serde (pq_table.rs:226-238; the JAX package's npz keys) ----
    def state(self) -> tuple[dict[str, np.ndarray], dict]:
        stored = P.pack_codes_4bit(self.codes) if self.config.n_bits == 4 else self.codes
        arrays = {"pq_codebooks": self.codebooks, "pq_codes": stored}
        if self.rotation is not None:
            arrays["pq_rotation"] = self.rotation
        if self.center is not None:
            arrays["pq_center"] = self.center
        c = self.config
        meta = {"pq": {"n_bits": c.n_bits, "m": c.m, "dist": c.dist, "k_means_size": c.k_means_size,
                       "k_means_max_iter": c.k_means_max_iter, "k_means_tol": c.k_means_tol,
                       "dim": self.dim, "rotate": c.rotate, "adc_quality": self.adc_quality}}
        return arrays, meta

    @classmethod
    def from_state(cls, arrays: dict, meta: dict, device="cuda") -> "PQTable":
        m = meta["pq"]
        config = PQConfig(n_bits=m["n_bits"], m=m["m"], dist=m["dist"],
                          k_means_size=m["k_means_size"], k_means_max_iter=m["k_means_max_iter"],
                          k_means_tol=m["k_means_tol"], rotate=bool(m.get("rotate", False)))
        codes = arrays["pq_codes"]
        if config.n_bits == 4:
            codes = P.unpack_codes_4bit(codes, config.m)
        return cls(config, m["dim"], arrays["pq_codebooks"], codes,
                   rotation=arrays.get("pq_rotation"), center=arrays.get("pq_center"),
                   adc_quality=m.get("adc_quality"), device=device)

    def save(self, path) -> None:
        arrays, meta = self.state()
        serde.save_arrays(path, arrays, meta)

    @classmethod
    def load(cls, path, device="cuda") -> "PQTable":
        arrays, meta = serde.load_arrays(path)
        return cls.from_state(arrays, meta, device=device)
