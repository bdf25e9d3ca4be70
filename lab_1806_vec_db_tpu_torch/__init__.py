"""lab_1806_vec_db_tpu_torch — the PyTorch/CUDA port of `lab_1806_vec_db_tpu`.

The JAX package is the reference; this package runs the same engine on an
NVIDIA Hopper GPU.  Plain tensor code is PyTorch; every TPU Pallas kernel on
a ported path is a hand-written CUDA kernel under `csrc/`, built with `nvcc`
at first use (`ops/_build.py`).

Ported so far, over float32 tables:
- the batched Flat search path, `VecDB.batch_search` -> `MetadataVecTable`
  -> `DynamicIndex` -> `FlatIndex._knn_device`, with kernels K1
  (`ops/scan.py`, the packed int8 chunk-min scan) and K2 (`ops/gather.py`,
  the exact rerank gather);
- HNSW tables (`models/hnsw.py`): the bulk build, both search routes and
  checkpoints, with kernels K3 (`ops/traverse.py`, the whole level-0 graph
  search) and K4 / K5 (`ops/beam_fused.py`, the fused lock-step beam body);
- PQ tables (`models/pq_table.py`): k-means training, Flat+PQ and HNSW+PQ
  search, with kernels K7 (`ops/adc.py`, the ADC scan with a chunk-min),
  K8 / K9 (`ops/adc.py`, ADC sums for k = 16 / 256) and K6 (`ops/merge.py`,
  the sorted beam merge of the classic lock-step loop);
- IVF (`models/ivf.py`) and the lean store tier, with kernel K10
  (`ops/scan_binned.py`, the binned int8 scan);
- the codes-resident tiers (`models/pq_codes.py:PQCodesIndex`,
  `models/ivfpq.py:IVFPQIndex`), which keep only PQ codes on the device and
  regenerate exact rows from the row source, with kernel K11 (`ops/adc.py`,
  the binned ADC chunk-min) beside K7 and K8;
- the q-resident stage-1 scans (`ops/scan_resident.py`): K12 (bf16 with a
  chunk-min), K13 (int8, the bf16 distance matrix) and K14 (int8 with a
  chunk-min), each behind its candidate function;
- uint8 tables (`models/u8.py`: `U8VecSet`, `FlatIndexU8`; `ops/u8.py`):
  exact integer distances, through `VecDB` too: l2sqr on the card through
  the uint8 stage 1 (`csrc/scan_u8_exact.cu`) and an exact rescan of the
  chosen groups, the rest
  through int8 GEMMs;
- the Flat planner's scan modes (`models/store.py:ScanMode`, "int8" /
  "pca" / "bf16" / "exact" with `pca_dim`, held by the store and set by
  `FlatIndex(..., scan=, pca_dim=)` or `VecDB(dir, scan=, pca_dim=)`; HNSW's
  scan route reads its store's): "pca" runs K1 over the store's
  PCA-projected mirror (`ops/project.py`);
- the native single-query engine (`models/native.py`, its own copy of the
  reference's C++ source in `csrc/hnsw_native.cpp`, built with g++ at first
  use) behind `FlatIndex.knn` and `HNSWIndex.knn_with_ef` on host stores (a
  CUDA store answers one query on the card);
- the tools: `bench/harness.py` (TOML ef sweeps, `ResultList`, `mesh = N`),
  `bench/synth.py`'s CLI, `cli/gen_gnd.py`, `cli/convert_fvecs.py`,
  `utils/io.py` (raw and fvecs files) and `utils/profiling.py` (the
  program's spans at each layer boundary of a search, recorded into a
  `torch.profiler` trace or counted by `collect()`, and `trace(dir)`);
- the sharded indexes (`parallel/`): a `Mesh` is one process and a tuple of
  devices (`make_mesh`); Flat, PQFlat, IVF, HNSW (K4 / K5 on a CUDA shard)
  and IVF-PQ (K11, K7) shard their rows over it and merge the shards' bests
  on the lead device; `VecDB(dir, mesh=...)` serves every search from a
  sharded exact scan; `dryrun_multichip` checks every path on tiny shapes.
"""

import torch

# True f32 products, the counterpart of the JAX package's Precision.HIGHEST
# default (lab_1806_vec_db_tpu/ops/distance.py): the exact scan and the plain
# K1 version rely on exact f32 matrix products.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["VecDB", "calc_dist", "__version__"]


def __getattr__(name):
    # Lazy import: keep `import lab_1806_vec_db_tpu_torch.ops` cheap for
    # kernel-only users while exposing the API at the top level.
    if name in ("VecDB", "calc_dist"):
        from .db import api

        return getattr(api, name)
    raise AttributeError(name)
