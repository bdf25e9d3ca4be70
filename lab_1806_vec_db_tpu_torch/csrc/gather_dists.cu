// K2: row-gather + exact distance for the rerank, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_gather.py:gather_dists_rs
// (Pallas body _gather_dist_kernel_mq) and its wide-r fallback
// gather_dists_rs_1q (_gather_dist_kernel): one kernel covers both.
//
// What it computes, for queries q (B, dim) f32, base rows (n_rows, dim) f32
// or bf16 and candidate ids (B, r) int32:
//
//   out[b, j] = sum_k (base[id, k] - q[b, k])^2                    (l2sqr)
//             = 1 - dot / max(|base[id]| * |q[b]|, 1e-10)           (cosine)
//             = +inf when id < 0 or id >= n_rows
//
// What bounds it on the H100: memory.  Each candidate costs one row read
// (3,840 bytes at dim 960) and ~2 flops per byte, so the kernel is a gather
// at HBM bandwidth.  The TPU needed a (N*SR, 128) row-slab copy so that each
// row was one aligned DMA; here the rows are read in place from the store's
// f32 (cap, dim) tensor: a warp reads one candidate row with coalesced
// 16-byte float4 loads (960 * 4 bytes is a multiple of 16), so no second copy
// of the base exists.  One CTA per query keeps that query's row hot in L1
// for all its candidates; the eight warps of the CTA take candidates in
// turn, and a shuffle reduction finishes each distance.
//
// The per-row distance itself (row_dist, query_norm) lives in beam_body.cuh,
// shared with K3 (traverse.cu), so the two kernels give the same bits.
//
// The lean store tier keeps its rerank rows in bf16 (2 bytes a lane): the
// same kernel reads them in place and upcasts each to f32 before the
// arithmetic, as the reference does (pallas_gather.py:146), halving the
// bytes per candidate.
//
// flags: bit 0 = cosine, bit 1 = vector path allowed (dim % 4 == 0, the
// queries 16-byte and the rows 16-byte (f32) / 8-byte (bf16) aligned; the
// wrapper checks), bit 2 = bf16 rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "beam_body.cuh"

namespace {

constexpr int WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
gather_dists_kernel(const float* __restrict__ q, const T* __restrict__ base,
                    const int32_t* __restrict__ ids, float* __restrict__ out, int r, int dim,
                    long long n_rows, int flags) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool cosine = flags & 1;
  const int dim4 = (flags & 2) ? dim >> 2 : 0;
  const float* qb = q + static_cast<size_t>(b) * dim;
  const float qn = cosine ? vecdb::query_norm(qb, dim, dim4, lane) : 0.f;

  for (int j = warp; j < r; j += WARPS) {
    const int id = ids[static_cast<size_t>(b) * r + j];
    float res = INFINITY;
    if (id >= 0 && id < n_rows)
      res = vecdb::row_dist(base + static_cast<size_t>(id) * dim, qb, dim, dim4, cosine, qn, lane);
    if (lane == 0) out[static_cast<size_t>(b) * r + j] = res;
  }
}

}  // namespace

extern "C" int vecdb_gather_dists(const void* q, const void* base, const void* ids, void* out,
                                  int B, int r, int dim, long long n_rows, int flags,
                                  void* stream) {
  if (B <= 0 || r <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flags & 4) {
    gather_dists_kernel<uint16_t><<<B, WARPS * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const uint16_t*>(base),
        static_cast<const int32_t*>(ids), static_cast<float*>(out), r, dim, n_rows, flags);
  } else {
    gather_dists_kernel<float><<<B, WARPS * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(base),
        static_cast<const int32_t*>(ids), static_cast<float*>(out), r, dim, n_rows, flags);
  }
  return static_cast<int>(cudaGetLastError());
}
