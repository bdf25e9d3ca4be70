// K12: bf16 q-resident scan with a 128-row chunk-min, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_scan.py:scan_chunkmin (Pallas
// body _scan_kernel).
//
// What it computes, for bf16 queries q (B, D), their f32 cache qc (B,), the
// bf16 base rows (N, D) with their f32 cache (N,) and a row bound n_valid:
//
//   dot[b, x] = sum_k q[b, k] * base[x, k]            (f32 accumulation)
//   l2sqr:  d = (qc[b] + cache[x]) - 2 * dot           (cache |x|^2, qc |q|^2)
//   cosine: d = 1 - dot / max(qc[b] * cache[x], 1e-10) (cache |x|,   qc |q|)
//   d = +inf for x >= n_valid
//   out_d[b, c] = min over x in [128 c, 128 c + 128) of d[b, x]
//   out_i[b, c] = the lowest such x that attains it
//
// so the outputs are (B, N/128) f32 and int32 global row ids, the
// reference's layout; a chunk wholly past n_valid gives (+inf, its first
// row).  The (B, N) distance matrix never reaches device memory.
//
// What bounds it on the H100: the bf16 products.  At N = 1M, B = 1000,
// D = 960 that is 1.92e12 operations (1.94 ms at the card's dense bf16
// rate) against 1.9 GB of rows (0.58 ms).  Design: int8_mma.cuh's tile and two-stage
// cp.async pipeline (csrc/int8_mma.cuh): one CTA owns 1024 rows (the
// reference's grid step) and 128 queries, walks them in 128-row sub-tiles of
// mma.sync m16n8k16 bf16 -> f32 products (a 64-byte stage is 32 bf16
// lanes, two k16 mmas), and reduces each finished sub-tile to its chunk's
// survivor in registers, lane shuffles and one 1 KB exchange between the two
// row-warps (chunk_min_128).  The query tiles of one row block are adjacent in launch
// order, so the rows are read from HBM about once.  wgmma / TMA are later
// work.
//
// Accuracy.  The tensor cores add into an f32 accumulator with truncation,
// so one accumulator carried through all 60 k16 mmas of a 960-lane row
// drifts low by tens of ulps (on an H100: cosine survivors up to 4.6e-5
// relative off).  So each 64-byte stage (two mmas, 32 products) sums into
// a zeroed partial, and the partials are added to the running sum with
// Kahan compensation in round-to-nearest f32 (mma_stage_split): the dot is
// then within a few ulps of exact, as the l2sqr distances need, since
// d = |q|^2 + |x|^2 - 2 dot cancels (uncompensated partials left 5,722 of
// 7.8M survivors at 1M x 960 up to 2.2e-5 off; the compensation costs
// 1.75x in time).  The plain version (scan_chunkmin_ref) sums the exact
// products in float64 and rounds once; distances agree to rtol 1e-5 /
// atol 1e-6, ids except where two rows of a chunk lie within that of each
// other.  The epilogue rounds each operation on its own (__fdiv_rn, not
// the fast division).
//
// Requirements, checked by the Python wrapper: N % 1024 == 0, D * 2 % 64 ==
// 0 (the wrapper zero-pads the columns), contiguous tensors, N / 1024 <=
// 65535.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace vecdb::i8;

constexpr int ROWS = 1024;  // _NB: rows per CTA
constexpr int SUBTILES = ROWS / BM;

// acc += A (128 x 32 bf16, row stride LDS bytes) x Bq (128 x 32 bf16)^T for
// this warp's 64 x 32 share of the tile: per 16-row tile mt, the stage's two
// k16 mmas sum into a zeroed partial, which is added to acc with Kahan
// compensation (comp holds the negated low part lost so far; acc - comp is
// the sum).
__device__ __forceinline__ void mma_stage_split(const int8_t* A, const int8_t* Bq, float (&acc)[4][4][4],
                                                float (&comp)[4][4][4], int warp_m, int warp_n, int g, int t) {
  unsigned bf[2][4][2];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = warp_n * 32 + nt * 8 + g;
      bf[kk][nt][0] = *reinterpret_cast<const unsigned*>(&Bq[n * LDS + kk * 32 + t * 4]);
      bf[kk][nt][1] = *reinterpret_cast<const unsigned*>(&Bq[n * LDS + kk * 32 + 16 + t * 4]);
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    float part[4][4] = {};
    const int r = warp_m * 64 + mt * 16 + g;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned af[4];
      af[0] = *reinterpret_cast<const unsigned*>(&A[r * LDS + kk * 32 + t * 4]);
      af[1] = *reinterpret_cast<const unsigned*>(&A[(r + 8) * LDS + kk * 32 + t * 4]);
      af[2] = *reinterpret_cast<const unsigned*>(&A[r * LDS + kk * 32 + 16 + t * 4]);
      af[3] = *reinterpret_cast<const unsigned*>(&A[(r + 8) * LDS + kk * 32 + 16 + t * 4]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(part[nt], af, bf[kk][nt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float y = __fsub_rn(part[nt][i], comp[mt][nt][i]);
        const float sum = __fadd_rn(acc[mt][nt][i], y);
        comp[mt][nt][i] = __fsub_rn(__fsub_rn(sum, acc[mt][nt][i]), y);
        acc[mt][nt][i] = sum;
      }
  }
}

template <bool COSINE>
__global__ void __launch_bounds__(THREADS)
scan_bf16_chunkmin_kernel(const int8_t* __restrict__ q, const float* __restrict__ qc,
                          const int8_t* __restrict__ base, const float* __restrict__ cache,
                          float* __restrict__ out_d, int32_t* __restrict__ out_i, int B,
                          int row_bytes, int n_valid, int S) {
  __shared__ __align__(16) int8_t smA[2][BM * LDS];
  __shared__ __align__(16) int8_t smB[2][BN * LDS];
  __shared__ float red_d[BN];
  __shared__ int red_i[BN];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int n0 = blockIdx.x * BN;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * ROWS;
  const int KT = row_bytes / BK;
  const int steps = SUBTILES * KT;

  // this thread's 8 query columns: n = n0 + warp_n*32 + nt*8 + t*2 + j
  float q_c[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + j;
      q_c[nt][j] = n < B ? qc[n] : 0.f;
    }

  float acc[4][4][4], comp[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = comp[mt][nt][i] = 0.f;

  auto load_stage = [&](int stage, int step) {
    const int sub = step / KT, kt = step - (step / KT) * KT;
    const int8_t* a_src = base + (row0 + static_cast<size_t>(sub) * BM) * row_bytes + kt * BK;
    const int8_t* b_src = q + kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 64 bytes = 512 16-byte pieces per operand
      const int id = tid + i * THREADS;
      const int r = id >> 2, c = (id & 3) * 16;
      cp_async16(&smA[stage][r * LDS + c], a_src + static_cast<size_t>(r) * row_bytes + c, 16);
      const bool ok = n0 + r < B;  // rows past B are zero-filled
      cp_async16(&smB[stage][r * LDS + c], ok ? b_src + static_cast<size_t>(n0 + r) * row_bytes + c : q,
                 ok ? 16 : 0);
    }
  };

  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_stage((s + 1) & 1, s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_stage_split(smA[s & 1], smB[s & 1], acc, comp, warp_m, warp_n, g, t);
    __syncthreads();  // stage s&1 is refilled by the next iteration's prefetch

    if (s % KT == KT - 1) {
      // epilogue of sub-tile `sub` (one 128-row chunk): rows
      // sub*128 + warp_m*64 + mt*16 + {g, g+8} of the CTA's block
      const int sub = s / KT;
      float best[4][2];
      int brow[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        best[nt][0] = best[nt][1] = CUDART_INF_F;
        brow[nt][0] = brow[nt][1] = 0x7fffffff;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = static_cast<int>(row0) + sub * BM + warp_m * 64 + mt * 16 + g + 8 * h;
          const float ca = cache[row];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float dot = __fsub_rn(acc[mt][nt][2 * h + j], comp[mt][nt][2 * h + j]);
              float d;
              if (COSINE) {
                d = __fsub_rn(1.f, __fdiv_rn(dot, fmaxf(__fmul_rn(q_c[nt][j], ca), 1e-10f)));
              } else {
                d = __fsub_rn(__fadd_rn(q_c[nt][j], ca), __fmul_rn(2.f, dot));
              }
              keep_min(best[nt][j], brow[nt][j], row < n_valid ? d : CUDART_INF_F, row);
              acc[mt][nt][2 * h + j] = comp[mt][nt][2 * h + j] = 0.f;
            }
        }
      if (chunk_min_128(best, brow, red_d, red_i, warp_m, warp_n, g, t)) {
        const int c = blockIdx.y * SUBTILES + sub;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + j;
            if (n < B) {
              out_d[static_cast<size_t>(n) * S + c] = best[nt][j];
              out_i[static_cast<size_t>(n) * S + c] = brow[nt][j];
            }
          }
      }
    }
  }
}

}  // namespace

extern "C" int vecdb_scan_bf16_chunkmin(const void* q, const void* qc, const void* base, const void* cache,
                                        void* out_d, void* out_i, int B, int N, int row_bytes, int n_valid,
                                        int cosine, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  dim3 grid((B + BN - 1) / BN, N / ROWS);
  auto kern = cosine ? scan_bf16_chunkmin_kernel<true> : scan_bf16_chunkmin_kernel<false>;
  kern<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(qc), static_cast<const int8_t*>(base),
      static_cast<const float*>(cache), static_cast<float*>(out_d), static_cast<int32_t*>(out_i), B, row_bytes,
      n_valid, N / 128);
  return static_cast<int>(cudaGetLastError());
}
