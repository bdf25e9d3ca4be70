// Device code of the mma.sync int8 scan kernels K13 / K14
// (csrc/scan_int8_bf16.cu), for Hopper (sm_90a):
//
//   cp_async16 / cp_async_commit / cp_async_wait   the two-stage cp.async ring
//   mma_s8                                         one m16n8k32 s8 x s8 -> s32 mma
//   mma_step                                       one BK-deep step of a
//                                                  128 x 128 s8 product from
//                                                  shared memory
//   keep_min / chunk_min_128                       the (distance, lowest row)
//                                                  minimum of each query
//                                                  column over a 128-row
//                                                  sub-tile
//
// The kernels score 128 base rows against 128 queries per step with 8 warps
// laid out 2 (rows) x 4 (queries); warp (wm, wn) holds rows wm*64 + mt*16 +
// {g, g+8} and queries wn*32 + nt*8 + 2t + {0, 1} of the tile in
// acc[mt][nt][2h + j] (g = lane / 4, t = lane % 4, h selects the +8 row).
// K1, K10 and K12 have their own wgmma pipelines (csrc/scan_wgmma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vecdb {
namespace i8 {

constexpr int BM = 128;       // base rows per sub-tile
constexpr int BN = 128;       // queries per CTA
constexpr int BK = 64;        // int8 depth per pipeline stage
constexpr int LDS = BK + 16;  // padded smem row stride in bytes (bank-conflict free)
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (queries)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A (128 x BK, row stride LDS) x Bq (128 x BK, row stride LDS)^T for
// this warp's 64 x 32 share of the tile.
__device__ __forceinline__ void mma_step(const int8_t* A, const int8_t* Bq, int (&acc)[4][4][4],
                                         int warp_m, int warp_n, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    unsigned af[4][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = warp_m * 64 + mt * 16 + g;
      af[mt][0] = *reinterpret_cast<const unsigned*>(&A[r * LDS + kk + t * 4]);
      af[mt][1] = *reinterpret_cast<const unsigned*>(&A[(r + 8) * LDS + kk + t * 4]);
      af[mt][2] = *reinterpret_cast<const unsigned*>(&A[r * LDS + kk + 16 + t * 4]);
      af[mt][3] = *reinterpret_cast<const unsigned*>(&A[(r + 8) * LDS + kk + 16 + t * 4]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = warp_n * 32 + nt * 8 + g;
      bf[nt][0] = *reinterpret_cast<const unsigned*>(&Bq[n * LDS + kk + t * 4]);
      bf[nt][1] = *reinterpret_cast<const unsigned*>(&Bq[n * LDS + kk + 16 + t * 4]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
  }
}

// The lexicographic (distance, row) minimum: a tie goes to the lower row,
// as the reference's argmin and its explicit lowest-index min do.
__device__ __forceinline__ void keep_min(float& d, int& r, float od, int orow) {
  if (od < d || (od == d && orow < r)) {
    d = od;
    r = orow;
  }
}

// best[nt][j] / brow[nt][j]: this thread's minimum over its 8 rows of a
// 128-row sub-tile for query column warp_n*32 + nt*8 + 2t + j.  Folds them
// over the 8 lanes that share a column (the g bits of the lane id) and then
// over the two row-warps through red_d / red_i (BN entries each); returns
// true on the lanes (warp_m 0, g 0) that then hold the sub-tile's minimum
// of their 8 columns.  Every thread of the CTA must call it.
__device__ __forceinline__ bool chunk_min_128(float (&best)[4][2], int (&brow)[4][2], float* red_d,
                                              int* red_i, int warp_m, int warp_n, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[nt][j], off);
        const int orow = __shfl_xor_sync(0xffffffffu, brow[nt][j], off);
        keep_min(best[nt][j], brow[nt][j], od, orow);
      }
  if (warp_m == 1 && g == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = warp_n * 32 + nt * 8 + t * 2 + j;
        red_d[c] = best[nt][j];
        red_i[c] = brow[nt][j];
      }
  }
  __syncthreads();
  if (warp_m != 0 || g != 0) return false;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = warp_n * 32 + nt * 8 + t * 2 + j;
      keep_min(best[nt][j], brow[nt][j], red_d[c], red_i[c]);
    }
  return true;
}

}  // namespace i8
}  // namespace vecdb
