// K1: packed int8 chunk-min scan for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_scan.py:scan_chunkmin_int8_packed
// (Pallas bodies _scan_kernel_int8_packed and _scan_kernel_int8_packed_bc,
// which differ only in the TPU channel layout).
//
// What it computes, for int8 queries q8 (B, D), query channels qs2/qc (B,),
// the permuted int8 mirror base (N, D) and its channels scale/cache (N,):
//
//   dot[x, b]  = sum_k base[x, k] * q8[b, k]                 (exact int32)
//   d[x, b]    = (cache[x] + qc[b]) - float(dot) * (scale[x] * qs2[b])
//   packed     = (bits(d) & ~127) | level(x)
//   out[c*16 + s, b] = int32 min over level = 0..127 of packed at row
//                      x = c*2048 + level*16 + s
//
// so out is (N/128, B) int32, the reference's survivor layout exactly: one
// survivor per strided 128-row group, its level in the low 7 bits.  The
// (N, B) distance matrix never reaches device memory.
//
// What bounds it on the H100: the int8 products.  At N = 1M, B = 1000,
// D = 1024 that is 2.0e12 int8 operations against only ~1 GB of mirror
// reads, far above the card's ops-per-byte balance point, so the kernel is
// built around tensor-core `mma.sync` s8 x s8 -> s32 (m16n8k32) tiles.  Each
// CTA owns one 2048-row chunk and 128 queries, walks the chunk in 128-row
// sub-tiles with a two-stage cp.async pipeline (64-byte k slices in padded,
// bank-conflict-free shared memory), and folds every sub-tile's distances
// into per-thread running minima in registers.  The chunk loop inside the
// CTA takes the place of the TPU's sequential grid, so no survivor state
// leaves the CTA until the final 16 x 128 write.  The 8 query tiles of one
// chunk are adjacent in launch order, so a chunk is read from HBM about once
// and served to the others from L2.  wgmma/TMA are later work.
//
// The epilogue uses __fadd_rn/__fmul_rn/__fsub_rn in the reference's order
// so nvcc cannot contract it into an FMA: the result matches the plain
// PyTorch version (scan_chunkmin_int8_packed_ref) bit for bit.  float(dot)
// is exact because |dot| <= 1024 * 127^2 < 2^24.
//
// Requirements, checked by the Python wrapper: N % 2048 == 0 (the wrapper
// pads with +BIG sentinels), D % 64 == 0, contiguous tensors, N/2048 <= 65535.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace vecdb::i8;

constexpr int CHUNK_ROWS = 2048;  // NB = CB of the reference (_tiles_for)
constexpr int SLOTS = 16;         // SB = CB / 128 survivors per chunk
constexpr int SUBTILES = CHUNK_ROWS / BM;

__global__ void __launch_bounds__(THREADS)
scan_int8_packed_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs2,
                        const float* __restrict__ qc, const int8_t* __restrict__ base,
                        const float* __restrict__ scale, const float* __restrict__ cache,
                        int32_t* __restrict__ out, int B, int D) {
  __shared__ __align__(16) int8_t smA[2][BM * LDS];
  __shared__ __align__(16) int8_t smB[2][BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int n0 = blockIdx.x * BN;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * CHUNK_ROWS;
  const int KT = D / BK;
  const int steps = SUBTILES * KT;

  // this thread's 8 query columns: n = n0 + warp_n*32 + nt*8 + t*2 + j
  float q_s[4][2], q_c[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + j;
      q_s[nt][j] = n < B ? qs2[n] : 0.f;
      q_c[nt][j] = n < B ? qc[n] : 0.f;
    }

  // running packed minima: [slot g / slot g+8][nt][j]
  int32_t mins[2][4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mins[h][nt][0] = mins[h][nt][1] = 0x7fffffff;

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  auto load_stage = [&](int stage, int step) {
    const int sub = step / KT, kt = step - (step / KT) * KT;
    const int8_t* a_src = base + (row0 + static_cast<size_t>(sub) * BM) * D + kt * BK;
    const int8_t* b_src = q8 + kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 64 bytes = 512 16-byte pieces per operand
      const int id = tid + i * THREADS;
      const int r = id >> 2, c = (id & 3) * 16;
      cp_async16(&smA[stage][r * LDS + c], a_src + static_cast<size_t>(r) * D + c, 16);
      const bool ok = n0 + r < B;  // rows past B are zero-filled
      cp_async16(&smB[stage][r * LDS + c], ok ? b_src + static_cast<size_t>(n0 + r) * D + c : q8,
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
    const int8_t* A = smA[s & 1];
    const int8_t* Bq = smB[s & 1];
    mma_step(A, Bq, acc, warp_m, warp_n, g, t);
    __syncthreads();  // stage s&1 is refilled by the next iteration's prefetch

    if (s % KT == KT - 1) {
      // epilogue of sub-tile `sub`: rows sub*128 + warp_m*64 + mt*16 + {g, g+8}
      // of the chunk, i.e. level sub*8 + warp_m*4 + mt, slots g and g+8
      const int sub = s / KT;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int level = sub * 8 + warp_m * 4 + mt;
        const size_t r_lo = row0 + sub * BM + warp_m * 64 + mt * 16 + g;
        const float sc[2] = {scale[r_lo], scale[r_lo + 8]};
        const float ca[2] = {cache[r_lo], cache[r_lo + 8]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float d = epilogue(acc[mt][nt][2 * h + j], ca[h], q_c[nt][j], sc[h], q_s[nt][j]);
              const int32_t m = (__float_as_int(d) & ~127) | level;
              mins[h][nt][j] = min(mins[h][nt][j], m);
              acc[mt][nt][2 * h + j] = 0;
            }
      }
    }
  }

  // combine the two row-warps that hold the same (slot, query) minima, then
  // write the chunk's 16 x 128 survivors with coalesced stores
  int32_t* red = reinterpret_cast<int32_t*>(&smA[0][0]);  // SLOTS x BN int32
  if (warp_m == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          red[(g + 8 * h) * BN + warp_n * 32 + nt * 8 + t * 2 + j] = mins[h][nt][j];
  }
  __syncthreads();
  if (warp_m == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = (g + 8 * h) * BN + warp_n * 32 + nt * 8 + t * 2 + j;
          red[i] = min(red[i], mins[h][nt][j]);
        }
  }
  __syncthreads();
  for (int i = tid; i < SLOTS * BN; i += THREADS) {
    const int slot = i / BN, n = n0 + i % BN;
    if (n < B) out[(static_cast<size_t>(blockIdx.y) * SLOTS + slot) * B + n] = red[i];
  }
}

}  // namespace

extern "C" int vecdb_scan_int8_packed(const void* q8, const void* qs2, const void* qc,
                                      const void* base, const void* scale, const void* cache,
                                      void* out, int B, int N, int D, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  dim3 grid((B + BN - 1) / BN, N / CHUNK_ROWS);
  scan_int8_packed_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qs2),
      static_cast<const float*>(qc), static_cast<const int8_t*>(base),
      static_cast<const float*>(scale), static_cast<const float*>(cache),
      static_cast<int32_t*>(out), B, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vecdb_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
