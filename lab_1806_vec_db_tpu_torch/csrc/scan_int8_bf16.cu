// K13 and K14: the q-resident int8 scans with a bf16 epilogue, for Hopper
// (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_scan.py:scan_dist_int8 (K13,
// Pallas body _dist_kernel_int8) and :scan_chunkmin_int8_t (K14, body
// _scan_kernel_int8_t), which share their dot and epilogue.
//
// What they compute, for row-quantized int8 queries q8 (B, D) with their
// scales qs and raw cache qc (B,), the int8 base rows (N, D) with their
// scales and raw cache (N,) (l2sqr: cache |x|^2, qc |q|^2; cosine: cache
// |x|, qc |q|) and a row bound n_valid, with bf(v) = round-to-nearest-even
// of v to bf16 and every f32 operation rounded once:
//
//   dot = sum_k q8[b, k] * base[x, k]                          (exact int32)
//   p   = bf(bf(dot) * bf(qs[b] * scale[x]))
//   l2sqr:  d = bf(bf(qc[b] + cache[x]) - bf(2 * p))
//   cosine: d = bf(1 - bf(p / bf(max(qc[b] * cache[x], 1e-10))))
//   d = +inf for x >= n_valid
//
//   K13: out (B, N) bf16, out[b, x] = d
//   K14: out_d (N/128, B) f32, out_i (N/128, B) int32: the min of d over
//        x in [128 c, 128 c + 128) and the lowest x that attains it
//
// That rounding order is the one the reference's interpret mode computes on
// the CPU (XLA upcasts each bf16 operation to f32 and rounds its result back
// to bf16, with no excess precision kept between the reference body's
// operations): the plain versions scan_dist_int8_ref / scan_chunkmin_int8_t_ref
// round in the same places, and both kernels equal them bit for bit.
// float(dot) is exact because |dot| <= 127^2 * 1040 < 2^24.
//
// What bounds them on the H100: the int8 products, 1.92e12 operations at
// N = 1M, B = 1000, D = 960 (0.97 ms); K13 also writes its 2.0 GB matrix
// (0.60 ms of bytes).  Design: the mma.sync pipeline of csrc/int8_mma.cuh, one CTA
// per 1024 rows x 128 queries in 128-row sub-tiles.  K13 pairs the rows of
// neighbouring lanes with one shuffle, so each lane stores two adjacent bf16
// of one query row (4-byte stores, 16 contiguous bytes per 4 lanes).  K14
// reduces each sub-tile to its survivors in registers (chunk_min_128) and
// writes one coalesced 128-query row per chunk: the reference's (row, query)
// orientation was a TPU sublane trick; only its output layout is kept.
//
// Requirements, checked by the Python wrapper: N % 1024 == 0, D % 64 == 0
// (the wrapper zero-pads the columns), contiguous tensors, N / 1024 <= 65535.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace vecdb::i8;

constexpr int ROWS = 1024;  // rows per CTA
constexpr int SUBTILES = ROWS / BM;

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// the bf16 epilogue of one (row, query) pair, in the reference's rounding
template <bool COSINE>
__device__ __forceinline__ float epilogue_bf16(int dot, float qs, float qc, float sc, float ca) {
  const float p = bf(__fmul_rn(bf(__int2float_rn(dot)), bf(__fmul_rn(qs, sc))));
  if (COSINE) return bf(__fsub_rn(1.f, bf(__fdiv_rn(p, bf(fmaxf(__fmul_rn(qc, ca), 1e-10f))))));
  return bf(__fsub_rn(bf(__fadd_rn(qc, ca)), bf(__fmul_rn(2.f, p))));
}

template <bool CHUNKMIN, bool COSINE>
__global__ void __launch_bounds__(THREADS)
scan_int8_bf16_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs,
                      const float* __restrict__ qc, const int8_t* __restrict__ base,
                      const float* __restrict__ scale, const float* __restrict__ cache,
                      void* __restrict__ out_d, int32_t* __restrict__ out_i, int B, int N, int D,
                      int n_valid) {
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
  const int KT = D / BK;
  const int steps = SUBTILES * KT;

  // this thread's 8 query columns: n = n0 + warp_n*32 + nt*8 + t*2 + j
  float q_s[4][2], q_c[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + j;
      q_s[nt][j] = n < B ? qs[n] : 0.f;
      q_c[nt][j] = n < B ? qc[n] : 0.f;
    }

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
    mma_step(smA[s & 1], smB[s & 1], acc, warp_m, warp_n, g, t);
    __syncthreads();  // stage s&1 is refilled by the next iteration's prefetch
    if (s % KT != KT - 1) continue;

    // epilogue of sub-tile `sub`: rows sub*128 + warp_m*64 + mt*16 + {g, g+8}
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
        const float sc = scale[row], ca = cache[row];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            d[j] = row < n_valid
                       ? epilogue_bf16<COSINE>(acc[mt][nt][2 * h + j], q_s[nt][j], q_c[nt][j], sc, ca)
                       : CUDART_INF_F;
            acc[mt][nt][2 * h + j] = 0;
            if (CHUNKMIN) keep_min(best[nt][j], brow[nt][j], d[j], row);
          }
          if (!CHUNKMIN) {
            // lanes g and g^1 trade one value: an even g stores rows
            // (row, row + 1) of column j = 0, an odd g rows (row - 1, row)
            // of column j = 1
            const bool even = (g & 1) == 0;
            const float other = __shfl_xor_sync(0xffffffffu, even ? d[1] : d[0], 4);
            const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + (even ? 0 : 1);
            const size_t x = even ? row : row - 1;
            const __nv_bfloat162 pair = even ? __floats2bfloat162_rn(d[0], other) : __floats2bfloat162_rn(other, d[1]);
            if (n < B)
              *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out_d) + static_cast<size_t>(n) * N + x) =
                  pair;
          }
        }
      }
    if (CHUNKMIN && chunk_min_128(best, brow, red_d, red_i, warp_m, warp_n, g, t)) {
      const size_t c = static_cast<size_t>(blockIdx.y) * SUBTILES + sub;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + warp_n * 32 + nt * 8 + t * 2;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (n + j < B) {
            static_cast<float*>(out_d)[c * B + n + j] = best[nt][j];
            out_i[c * B + n + j] = brow[nt][j];
          }
      }
    }
  }
}

template <bool CHUNKMIN>
int launch(const void* q8, const void* qs, const void* qc, const void* base, const void* scale, const void* cache,
           void* out_d, void* out_i, int B, int N, int D, int n_valid, bool cosine, void* stream) {
  dim3 grid((B + BN - 1) / BN, N / ROWS);
  auto kern = cosine ? scan_int8_bf16_kernel<CHUNKMIN, true> : scan_int8_bf16_kernel<CHUNKMIN, false>;
  kern<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qs), static_cast<const float*>(qc),
      static_cast<const int8_t*>(base), static_cast<const float*>(scale), static_cast<const float*>(cache), out_d,
      static_cast<int32_t*>(out_i), B, N, D, n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flags: bit 0 cosine, bit 1 K14 (chunk-min into out_d f32 / out_i);
// without it K13 (out_d is the (B, N) bf16 matrix, out_i unused)
extern "C" int vecdb_scan_int8_bf16(const void* q8, const void* qs, const void* qc, const void* base,
                                    const void* scale, const void* cache, void* out_d, void* out_i, int B, int N,
                                    int D, int n_valid, int flags, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const bool cosine = flags & 1;
  if (flags & 2) return launch<true>(q8, qs, qc, base, scale, cache, out_d, out_i, B, N, D, n_valid, cosine, stream);
  return launch<false>(q8, qs, qc, base, scale, cache, out_d, out_i, B, N, D, n_valid, cosine, stream);
}
