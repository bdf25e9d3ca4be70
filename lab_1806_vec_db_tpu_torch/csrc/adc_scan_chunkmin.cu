// K7: PQ-ADC scan fused with a 32-row chunk-min, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_adc.py:adc_scan_chunkmin (Pallas
// body _adc_chunkmin_kernel), row-major codes.
//
// What it computes, for the PERMUTED codes (N, cw) uint8 (4-bit codes packed
// two per byte, low nibble first, when `packed`), the per-query int8 LUT
// lut (B, Kd) with Kd = mk * 16 (column g*16 + v holds group g, code v; zero
// columns for groups past m), the per-query scales (B,) and, for cosine, the
// int8 centroid-sqnorm column cs (Kd,) with its scale and the query norms:
//
//   acc[x, b] = sum_g lut[b, g*16 + code(x, g)]                 (exact int32)
//   d[x, b]   = float(acc) * scale[b]
//   cosine:     c_sq = float(sum_g cs[g*16 + code(x, g)]) * cs_scale
//               d = 1 - d / max(sqrt(max(c_sq, 0)) * qn[b], 1e-10)
//   d = +inf where x >= n_valid
//   out_d[b, s], out_p[b, s] = min of d over rows x in [32 s, 32 s + 32) and
//                              the lowest x that reaches it
//
// The wrapper (ops/adc.py) quantizes the LUT as _prep_lut_quant does, takes
// the top-k over the (B, S) survivors and decodes positions through the
// permutation.
//
// What bounds it on the H100: the one-hot product.  The ADC sum is a
// (rows, Kd) one-hot x (Kd, B) int8 product: 2 * N * B * m * 16 int8
// operations (1.02e13 at N = 1M, B = 1000, m = 320) against N * cw + B * Kd
// bytes of input, so the tensor cores bound it, not the memory.  The kernel
// is K1's (csrc/scan_int8_packed.cu) mma.sync m16n8k32 s8 pipeline with the
// A operand generated in registers from the code nibbles instead of loaded:
// a thread's A register for row r and k-columns 4t..4t+3 of group g is
// 1 << 8*(code & 3) when code >> 2 == t, else 0.  Each CTA owns 128 queries
// and a 2048-row chunk, stages each 128-row sub-tile's codes unpacked in
// shared memory ([group][row], conflict-free for the fragment loads), and
// streams the LUT in 64-column slices with a two-stage cp.async pipeline
// (the LUT is L2-resident: 5 MB at B = 1000, m = 320).  The epilogue and the
// chunk-min run in registers and warp shuffles, so the (N, B) matrix never
// reaches device memory.  wgmma / TMA are later work.
//
// The epilogue rounds in the reference's order with __fmul_rn / __fdiv_rn /
// __fsub_rn and IEEE sqrtf, so the result equals the plain PyTorch version
// (ops/adc.py:adc_chunkmin_ref) bit for bit: the int32 sums are exact.
//
// Requirements, checked by the wrapper: Kd % 64 == 0, cw % 4 == 0 (zero
// padding bytes), mk >= number of groups the code bytes hold, contiguous
// tensors, ceil(N / 2048) <= 65535.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_ROWS = 2048;  // rows per CTA
constexpr int BM = 128;           // rows per sub-tile
constexpr int BN = 128;           // queries per CTA
constexpr int BK = 64;            // LUT columns per pipeline stage (4 groups)
constexpr int LDS = BK + 16;      // padded smem row stride in bytes
constexpr int THREADS = 256;      // 8 warps: 2 (rows) x 4 (queries)
constexpr int SUBTILES = CHUNK_ROWS / BM;
constexpr int CHUNK = 32;         // rows per survivor

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

// one-hot A register: bytes j = 0..3 hold (code == 4t + j)
__device__ __forceinline__ unsigned onehot4(unsigned code, int t) {
  return (code >> 2) == static_cast<unsigned>(t) ? 1u << ((code & 3u) << 3) : 0u;
}

// (d, pos) lexicographic min: the smaller distance, then the lower position
__device__ __forceinline__ void keep_min(float& d, int& p, float d2, int p2) {
  if (d2 < d || (d2 == d && p2 < p)) {
    d = d2;
    p = p2;
  }
}

__global__ void __launch_bounds__(THREADS)
adc_chunkmin_kernel(const uint8_t* __restrict__ codes, const int8_t* __restrict__ lut,
                    const float* __restrict__ scales, const float* __restrict__ qn,
                    const int8_t* __restrict__ cs, float cs_scale, float* __restrict__ out_d,
                    int32_t* __restrict__ out_p, int B, int N, int n_valid, int cw, int mk,
                    int S, int packed, int cosine) {
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* smB = reinterpret_cast<int8_t*>(smem);                 // 2 x BN x LDS
  float* csq = reinterpret_cast<float*>(smem + 2 * BN * LDS);    // BM
  int8_t* cs_s = reinterpret_cast<int8_t*>(csq + BM);            // Kd (cosine)
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(cs_s + (cosine ? mk * 16 : 0));  // mk x BM

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int n0 = blockIdx.x * BN;
  const long long row0 = static_cast<long long>(blockIdx.y) * CHUNK_ROWS;
  const int Kd = mk * 16;
  const int KT = Kd / BK;
  const int steps = SUBTILES * KT;
  const int words = cw >> 2;
  const int groups_in_codes = packed ? 2 * cw : cw;

  if (cosine)
    for (int i = tid; i < Kd; i += THREADS) cs_s[i] = cs[i];

  // this thread's 8 query columns: n = n0 + warp_n*32 + nt*8 + t*2 + j
  float q_s[4][2], q_n[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + j;
      q_s[nt][j] = n < B ? scales[n] : 0.f;
      q_n[nt][j] = n < B ? qn[n] : 0.f;
    }

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  auto load_stage = [&](int stage, int step) {
    const int kt = step % KT;
    const int8_t* b_src = lut + kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 queries x 64 bytes = 512 16-byte pieces
      const int id = tid + i * THREADS;
      const int r = id >> 2, c = (id & 3) * 16;
      const bool ok = n0 + r < B;  // queries past B are zero-filled
      cp_async16(&smB[(stage * BN + r) * LDS + c],
                 ok ? b_src + static_cast<size_t>(n0 + r) * Kd + c : lut, ok ? 16 : 0);
    }
  };

  // stage the codes of sub-tile `sub` unpacked as codes_s[group * BM + row]
  // (rows past N read as code 0: they are masked by position anyway), and
  // for cosine each row's centroid-sqnorm sum
  auto stage_codes = [&](int sub) {
    const long long r0 = row0 + static_cast<long long>(sub) * BM;
    for (int i = tid; i < words * BM; i += THREADS) {
      const int row = i % BM, w = i / BM;
      const long long x = r0 + row;
      const unsigned v =
          x < N ? __ldg(reinterpret_cast<const unsigned*>(codes + x * cw) + w) : 0u;
      if (packed) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int grp = 8 * w + e;
          if (grp < mk) codes_s[grp * BM + row] = (v >> (4 * e)) & 15u;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int grp = 4 * w + e;
          if (grp < mk) codes_s[grp * BM + row] = (v >> (8 * e)) & 255u;
        }
      }
    }
    for (int i = groups_in_codes * BM + tid; i < mk * BM; i += THREADS) codes_s[i] = 0;
    __syncthreads();
    if (cosine && tid < BM) {
      int s = 0;
      for (int grp = 0; grp < mk; ++grp) s += cs_s[grp * 16 + codes_s[grp * BM + tid]];
      csq[tid] = __fmul_rn(__int2float_rn(s), cs_scale);
    }
    // the barrier of the first k-step orders these writes before their reads
  };

  stage_codes(0);
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
    const int8_t* Bq = smB + (s & 1) * BN * LDS;
    const int kt = s % KT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int grp = kt * 4 + kk / 16;  // groups grp (a[0], a[1]) and grp + 1 (a[2], a[3])
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = warp_m * 64 + mt * 16 + g;
        af[mt][0] = onehot4(codes_s[grp * BM + r], t);
        af[mt][1] = onehot4(codes_s[grp * BM + r + 8], t);
        af[mt][2] = onehot4(codes_s[(grp + 1) * BM + r], t);
        af[mt][3] = onehot4(codes_s[(grp + 1) * BM + r + 8], t);
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

    if (kt == KT - 1) {
      // epilogue of sub-tile `sub`: rows warp_m*64 + mt*16 + {g, g+8}; the
      // 32-row chunk c2 of this warp holds mt = 2*c2, 2*c2 + 1
      const int sub = s / KT;
      const long long r0 = row0 + static_cast<long long>(sub) * BM;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float best = INFINITY;
            int best_p = 0x7fffffff;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int mt = 2 * c2 + mi;
                const int row = warp_m * 64 + mt * 16 + g + 8 * h;
                const long long x = r0 + row;
                float d = __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + j]), q_s[nt][j]);
                if (cosine) {
                  const float norm0 = sqrtf(fmaxf(csq[row], 0.f));
                  d = __fsub_rn(1.f, __fdiv_rn(d, fmaxf(__fmul_rn(norm0, q_n[nt][j]), 1e-10f)));
                }
                if (x >= n_valid) d = INFINITY;
                keep_min(best, best_p, d, static_cast<int>(x));
              }
#pragma unroll
            for (int o = 4; o < 32; o <<= 1) {
              const float d2 = __shfl_xor_sync(0xffffffffu, best, o);
              const int p2 = __shfl_xor_sync(0xffffffffu, best_p, o);
              keep_min(best, best_p, d2, p2);
            }
            const int n = n0 + warp_n * 32 + nt * 8 + t * 2 + j;
            const long long chunk = (r0 + warp_m * 64) / CHUNK + c2;
            if (g == 0 && n < B && chunk < S) {
              out_d[static_cast<size_t>(n) * S + chunk] = best;
              out_p[static_cast<size_t>(n) * S + chunk] = best_p;
            }
          }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
      __syncthreads();  // every warp is done with codes_s / csq of this sub-tile
      if (sub + 1 < SUBTILES) stage_codes(sub + 1);
    } else {
      __syncthreads();  // stage s&1 is refilled by the next iteration's prefetch
    }
  }
}

}  // namespace

extern "C" int vecdb_adc_chunkmin(const void* codes, const void* lut, const void* scales,
                                  const void* qn, const void* cs, float cs_scale, void* out_d,
                                  void* out_p, int B, int N, int n_valid, int cw, int mk, int S,
                                  int packed, int cosine, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const size_t smem = 2 * BN * LDS + BM * sizeof(float) + (cosine ? mk * 16 : 0) +
                      static_cast<size_t>(mk) * BM;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        adc_chunkmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((B + BN - 1) / BN, (N + CHUNK_ROWS - 1) / CHUNK_ROWS);
  adc_chunkmin_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(lut),
      static_cast<const float*>(scales), static_cast<const float*>(qn),
      static_cast<const int8_t*>(cs), cs_scale, static_cast<float*>(out_d),
      static_cast<int32_t*>(out_p), B, N, n_valid, cw, mk, S, packed, cosine);
  return static_cast<int>(cudaGetLastError());
}
