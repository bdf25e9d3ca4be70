// K7: PQ-ADC scan fused with a chunk-min, for Hopper (sm_90a): the kernel,
// instantiated per chunk by csrc/adc_scan_chunkmin.cu (chunks 8-32 and the
// entry point) and csrc/adc_scan_chunkmin_small.cu (chunks 1-4), two sources
// that nvcc builds in parallel.
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_adc.py:adc_scan_chunkmin (Pallas
// body _adc_chunkmin_kernel), row-major codes, chunk 1, 2, 4, 8, 16 or 32.
//
// What it computes, for the PERMUTED nibble-packed codes (N, cw) uint8 (low
// nibble first), the per-query int8 LUT lut (B, Kd) with Kd = 32 cw (column
// g*16 + v holds group g, code v; zero columns for groups past m), the
// per-query scales (B,) and, for cosine, the int8 centroid-sqnorm column cs
// (Kd,) with its scale and the query norms:
//
//   acc[x, b] = sum_g lut_b[g*16 + code(x, g)]                   (exact int32)
//   d         = float(acc) * scale[b]
//   cosine:     c_sq = float(sum_g cs[g*16 + code(x, g)]) * cs_scale
//               d = 1 - d / max(sqrt(max(c_sq, 0)) * qn[b], 1e-10)
//   d = +inf where x >= n_valid
//
// and out_d[b, s], out_p[b, s] = the min of d over rows x in [chunk s,
// chunk (s + 1)) and the lowest x that reaches it.  The epilogue rounds in
// the reference's order (__fmul_rn / __fdiv_rn / __fsub_rn, IEEE sqrtf), so
// the result equals the plain PyTorch version (ops/adc.py) bit for bit.
//
// What bounds it on the H100: the ADC sum as a (rows, Kd) one-hot x (Kd, B)
// int8 product on the tensor cores, 2 N B Kd operations (1.02e13 at N = 1M,
// B = 1000, m = 320) against N cw + B Kd bytes.  The design:
//
// - One CTA: 128 queries (the wgmma N) x 2048 code rows (8192 when the whole
//   LUT fits the ring), in sub-tiles of 256 rows.  Warpgroup 0 is the
//   producer: one thread streams the CTA's LUT in 128-column stages (16 KB,
//   one TMA box of 128 bytes x 128 queries, 128-byte swizzle) into a ring of
//   8 stages under full / empty mbarriers.  When Kd <= 8 x 128 (codes_pq_10m's
//   coarse stage 0: Kd 512) the LUT is loaded once and stays.  Warpgroups 1
//   and 2 are consumers (setmaxnreg gives them the producer's registers,
//   up to 232 each; ptxas fits them in 168): each owns 128
//   rows of a sub-tile as two m64 tiles and issues wgmma.mma_async
//   m64n128k32 s32.s8.s8 with A in registers and B (the LUT stage, K-major
//   like the LUT rows) read through a descriptor.
// - A is never loaded: a thread's A register for row r and k-columns
//   4t..4t+3 of group g is 1 << 8*(code & 3) when code >> 2 == t, else 0,
//   built from the row's code word (8 groups, one 4-byte load a stage).
// - Accumulator rows are mapped to code rows so that each warp owns 32
//   consecutive rows (tile mt, half h, lane group g -> row 32 warp + 16 mt +
//   8 h + g): a chunk of 8 rows is one half, 32 all four, below 8 a shuffle
//   over the low bits of g; the chunk-min stays in registers and shuffles.
// - Cosine: each lane of a quad sums the centroid-sqnorm column for 2 of a
//   stage's 8 groups of its 4 rows; the quad adds them in the epilogue.
//
// Requirements, checked by the wrapper: nibble-packed codes with cw % 4 == 0
// (zero padding bytes), Kd == 32 cw, a 16-byte aligned LUT, contiguous
// tensors, ceil(N / 2048) <= 65535, S = ceil(N / 256) * 256 / chunk.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace k7 {

constexpr int BN = 128;                    // queries per CTA (the wgmma N)
constexpr int TILE_ROWS = 256;             // rows per sub-tile: 2 warpgroups x 2 m64 tiles
constexpr int BK = 128;                    // LUT columns per stage: 8 groups, one code word
constexpr int STAGE_BYTES = BN * BK;       // 16 KB
constexpr int RING = 8;                    // stages in shared memory
constexpr int THREADS = 384;               // warpgroup 0 produces, 1 and 2 consume
constexpr int CONSUMERS = 256;
constexpr int ROWS_STREAM = 2048;          // rows per CTA when the LUT streams
constexpr int ROWS_RESIDENT = 8192;        // rows per CTA when it stays (Kd <= RING * BK)

inline size_t smem_bytes(int Kd, bool cosine) {
  return 1024 + RING * STAGE_BYTES + 2 * RING * sizeof(uint64_t) + 2 * BN * sizeof(float) +
         (cosine ? Kd : 0);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one 128-column x 128-query LUT box into `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// K-major B operand, 128-byte swizzle: rows of 128 bytes, 8-row groups 1024
// bytes apart; a k-step of 32 columns advances the start by 32 bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads / writes across wgmma
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A (64 x 32, registers) x B (32 x 128, shared memory): accumulate == 0
// overwrites d
__device__ __forceinline__ void wgmma_128(int (&d)[64], const unsigned (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc));
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

template <int CHUNK>
__global__ void __launch_bounds__(THREADS, 1)
adc_chunkmin_kernel(const __grid_constant__ CUtensorMap lut_map, const uint8_t* __restrict__ codes,
                    const float* __restrict__ scales, const float* __restrict__ qn,
                    const int8_t* __restrict__ cs, float cs_scale, float* __restrict__ out_d,
                    int32_t* __restrict__ out_p, int B, int N, int n_valid, int cw, int S,
                    int rows_per_cta) {
  static_assert(CHUNK == 1 || CHUNK == 2 || CHUNK == 4 || CHUNK == 8 || CHUNK == 16 || CHUNK == 32,
                "CHUNK must be 1, 2, 4, 8, 16 or 32");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * STAGE_BYTES);
  uint64_t* empty = full + RING;
  float* sc_s = reinterpret_cast<float*>(empty + RING);
  float* qn_s = sc_s + BN;
  int8_t* cs_s = reinterpret_cast<int8_t*>(qn_s + BN);

  const int tid = threadIdx.x;
  const int KT = cw / 4;  // stages per sub-tile
  const bool resident = KT <= RING;
  const bool cosine = cs != nullptr;
  const int n0 = blockIdx.x * BN;
  const long long row0 = static_cast<long long>(blockIdx.y) * rows_per_cta;
  // sub-tiles up to the survivors' n_pad = S * CHUNK rows (a multiple of 256)
  const long long left = (static_cast<long long>(S) * CHUNK - row0 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_sub = static_cast<int>(min(left, static_cast<long long>(rows_per_cta / TILE_ROWS)));

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS) {
    sc_s[i] = n0 + i < B ? scales[n0 + i] : 0.f;
    qn_s[i] = n0 + i < B ? qn[n0 + i] : 0.f;
  }
  if (cosine)
    for (int i = tid; i < 32 * cw; i += THREADS) cs_s[i] = cs[i];
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      const int total = resident ? KT : n_sub * KT;
      for (int it = 0; it < total; ++it) {
        const int slot = it % RING;
        if (it >= RING) mbar_wait(&empty[slot], ((it / RING) - 1) & 1);
        mbar_expect_tx(&full[slot], STAGE_BYTES);
        tma_load(ring + slot * STAGE_BYTES, &lut_map, (it % KT) * BK, n0, &full[slot]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128;
  const int wg = ct >> 7, warp = (ct >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  // this lane's row of half f = 2 mt + h in sub-tile sub: rbase + 256 sub + 8 f
  const long long rbase = row0 + 128 * wg + 32 * warp + g;

  // the code word (8 groups) of stage kt for the lane's four rows
  auto words = [&](int sub, int kt, unsigned (&w)[4]) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const long long x = rbase + static_cast<long long>(sub) * TILE_ROWS + 8 * f;
      w[f] = x < N ? __ldg(reinterpret_cast<const unsigned*>(codes + x * cw) + kt) : 0u;
    }
  };

  int acc[2][64];
  int csum[4] = {0, 0, 0, 0};
  unsigned cur[4], nxt[4] = {0u, 0u, 0u, 0u};
  words(0, 0, cur);
  int it = 0;
  for (int sub = 0; sub < n_sub; ++sub) {
    if (sub + 1 < n_sub)  // the next sub-tile's rows, a sub-tile ahead (a stage 0 row is 16 bytes)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const long long x = rbase + static_cast<long long>(sub + 1) * TILE_ROWS + 8 * f;
        if (x < N) asm volatile("prefetch.global.L1 [%0];\n" ::"l"(codes + x * cw));
      }
    for (int kt = 0; kt < KT; ++kt, ++it) {
      if (kt + 1 < KT)
        words(sub, kt + 1, nxt);
      else if (sub + 1 < n_sub)
        words(sub + 1, 0, nxt);
      const int slot = resident ? kt : it % RING;
      mbar_wait(&full[slot], resident ? 0u : static_cast<unsigned>((it / RING) & 1));
      if (cosine) {
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int e = 2 * t; e < 2 * t + 2; ++e)
            csum[f] += cs_s[(8 * kt + e) * 16 + ((cur[f] >> (4 * e)) & 15u)];
      }
      // the stage's A registers (k-steps kk: groups 2 kk, 2 kk + 1), all
      // built before its wgmmas: a register written while a wgmma is in
      // flight makes ptxas serialize them
      unsigned a[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[kk][mt][0] = onehot4((cur[2 * mt] >> (8 * kk)) & 15u, t);
          a[kk][mt][1] = onehot4((cur[2 * mt + 1] >> (8 * kk)) & 15u, t);
          a[kk][mt][2] = onehot4((cur[2 * mt] >> (8 * kk + 4)) & 15u, t);
          a[kk][mt][3] = onehot4((cur[2 * mt + 1] >> (8 * kk + 4)) & 15u, t);
        }
      const uint8_t* stage = ring + slot * STAGE_BYTES;
      wgmma_fence();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = desc_sw128(stage + 32 * kk);
        const int accumulate = kt | kk;  // the sub-tile's first k-step overwrites
        wgmma_128(acc[0], a[kk][0], desc, accumulate);
        wgmma_128(acc[1], a[kk][1], desc, accumulate);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (!resident) mbar_arrive(&empty[slot]);  // the stage's wgmmas have completed
#pragma unroll
      for (int f = 0; f < 4; ++f) cur[f] = nxt[f];
    }

    // epilogue of sub-tile `sub`: a chunk is GROUP consecutive halves, or
    // LANES rows g of one half
    constexpr int GROUP = CHUNK >= 8 ? CHUNK / 8 : 1;
    constexpr int LANES = CHUNK >= 8 ? 8 : CHUNK;
    float csq[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      int s = csum[f];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      csq[f] = __fmul_rn(__int2float_rn(s), cs_scale);
      csum[f] = 0;
    }
    const int xb = static_cast<int>(rbase) + sub * TILE_ROWS;
#pragma unroll
    for (int f0 = 0; f0 < 4; f0 += GROUP) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + t * 2 + j;
          const float qs = sc_s[col], qnn = qn_s[col];
          float best = INFINITY;
          int best_p = xb + 8 * f0;
#pragma unroll
          for (int f = f0; f < f0 + GROUP; ++f) {  // rows ascending: a strict < keeps the lowest
            const int x = xb + 8 * f;
            float d = __fmul_rn(__int2float_rn(acc[f >> 1][nt * 4 + 2 * (f & 1) + j]), qs);
            if (cosine) {
              const float norm0 = sqrtf(fmaxf(csq[f], 0.f));
              d = __fsub_rn(1.f, __fdiv_rn(d, fmaxf(__fmul_rn(norm0, qnn), 1e-10f)));
            }
            if (x < n_valid && d < best) {
              best = d;
              best_p = x;
            }
          }
#pragma unroll
          for (int o = 4; o < 4 * LANES; o <<= 1) {
            const float d2 = __shfl_xor_sync(0xffffffffu, best, o);
            const int p2 = __shfl_xor_sync(0xffffffffu, best_p, o);
            keep_min(best, best_p, d2, p2);
          }
          const int chunk = (xb + 8 * f0) / CHUNK;
          const int q = n0 + col;
          if ((g & (LANES - 1)) == 0 && q < B && chunk < S) {
            out_d[static_cast<size_t>(q) * S + chunk] = best;
            out_p[static_cast<size_t>(q) * S + chunk] = best_p;
          }
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda link)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// one launch of the chunk's kernel; its instantiations live in the two .cu files
template <int CHUNK>
int launch(const void* codes, const void* lut, const void* scales, const void* qn, const void* cs,
           float cs_scale, void* out_d, void* out_p, int B, int N, int n_valid, int cw, int S,
           void* stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int Kd = 32 * cw;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kd), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kd)};
  const cuuint32_t box[2] = {BK, BN}, elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(lut), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Kd, cs != nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      adc_chunkmin_kernel<CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = cw / 4 <= RING ? ROWS_RESIDENT : ROWS_STREAM;
  dim3 grid((B + BN - 1) / BN, (N + rows - 1) / rows);
  adc_chunkmin_kernel<CHUNK><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const uint8_t*>(codes), static_cast<const float*>(scales),
      static_cast<const float*>(qn), static_cast<const int8_t*>(cs), cs_scale,
      static_cast<float*>(out_d), static_cast<int32_t*>(out_p), B, N, n_valid, cw, S, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k7
