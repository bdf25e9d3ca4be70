// K8 and K9: PQ-ADC sums, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_adc.py:_adc_sums_v2 (K8, Pallas
// body _adc_kernel_v2, k = 16) and _adc_sums_stepwise (K9, body
// _adc_kernel_stepwise, k = 256).
//
//   sum[r, x] = sum_i lut[r, i, code(x, i)]       i = 0 .. m-1, in order
//
// accumulated in int32 for int8 (then float(sum) * scale[r]) and in f32 for
// bf16 / f32 (__fadd_rn, group by group), so the sums equal the plain
// versions (ops/adc.py) bit for bit.  Codes are (n_rows, cw) uint8, 4-bit
// codes packed two per byte (low nibble first) when `packed`.  Two launch
// shapes:
//
//   dense  out (R, N): every code row against every LUT row (the scan of
//          adc_scan_pallas; the top-k is taken outside the kernel);
//   ids    out (B, C): query b's LUT against the code rows ids[b, c] (the
//          HNSW+PQ node distance); ids < 0 or >= n_rows give +inf.  With
//          `shared` every query uses LUT row 0 (the cosine centroid-sqnorm
//          row).  This replaces the TPU's 128-query diagonal trick
//          (pallas_adc.py:786-803), which scored every gathered row against
//          128 LUTs to keep one.
//
// What bounds them on the H100: shared-memory lookups, not bytes.  Each
// output costs m lookups against m (k = 256) or m / 2 (k = 16) code bytes.
//
// K8 (k = 16), in namespace k8:
//
//   dense  With an int8 LUT and nibble-packed codes (what every search
//          gives it: `adc_scan_pallas` defaults to lut_dtype "int8") the
//          int32 sums do not depend on their order, so the function is
//          K7's one-hot product without the chunk-min: `dense_onehot_kernel`
//          runs K7's pipeline (a TMA producer warpgroup streaming the LUT
//          as (R, 32 cw) int8 columns in 128-byte swizzled boxes, two
//          consumer warpgroups issuing wgmma m64n128k32 with the one-hot A
//          built in registers from the code words; csrc/adc_scan_chunkmin.cuh,
//          included for its helpers) with a dense epilogue that stores
//          float(acc) * scale[r] to out[r, x], 8 lanes on 8 consecutive
//          rows.  A bf16 / f32 LUT, or one code a byte, reach the dense
//          shape only through `adc_sums`; they run the lookup body
//          `adc_sums_dense_kernel`: the LUT staged in shared memory by
//          groups of subspaces, the tile's codes unpacked and transposed to
//          [group][row], so the 32 lanes of a warp look up one LUT row's
//          16-entry group at once (conflict-free: the lanes only differ in
//          which of 16 consecutive entries they read).
//   ids    A CTA of 8 warps stages the LUT rows of its queries (10 KB each
//          in bf16 at m = 320) once, by 16-byte cp.async, and keeps them
//          for the whole call.  A warp serves one query, so its lookups stay
//          within one 16-entry group (conflict-free as above); a lane takes
//          one candidate a pass and reads its code row 16 bytes at a time,
//          the next 16 in flight while these are looked up.  Several
//          queries share a CTA where C is small (C 1 or 16: 8 queries),
//          several warps share a query where it is large (C 128: 4 warps, 2
//          queries; C 2048: 8 warps, 8 passes): more warps hide the in-order
//          add chains' latency better than more chains a lane did (measured
//          with 2 and 4); `ops/adc.py:k8_ids_plan` sizes it.
//
// K9 (k = 256; bf16, or f32 under `exact`), its own kernels:
//
//   dense  A CTA is 32 LUT rows (one per lane) x 1024 code rows (64 per
//          thread, 16 warps), so each staged LUT entry serves 4 lookups and
//          the LUT crosses L2 N / 1024 times (21 GB at R = 1000, N =
//          131,072, against 172 GB for a 128-row tile).  Four groups a
//          stage (the rows' code bytes are one 4-byte word), copied with
//          cp.async into a two-stage ring (one stage for f32), so the next
//          stage arrives while this one is looked up.  The lanes of a warp
//          share one code row (the code read is a broadcast) and differ in
//          the LUT row, whose stage stride is an odd number of 4-byte
//          words: 32 lanes reading the same code hit 32 distinct banks.
//          That stride is why the copies are 4 bytes wide: a 16-byte copy
//          keeps every row's entry c in one of 8 bank quads.  The row block
//          is the fast grid index, so the CTAs running together share one
//          LUT row block in L2.
//   ids    A CTA per query streams that query's LUT (160 KB in bf16 at
//          m = 320) once per 256 candidates in 16 KB stages of 16-byte
//          cp.async copies, four stages in flight; a thread per candidate
//          reads its row's codes straight from device memory, one stage
//          ahead, 4 groups a load.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "adc_scan_chunkmin.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 128;  // dense: code rows per CTA (lane + 32 * (warp % 4))
constexpr int RQ = 32;     // dense: LUT rows per CTA (16 per thread)
constexpr int RQ_T = RQ / 2;
constexpr int STAGE_BYTES = 32 * 1024;
constexpr int K = 16;  // K8's codebook size; K9 (k = 256) is namespace k9

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int widen(int8_t v) { return static_cast<int>(v); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) { return a + b; }

__device__ __forceinline__ float finish(float acc, const float*, int) { return acc; }
__device__ __forceinline__ float finish(int acc, const float* scales, int r) {
  return __fmul_rn(__int2float_rn(acc), scales[r]);
}

__device__ __forceinline__ unsigned code_at(const uint8_t* row, int g, int packed) {
  return packed ? (row[g >> 1] >> ((g & 1) << 2)) & 15u : row[g];
}

// groups per stage so that the dense LUT stage (RQ x G x K of T) fits 32 KB
template <typename T> struct DenseGroups {
  static constexpr int value = STAGE_BYTES / (RQ * K * static_cast<int>(sizeof(T)));
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
adc_sums_dense_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ lut,
                      const float* __restrict__ scales, float* __restrict__ out, int N, int R,
                      int m, int cw, int packed) {
  constexpr int G = DenseGroups<T>::value;
  using A = typename Acc<T>::type;
  __shared__ __align__(16) T lut_s[RQ * G * K];
  __shared__ uint8_t codes_s[G * ROWS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = lane + 32 * (warp & 3);  // this thread's code row in the tile
  const int qbase = (warp >> 2) * RQ_T;    // its first LUT row in the tile
  const long long n0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int r0 = blockIdx.y * RQ;

  A acc[RQ_T];
#pragma unroll
  for (int q = 0; q < RQ_T; ++q) acc[q] = A(0);

  for (int g0 = 0; g0 < m; g0 += G) {
    const int gl = min(G, m - g0);
    for (int i = tid; i < RQ * gl * K; i += THREADS) {
      const int r = i / (gl * K), rem = i - r * (gl * K);
      lut_s[r * G * K + rem] =
          r0 + r < R ? lut[(static_cast<size_t>(r0 + r) * m + g0) * K + rem] : zero<T>();
    }
    for (int i = tid; i < ROWS * gl; i += THREADS) {
      const int rr = i % ROWS, j = i / ROWS;
      const long long x = n0 + rr;
      codes_s[j * ROWS + rr] = x < N ? code_at(codes + x * cw, g0 + j, packed) : 0;
    }
    __syncthreads();
    for (int j = 0; j < gl; ++j) {
      const int c = codes_s[j * ROWS + row];
      const T* l = lut_s + qbase * G * K + j * K + c;
#pragma unroll
      for (int q = 0; q < RQ_T; ++q) acc[q] = add(acc[q], widen(l[q * G * K]));
    }
    __syncthreads();
  }
  const long long x = n0 + row;
  if (x < N) {
#pragma unroll
    for (int q = 0; q < RQ_T; ++q) {
      const int r = r0 + qbase + q;
      if (r < R) out[static_cast<size_t>(r) * N + x] = finish(acc[q], scales, r);
    }
  }
}

// ------------------------------------------------------------------ K9 ----

namespace k9 {

constexpr int K = 256;
constexpr int THREADS = 512;             // dense: 16 warps
constexpr int QB = 32;                   // dense: LUT rows per CTA, one per lane
constexpr int RT = 64;                   // dense: code rows per thread
constexpr int RB = RT * (THREADS / 32);  // dense: code rows per CTA (1024)
constexpr int G = 4;                     // dense: groups per stage (one code word a row)
constexpr int IDS_THREADS = 256;         // ids: candidates per pass, one per thread
constexpr int IDS_STAGE = 16 * 1024;     // ids: LUT bytes per stage
constexpr int IDS_STAGES = 4;

// the dense kernel's shared memory: per stage, QB LUT rows of G groups at
// an odd stride of QSW words, then RB code words
template <typename T> struct Dense {
  static constexpr int WORDS = G * K * static_cast<int>(sizeof(T)) / 4;  // a LUT row's words
  static constexpr int QSW = WORDS + 1;
  static constexpr int STAGES = sizeof(T) == 2 ? 2 : 1;  // f32 (exact): 128 KB, one stage
  static constexpr int LUT_BYTES = QB * QSW * 4;
  static constexpr int STAGE_BYTES = LUT_BYTES + RB * 4;
  static constexpr int BYTES = STAGES * STAGE_BYTES;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// entry c of a staged LUT group (bf16 widened exactly: its bits are the
// high half of the f32)
__device__ __forceinline__ float entry(const __nv_bfloat16* g, unsigned c) {
  return __uint_as_float(static_cast<unsigned>(reinterpret_cast<const unsigned short*>(g)[c]) << 16);
}
__device__ __forceinline__ float entry(const float* g, unsigned c) { return g[c]; }

// four code bytes of a row from group g on (0 past m): one load when rows
// are 4-byte aligned (cw % 4 == 0, g % 4 == 0: the word ends within cw)
__device__ __forceinline__ unsigned code_word(const uint8_t* row, int g, int m, bool aligned) {
  if (aligned) return g < m ? __ldg(reinterpret_cast<const unsigned*>(row + g)) : 0u;
  unsigned v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) v |= (g + e < m ? static_cast<unsigned>(row[g + e]) : 0u) << (8 * e);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
dense_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ lut, float* __restrict__ out,
             int N, int R, int m, int cw) {
  using L = Dense<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n0 = static_cast<long long>(blockIdx.x) * RB;
  const int r0 = blockIdx.y * QB;
  const int steps = (m + G - 1) / G;
  const bool aligned = (cw & 3) == 0;

  // stage `step`'s LUT slice (groups past m and rows past R zero-filled: a
  // zero code word then adds +0, which leaves every sum as it is) and code
  // words into buffer st
  auto load = [&](int st, int step) {
    uint8_t* base = smem + st * L::STAGE_BYTES;
    unsigned* lut_s = reinterpret_cast<unsigned*>(base);
    unsigned* codes_s = reinterpret_cast<unsigned*>(base + L::LUT_BYTES);
    const int g0 = step * G;
    const int real_words = min(G, m - g0) * (K * static_cast<int>(sizeof(T)) / 4);
#pragma unroll 8
    for (int j = 0; j < QB * L::WORDS / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int q = i / L::WORDS, w = i % L::WORDS;  // powers of two: shifts
      const bool ok = r0 + q < R && w < real_words;
      const unsigned* src =
          reinterpret_cast<const unsigned*>(lut + (static_cast<size_t>(r0 + q) * m + g0) * K) + w;
      cp_async4(lut_s + q * L::QSW + w, ok ? static_cast<const void*>(src) : lut, ok ? 4 : 0);
    }
#pragma unroll
    for (int j = 0; j < RB / THREADS; ++j) {
      const int r = tid + j * THREADS;
      const long long x = n0 + r;
      const uint8_t* row = codes + x * cw;
      if (aligned)
        cp_async4(codes_s + r, x < N && g0 < m ? static_cast<const void*>(row + g0) : codes,
                  x < N ? 4 : 0);
      else
        codes_s[r] = x < N ? code_word(row, g0, m, false) : 0u;
    }
  };

  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    int st = 0;
    if (L::STAGES == 2) {
      st = s & 1;
      if (s + 1 < steps) {
        load(st ^ 1, s + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* base = smem + st * L::STAGE_BYTES;
    const unsigned* codes_s = reinterpret_cast<const unsigned*>(base + L::LUT_BYTES) + warp * RT;
    const T* lq = reinterpret_cast<const T*>(base + lane * L::QSW * 4);
#pragma unroll
    for (int r0 = 0; r0 < RT; r0 += 4) {
      // four rows' code words in one load (a broadcast: the warp's lanes share the rows)
      const uint4 w4 = *reinterpret_cast<const uint4*>(codes_s + r0);
      const unsigned ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[r0 + i] = __fadd_rn(acc[r0 + i], entry(lq + g * K, (ws[i] >> (8 * g)) & 255u));
    }
    __syncthreads();  // buffer st is refilled next
    if (L::STAGES == 1 && s + 1 < steps) {
      load(0, s + 1);
      cp_async_commit();
    }
  }

  const int q = r0 + lane;
  const long long xb = n0 + warp * RT;
  if (q < R) {
    float* o = out + static_cast<size_t>(q) * N + xb;
    if ((N & 3) == 0 && xb + RT <= N) {
#pragma unroll
      for (int r = 0; r < RT; r += 4)
        *reinterpret_cast<float4*>(o + r) = make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (xb + r < N) o[r] = acc[r];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(IDS_THREADS)
ids_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ lut,
           const int32_t* __restrict__ ids, float* __restrict__ out, int C, int m, int cw,
           long long n_rows, int shared) {
  constexpr int GS = IDS_STAGE / (K * static_cast<int>(sizeof(T)));  // groups a stage: 32 bf16, 16 f32
  constexpr int W = GS / 4;                                          // code words a stage
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const uint8_t* lut_b =
      reinterpret_cast<const uint8_t*>(lut + (shared ? 0 : static_cast<size_t>(b) * m * K));
  const long long lut_bytes = static_cast<long long>(m) * K * sizeof(T);
  const int steps = (m + GS - 1) / GS;
  const bool aligned = (cw & 3) == 0;

  auto load = [&](int step) {  // one commit group per call, empty past the end
    if (step < steps) {
      uint8_t* dst = smem + (step % IDS_STAGES) * IDS_STAGE;
#pragma unroll
      for (int j = 0; j < IDS_STAGE / 16 / IDS_THREADS; ++j) {
        const int i = tid + j * IDS_THREADS;
        const long long o = static_cast<long long>(step) * IDS_STAGE + i * 16;
        cp_async16(dst + i * 16, o < lut_bytes ? lut_b + o : lut_b, o < lut_bytes ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  for (int c0 = 0; c0 < C; c0 += IDS_THREADS) {
    const int c = c0 + tid;
    const int id = c < C ? ids[static_cast<size_t>(b) * C + c] : -1;
    const bool ok = id >= 0 && id < n_rows;
    const uint8_t* row = codes + (ok ? static_cast<long long>(id) * cw : 0);
    unsigned cur[W], nxt[W];
#pragma unroll
    for (int j = 0; j < W; ++j) cur[j] = ok ? code_word(row, 4 * j, m, aligned) : 0u;
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < IDS_STAGES - 1; ++p) load(p);
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<IDS_STAGES - 2>();
      __syncthreads();  // stage s landed for every thread; stage s - 1's slot is free
      load(s + IDS_STAGES - 1);
      const int g0 = s * GS;
#pragma unroll
      for (int j = 0; j < W; ++j)
        nxt[j] = ok && s + 1 < steps ? code_word(row, g0 + GS + 4 * j, m, aligned) : 0u;
      const T* ls = reinterpret_cast<const T*>(smem + (s % IDS_STAGES) * IDS_STAGE);
      const int gl = min(GS, m - g0);
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * j + e < gl)
            acc = __fadd_rn(acc, entry(ls + (4 * j + e) * K, (cur[j] >> (8 * e)) & 255u));
#pragma unroll
      for (int j = 0; j < W; ++j) cur[j] = nxt[j];
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass refills every slot
    if (c < C) out[static_cast<size_t>(b) * C + c] = ok ? acc : INFINITY;
  }
}

template <typename T>
int launch_dense(const void* codes, const void* lut, void* out, int N, int R, int m, int cw,
                 cudaStream_t stream) {
  const int smem = Dense<T>::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(dense_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + RB - 1) / RB, (R + QB - 1) / QB);  // row blocks fastest: CTAs in flight share a LUT block
  dense_kernel<T><<<grid, THREADS, smem, stream>>>(static_cast<const uint8_t*>(codes),
                                                   static_cast<const T*>(lut), static_cast<float*>(out),
                                                   N, R, m, cw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ids(const void* codes, const void* lut, const void* ids, void* out, int B, int C, int m,
               int cw, long long n_rows, int shared, cudaStream_t stream) {
  constexpr int smem = IDS_STAGES * IDS_STAGE;
  const cudaError_t err =
      cudaFuncSetAttribute(ids_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ids_kernel<T><<<B, IDS_THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const T*>(lut), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), C, m, cw, n_rows, shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k9

// ------------------------------------------------------------------ K8 ----

namespace k8 {

// ---- dense shape, int8 LUT, nibble-packed codes: K7's one-hot product ----

constexpr int BN = k7::BN;                // LUT rows (queries) per CTA, the wgmma N
constexpr int TILE_ROWS = k7::TILE_ROWS;  // code rows per sub-tile: 2 consumers x 2 m64 tiles
constexpr int BK = k7::BK;                // LUT columns per stage: 8 groups, one code word
constexpr int STAGE_BYTES = k7::STAGE_BYTES;
constexpr int RING = k7::RING;
constexpr int THREADS = k7::THREADS;      // warpgroup 0 produces, 1 and 2 consume
constexpr int CONSUMERS = k7::CONSUMERS;
constexpr int SMEM = 1024 + RING * STAGE_BYTES + 2 * RING * 8 + BN * 4;

// out[r, x] = float(sum_g lut[r, g * 16 + code(x, g)]) * scale[r], r < R,
// x < N: K7's pipeline and row map (adc_scan_chunkmin.cuh) with a dense
// epilogue in place of the chunk-min
__global__ void __launch_bounds__(THREADS, 1)
dense_onehot_kernel(const __grid_constant__ CUtensorMap lut_map, const uint8_t* __restrict__ codes,
                    const float* __restrict__ scales, float* __restrict__ out, int R, int N, int cw,
                    int rows_per_cta) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (k7::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING * STAGE_BYTES);
  uint64_t* empty = full + RING;
  float* sc_s = reinterpret_cast<float*>(empty + RING);

  const int tid = threadIdx.x;
  const int KT = cw / 4;  // stages per sub-tile
  const bool resident = KT <= RING;
  const int n0 = blockIdx.x * BN;
  const long long row0 = static_cast<long long>(blockIdx.y) * rows_per_cta;
  const long long left = (static_cast<long long>(N) - row0 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_sub = static_cast<int>(min(left, static_cast<long long>(rows_per_cta / TILE_ROWS)));

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      k7::mbar_init(&full[i], 1);
      k7::mbar_init(&empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS) sc_s[i] = n0 + i < R ? scales[n0 + i] : 0.f;
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      const int total = resident ? KT : n_sub * KT;
      for (int it = 0; it < total; ++it) {
        const int slot = it % RING;
        if (it >= RING) k7::mbar_wait(&empty[slot], ((it / RING) - 1) & 1);
        k7::mbar_expect_tx(&full[slot], STAGE_BYTES);
        k7::tma_load(ring + slot * STAGE_BYTES, &lut_map, (it % KT) * BK, n0, &full[slot]);
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

  auto words = [&](int sub, int kt, unsigned (&w)[4]) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const long long x = rbase + static_cast<long long>(sub) * TILE_ROWS + 8 * f;
      w[f] = x < N ? __ldg(reinterpret_cast<const unsigned*>(codes + x * cw) + kt) : 0u;
    }
  };

  int acc[2][64];
  unsigned cur[4], nxt[4] = {0u, 0u, 0u, 0u};
  words(0, 0, cur);
  int it = 0;
  for (int sub = 0; sub < n_sub; ++sub) {
    if (sub + 1 < n_sub)
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
      k7::mbar_wait(&full[slot], resident ? 0u : static_cast<unsigned>((it / RING) & 1));
      unsigned a[4][2][4];  // every A register built before the stage's first wgmma
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[kk][mt][0] = k7::onehot4((cur[2 * mt] >> (8 * kk)) & 15u, t);
          a[kk][mt][1] = k7::onehot4((cur[2 * mt + 1] >> (8 * kk)) & 15u, t);
          a[kk][mt][2] = k7::onehot4((cur[2 * mt] >> (8 * kk + 4)) & 15u, t);
          a[kk][mt][3] = k7::onehot4((cur[2 * mt + 1] >> (8 * kk + 4)) & 15u, t);
        }
      const uint8_t* stage = ring + slot * STAGE_BYTES;
      k7::wgmma_fence();
      k7::fence_acc(acc[0]);
      k7::fence_acc(acc[1]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = k7::desc_sw128(stage + 32 * kk);
        const int accumulate = kt | kk;  // the sub-tile's first k-step overwrites
        k7::wgmma_128(acc[0], a[kk][0], desc, accumulate);
        k7::wgmma_128(acc[1], a[kk][1], desc, accumulate);
      }
      k7::wgmma_commit();
      k7::wgmma_wait<0>();
      k7::fence_acc(acc[0]);
      k7::fence_acc(acc[1]);
      if (!resident) k7::mbar_arrive(&empty[slot]);
#pragma unroll
      for (int f = 0; f < 4; ++f) cur[f] = nxt[f];
    }

    // dense epilogue: per store, 8 lanes (g) write 8 consecutive rows of
    // one LUT row, 4 LUT rows (t) a warp: whole 32-byte sectors
    const long long xb = rbase + static_cast<long long>(sub) * TILE_ROWS;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const long long x = xb + 8 * f;
      if (x >= N) continue;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + t * 2 + j;
          if (n0 + col < R)
            out[static_cast<size_t>(n0 + col) * N + x] =
                __fmul_rn(__int2float_rn(acc[f >> 1][nt * 4 + 2 * (f & 1) + j]), sc_s[col]);
        }
    }
  }
}

// lut (R, Kd = 32 cw) int8, 16-byte aligned; codes (N, cw), cw % 4 == 0
int launch_dense_onehot(const void* codes, const void* lut, const void* scales, void* out, int N, int R,
                        int cw, cudaStream_t stream) {
  const k7::EncodeTiled encode = k7::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(32 * cw), static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(32 * cw)};
  const cuuint32_t box[2] = {BK, BN}, elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(lut), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      cudaFuncSetAttribute(dense_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = cw / 4 <= RING ? k7::ROWS_RESIDENT : k7::ROWS_STREAM;
  dim3 grid((R + BN - 1) / BN, (N + rows - 1) / rows);
  dense_onehot_kernel<<<grid, THREADS, SMEM, stream>>>(map, static_cast<const uint8_t*>(codes),
                                                       static_cast<const float*>(scales),
                                                       static_cast<float*>(out), R, N, cw, rows);
  return static_cast<int>(cudaGetLastError());
}

// ---- ids shape: a warp per query, 32 candidates a warp per pass ----

constexpr int IDS_THREADS = 256;  // 8 warps

__device__ __forceinline__ float entry(const __nv_bfloat16* g, unsigned c) {
  return __uint_as_float(static_cast<unsigned>(reinterpret_cast<const unsigned short*>(g)[c]) << 16);
}
__device__ __forceinline__ float entry(const float* g, unsigned c) { return g[c]; }

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 code bytes of a row from byte k on, zeros past cw: one 16-byte load
// where rows are 16-byte aligned (`aligned`: cw % 16 == 0 and an aligned
// base, so k + 16 <= cw whenever k < cw)
__device__ __forceinline__ uint4 code_bytes(const uint8_t* row, int k, int cw, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(row + k));
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (k + e < cw) v[e >> 2] |= static_cast<unsigned>(row[k + e]) << (8 * (e & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// out[b, c] = sum_i lut_b[i, code(ids[b, c], i)] in order (+inf for an id
// out of range).  CTA: qc queries (one LUT row each, or the one shared row)
// staged once by 16-byte cp.async; warp w serves query w / wq, its lane l
// candidates p * 32 wq + (w % wq) * 32 + l in passes p
// (`ops/adc.py:k8_ids_plan`)
template <typename T>
__global__ void __launch_bounds__(IDS_THREADS)
ids_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ lut, const int32_t* __restrict__ ids,
           float* __restrict__ out, int B, int C, int m, int cw, int packed, long long n_rows, int shared,
           int wq, int qc, int aligned) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_bytes = m * 16 * static_cast<int>(sizeof(T));  // a multiple of 32
  const int q0 = blockIdx.x * qc;
  const int nq = shared ? 1 : min(qc, B - q0);
  const int pieces = row_bytes / 16;
  for (int i = tid; i < nq * pieces; i += IDS_THREADS) {
    const int r = i / pieces, p = i - r * pieces;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(lut) +
                         static_cast<size_t>(shared ? 0 : q0 + r) * row_bytes + p * 16;
    k9::cp_async16(smem + static_cast<size_t>(r) * row_bytes + p * 16, src, 16);
  }
  k9::cp_async_commit();
  k9::cp_async_wait<0>();
  __syncthreads();

  const int qs = warp / wq, ws = warp - (warp / wq) * wq, b = q0 + qs;
  if (qs >= qc || b >= B) return;
  const T* lq = reinterpret_cast<const T*>(smem + (shared ? 0 : static_cast<size_t>(qs) * row_bytes));
  const int nbytes = packed ? (m + 1) / 2 : m;  // the code bytes that hold the m groups
  const int gpc = packed ? 32 : 16;             // groups per 16 code bytes
  for (int c = ws * 32 + lane; c - lane < C; c += 32 * wq) {
    const int id = c < C ? ids[static_cast<size_t>(b) * C + c] : -1;
    const bool ok = id >= 0 && id < n_rows;
    const uint8_t* row = codes + (ok ? static_cast<long long>(id) * cw : 0);
    float acc = 0.f;
    uint4 cur = ok ? code_bytes(row, 0, cw, aligned) : make_uint4(0u, 0u, 0u, 0u);
    for (int k = 0; k < nbytes; k += 16) {
      // the next 16 code bytes load while these are looked up
      const uint4 nxt = ok && k + 16 < nbytes ? code_bytes(row, k + 16, cw, aligned) : make_uint4(0u, 0u, 0u, 0u);
      const int g0 = (k / 16) * gpc;
      const int gl = min(gpc, m - g0);
      const T* lg = lq + static_cast<size_t>(g0) * 16;
      if (packed) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if (e < gl) acc = __fadd_rn(acc, entry(lg + e * 16, (word(cur, e >> 3) >> (4 * (e & 7))) & 15u));
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (e < gl) acc = __fadd_rn(acc, entry(lg + e * 16, (word(cur, e >> 2) >> (8 * (e & 3))) & 15u));
      }
      cur = nxt;
    }
    if (c < C) out[static_cast<size_t>(b) * C + c] = ok ? acc : INFINITY;
  }
}

template <typename T>
int launch_ids(const void* codes, const void* lut, const void* ids, void* out, int B, int C, int m, int cw,
               int packed, long long n_rows, int shared, int wq, int qc, cudaStream_t stream) {
  if (wq < 1 || qc < 1 || wq * qc > IDS_THREADS / 32) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = cw % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const int smem = m * 16 * static_cast<int>(sizeof(T)) * (shared ? 1 : qc);
  const cudaError_t err = cudaFuncSetAttribute(ids_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ids_kernel<T><<<(B + qc - 1) / qc, IDS_THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const T*>(lut), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), B, C, m, cw, packed, n_rows, shared, wq, qc, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k8

// lut_type: 0 int8 (scales required), 1 bf16, 2 f32.  An int8 LUT with
// packed codes is K8's one-hot wgmma kernel (the wrapper hands it the LUT
// as (R, 32 cw) columns with cw % 4 == 0, m = 2 cw); the rest run the
// lookup body adc_sums_dense_kernel
int launch_dense(const void* codes, const void* lut, const void* scales, void* out, int N, int R,
                 int m, int cw, int packed, int lut_type, cudaStream_t stream) {
  if (lut_type == 0 && packed) {
    if (cw % 4 || m != 2 * cw) return static_cast<int>(cudaErrorInvalidValue);
    return k8::launch_dense_onehot(codes, lut, scales, out, N, R, cw, stream);
  }
  dim3 grid((N + ROWS - 1) / ROWS, (R + RQ - 1) / RQ);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (lut_type == 0)
    adc_sums_dense_kernel<int8_t><<<grid, THREADS, 0, stream>>>(
        cd, static_cast<const int8_t*>(lut), sc, o, N, R, m, cw, packed);
  else if (lut_type == 1)
    adc_sums_dense_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        cd, static_cast<const __nv_bfloat16*>(lut), sc, o, N, R, m, cw, packed);
  else
    adc_sums_dense_kernel<float><<<grid, THREADS, 0, stream>>>(
        cd, static_cast<const float*>(lut), sc, o, N, R, m, cw, packed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vecdb_adc_sums_dense(const void* codes, const void* lut, const void* scales,
                                    void* out, int N, int R, int m, int k, int cw, int packed,
                                    int lut_type, void* stream) {
  if (N <= 0 || R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 16) return launch_dense(codes, lut, scales, out, N, R, m, cw, packed, lut_type, s);
  if (k == 256 && !packed) {  // K9: bf16, or f32 under `exact`
    if (lut_type == 1) return k9::launch_dense<__nv_bfloat16>(codes, lut, out, N, R, m, cw, s);
    if (lut_type == 2) return k9::launch_dense<float>(codes, lut, out, N, R, m, cw, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// wq, qc: K8's plan (ops/adc.py:k8_ids_plan); K9 ignores them
extern "C" int vecdb_adc_sums_ids(const void* codes, const void* lut, const void* ids, void* out,
                                  int B, int C, int m, int k, int cw, int packed,
                                  long long n_rows, int shared, int lut_type, int wq, int qc,
                                  void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (lut_type == 0) return static_cast<int>(cudaErrorInvalidValue);  // ids take bf16 / f32
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 16) {
    if (lut_type == 1)
      return k8::launch_ids<__nv_bfloat16>(codes, lut, ids, out, B, C, m, cw, packed, n_rows, shared, wq, qc, s);
    return k8::launch_ids<float>(codes, lut, ids, out, B, C, m, cw, packed, n_rows, shared, wq, qc, s);
  }
  if (k == 256 && !packed) {
    if (lut_type == 1)
      return k9::launch_ids<__nv_bfloat16>(codes, lut, ids, out, B, C, m, cw, n_rows, shared, s);
    return k9::launch_ids<float>(codes, lut, ids, out, B, C, m, cw, n_rows, shared, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
