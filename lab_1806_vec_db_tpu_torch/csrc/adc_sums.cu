// K8 and K9: PQ-ADC sums, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_adc.py:_adc_sums_v2 (K8, Pallas
// body _adc_kernel_v2, k = 16) and _adc_sums_stepwise (K9, body
// _adc_kernel_stepwise, k = 256): one body, templated on k and on the LUT
// type (int8 with a per-row scale, bf16, or f32).
//
//   sum[r, x] = sum_i lut[r, i, code(x, i)]       i = 0 .. m-1, in order
//
// accumulated in int32 for int8 (then float(sum) * scale[r]) and in f32 for
// bf16 / f32.  Codes are (n_rows, cw) uint8, 4-bit codes packed two per byte
// (low nibble first) when `packed`.  Two launch shapes over that body:
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
// What bounds it on the H100: shared-memory lookups, not bytes.  Each output
// costs m lookups (3.2e2 at m = 320) against m/2 code bytes.  The LUT is
// staged in shared memory by groups of subspaces (a k = 256 bf16 LUT is
// 160 KB per query at m = 320, so it is staged G groups at a time), the
// codes of the tile's rows unpacked and transposed to [group][row], so the
// 32 lanes of a warp read 32 rows' codes as consecutive bytes and look up
// one LUT row's 16-entry group (k = 16: one conflict-free access, the lanes
// only differ in which of 16 consecutive words they read).  Each thread keeps
// RQ_T accumulators (dense) or one (ids) in registers and adds the groups in
// order, so the sums equal the plain versions (ops/adc.py) bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 128;  // dense: code rows per CTA (lane + 32 * (warp % 4))
constexpr int RQ = 32;     // dense: LUT rows per CTA (16 per thread)
constexpr int RQ_T = RQ / 2;
constexpr int IDS_THREADS = 128;  // ids: candidates per pass (one per thread)
constexpr int STAGE_BYTES = 32 * 1024;

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
template <int K, typename T> struct DenseGroups {
  static constexpr int per_stage = STAGE_BYTES / (RQ * K * static_cast<int>(sizeof(T)));
  static constexpr int value = per_stage < 1 ? 1 : per_stage;
};

template <int K, typename T>
__global__ void __launch_bounds__(THREADS)
adc_sums_dense_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ lut,
                      const float* __restrict__ scales, float* __restrict__ out, int N, int R,
                      int m, int cw, int packed) {
  constexpr int G = DenseGroups<K, T>::value;
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

template <int K, typename T>
__global__ void __launch_bounds__(IDS_THREADS)
adc_sums_ids_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ lut,
                    const int32_t* __restrict__ ids, float* __restrict__ out, int C, int m,
                    int cw, int packed, long long n_rows, int shared) {
  // groups per stage: the LUT stage (G x K of T) and the code stage
  // (G x 128 bytes) each within 16 KB
  constexpr int G_LUT = 16 * 1024 / (K * static_cast<int>(sizeof(T)));
  constexpr int G = G_LUT < 128 ? G_LUT : 128;
  using A = typename Acc<T>::type;
  __shared__ __align__(16) T lut_s[G * K];
  __shared__ uint8_t codes_s[G * IDS_THREADS];

  const int b = blockIdx.x, tid = threadIdx.x;
  const T* lut_b = lut + (shared ? 0 : static_cast<size_t>(b) * m * K);
  for (int c0 = 0; c0 < C; c0 += IDS_THREADS) {
    const int c = c0 + tid;
    const int id = c < C ? ids[static_cast<size_t>(b) * C + c] : -1;
    const bool ok = id >= 0 && id < n_rows;
    const uint8_t* row = codes + (ok ? static_cast<long long>(id) * cw : 0);
    A acc = A(0);
    for (int g0 = 0; g0 < m; g0 += G) {
      const int gl = min(G, m - g0);
      for (int i = tid; i < gl * K; i += IDS_THREADS) lut_s[i] = lut_b[static_cast<size_t>(g0) * K + i];
      for (int j = 0; j < gl; ++j) codes_s[j * IDS_THREADS + tid] = ok ? code_at(row, g0 + j, packed) : 0;
      __syncthreads();
      for (int j = 0; j < gl; ++j) acc = add(acc, widen(lut_s[j * K + codes_s[j * IDS_THREADS + tid]]));
      __syncthreads();
    }
    if (c < C) out[static_cast<size_t>(b) * C + c] = ok ? finish(acc, nullptr, 0) : INFINITY;
  }
}

// lut_type: 0 int8 (scales required), 1 bf16, 2 f32
template <int K>
int launch_dense(const void* codes, const void* lut, const void* scales, void* out, int N, int R,
                 int m, int cw, int packed, int lut_type, cudaStream_t stream) {
  dim3 grid((N + ROWS - 1) / ROWS, (R + RQ - 1) / RQ);
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  if (lut_type == 0)
    adc_sums_dense_kernel<K, int8_t><<<grid, THREADS, 0, stream>>>(
        cd, static_cast<const int8_t*>(lut), sc, o, N, R, m, cw, packed);
  else if (lut_type == 1)
    adc_sums_dense_kernel<K, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        cd, static_cast<const __nv_bfloat16*>(lut), sc, o, N, R, m, cw, packed);
  else
    adc_sums_dense_kernel<K, float><<<grid, THREADS, 0, stream>>>(
        cd, static_cast<const float*>(lut), sc, o, N, R, m, cw, packed);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_ids(const void* codes, const void* lut, const void* ids, void* out, int B, int C, int m,
               int cw, int packed, long long n_rows, int shared, int lut_type,
               cudaStream_t stream) {
  const uint8_t* cd = static_cast<const uint8_t*>(codes);
  const int32_t* id = static_cast<const int32_t*>(ids);
  float* o = static_cast<float*>(out);
  if (lut_type == 1)
    adc_sums_ids_kernel<K, __nv_bfloat16><<<B, IDS_THREADS, 0, stream>>>(
        cd, static_cast<const __nv_bfloat16*>(lut), id, o, C, m, cw, packed, n_rows, shared);
  else
    adc_sums_ids_kernel<K, float><<<B, IDS_THREADS, 0, stream>>>(
        cd, static_cast<const float*>(lut), id, o, C, m, cw, packed, n_rows, shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vecdb_adc_sums_dense(const void* codes, const void* lut, const void* scales,
                                    void* out, int N, int R, int m, int k, int cw, int packed,
                                    int lut_type, void* stream) {
  if (N <= 0 || R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 16) return launch_dense<16>(codes, lut, scales, out, N, R, m, cw, packed, lut_type, s);
  if (k == 256) return launch_dense<256>(codes, lut, scales, out, N, R, m, cw, packed, lut_type, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vecdb_adc_sums_ids(const void* codes, const void* lut, const void* ids, void* out,
                                  int B, int C, int m, int k, int cw, int packed,
                                  long long n_rows, int shared, int lut_type, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (lut_type == 0) return static_cast<int>(cudaErrorInvalidValue);  // ids take bf16 / f32
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 16)
    return launch_ids<16>(codes, lut, ids, out, B, C, m, cw, packed, n_rows, shared, lut_type, s);
  if (k == 256)
    return launch_ids<256>(codes, lut, ids, out, B, C, m, cw, packed, n_rows, shared, lut_type, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
