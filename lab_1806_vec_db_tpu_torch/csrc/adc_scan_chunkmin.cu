// K7: PQ-ADC scan fused with a chunk-min, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_adc.py:adc_scan_chunkmin (Pallas
// body _adc_chunkmin_kernel), row-major codes, chunk 1, 2, 4, 8, 16 or 32.
//
// What it computes, for the PERMUTED codes (N, cw) uint8 (4-bit codes packed
// two per byte, low nibble first, when `packed`), the per-query int8 LUT
// lut (B, Kd) with Kd = mk * 16 (column g*16 + v holds group g, code v; zero
// columns for groups past m), the per-query scales (B,) and, for cosine, the
// int8 centroid-sqnorm column cs (Kd,) with its scale and the query norms:
// the ADC distance d[x, b] of csrc/adc_onehot.cuh, +inf where x >= n_valid,
// and out_d[b, s], out_p[b, s] = the min of d over rows x in
// [chunk s, chunk (s + 1)) and the lowest x that reaches it.
//
// The wrapper (ops/adc.py) quantizes the LUT as _prep_lut_quant does, takes
// the top-k over the (B, S) survivors and decodes positions through the
// permutation.
//
// What bounds it on the H100: the one-hot product.  The ADC sum is a
// (rows, Kd) one-hot x (Kd, B) int8 product: 2 * N * B * m * 16 int8
// operations (1.02e13 at N = 1M, B = 1000, m = 320) against N * cw + B * Kd
// bytes of input, so the tensor cores bound it, not the memory.  The
// pipeline is csrc/adc_onehot.cuh's (K1's mma.sync m16n8k32 s8 pipeline
// with the A operand generated in registers from the code nibbles): each
// CTA owns 128 queries and a 2048-row chunk of 16 sub-tiles.  The chunk
// size is a template parameter: the chunk-min stays in registers and warp
// shuffles, so the (N, B) matrix never reaches device memory; a smaller
// chunk only writes more survivors (B * N / chunk).  wgmma / TMA are later
// work.
//
// Requirements, checked by the wrapper: Kd % 64 == 0, cw % 4 == 0 (zero
// padding bytes), mk >= number of groups the code bytes hold, contiguous
// tensors, ceil(N / 2048) <= 65535, S = ceil(N / 256) * 256 / chunk.

#include "adc_onehot.cuh"

namespace {

constexpr int CHUNK_ROWS = 2048;  // rows per CTA
constexpr int SUBTILES = CHUNK_ROWS / adc::BM;

template <int CHUNK>
__global__ void __launch_bounds__(adc::THREADS, adc::MIN_CTAS)
adc_chunkmin_kernel(const uint8_t* __restrict__ codes, const int8_t* __restrict__ lut,
                    const float* __restrict__ scales, const float* __restrict__ qn,
                    const int8_t* __restrict__ cs, float cs_scale, float* __restrict__ out_d,
                    int32_t* __restrict__ out_p, int B, int N, int n_valid, int cw, int mk, int S,
                    int packed) {
  extern __shared__ __align__(16) uint8_t smem[];
  const adc::Tile tl(smem, mk, cs != nullptr);
  const int n0 = blockIdx.x * adc::BN;
  const long long row0 = static_cast<long long>(blockIdx.y) * CHUNK_ROWS;
  const int Kd = mk * 16;

  float q_s[4][2], q_n[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + adc::lane_col(nt, j);
      q_s[nt][j] = n < B ? scales[n] : 0.f;
      q_n[nt][j] = n < B ? qn[n] : 0.f;
    }

  // sub-tiles up to the survivors' n_pad = S * CHUNK rows (a multiple of 256)
  const long long n_pad = static_cast<long long>(S) * CHUNK;
  const long long left = (n_pad - row0 + adc::BM - 1) / adc::BM;
  const int n_sub = left < SUBTILES ? static_cast<int>(left) : SUBTILES;
  adc::chunkmin_scan<CHUNK, false>(
      tl, codes + row0 * cw, N - row0, n_sub, cw, mk, packed != 0, cs, cs_scale, q_s, q_n,
      [&](int r) { return n0 + r < B ? lut + static_cast<size_t>(n0 + r) * Kd : nullptr; },
      [&](int x) { return row0 + x < n_valid; },
      [&](int x) { return static_cast<int>(row0 + x); },
      [&](int c, int n, float d, int p) {
        const long long chunk = row0 / CHUNK + c;
        const int q = n0 + n;
        if (q < B && chunk < S) {
          out_d[static_cast<size_t>(q) * S + chunk] = d;
          out_p[static_cast<size_t>(q) * S + chunk] = p;
        }
      });
}

template <int CHUNK>
struct Launch {
  static int run(const void* codes, const void* lut, const void* scales, const void* qn,
                 const void* cs, float cs_scale, void* out_d, void* out_p, int B, int N,
                 int n_valid, int cw, int mk, int S, int packed, void* stream) {
    const size_t smem = adc::smem_bytes(mk, cs != nullptr);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          adc_chunkmin_kernel<CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dim3 grid((B + adc::BN - 1) / adc::BN, (N + CHUNK_ROWS - 1) / CHUNK_ROWS);
    adc_chunkmin_kernel<CHUNK><<<grid, adc::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(lut),
        static_cast<const float*>(scales), static_cast<const float*>(qn),
        static_cast<const int8_t*>(cs), cs_scale, static_cast<float*>(out_d),
        static_cast<int32_t*>(out_p), B, N, n_valid, cw, mk, S, packed);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int vecdb_adc_chunkmin(const void* codes, const void* lut, const void* scales,
                                  const void* qn, const void* cs, float cs_scale, void* out_d,
                                  void* out_p, int B, int N, int n_valid, int cw, int mk, int S,
                                  int packed, int chunk, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  return adc::dispatch_chunk<Launch>(chunk, codes, lut, scales, qn, cs, cs_scale, out_d, out_p, B,
                                     N, n_valid, cw, mk, S, packed, stream);
}
