// K11: binned PQ-ADC chunk-min over probed posting lists, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_adc.py:adc_chunkmin_binned (Pallas
// body _adc_chunkmin_binned_kernel), row-major codes, chunk 1, 2, 4, 8, 16
// or 32.
//
// What it computes: the IVF-PQ codes are cluster-sorted, list l owning the
// lpad-row segment [l lpad, (l + 1) lpad) of codes (nlist lpad, cw) uint8,
// of which the first lens[l] rows are valid.  Bin column j of list l holds
// query b = bins[l, j] (-1: none).  For every list row x and filled column:
// the ADC distance d of csrc/adc_onehot.cuh with query b's int8 LUT row
// lut[b] (B, Kd), scale scales[b], norm qn[b] (cosine: the int8 cs column),
// +inf where x >= lens[l]; and
//   out_d[l, j, s], out_p[l, j, s] = the min of d over list rows
//       [chunk s, chunk (s + 1)) and the lowest GLOBAL slot l lpad + x that
//       reaches it.
// Empty columns (bins -1) come out +inf with the chunk's first slot; the
// caller never reads them.  The (nlist, QB, lpad / chunk) layout makes a
// query's survivors of one probe a contiguous row (a plain row gather).
//
// What bounds it on the H100: the one-hot product, 2 * nlist * lpad * QB *
// m * 16 int8 operations (~1.1e13 at 10M rows, QB 64, m 320: ~5.5 ms at the
// int8 peak) against ~0.95 ms of device-memory traffic (2.6 GB of codes,
// the survivors).  One CTA per (list, 512-row tile) x 128 bin columns runs
// csrc/adc_onehot.cuh's pipeline over four 128-row sub-tiles.  The LUT rows
// are read through `bins` (the 5 MB int8 LUT stays in L2), not copied per
// list as the reference's (nlist, W, QB) LUT block is; a warp whose 32
// columns hold no query skips the product, and a CTA whose tile lies past
// the list's length, or whose columns are all empty, only writes its +inf
// survivors.  wgmma / TMA and fewer one-hot rebuilds are later work.
//
// Requirements, checked by the wrapper: Kd % 64 == 0, cw % 4 == 0, lpad % 512
// == 0, codes hold at least nlist * lpad rows, contiguous tensors.

#include "adc_onehot.cuh"

namespace {

constexpr int TILE = 512;  // list rows per CTA (the reference's _NT_BIN)

template <int CHUNK>
__global__ void __launch_bounds__(adc::THREADS, adc::MIN_CTAS)
adc_chunkmin_binned_kernel(const uint8_t* __restrict__ codes, const int8_t* __restrict__ lut,
                           const float* __restrict__ scales, const float* __restrict__ qn,
                           const int8_t* __restrict__ cs, float cs_scale,
                           const int32_t* __restrict__ lens, const int32_t* __restrict__ bins,
                           float* __restrict__ out_d, int32_t* __restrict__ out_p, int lpad, int QB,
                           int cw, int mk, int packed) {
  extern __shared__ __align__(16) uint8_t smem[];
  const adc::Tile tl(smem, mk, cs != nullptr);
  const int tiles = lpad / TILE;
  const int l = blockIdx.x / tiles, tt = blockIdx.x % tiles;
  const int c0 = blockIdx.y * adc::BN;  // first bin column of this CTA
  const int x0 = tt * TILE;             // first list row of this CTA
  const long long slot0 = static_cast<long long>(l) * lpad + x0;
  const int len = lens[l];
  const int SL = lpad / CHUNK;
  const int Kd = mk * 16;
  const int* lbins = bins + static_cast<size_t>(l) * QB;

  int live = 0;
  for (int r = threadIdx.x; r < adc::BN; r += adc::THREADS) {
    const int b = c0 + r < QB ? lbins[c0 + r] : -1;
    tl.rows[r] = b >= 0 ? lut + static_cast<size_t>(b) * Kd : nullptr;
    live |= b >= 0;
  }
  if (!__syncthreads_or(live) || x0 >= len) {
    // every row masked, or no query: +inf survivors at each chunk's first slot
    const int cols = min(adc::BN, QB - c0);
    for (int i = threadIdx.x; i < cols * (TILE / CHUNK); i += adc::THREADS) {
      const int n = i / (TILE / CHUNK), c = i % (TILE / CHUNK);
      const size_t o = (static_cast<size_t>(l) * QB + c0 + n) * SL + tt * (TILE / CHUNK) + c;
      out_d[o] = INFINITY;
      out_p[o] = static_cast<int>(slot0 + c * CHUNK);
    }
    return;
  }

  float q_s[4][2], q_n[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = c0 + adc::lane_col(nt, j);
      const int b = col < QB ? lbins[col] : -1;
      q_s[nt][j] = b >= 0 ? scales[b] : 0.f;
      q_n[nt][j] = b >= 0 ? qn[b] : 0.f;
    }

  adc::chunkmin_scan<CHUNK, true>(
      tl, codes + slot0 * cw, TILE, TILE / adc::BM, cw, mk, packed != 0, cs, cs_scale, q_s, q_n,
      [&](int r) { return tl.rows[r]; },
      [&](int x) { return x0 + x < len; },
      [&](int x) { return static_cast<int>(slot0 + x); },
      [&](int c, int n, float d, int p) {
        if (c0 + n >= QB) return;
        const size_t o = (static_cast<size_t>(l) * QB + c0 + n) * SL + tt * (TILE / CHUNK) + c;
        const bool filled = tl.rows[n] != nullptr;
        out_d[o] = filled ? d : INFINITY;
        out_p[o] = filled ? p : static_cast<int>(slot0 + c * CHUNK);
      });
}

template <int CHUNK>
struct Launch {
  static int run(const void* codes, const void* lut, const void* scales, const void* qn,
                 const void* cs, float cs_scale, const void* lens, const void* bins, void* out_d,
                 void* out_p, int nlist, int lpad, int QB, int cw, int mk, int packed,
                 void* stream) {
    const size_t smem = adc::smem_bytes(mk, cs != nullptr);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          adc_chunkmin_binned_kernel<CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dim3 grid(nlist * (lpad / TILE), (QB + adc::BN - 1) / adc::BN);
    adc_chunkmin_binned_kernel<CHUNK>
        <<<grid, adc::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(lut),
            static_cast<const float*>(scales), static_cast<const float*>(qn),
            static_cast<const int8_t*>(cs), cs_scale, static_cast<const int32_t*>(lens),
            static_cast<const int32_t*>(bins), static_cast<float*>(out_d),
            static_cast<int32_t*>(out_p), lpad, QB, cw, mk, packed);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" int vecdb_adc_chunkmin_binned(const void* codes, const void* lut, const void* scales,
                                         const void* qn, const void* cs, float cs_scale,
                                         const void* lens, const void* bins, void* out_d,
                                         void* out_p, int nlist, int lpad, int QB, int cw, int mk,
                                         int packed, int chunk, void* stream) {
  if (nlist <= 0 || QB <= 0) return 0;
  return adc::dispatch_chunk<Launch>(chunk, codes, lut, scales, qn, cs, cs_scale, lens, bins,
                                     out_d, out_p, nlist, lpad, QB, cw, mk, packed, stream);
}
