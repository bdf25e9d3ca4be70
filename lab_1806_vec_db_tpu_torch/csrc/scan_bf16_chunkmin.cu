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
// so the outputs are (B, N_pad/128) f32 and int32 global row ids, the
// reference's layout; rows in [N, N_pad) are zero rows with cache 0, and a
// chunk wholly past n_valid gives (+inf, its first row).  The (B, N)
// distance matrix never reaches device memory.
//
// What bounds it on the H100: the bf16 products, 2 B N D operations (1.92e12
// at N = 1M, B = 1000, D = 960: 1.94 ms at the card's dense bf16 rate)
// against 1.9 GB of rows (0.58 ms), and behind them the L2 reads that feed
// the tensor cores: every query tile reads every row.  The design:
//
// - A CTA takes 128 queries and walks 128-row chunks (the wgmma N): chunks
//   y, y + G, ... of its query tile (`ops/scan_resident.py:k12_plan`); the
//   query tiles of one chunk run together and share its rows in L2.  One
//   producer thread (warpgroup 0) streams by TMA, warpgroups 1 and 2
//   consume: consumer p owns queries 64 p ... 64 p + 63 (the wgmma M) of
//   every chunk.
// - 128 queries x 960 bf16 lanes (245,760 bytes) do not fit the 232,448
//   bytes a block may use.  So queries 0-63 stay resident (15 boxes of 64 x
//   128 bytes, loaded once, 128-byte swizzle) and each ring stage carries,
//   beside one 128-byte box of the chunk's 128 rows (two 64-row TMA boxes),
//   the same box of queries 64-127: 24 KB a stage, four stages, one ring that
//   both consumers release.  The rows then cross L2 once per 128 queries and
//   the streamed queries add half that: 23 GB at flat_1m where 64 resident
//   queries alone read 30.7 GB.  Both that layout and a 2-CTA cluster
//   multicasting the rows to two 64-query CTAs (which stalled on its paired
//   releases) measured slower on an H100 (PERF.md §6).  Past 960 lanes
//   both query boxes stream.
// - Each box runs wgmma.mma_async m64n128k16 f32.bf16.bf16 over its four
//   k16 steps, A (queries) and B (rows) both from shared memory, K-major.
// - Accuracy.  The tensor cores add into an f32 accumulator with truncation,
//   so one accumulator carried through all 60 k16 steps of a 960-lane row
//   drifts low by tens of ulps (on an H100: cosine survivors up to 4.6e-5
//   relative off), and d = |q|^2 + |x|^2 - 2 dot cancels.  So the products
//   of CBOX = 3 boxes (12 k16 steps, 192 lanes) sum into a partial that is
//   added to the running sum in round-to-nearest f32 with Kahan
//   compensation, the compensation carried in the partial itself: after
//   s' = s + p the partial's registers take p - (s' - s), the part of p that
//   s' lost, and the next partial's wgmmas accumulate onto it.  A consumer
//   then holds 64 partial and 64 sum registers, no third set (ptxas gives
//   168 registers a thread at 384 threads), and within a partial one box's
//   products stay in flight while the next box's issue.  Shorter partials
//   (1 or 2 boxes) were slower on an H100 and no more needed: at 3 boxes
//   the largest survivor error is a third of the tolerance (PERF.md §6).
//   The plain version (scan_chunkmin_ref) sums the exact products in
//   float64 and rounds once; distances agree to rtol 1e-5 / atol 1e-6, ids
//   except where two rows of a chunk lie within that of each other.  The epilogue rounds
//   each operation on its own (__fdiv_rn, not the fast division).
// - wgmma's accumulator layout puts a query on each lane's rows (16 w + g,
//   16 w + g + 8) and a chunk's 128 rows across a quad's 4 lanes (columns
//   8 nt + 2 t + j), so the chunk-min is 32 in-register (d, row) minima
//   and two quad shuffles: no shared-memory exchange.
//
// Requirements, checked by the Python wrapper: D % 8 == 0 (TMA's row
// stride: 16 bytes), 16-byte aligned contiguous tensors, N_pad % 128 == 0.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_wgmma.cuh"

namespace {

using k7::keep_min;
using k7::mbar_arrive;
using k7::mbar_expect_tx;
using k7::mbar_init;
using k7::smem_u32;

constexpr int CHUNK = 128;            // rows per survivor (the wgmma N)
constexpr int BQ = 64;                // queries per consumer (the wgmma M)
constexpr int QT = 2 * BQ;            // queries per CTA
constexpr int BK = 64;                // bf16 lanes per box (one 128-byte swizzle row)
constexpr int HALF = 64;              // rows per TMA box: two make a stage's rows
constexpr int HALF_BOX = HALF * 128;  // 8 KB
constexpr int ROW_BOX = CHUNK * 128;  // 16 KB
constexpr int Q_BOX = BQ * 128;       // 8 KB
constexpr int RESIDENT_KT = 15;       // boxes of the resident query half: D <= 960
constexpr int CBOX = 3;               // boxes (of 64 lanes) per compensated partial
constexpr int CONSUMERS = 256;        // warpgroups 1 and 2
constexpr int THREADS = 128 + CONSUMERS;
constexpr int SMEM_MAX = 232448;

struct Layout {
  int resident, stage, ring;
  size_t qres, chan, bars, bytes;
};

// shared memory, after a 1024-byte alignment pad: the resident query half,
// the ring (a stage: the rows' box, then the streamed query box(es)), each
// consumer's two 128-float cache buffers, the 128 query caches, the full /
// empty / query mbarriers
__host__ __device__ inline Layout layout(int KT) {
  Layout L;
  L.resident = KT <= RESIDENT_KT;
  L.stage = ROW_BOX + (L.resident ? 1 : 2) * Q_BOX;
  L.qres = L.resident ? static_cast<size_t>(KT) * Q_BOX : 0;
  const size_t fixed = 1024 + L.qres + (4 * CHUNK + QT) * 4 + 8;
  L.ring = static_cast<int>((SMEM_MAX - fixed) / (L.stage + 16));
  if (L.ring > 8) L.ring = 8;
  L.chan = L.qres + static_cast<size_t>(L.ring) * L.stage;
  L.bars = L.chan + (4 * CHUNK + QT) * 4;
  L.bytes = 1024 + L.bars + (2 * L.ring + 1) * 8;
  return L;
}

template <bool COSINE>
__global__ void __launch_bounds__(THREADS, 1)
scan_bf16_chunkmin_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap r_map,
                          const float* __restrict__ qc, const float* __restrict__ cache,
                          float* __restrict__ out_d, int32_t* __restrict__ out_i, int B, int N, int KT,
                          int n_valid, int S) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  const Layout L = layout(KT);
  uint8_t* qres = base;
  uint8_t* ring = base + L.qres;
  float* cache_s = reinterpret_cast<float*>(base + L.chan);  // consumer p, chunk parity e: (2 p + e) * 128
  float* qc_s = cache_s + 4 * CHUNK;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + L.ring;
  uint64_t* qbar = empty + L.ring;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * QT;

  if (tid == 0) {
    for (int i = 0; i < L.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < QT; i += THREADS) qc_s[i] = n0 + i < B ? qc[n0 + i] : 0.f;
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: thread 0 streams
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      if (L.resident) {
        mbar_expect_tx(qbar, KT * Q_BOX);
        for (int kt = 0; kt < KT; ++kt) k7::tma_load(qres + kt * Q_BOX, &q_map, kt * BK, n0, qbar);
      }
      int it = 0;
      for (int c = blockIdx.y; c < S; c += gridDim.y) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int slot = it % L.ring;
          if (it >= L.ring) scan::wait(&empty[slot], ((it / L.ring) - 1) & 1);
          uint8_t* st = ring + slot * L.stage;
          mbar_expect_tx(&full[slot], L.stage);
          k7::tma_load(st, &r_map, kt * BK, c * CHUNK, &full[slot]);
          k7::tma_load(st + HALF_BOX, &r_map, kt * BK, c * CHUNK + HALF, &full[slot]);
          k7::tma_load(st + ROW_BOX, &q_map, kt * BK, n0 + BQ, &full[slot]);
          if (!L.resident) k7::tma_load(st + ROW_BOX + Q_BOX, &q_map, kt * BK, n0, &full[slot]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128;
  const int p = ct >> 7, warp = (ct >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float qcv[2] = {qc_s[BQ * p + 16 * warp + g], qc_s[BQ * p + 16 * warp + g + 8]};
  if (L.resident) scan::wait(qbar, 0);

  float part[64], sum[64];
  int it = 0, kc = 0;  // boxes, chunks
  for (int c = blockIdx.y; c < S; c += gridDim.y, ++kc) {
    const int row0 = c * CHUNK;
    const int r = row0 + (ct & 127);
    const float cv = r < N ? __ldg(cache + r) : 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    for (int kt0 = 0; kt0 < KT; kt0 += CBOX) {  // one compensated partial: up to CBOX boxes
      const int kend = min(kt0 + CBOX, KT);
      k7::wgmma_fence();  // the Kahan step wrote the partial's registers
      scan::fence_acc(part);
      int prev = -1;  // the stage of the box before, whose products may still be in flight
      for (int kt = kt0; kt < kend; ++kt, ++it) {
        const int slot = it % L.ring;
        scan::wait(&full[slot], static_cast<unsigned>((it / L.ring) & 1));
        const uint8_t* st = ring + slot * L.stage;
        // queries 0-63: resident (or the stage's second query box), 64-127: the stage's first
        const uint8_t* qa = p ? st + ROW_BOX : L.resident ? qres + kt * Q_BOX : st + ROW_BOX + Q_BOX;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          scan::wgmma_bf16(part, k7::desc_sw128(qa + 32 * kk), k7::desc_sw128(st + 32 * kk), kt | kk);
        k7::wgmma_commit();
        if (prev >= 0) {  // the box before has completed: free its stage
          k7::wgmma_wait<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = slot;
      }
      k7::wgmma_wait<0>();
      scan::fence_acc(part);
      mbar_arrive(&empty[prev]);
      // s' = s + p; the partial keeps p - (s' - s), what s' lost
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float s2 = __fadd_rn(sum[i], part[i]);
        part[i] = __fsub_rn(part[i], __fsub_rn(s2, sum[i]));
        sum[i] = s2;
      }
    }

    // the chunk's survivor for each of this lane's two queries: rows
    // row0 + 8 nt + 2 t + j in ascending order, then the quad
    float* cs = cache_s + (2 * p + (kc & 1)) * CHUNK;
    cs[ct & 127] = cv;
    scan::named_sync(1 + p, 128);
    float best[2] = {CUDART_INF_F, CUDART_INF_F};
    int brow[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + t * 2 + j;
        const int row = row0 + col;
        const float ca = cs[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dot = sum[nt * 4 + 2 * h + j];
          float d;
          if (COSINE) {
            d = __fsub_rn(1.f, __fdiv_rn(dot, fmaxf(__fmul_rn(qcv[h], ca), 1e-10f)));
          } else {
            d = __fsub_rn(__fadd_rn(qcv[h], ca), __fmul_rn(2.f, dot));
          }
          keep_min(best[h], brow[h], row < n_valid ? d : CUDART_INF_F, row);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1)
        keep_min(best[h], brow[h], __shfl_xor_sync(0xffffffffu, best[h], off),
                 __shfl_xor_sync(0xffffffffu, brow[h], off));
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = n0 + BQ * p + 16 * warp + g + 8 * h;
        if (q < B) {
          out_d[static_cast<size_t>(q) * S + c] = best[h];
          out_i[static_cast<size_t>(q) * S + c] = brow[h];
        }
      }
    }
  }
}

}  // namespace

// grid: (ceil(B / 128) query tiles, ctas CTAs each); N rows of the base (a
// multiple of 8 lanes wide: D % 8 == 0), n_pad = S * 128 >= N
extern "C" int vecdb_scan_bf16_chunkmin(const void* q, const void* qc, const void* base, const void* cache,
                                        void* out_d, void* out_i, int B, int N, int n_pad, int D, int n_valid,
                                        int cosine, int ctas, void* stream) {
  if (B <= 0 || n_pad <= 0) return 0;
  if (N <= 0 || D <= 0 || D % 8 || n_pad % CHUNK || N > n_pad || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, r_map;
  if (scan::tensor_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, D, B, 2LL * D, BK, BQ) != CUDA_SUCCESS ||
      scan::tensor_map(&r_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, D, N, 2LL * D, BK, HALF) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int KT = (D + BK - 1) / BK;
  const Layout L = layout(KT);
  if (L.ring < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = cosine ? scan_bf16_chunkmin_kernel<true> : scan_bf16_chunkmin_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((B + QT - 1) / QT, ctas);
  kern<<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, r_map, static_cast<const float*>(qc), static_cast<const float*>(cache), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), B, N, KT, n_valid, n_pad / CHUNK);
  return static_cast<int>(cudaGetLastError());
}
