// K10: segmented (binned) int8 group-min scan for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_scan.py:scan_chunkmin_int8_binned
// (Pallas bodies _scan_kernel_int8_binned and _scan_kernel_int8_binned_bc,
// which differ only in the TPU channel layout).
//
// The binned IVF search scans each posting list ONCE against the block of
// (up to) QB = 128 queries that probe it.  Inputs: the int8 queries q8
// (B_pad, D) with their channels qs2 / qc (B_pad,), the per-list query bins
// (nlist, 128) int32 (-1 on empty slots), and the cluster-sorted int8 mirror
// base (>= nlist * lpad, D) with its channels scale / cache.  List l owns
// mirror rows [l * lpad, (l + 1) * lpad); pad rows carry scale 0 and cache
// +BIG, so no row needs a mask.  For 512-row tile T of list l:
//
//   q(c)      = max(bins[l, c], 0)            (an empty slot scores query 0,
//                                              like the reference; the caller
//                                              never reads it back)
//   dot[x, c] = sum_k base[x, k] * q8[q(c), k]                  (exact int32)
//   d[x, c]   = (cache[x] + qc[q(c)]) - float(dot) * (scale[x] * qs2[q(c)]),
//               the multiply-subtract fused (one rounding)
//   out[T*128 + s, c] = int32 min over level = 0..3 of
//                       (bits(d) & ~3) | level   at row x = T*512 + level*128 + s
//
// so out is (nlist * lpad / 4, 128) int32, the reference's layout exactly.
// Only rows below nlist * lpad are read: the ingest-sorted lean mirror keeps
// its overflow segment and capacity padding after them.
//
// What bounds it on the H100: memory.  Each list is read once for its 128
// queries (2 * 128 int8 operations per mirror byte, under the card's ~590
// int8 operations per HBM byte), and the (R/4, 128) int32 output adds 128
// bytes per mirror row: at ivf_1m's R = 1,179,648 rows of 1024 bytes the
// floor is 0.395 ms.  The design (K1's pipeline, csrc/scan_int8_packed.cu):
//
// - A CTA walks a contiguous run of the nlist * lpad / 512 tiles
//   (`ops/scan_binned.py:k10_plan`: one wave of CTAs, each with an equal
//   share of tiles, so a list is split where whole lists would leave SMs
//   idle).  Warpgroups 0 and 1 consume, warps 8 and 9 produce: 320 threads,
//   so ptxas may give each thread 200 registers (at 384 threads it gives 168
//   and the consumers' 64 accumulators and 64 minima spilled).
// - B (the bin's 128 queries).  TMA cannot gather, so lanes 1-31 of the
//   producer warps copy each query row through `bins` with 16-byte cp.async
//   into the layout TMA's 128-byte swizzle would give a 128 x 128-byte box
//   (16-byte chunk j of row n at chunk j ^ (n % 8): `ops/scan.py:
//   k1_stage_offset`), zero past D, and arrive on an mbarrier.  Where D <= 1024 the 128 x D tile stays resident
//   for the CTA's run of tiles of one list and is gathered again only where
//   the run crosses into the next list (after both consumers release it);
//   past 1024 lanes each ring stage carries its gathered query box beside
//   its mirror box (all 32 lanes of the consumer's producer warp gather it).
// - A (the mirror rows).  Lane 0 of warp 8 + p streams consumer p's 64-row x
//   128-byte boxes by TMA into that consumer's own ring of stages under full
//   / empty mbarriers.  A mirror width that is not a multiple of 128 bytes
//   reads as zeros past the tensor map's width (TMA's fill), so the mirror
//   is never copied.
// - The group-min needs no exchange: a 512-row tile holds eight 64-row
//   wgmma tiles, tile j covering level j / 2 and slots (j % 2) * 64 ... + 63.
//   Consumer p takes the tiles j % 2 == p, issues wgmma.mma_async
//   m64n128k32 s32.s8.s8 (both operands from shared memory, K-major), folds
//   each level into a running minimum held in the same accumulator
//   positions, and stores its 64 x 128 int32 survivors once per 512-row tile.
// - Memory: the ring takes what the resident query tile leaves of the 227
//   KB: at D = 1024 eleven 8 KB stages (five per consumer), up to 80 KB in
//   flight per SM.  Holding 3.35 TB/s on 132 SMs needs ~25 GB/s an SM, so
//   80 KB covers ~3 us of memory latency, several times its loaded value.
//
// The epilogue fuses the multiply-subtract into one rounding (__fmaf_rn),
// which is how XLA computes the reference's body (its interpret mode agrees
// element for element); the plain version scan_chunkmin_int8_binned_ref
// emulates that single rounding exactly, so the output equals it bit for bit.
// float(dot) is exact: |dot| <= D * 127^2 < 2^24 for D <= 1040.
//
// Requirements, checked by the Python wrapper: lpad % 512 == 0, D % 16 == 0
// (TMA's row stride), a 16-byte aligned mirror and queries, contiguous
// tensors.  The caller guarantees every bins value lies in [-1, B_pad)
// (binning.bin_queries builds them so); the wrapper does not read bins back,
// which would stall the host on every search.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_wgmma.cuh"

namespace {

using k7::mbar_arrive;
using k7::mbar_expect_tx;
using k7::mbar_init;
using k7::smem_u32;

constexpr int TILE_ROWS = 512;  // _NB_BIN: one grid step of the reference
constexpr int LEVELS = 4;       // _GS: rows per survivor group, the 2 packed low bits
constexpr int QB = 128;         // queries per list bin (the wgmma N)
constexpr int BM = 64;          // mirror rows per wgmma tile (the wgmma M)
constexpr int BK = 128;         // bytes of depth per box (one 128-byte swizzle row)
constexpr int A_BOX = BM * BK;  // 8 KB
constexpr int Q_BOX = QB * BK;  // 16 KB
constexpr int RESIDENT_KT = 8;  // boxes of the resident query tile: D <= 1024
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int THREADS = CONSUMERS + 64;  // warps 8 and 9 produce
constexpr int GATHER = 62;      // lanes 1-31 of both gather the resident query tile
constexpr int SMEM_MAX = 232448;

struct Layout {
  int resident, stage, ring;
  size_t qres, chan, bars, bytes;
};

// shared memory, after a 1024-byte alignment pad: the resident query tile,
// the ring, each consumer's 2 x 128 query channels, the full / empty /
// query-full / query-empty mbarriers
__host__ __device__ inline Layout layout(int KT) {
  Layout L;
  L.resident = KT <= RESIDENT_KT;
  L.stage = A_BOX + (L.resident ? 0 : Q_BOX);
  L.qres = L.resident ? static_cast<size_t>(KT) * Q_BOX : 0;
  const size_t fixed = 1024 + L.qres + 4 * QB * 4 + 16;
  L.ring = static_cast<int>((SMEM_MAX - fixed) / (L.stage + 16));
  if (L.ring > 16) L.ring = 16;
  L.chan = L.qres + static_cast<size_t>(L.ring) * L.stage;
  L.bars = L.chan + 4 * QB * 4;
  L.bytes = 1024 + L.bars + (2 * L.ring + 2) * 8;
  return L;
}

// the multiply-subtract fused and rounded once, as XLA computes the
// reference's Pallas body
__device__ __forceinline__ float epilogue_fms(int dot, float ca, float qc, float sc, float qs) {
  return __fmaf_rn(-__int2float_rn(dot), __fmul_rn(sc, qs), __fadd_rn(ca, qc));
}

// box kt (128 bins x 128 bytes) of list l's query tile into `dst` in the
// 128-byte swizzle, threads i0, i0 + step, ... of the copy; zero past D
__device__ __forceinline__ void gather_box(uint8_t* dst, const int8_t* __restrict__ q8,
                                           const int32_t* __restrict__ bins, int l, int kt, int D,
                                           int i0, int step) {
  for (int i = i0; i < QB * 8; i += step) {
    const int n = i >> 3, j = i & 7;
    const int q = max(__ldg(bins + static_cast<size_t>(l) * QB + n), 0);
    const int col = kt * BK + 16 * j;
    const bool in = col < D;
    scan::cp_async16(dst + n * BK + ((j ^ (n & 7)) << 4), in ? q8 + static_cast<size_t>(q) * D + col : q8,
                     in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
scan_int8_binned_kernel(const __grid_constant__ CUtensorMap a_map, const int8_t* __restrict__ q8,
                        const float* __restrict__ qs2, const float* __restrict__ qc,
                        const int32_t* __restrict__ bins, const float* __restrict__ scale,
                        const float* __restrict__ cache, int32_t* __restrict__ out, int D, int KT,
                        int tiles_per_list, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  const Layout L = layout(KT);
  uint8_t* qres = base;
  uint8_t* ring = base + L.qres;
  float* chan = reinterpret_cast<float*>(base + L.chan);  // consumer p: qs2 at 2 p QB, qc at (2 p + 1) QB
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);  // consumer p's slots p * rc ...
  uint64_t* empty = full + L.ring;
  uint64_t* qfull = empty + L.ring;
  uint64_t* qempty = qfull + 1;

  const int tid = threadIdx.x;
  const int rc = L.ring / 2;  // stages a consumer's own ring holds
  // this CTA's run of tiles (tile G: list G / tiles_per_list, rows G * 512 ...)
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);

  if (tid == 0) {
    for (int i = 0; i < L.ring; ++i) {
      mbar_init(&full[i], L.resident ? 1 : 1 + 32);  // TMA's arrival (+ the gathering warp's)
      mbar_init(&empty[i], 128);
    }
    mbar_init(qfull, GATHER);
    mbar_init(qempty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warps
    const int p = (tid - CONSUMERS) >> 5, lane = tid & 31;
    if (lane == 0 || !L.resident) {  // warp 8 + p feeds consumer p's ring
      int it = 0;
      for (int G = t0; G < t1; ++G) {
        const int l = G / tiles_per_list;
        for (int lev = 0; lev < LEVELS; ++lev) {
          const int row = G * TILE_ROWS + (2 * lev + p) * BM;
          for (int kt = 0; kt < KT; ++kt, ++it) {
            const int slot = p * rc + it % rc;
            if (it >= rc) scan::wait(&empty[slot], ((it / rc) - 1) & 1);
            uint8_t* st = ring + slot * L.stage;
            if (lane == 0) {
              mbar_expect_tx(&full[slot], A_BOX);
              k7::tma_load(st, &a_map, kt * BK, row, &full[slot]);
            }
            if (!L.resident) {
              gather_box(st + A_BOX, q8, bins, l, kt, D, lane, 32);
              scan::cp_async_arrive(&full[slot]);
            }
          }
        }
      }
    } else {  // the other lanes gather the resident tile of each list of the run
      const int gt = p * 31 + lane - 1;
      int seg = 0;
      for (int G = t0, cur = -1; G < t1; ++G) {
        const int l = G / tiles_per_list;
        if (l == cur) continue;
        cur = l;
        if (seg > 0) scan::wait(qempty, (seg - 1) & 1);  // both consumers are done with the last list
        for (int kt = 0; kt < KT; ++kt) gather_box(qres + kt * Q_BOX, q8, bins, l, kt, D, gt, GATHER);
        scan::cp_async_arrive(qfull);
        ++seg;
      }
    }
    return;
  }

  const int p = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* qs_s = chan + 2 * p * QB;
  float* qc_s = qs_s + QB;

  int acc[64];
  int32_t mins[64];
  int it = 0;  // this consumer's box count: box it is in slot p * rc + it % rc
  int seg = 0;
  for (int G = t0, cur = -1; G < t1; ++G) {
    const int l = G / tiles_per_list;
    if (l != cur) {  // a new list: its bins' channels, and (resident) its query tile
      cur = l;
      if (L.resident && seg > 0) mbar_arrive(qempty);
      scan::named_sync(1 + p, 128);  // this warpgroup no longer reads the last list's channels
      const int q = max(__ldg(bins + static_cast<size_t>(l) * QB + (tid & 127)), 0);
      qs_s[tid & 127] = __ldg(qs2 + q);
      qc_s[tid & 127] = __ldg(qc + q);
      scan::named_sync(1 + p, 128);
      if (L.resident) {
        scan::wait(qfull, seg & 1);
        scan::fence_proxy_async();
      }
      ++seg;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) mins[i] = 0x7fffffff;
    for (int lev = 0; lev < LEVELS; ++lev) {
      const size_t x = static_cast<size_t>(G) * TILE_ROWS + (2 * lev + p) * BM + 16 * warp + g;
      const float sc[2] = {__ldg(scale + x), __ldg(scale + x + 8)};
      const float ca[2] = {__ldg(cache + x), __ldg(cache + x + 8)};
      k7::wgmma_fence();
      k7::fence_acc(acc);
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int slot = p * rc + it % rc;
        scan::wait(&full[slot], static_cast<unsigned>((it / rc) & 1));
        const uint8_t* st = ring + slot * L.stage;
        if (!L.resident) scan::fence_proxy_async();
        const uint8_t* qb = L.resident ? qres + kt * Q_BOX : st + A_BOX;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          scan::wgmma_s8(acc, k7::desc_sw128(st + 32 * kk), k7::desc_sw128(qb + 32 * kk), kt | kk);
        k7::wgmma_commit();
        if (kt > 0) {  // the previous box's products have completed: free its stage
          k7::wgmma_wait<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = slot;
      }
      k7::wgmma_wait<0>();
      k7::fence_acc(acc);
      mbar_arrive(&empty[prev]);

#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + t * 2 + j;
          const float qs = qs_s[col], qcv = qc_s[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = nt * 4 + 2 * h + j;
            const float d = epilogue_fms(acc[i], ca[h], qcv, sc[h], qs);
            mins[i] = min(mins[i], (__float_as_int(d) & ~(LEVELS - 1)) | lev);
          }
        }
    }
    // slots p * 64 + 16 warp + g + 8 h of tile G; two adjacent columns a store
    int32_t* o = out + (static_cast<size_t>(G) * QB + p * BM + 16 * warp + g) * QB + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(o + 8 * h * QB + 8 * nt) = make_int2(mins[nt * 4 + 2 * h], mins[nt * 4 + 2 * h + 1]);
  }
}

}  // namespace

// grid: `ctas` CTAs, CTA y scanning tiles [y T / ctas, (y + 1) T / ctas) of
// the T = nlist * lpad / 512 tiles
extern "C" int vecdb_scan_int8_binned(const void* q8, const void* qs2, const void* qc, const void* bins,
                                      const void* base, const void* scale, const void* cache, void* out,
                                      int nlist, int lpad, int D, int ctas, void* stream) {
  if (nlist <= 0 || lpad <= 0) return 0;
  if (lpad % TILE_ROWS || D <= 0 || D % 16 || ctas <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(nlist) * lpad;
  if (rows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map;
  if (scan::tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, D, rows, D, BK, BM) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int KT = (D + BK - 1) / BK;
  const Layout L = layout(KT);
  if (L.ring < 4) return static_cast<int>(cudaErrorInvalidValue);  // two stages a consumer
  const cudaError_t err = cudaFuncSetAttribute(scan_int8_binned_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = static_cast<int>(rows / TILE_ROWS);
  scan_int8_binned_kernel<<<ctas, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      a_map, static_cast<const int8_t*>(q8), static_cast<const float*>(qs2), static_cast<const float*>(qc),
      static_cast<const int32_t*>(bins), static_cast<const float*>(scale), static_cast<const float*>(cache),
      static_cast<int32_t*>(out), D, KT, lpad / TILE_ROWS, tiles);
  return static_cast<int>(cudaGetLastError());
}
