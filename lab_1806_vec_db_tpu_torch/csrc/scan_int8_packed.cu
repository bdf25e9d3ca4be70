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
// What bounds it on the H100: the int8 products, 2 N B D operations (1.9e12
// at N = 1M, B = 1000, D = 960: 0.97 ms at the card's int8 peak) against
// ~1 GB of mirror, and behind them the L2 reads that feed the tensor cores:
// every query tile reads every row, 8.2 GB at that shape, ~1.25 ms of TMA
// feed alone.  With the products and the feed overlapping it runs ~1.7 ms
// there: what is left is the feed's own pace.  Past 1024 lanes each row box
// brings its query box, three times the bytes, and the feed alone sets the
// pace.
// The design:
//
// - A CTA is one tile of 128 queries (the wgmma N) and a run of work items
//   (`ops/scan.py:k1_plan`): an item is one 2048-row chunk, or a 1/2, 1/4 or
//   1/8 part of one where the chunks alone would leave SMs idle (the IVF
//   overflow segments, small batches); items are dealt round-robin to the
//   CTAs of a query tile, so the query tiles of one item run together and
//   share its rows in L2.
// - The query tile stays in shared memory for the CTA's whole run (128 x D
//   bytes, loaded once by TMA in 128-byte boxes with the 128-byte swizzle)
//   where D <= 1024, so the mirror crosses L2 once per query tile and the
//   queries not at all; past 1024 lanes each ring stage carries its query
//   box beside its row box.
// - Warpgroup 0 produces, warpgroups 1 and 2 consume; they take the 64-row
//   tiles in turns.  One thread of warp p streams consumer p's tiles, as
//   64-row x 128-byte boxes of the mirror, by TMA into that consumer's own
//   ring of stages under full / empty mbarriers (one ring shared by both
//   would have a consumer wait on a slot's phase before the other's earlier
//   phase had landed).  Each consumer issues `wgmma.mma_async` m64n128k32 s32.s8.s8 with A (mirror rows)
//   and B (queries) both read from shared memory through descriptors, both
//   K-major as they lie in device memory.  A consumer keeps one box's
//   wgmmas in flight while it waits on the next box's full barrier, and
//   frees a stage once the products that read it have completed; while one
//   consumer runs its epilogue the other's products are in flight.
// - The consumer index is broadcast from lane 0 (`__shfl_sync`), so that
//   ptxas sees it warp-uniform: the tile loop branches on it around the
//   wgmmas, and on a thread-dependent value there ptxas serializes them
//   (its note "wgmma.mma_async instructions are serialized due to program
//   dependence on compiler-inserted WG.AR in divergent path": each wgmma
//   waits for the one before, and products and feed barely overlap: 2.2 ms
//   at the shape above, against ~1.7 ms pipelined).
// - wgmma's accumulator layout is the survivor layout: in a 64-row tile
//   (16-row aligned), warp w holds rows 16 w + g and 16 w + g + 8 of query
//   columns 8 nt + 2 t + j, i.e. level tile_row0 / 16 + w, slots g and
//   g + 8.  The epilogue folds each distance straight into a running
//   minimum in the same register position; at an item's end the two
//   consumers' 4 warps meet in shared memory (int32 atomicMin) and the
//   item's 16 x 128 survivors leave the CTA in coalesced stores (a global
//   atomicMin where an item is part of a chunk: the wrapper fills the
//   output with INT32_MAX first).
//
// The epilogue uses __fadd_rn/__fmul_rn/__fsub_rn in the reference's order
// so nvcc cannot contract it into an FMA: the result matches the plain
// PyTorch version (scan_chunkmin_int8_packed_ref) bit for bit.  float(dot)
// is exact because |dot| <= 1024 * 127^2 < 2^24 (the mirror's 1024 lanes).
//
// Requirements, checked by the Python wrapper: N % 2048 == 0 (the wrapper
// pads with +BIG sentinels), D % 128 == 0, 16-byte aligned contiguous
// tensors; the plan's CTAs per query tile <= 65535.
//
// The exact uint8 stage 1 (`scan_u8_exact_kernel`) has a body of its own,
// csrc/scan_u8_exact.cu: its rows are wgmma's B operand, so that a
// survivor's level-minimum ends in one thread's registers.
//
// It includes csrc/scan_wgmma.cuh (the wgmma shape, shared with K10) and
// through it K7's header for the mbarrier, TMA, descriptor and wgmma fence
// helpers only; K7's kernel is unchanged.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_wgmma.cuh"

namespace {

using k7::mbar_arrive;
using k7::mbar_expect_tx;
using k7::mbar_init;
using k7::mbar_wait;
using k7::smem_u32;

constexpr int CHUNK_ROWS = 2048;  // NB = CB of the reference (_tiles_for)
constexpr int SLOTS = 16;         // survivors per chunk
constexpr int BN = 128;           // queries per CTA (the wgmma N)
constexpr int BM = 64;            // mirror rows per tile (the wgmma M)
constexpr int BK = 128;           // bytes of depth per box (one 128-byte swizzle row)
constexpr int A_BOX = BM * BK;    // 8 KB
constexpr int Q_BOX = BN * BK;    // 16 KB
constexpr int RESIDENT_KT = 8;    // boxes of the resident query tile: D <= 1024
constexpr int THREADS = 384;      // warpgroup 0 produces, 1 and 2 consume
constexpr int SMEM_MAX = 232448;

struct Layout {
  int resident, stage, ring;
  size_t qres, red, chan, bars, bytes;
};

// shared memory, after a 1024-byte alignment pad: the resident query tile,
// the ring, the 16 x 128 int32 reduction, the 2 x 128 query channels, the
// full / empty / query mbarriers
__host__ __device__ inline Layout layout(int KT) {
  Layout L;
  L.resident = KT <= RESIDENT_KT;
  L.stage = A_BOX + (L.resident ? 0 : Q_BOX);
  L.qres = L.resident ? static_cast<size_t>(KT) * Q_BOX : 0;
  const size_t fixed = 1024 + L.qres + SLOTS * BN * 4 + 2 * BN * 4 + 8;
  L.ring = static_cast<int>((SMEM_MAX - fixed) / (L.stage + 16));
  if (L.ring > 16) L.ring = 16;
  L.red = L.qres + static_cast<size_t>(L.ring) * L.stage;
  L.chan = L.red + SLOTS * BN * 4;
  L.bars = L.chan + 2 * BN * 4;
  L.bytes = 1024 + L.bars + (2 * L.ring + 1) * 8;
  return L;
}

__device__ __forceinline__ float epilogue(int dot, float ca, float qc, float sc, float qs) {
  return __fsub_rn(__fadd_rn(ca, qc), __fmul_rn(__int2float_rn(dot), __fmul_rn(sc, qs)));
}

__device__ __forceinline__ void consumers_sync() {  // the 256 consumer threads only
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
scan_int8_packed_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap q_map,
                        const float* __restrict__ qs2, const float* __restrict__ qc,
                        const float* __restrict__ scale, const float* __restrict__ cache,
                        int32_t* __restrict__ out, int B, int KT, int parts, int items, int atomic) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  const Layout L = layout(KT);
  uint8_t* qres = base;
  uint8_t* ring = base + L.qres;
  int32_t* red = reinterpret_cast<int32_t*>(base + L.red);
  float* qs_s = reinterpret_cast<float*>(base + L.chan);
  float* qc_s = qs_s + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);  // two rings: consumer c's slots c * rc ...
  uint64_t* empty = full + L.ring;
  uint64_t* qbar = empty + L.ring;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int part_rows = CHUNK_ROWS / parts;
  const int tiles = part_rows / BM;  // tiles per item (even: 4-32)

  if (tid == 0) {
    for (int i = 0; i < L.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < BN; i += THREADS) {
    qs_s[i] = n0 + i < B ? qs2[n0 + i] : 0.f;
    qc_s[i] = n0 + i < B ? qc[n0 + i] : 0.f;
  }
  for (int i = tid; i < SLOTS * BN; i += THREADS) red[i] = 0x7fffffff;
  __syncthreads();

  const int rc = L.ring / 2;  // stages a consumer's own ring holds
  if (tid < 128) {  // producer warpgroup: lane 0 of warp p feeds consumer p
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0 && L.resident) {
      mbar_expect_tx(qbar, KT * Q_BOX);
      for (int kt = 0; kt < KT; ++kt) k7::tma_load(qres + kt * Q_BOX, &q_map, kt * BK, n0, qbar);
    }
    if ((tid & 31) == 0 && tid < 64) {
      const int p = tid >> 5;
      int it = 0, T = 0;
      for (int item = blockIdx.y; item < items; item += gridDim.y) {
        const int row0 = (item / parts) * CHUNK_ROWS + (item % parts) * part_rows;
        for (int tile = 0; tile < tiles; ++tile, ++T) {
          if ((T & 1) != p) continue;
          for (int kt = 0; kt < KT; ++kt, ++it) {
            const int slot = p * rc + it % rc;
            if (it >= rc) mbar_wait(&empty[slot], ((it / rc) - 1) & 1);
            uint8_t* st = ring + slot * L.stage;
            mbar_expect_tx(&full[slot], L.stage);
            k7::tma_load(st, &a_map, kt * BK, row0 + tile * BM, &full[slot]);
            if (!L.resident) k7::tma_load(st + A_BOX, &q_map, kt * BK, n0, &full[slot]);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128;
  // the consumer index, broadcast from lane 0 so that ptxas sees it
  // warp-uniform: a branch on a thread-dependent value around the wgmmas
  // makes it serialize them (a wait after each)
  const int wg = __shfl_sync(0xffffffffu, ct >> 7, 0), warp = (ct >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (L.resident) mbar_wait(qbar, 0);

  int acc[64];
  int32_t mins[64];
  int T = 0;   // the CTA's tile count: tile T is consumer T % 2's
  int it = 0;  // this consumer's box count: box it is in slot wg * rc + it % rc
  for (int item = blockIdx.y; item < items; item += gridDim.y) {
    const int chunk = item / parts;
    const int prow0 = (item % parts) * part_rows;  // the item's first row within its chunk
#pragma unroll
    for (int i = 0; i < 64; ++i) mins[i] = 0x7fffffff;
    for (int tile = 0; tile < tiles; ++tile, ++T) {
      if ((T & 1) != wg) continue;
      const int crow = prow0 + tile * BM + 16 * warp + g;  // this lane's first row within the chunk
      const size_t x = static_cast<size_t>(chunk) * CHUNK_ROWS + crow;
      float sc[2], ca[2];
      sc[0] = __ldg(scale + x);
      sc[1] = __ldg(scale + x + 8);
      ca[0] = __ldg(cache + x);
      ca[1] = __ldg(cache + x + 8);
      k7::wgmma_fence();
      k7::fence_acc(acc);
      int prev = 0;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int slot = wg * rc + it % rc;
        mbar_wait(&full[slot], static_cast<unsigned>((it / rc) & 1));
        const uint8_t* st = ring + slot * L.stage;
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

      const int level = crow >> 4;
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + t * 2 + j;
          const float qs = qs_s[col], qcv = qc_s[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = nt * 4 + 2 * h + j;
            const float d = epilogue(acc[i], ca[h], qcv, sc[h], qs);
            mins[i] = min(mins[i], (__float_as_int(d) & ~127) | level);
          }
        }
    }

    // the item's survivors: fold the 8 warps' minima in shared memory, then
    // store them (slot-major, query-minor) and reset the buffer
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + t * 2 + j;
          const int v = mins[nt * 4 + 2 * h + j];
          atomicMin(&red[(g + 8 * h) * BN + col], v);
        }
    consumers_sync();
    for (int i = ct; i < SLOTS * BN; i += 256) {
      const int q = n0 + (i & (BN - 1));
      if (q < B) {
        int32_t* o = out + (static_cast<size_t>(chunk) * SLOTS + i / BN) * B + q;
        if (atomic)
          atomicMin(o, red[i]);
        else
          *o = red[i];
      }
      red[i] = 0x7fffffff;
    }
    consumers_sync();
  }
}

}  // namespace

// grid: (ceil(B / 128) query tiles, ctas CTAs each); `parts` items per
// chunk, `items` = N / 2048 * parts; `atomic` when parts > 1 (out then
// holds INT32_MAX on entry)
extern "C" int vecdb_scan_int8_packed(const void* q8, const void* qs2, const void* qc,
                                      const void* base, const void* scale, const void* cache,
                                      void* out, int B, int N, int D, int parts, int ctas,
                                      void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (D % BK || N % CHUNK_ROWS || (parts != 1 && parts != 2 && parts != 4 && parts != 8) || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const k7::EncodeTiled encode = k7::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap a_map, q_map;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N)};
  const cuuint64_t q_dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D)};
  const cuuint32_t a_box[2] = {BK, BM}, q_box[2] = {BK, BN}, elem[2] = {1, 1};
  if (encode(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), a_dims, strides, a_box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(q8), q_dims, strides, q_box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(D / BK);
  if (L.ring < 4) return static_cast<int>(cudaErrorInvalidValue);  // two stages a consumer
  const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(scan_int8_packed_kernel),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = N / CHUNK_ROWS * parts;
  dim3 grid((B + BN - 1) / BN, ctas);
  scan_int8_packed_kernel<<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      a_map, q_map, static_cast<const float*>(qs2), static_cast<const float*>(qc),
      static_cast<const float*>(scale), static_cast<const float*>(cache), static_cast<int32_t*>(out), B, D / BK,
      parts, items, parts > 1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vecdb_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
