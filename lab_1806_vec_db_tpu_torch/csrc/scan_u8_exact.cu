// K1u8: the exact uint8 stage 1 for Hopper (sm_90a), `scan_u8_exact_kernel`.
//
// Replaces no TPU kernel: the JAX package's uint8 search is plain XLA int8
// GEMMs (`ops/u8.py:knn_scan_u8`).  It was added for the exact uint8 route
// (`models/u8.py:exact_route`), which keeps one survivor per strided
// 128-row group, as K1 does, so that the (N, B) distance matrix never
// reaches device memory.
//
// What it computes, for the centred int8 queries q8 (B, D) with int32
// qn8 = |q8|^2, and the centred int8 mirror x8 (N, D) with int32
// n8 = |x8|^2 (the sentinel 2^23 on zero rows holding no valid row):
//
//   d[x, b]       = n8[x] + qn8[b] - 2 dot(x8[x], q8[b])        (exact int32)
//   out[c*16+s, b] = min over level = 0..127 of (d << 7) | level at row
//                    x = c*2048 + level*16 + s
//
// exact while d < 2^24 (the wrapper's rule: width <= 129), and equal to
// `ops/scan.py:scan_chunkmin_u8_packed_ref` bit for bit.
//
// What bounds it on the H100, at BIGANN-100M's shape (100M x 128, B 1000):
// the int8 products, 2 N B D = 2.56e13 operations, 12.94 ms at the card's
// int8 peak; the bytes (the rows once, their n8, the survivors written
// once) take 4.87 ms.  Behind the products, each element costs one integer
// multiply-add and half of a three-way minimum: ~1e11 elements, ~6-10 ms
// of integer issue, which has to run under the products.
//
// The operand layout, and why.  The queries are wgmma's A operand: 64
// queries a warpgroup (the wgmma M), read from a query buffer resident in
// shared memory for the CTA's whole run; the mirror rows are the B operand,
// 128 rows a box (the wgmma N), K-major as the mirror lies in device memory,
// by TMA into a ring.  A mirror row is c*2048 + level*16 + s and a box
// starts on a 16-row boundary, so in the m64n128 accumulator thread (warp
// w, lane 4g + t) holds queries 16w + g and 16w + g + 8 at columns
// 8 nt + 2 t + j: slot 8 (nt & 1) + 2 t + j, level box_level0 + nt / 2.
// Each thread thus owns 2 queries x 4 slots, holds every level of the box
// for each of them, and no other thread of the CTA holds that (query, slot).
//
// - The level-minimum ends in registers: a three-way-min chain over the
//   box's columns into 8 running minima a query tile, which keep running
//   across the boxes of a chunk; at a chunk's end each thread stores its
//   survivors (a global atomicMin where an item is a part of a chunk: the
//   wrapper fills the output with INT32_MAX first).  No shared-memory fold,
//   no barrier between the consumers.
// - The registers that frees pay for overlap inside a warpgroup: a consumer
//   issues the next wgmma group into its second accumulator before it
//   folds the last one (wgmma_wait<1>), so its products run under its own
//   epilogue, not only under the other consumer's.
// - Each row box is reused across query tiles from shared memory: the CTA
//   holds 2 Q tiles of 64 queries (the plan's `q`, 1, 2 or 4), consumer c
//   runs its Q tiles against every box, so the rows cross L2 once per 128 Q
//   queries (`ops/scan.py:u8_plan` picks Q and the grid).
// - The epilogue stays exact: the row channel comes by TMA beside its box,
//   each thread turns its 32 columns into cl = n8 * 128 + level once a box,
//   reused across the box's query tiles; an element costs cl - 256 dot and
//   half of a three-way min; qn8 * 128, the same for every row of a query,
//   is added once per survivor before the store.  A positive packed int32
//   orders as its f32 bits do, so the survivor select reads it unchanged.
//
// Warpgroup 0 produces (one thread: the query tiles once, then per box its
// D / 128 row boxes and its n8 by TMA onto one mbarrier), warpgroups 1 and
// 2 consume; each box is read by both consumers, so its empty barrier
// counts both.  The consumer index is broadcast from lane 0 (`__shfl_sync`)
// so that ptxas sees it warp-uniform: a branch on a thread-dependent value
// around the wgmmas makes it serialize them.
//
// The variants measured on the way (100M x 128, B 1000, one H100 80GB HBM3 at
// its 700 W limit, which the card reaches here: the SM clock read 1.47-1.94
// GHz in these runs), each against the others in one process:
// - K1's body with the rows as A (the parent's form): 43.5 ms;
// - this form at q 1 / 2 / 4: 30.9 / 25.5 / 24.3 ms (q 4's store addresses,
//   hoisted out of the item loop by the compiler, spilled 8 bytes until
//   pinned);
// - with the fold cut to one element (products and feed alone): 18.2 ms at
//   q 2, 17.2-17.9 at q 4; with no products (epilogue and feed alone): 15.1
//   and 11.3 ms (at q 4 ~35 elements a clock an SM, each a multiply-add and
//   half a three-way min); products and epilogue overlap only in part;
// - cl made by a producer warp into shared memory and read by each fold:
//   27.8-28.9 ms against 22.6-23.5 (the fold's loads cost more than the
//   multiply-adds they save);
// - 240 consumer registers (the producer 24): 22.0-23.1 against 21.9-25.1,
//   within the runs' spread; 232 kept.
// What holds it now is the card's power: the products and feed alone draw
// the 700 W limit at 1.74 GHz, the epilogue and feed alone 670 W at 1.98
// GHz, and together the clock falls to 1.47-1.82 GHz (21.9 ms at q 4).
//
// Requirements, checked by the launcher: N % 2048 == 0, D % 128 == 0 with
// D <= 256, 16-byte aligned contiguous tensors; q 1, 2 or 4 with a ring of
// at least 3 boxes; parts 1, 2, 4 or 8.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_wgmma.cuh"

namespace {

using k7::mbar_arrive;
using k7::mbar_expect_tx;
using k7::mbar_init;
using k7::smem_u32;

constexpr int CHUNK_ROWS = 2048;  // rows a chunk: 128 levels x 16 slots
constexpr int SLOTS = 16;         // survivors a chunk
constexpr int QM = 64;            // queries a tile (the wgmma M)
constexpr int BOX = 128;          // mirror rows a box (the wgmma N)
constexpr int BK = 128;           // bytes of depth a TMA box (one 128-byte swizzle row)
constexpr int Q_BOX = QM * BK;    // 8 KB
constexpr int R_BOX = BOX * BK;   // 16 KB
constexpr int N8_BOX = BOX * 4;   // a box's row channel: 128 int32
constexpr int THREADS = 384;      // warpgroup 0 produces, 1 and 2 consume
constexpr int SMEM_MAX = 232448;
constexpr int MAX_RING = 16;
constexpr int MIN_RING = 3;       // a consumer holds up to two boxes at once

struct Layout {
  int ring;
  size_t ring_off, n8_off, qn_off, bars, bytes;
};

// shared memory, after a 1024-byte alignment pad: the CTA's 2 Q query tiles
// (KT boxes each), the ring of row boxes, the ring of their row channels,
// the tiles' qn8 * 128, the full / empty / query mbarriers
__host__ __device__ inline Layout layout(int KT, int Q) {
  Layout L;
  const size_t qres = static_cast<size_t>(2 * Q) * KT * Q_BOX;
  const size_t stage = static_cast<size_t>(KT) * R_BOX;
  const size_t qn = static_cast<size_t>(2 * Q) * QM * 4;
  const size_t fixed = 1024 + qres + qn + 8;
  L.ring = static_cast<int>((SMEM_MAX - fixed) / (stage + N8_BOX + 16));
  if (L.ring > MAX_RING) L.ring = MAX_RING;
  L.ring_off = qres;
  L.n8_off = qres + static_cast<size_t>(L.ring) * stage;
  L.qn_off = L.n8_off + static_cast<size_t>(L.ring) * N8_BOX;
  L.bars = L.qn_off + qn;
  L.bytes = 1024 + L.bars + (2 * L.ring + 1) * 8;
  return L;
}

// a K-major operand in shared memory at byte address `a`, 128-byte swizzle
// (k7::desc_sw128 on an address already in the shared window)
__device__ __forceinline__ uint64_t desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// one wgmma group: 64 queries (A, at `qa`) against a 128-row box (B, at
// `rb`), KT boxes of depth, into `acc` (overwritten)
__device__ __forceinline__ void issue(int (&acc)[64], uint32_t qa, uint32_t rb, int KT) {
  k7::wgmma_fence();
  k7::fence_acc(acc);
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      scan::wgmma_s8(acc, desc(qa + kt * Q_BOX + 32 * kk), desc(rb + kt * R_BOX + 32 * kk), kt | kk);
  }
  k7::wgmma_commit();
}

// cl of this thread's 32 columns of a box: n8 * 128 + level, column
// 8 nt + 2 t + j at cl[2 nt + j], level lvl + nt / 2
__device__ __forceinline__ void load_cl(int (&cl)[32], const int32_t* n8, int t, int lvl) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int2 v = *reinterpret_cast<const int2*>(n8 + 8 * nt + 2 * t);
    cl[2 * nt] = v.x * 128 + lvl + (nt >> 1);
    cl[2 * nt + 1] = v.y * 128 + lvl + (nt >> 1);
  }
}

// fold a completed group into its tile's running minima: m[4 h + 2 p + j]
// is query 16 w + g + 8 h, slot 8 p + 2 t + j; its box columns are nt = p,
// p + 2, ..., p + 14, each cl - 256 dot = (n8 - 2 dot) * 128 + level
__device__ __forceinline__ void fold(const int (&acc)[64], const int (&cl)[32], int (&m)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        int v = m[4 * h + 2 * p + j];
#pragma unroll
        for (int e = 0; e < 16; e += 4) {
          const int a = e + p, b = e + 2 + p;
          v = __vimin3_s32(v, cl[2 * a + j] - acc[4 * a + 2 * h + j] * 256,
                           cl[2 * b + j] - acc[4 * b + 2 * h + j] * 256);
        }
        m[4 * h + 2 * p + j] = v;
      }
}

// Q query tiles a consumer: the CTA holds 2 Q tiles (128 Q queries)
template <int Q>
__global__ void __launch_bounds__(THREADS, 1)
scan_u8_exact_kernel(const __grid_constant__ CUtensorMap r_map, const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap n8_map, const int32_t* __restrict__ qn8,
                     int32_t* __restrict__ out, int B, int KT, int parts, int items, int atomic) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  const Layout L = layout(KT, Q);
  uint8_t* ring = base + L.ring_off;
  const int32_t* n8s = reinterpret_cast<const int32_t*>(base + L.n8_off);
  int32_t* qn_s = reinterpret_cast<int32_t*>(base + L.qn_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + L.ring;
  uint64_t* qbar = empty + L.ring;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * (2 * Q * QM);  // the CTA's first query
  const int readers = n0 + Q * QM < B ? 2 : 1;  // the second consumer works where its tiles hold a query
  const int part_rows = CHUNK_ROWS / parts;
  const int boxes = part_rows / BOX;  // boxes an item: 16, 8, 4 or 2

  if (tid == 0) {
    for (int i = 0; i < L.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128 * readers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 2 * Q * QM; i += THREADS) qn_s[i] = n0 + i < B ? qn8[n0 + i] * 128 : 0;
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      // the tiles that hold a query (a tile past B is never read into a kept survivor)
      const int tiles = min(2 * Q, (B - n0 + QM - 1) / QM);
      mbar_expect_tx(qbar, tiles * KT * Q_BOX);
      for (int tl = 0; tl < tiles; ++tl)
        for (int kt = 0; kt < KT; ++kt)
          k7::tma_load(base + (tl * KT + kt) * Q_BOX, &q_map, kt * BK, n0 + tl * QM, qbar);
      int it = 0;
      for (int item = blockIdx.y; item < items; item += gridDim.y) {
        const int row0 = (item / parts) * CHUNK_ROWS + (item % parts) * part_rows;
        for (int b = 0; b < boxes; ++b, ++it) {
          const int slot = it % L.ring;
          if (it >= L.ring) scan::wait(&empty[slot], ((it / L.ring) - 1) & 1);
          mbar_expect_tx(&full[slot], KT * R_BOX + N8_BOX);
          for (int kt = 0; kt < KT; ++kt)
            k7::tma_load(ring + static_cast<size_t>(slot) * KT * R_BOX + kt * R_BOX, &r_map, kt * BK,
                         row0 + b * BOX, &full[slot]);
          // the box's row channel: n8 viewed as (N / 128, 128) int32
          k7::tma_load(base + L.n8_off + slot * N8_BOX, &n8_map, 0, (row0 + b * BOX) / BOX, &full[slot]);
        }
      }
    }
    return;
  }

  // the consumer index, broadcast from lane 0 so that ptxas sees it
  // warp-uniform (a branch on a thread-dependent value around the wgmmas
  // makes it serialize them)
  const int wg = __shfl_sync(0xffffffffu, (tid - 128) >> 7, 0);
  if (wg >= readers) return;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = ((tid - 128) >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  scan::wait(qbar, 0);

  const uint32_t qa = smem_u32(base) + wg * Q * KT * Q_BOX;  // this consumer's first query tile
  const uint32_t rbase = smem_u32(ring);
  const uint32_t rstage = KT * R_BOX;
  int acc0[64], acc1[64];
  int cl[32];
  int mins[Q][8];
  int it = 0;  // the CTA's box count: box it is in slot it % ring
  for (int item = blockIdx.y; item < items; item += gridDim.y) {
    const int chunk = item / parts;
    const int lvl0 = ((item % parts) * part_rows) >> 4;  // the item's first level
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i) mins[q][i] = 0x7fffffff;
    int prev = 0;  // the slot of the box whose last group is in flight
    if constexpr (Q == 1) {
      // groups alternate between the accumulators box by box
      for (int b = 0; b < boxes; b += 2) {
        int slot = it % L.ring;
        scan::wait(&full[slot], static_cast<unsigned>((it / L.ring) & 1));
        issue(acc0, qa, rbase + slot * rstage, KT);
        if (b > 0) {
          k7::wgmma_wait<1>();
          k7::fence_acc(acc1);
          fold(acc1, cl, mins[0]);
          mbar_arrive(&empty[prev]);
        }
        load_cl(cl, n8s + slot * BOX, t, lvl0 + 8 * b);
        prev = slot;
        ++it;
        slot = it % L.ring;
        scan::wait(&full[slot], static_cast<unsigned>((it / L.ring) & 1));
        issue(acc1, qa, rbase + slot * rstage, KT);
        k7::wgmma_wait<1>();
        k7::fence_acc(acc0);
        fold(acc0, cl, mins[0]);
        mbar_arrive(&empty[prev]);
        load_cl(cl, n8s + slot * BOX, t, lvl0 + 8 * (b + 1));
        prev = slot;
        ++it;
      }
    } else {
      // the tiles of a box in pairs: tile 2 u into acc0, tile 2 u + 1 into acc1
      for (int b = 0; b < boxes; ++b, ++it) {
        const int slot = it % L.ring;
        scan::wait(&full[slot], static_cast<unsigned>((it / L.ring) & 1));
        const uint32_t rb = rbase + slot * rstage;
#pragma unroll
        for (int u = 0; u < Q; u += 2) {
          issue(acc0, qa + u * KT * Q_BOX, rb, KT);
          if (u > 0 || b > 0) {
            k7::wgmma_wait<1>();
            k7::fence_acc(acc1);
            fold(acc1, cl, mins[u > 0 ? u - 1 : Q - 1]);
          }
          if (u == 0) {  // the last box's groups have all completed: free it, read this box's channel
            if (b > 0) mbar_arrive(&empty[prev]);
            load_cl(cl, n8s + slot * BOX, t, lvl0 + 8 * b);
          }
          issue(acc1, qa + (u + 1) * KT * Q_BOX, rb, KT);
          k7::wgmma_wait<1>();
          k7::fence_acc(acc0);
          fold(acc0, cl, mins[u]);
        }
        prev = slot;
      }
    }
    k7::wgmma_wait<0>();
    k7::fence_acc(acc1);
    fold(acc1, cl, mins[Q - 1]);
    mbar_arrive(&empty[prev]);

    // the item's survivors: query 16 w + g + 8 h of tile q, slots 8 p + 2 t + j;
    // q0 is pinned here so that the compiler does not hoist the 2 Q store
    // addresses out of the item loop, where they would hold registers the
    // loop needs
    int q0 = wg * Q * QM + 16 * warp + g;
    asm volatile("" : "+r"(q0));
    int32_t* orow = out + (static_cast<size_t>(chunk) * SLOTS + 2 * t) * B + n0;
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ql = q0 + q * QM + 8 * h;  // the query within the CTA
        if (n0 + ql < B) {
          const int add = qn_s[ql];
          int32_t* o = orow + ql;
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int v = mins[q][4 * h + 2 * p + j] + add;
              int32_t* oj = o + static_cast<size_t>(8 * p + j) * B;
              if (atomic)
                atomicMin(oj, v);
              else
                *oj = v;
            }
        }
      }
  }
}

template <int Q>
int launch(const CUtensorMap& r_map, const CUtensorMap& q_map, const CUtensorMap& n8_map, const void* qn8,
           void* out, int B, int N, int KT, int parts, int ctas, cudaStream_t stream) {
  const Layout L = layout(KT, Q);
  if (L.ring < MIN_RING) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(scan_u8_exact_kernel<Q>),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = N / CHUNK_ROWS * parts;
  dim3 grid((B + 2 * Q * QM - 1) / (2 * Q * QM), ctas);
  scan_u8_exact_kernel<Q><<<grid, THREADS, L.bytes, stream>>>(r_map, q_map, n8_map,
                                                              static_cast<const int32_t*>(qn8),
                                                              static_cast<int32_t*>(out), B, KT, parts, items,
                                                              parts > 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid: (ceil(B / (128 q)) query groups, ctas CTAs each); q query tiles of
// 64 a consumer; `parts` items a chunk; `atomic` where parts > 1 (out then
// holds INT32_MAX on entry).  q8 (B, D) and base (N, D) the centred int8
// rows, qn8 (B,) and n8 (N,) int32 their squared norms, out (N / 128, B).
extern "C" int vecdb_scan_u8_exact(const void* q8, const void* qn8, const void* base, const void* n8, void* out,
                                   int B, int N, int D, int parts, int ctas, int q, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (D % BK || D > 2 * BK || N % CHUNK_ROWS || (parts != 1 && parts != 2 && parts != 4 && parts != 8) ||
      ctas <= 0 || (q != 1 && q != 2 && q != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap r_map, q_map, n8_map;
  // n8 viewed as (N / 128, 128) int32: one 512-byte box a row box
  if (scan::tensor_map(&r_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, D, N, D, BK, BOX) != CUDA_SUCCESS ||
      scan::tensor_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q8, D, B, D, BK, QM) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t n_dims[2] = {static_cast<cuuint64_t>(BOX), static_cast<cuuint64_t>(N / BOX)};
  const cuuint64_t n_strides[1] = {static_cast<cuuint64_t>(N8_BOX)};
  const cuuint32_t n_box[2] = {BOX, 1}, elem[2] = {1, 1};
  if (k7::encode_tiled()(&n8_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(n8), n_dims, n_strides,
                         n_box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int KT = D / BK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q == 1) return launch<1>(r_map, q_map, n8_map, qn8, out, B, N, KT, parts, ctas, s);
  if (q == 2) return launch<2>(r_map, q_map, n8_map, qn8, out, B, N, KT, parts, ctas, s);
  return launch<4>(r_map, q_map, n8_map, qn8, out, B, N, KT, parts, ctas, s);
}
