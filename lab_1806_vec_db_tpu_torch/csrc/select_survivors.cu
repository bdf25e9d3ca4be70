// The stage-1 survivor select: the exact top-r of K1's packed survivors of
// every query, decoded, in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package takes this select with
// `lax.approx_min_k` (lab_1806_vec_db_tpu/ops/pallas_scan.py:
// scan_candidates_int8_packed), which is plain XLA, not Pallas.  In the port it
// was ops/scan.py:select_survivors_ref alone: a transposed copy of K1's
// (S, B) int32 output, a stable `torch.sort` of all S survivors of every query
// (cub's segmented radix sort and its index iota), a gather of the first r and
// ~10 elementwise launches to decode them: ~0.7 ms of device time a call at
// flat_1m's S 7,936, B 1000, r 40.  This kernel replaces all of it; the sort
// stays as the plain version, which CPU tensors run.
//
// What it computes, for packed (S, B) int32 read in place (row s, query b at
// s * B + b): for each query, the survivors ordered by the packed value
// viewed as f32, ascending, ties to the lower position s (-0.0 ties with
// +0.0; a NaN, which K1 does not make, after everything), the stable sort's
// order; the first r of them decoded as
//   dist = bitcast_f32(v & ~127), id = (s / 16) * 2048 + s % 16 + (v & 127) * 16,
// (+inf, -1) where dist >= 1e38 and past the S survivors there are.
//
// What bounds it on the H100: bytes.  It must read K1's output once (S B 4
// bytes: 31.7 MB at the cell, 9.5 us at 3.35 TB/s; K1 has just written it,
// much of it into the 50 MB L2) and write B r 8 bytes.  The design reads the
// survivors twice, the second time mostly from L2, and does a few operations
// a survivor; only about r of them a query are ever sorted:
//
// - Load.  A CTA takes 8 queries, one warp a query, so each survivor row
//   gives it one 32-byte sector.  512-row tiles come in by 4-byte cp.async
//   through a 3-stage ring, transposed on the way into shared memory (a
//   query's rows contiguous, the row stride 4 words past a bank multiple so
//   neither the writes nor the warp's reads conflict): no transposed copy in
//   device memory.  Every load of a tile is issued before its values are
//   used: a branch around each load would make them wait one by one.
// - Pass 1 (where S > 2 r).  Each lane keeps the least value (past r 512,
//   the two least) of 16 groups, group (lane, j) the rows 32 j + lane mod
//   512, by fminf on the f32 values.  A warp-wide binary search on the key
//   (redux steps) finds a bound T0 with at least r of those 512 (1024)
//   values at or below it: at least r survivors lie at or below T0, and for
//   unclustered keys not many more (about 42 at r 40, 630 at r 600).
// - Pass 2.  A survivor passes if its f32 value is at most T0's (the f32
//   compare orders -0.0 with +0.0 and fails for NaN, as the key would).  A
//   tile's few passing rows go into the warp's buffer of CAP >= 2 r (key <<
//   32 | position) items at once, each lane's after the lower lanes'.  If a
//   tile's would overflow it (many ties at T0), the tile goes 32 rows at a
//   time, and the buffer, when full, is sorted and cut to its r least, the
//   bound dropping to below the r-th key: a later survivor at that key has
//   a higher position and loses the tie.  So any input is exact; only the
//   time depends on it.
// - Finish.  One bitonic sort of the buffer (in registers up to 64 items,
//   else in shared memory), then the first r are re-read from `packed` (so
//   -0.0 and NaN bits come out as they went in) and decoded.
//
// At the cell it takes 0.028 ms a call on an H100, where the plain version
// takes 1.02 (PERF.md's kernel table).  It was the faster at every shape
// timed, so ops/survivors.py's rule sends it every r up to its buffer's
// 1024; its module doc lists the shapes and times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 8;                    // queries a CTA, one warp each
constexpr int THREADS = QT * 32;
constexpr int TR = 512;                  // survivor rows a tile
constexpr int TRP = TR + 4;              // a query's row stride in a stage (words)
constexpr int NSTAGE = 3;                // tiles in flight or in use
constexpr int STAGE_WORDS = QT * TRP;
constexpr int GPL = 16;                  // pass 1's groups a lane
constexpr int GROUPS = 32 * GPL;         // pass 1 keeps two values a group past GROUPS
constexpr int R_MAX = 1024;              // ops/survivors.py's R_MAX
constexpr int CAP_MIN = 64, CAP_MAX = 2 * R_MAX;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long EMPTY = ~0ull;  // sorts after every item

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The packed value's place in the f32 order as an unsigned key: -0.0 as
// +0.0, every NaN last, at 0xfffffffe.
__device__ __forceinline__ unsigned order_key(int v) {
  unsigned u = static_cast<unsigned>(v);
  u = u == 0x80000000u ? 0u : u;
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (u & 0x7fffffffu) > 0x7f800000u ? 0xfffffffeu : k;
}

// Pass 2's bound: a survivor is kept where its key is at most a bound key,
// tested on the f32 value itself (f <= le orders -0.0 with +0.0 and fails
// for NaN), or where every key passes.
struct Bound {
  float le;
  bool all;

  __device__ void at_most(unsigned key) {
    all = key >= 0xfffffffeu;
    // zero's key less one is no f32's key (-0.0 shares +0.0's): the largest
    // negative denormal's; past +inf's key every number passes, NaN not
    const unsigned k = key == 0x7fffffffu ? 0x7ffffffeu : key;
    le = k >= 0xff800000u ? INFINITY : __uint_as_float((k & 0x80000000u) ? k ^ 0x80000000u : ~k);
  }
  __device__ bool takes(float f) const { return (f <= le) | all; }
};

// Bitonic sort of a[0, n) ascending, n a power of two >= 64, by one warp
// in shared memory: each lane loads up to four pairs of a step before it
// stores any (the pairs of a step are disjoint).
__device__ void warp_sort(unsigned long long* a, int n, int lane) {
  for (int k = 2; k <= n; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t0 = lane; t0 < n / 2; t0 += 128) {
        int i[4];
        unsigned long long x[4], y[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + 32 * u;
          i[u] = 2 * t - (t & (j - 1));  // the lower of the pair (i, i + j)
          if (t < n / 2) {
            x[u] = a[i[u]];
            y[u] = a[i[u] + j];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t0 + 32 * u < n / 2 && (x[u] > y[u]) == ((i[u] & k) == 0)) {
            a[i[u]] = y[u];
            a[i[u] + j] = x[u];
          }
      }
      __syncwarp();
    }
}

// Bitonic sort of a[0, 64), a[0, count) padded with EMPTY, by one warp in
// registers: item 2 lane + e in v[e], pairs 2 or more apart by shuffles.
__device__ __forceinline__ void warp_sort64(unsigned long long* a, int count, int lane) {
  unsigned long long v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) v[e] = 2 * lane + e < count ? a[2 * lane + e] : EMPTY;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {
        const unsigned long long lo = min(v[0], v[1]), hi = max(v[0], v[1]);
        const bool up = ((2 * lane) & k) == 0;
        v[0] = up ? lo : hi;
        v[1] = up ? hi : lo;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * lane + e;
          const unsigned long long w = __shfl_xor_sync(FULL, v[e], j >> 1);
          v[e] = (((i & j) == 0) == ((i & k) == 0)) ? min(v[e], w) : max(v[e], w);
        }
      }
    }
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 2; ++e) a[2 * lane + e] = v[e];
  __syncwarp();
}

// Sort a[0, count), padded with EMPTY to a power of two (<= cap), after
// every lane's appends; one copy of the code for every call site.
__device__ __noinline__ void sort_items(unsigned long long* a, int count, int lane) {
  __syncwarp();
  if (count <= 64) {
    warp_sort64(a, count, lane);
    return;
  }
  int n = 1;
  while (n < count) n <<= 1;
  for (int i = count + lane; i < n; i += 32) a[i] = EMPTY;
  __syncwarp();
  warp_sort(a, n, lane);
}

// Issue tile t's copies: rows [t TR, t TR + TR) of queries [b0, b0 + QT)
// into the stage at shared address `stage`, query q's row s at q * TRP + s.
// Rows past S and queries past B are not read.
__device__ __forceinline__ void load_tile(unsigned stage, const int* __restrict__ packed, int S, int B,
                                          int b0, int t) {
  constexpr int STEP = THREADS / QT;  // rows a pass of the CTA's threads covers
  const int q = threadIdx.x & (QT - 1), row0 = threadIdx.x / QT;
  if (b0 + q >= B) return;
  const int rows = S - t * TR;
  const int* src = packed + (static_cast<size_t>(t) * TR + row0) * B + b0 + q;
  const size_t step = static_cast<size_t>(STEP) * B;
  const unsigned dst = stage + (q * TRP + row0) * 4;
#pragma unroll
  for (int k = 0; k < TR / STEP; ++k, src += step)
    if (row0 + k * STEP < rows) cp_async4(dst + k * STEP * 4, src);
}

// One pass over all tiles through the ring; `body(rows, words of this
// warp's query in the tile)` runs on every thread, between barriers, rows
// being the tile's rows before S (TR but in the last tile).
template <typename Body>
__device__ __forceinline__ void stream(int* ring, const int* __restrict__ packed, int S, int B, int b0,
                                       int warp, Body body) {
  const int tiles = (S + TR - 1) / TR;
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < tiles) load_tile(ring_s + t * STAGE_WORDS * 4, packed, S, B, b0, t);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<NSTAGE - 2>();  // this thread's copies of tile t have landed
    __syncthreads();              // everyone's have, and tile t - 1's stage is free
    const int next = t + NSTAGE - 1;
    if (next < tiles) load_tile(ring_s + (next % NSTAGE) * STAGE_WORDS * 4, packed, S, B, b0, next);
    cp_async_commit();
    body(S - t * TR, ring + (t % NSTAGE) * STAGE_WORDS + warp * TRP);
  }
  __syncthreads();  // the ring is free for the next pass
}

// f32 max that keeps NaN (fmaxf passes over it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// Pass 1 of this warp's query: each lane keeps the least value (TWO: the
// two least) of GPL groups, group (lane, j) being the rows 32 j + lane mod
// TR; then a key with at least r of those values at or below it, within
// 127 of the least such key (at most the level bits above it), searched
// between their least and greatest.  At least r survivors lie at or below
// it.  fminf passes over NaN, which also stands for a row past S: a group of
// NaN or of no survivor keeps NaN, NaN's key.  Every thread runs the pass;
// a warp past B gets no bound.
template <bool TWO>
__device__ unsigned pass_one(int* ring, const int* __restrict__ packed, int S, int B, int b0, int warp,
                             int lane, bool live, int r) {
  constexpr int V = TWO ? 2 * GPL : GPL;
  const float nan = __uint_as_float(0x7fffffffu);
  float g[V];  // g[j] the least of group j, g[GPL + j] the second least
#pragma unroll
  for (int j = 0; j < V; ++j) g[j] = nan;
  stream(ring, packed, S, B, b0, warp, [&](int rows, const int* col) {
    if (!live) return;
#pragma unroll
    for (int i = 0; i < TR / 32; ++i) {
      const float v = __int_as_float(col[32 * i + lane]);
      const float f = rows >= TR || 32 * i + lane < rows ? v : nan;
      if (TWO) g[GPL + i % GPL] = fminf(g[GPL + i % GPL], max_nan(g[i % GPL], f));
      g[i % GPL] = fminf(g[i % GPL], f);
    }
  });
  if (!live) return 0xffffffffu;
  unsigned k[V];
#pragma unroll
  for (int j = 0; j < V; ++j) k[j] = order_key(__float_as_int(g[j]));
  unsigned lo = k[0], hi = k[0];
#pragma unroll
  for (int j = 1; j < V; ++j) {
    lo = min(lo, k[j]);
    hi = max(hi, k[j]);
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  while (hi - lo > 127u) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) c += k[j] <= mid;
    if (__reduce_add_sync(FULL, c) >= static_cast<unsigned>(r)) hi = mid;
    else lo = mid + 1;
  }
  return hi;
}

// Grid: ceil(B / QT) CTAs.  Dynamic shared memory: the ring, then each warp's
// buffer of cap items.
__global__ void __launch_bounds__(THREADS)
select_survivors_kernel(const int* __restrict__ packed, int S, int B, int r, int cap,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* ring = reinterpret_cast<int*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(smem + NSTAGE * STAGE_WORDS * 4) + static_cast<size_t>(warp) * cap;
  const int b0 = blockIdx.x * QT, b = b0 + warp;
  const bool live = b < B;  // warp-uniform
  Bound bound;
  bound.at_most(0xffffffffu);  // at first every survivor passes
  if (S > 2 * r) {  // CTA-uniform: a bound that keeps about r of S
    const unsigned t0 = r <= GROUPS ? pass_one<false>(ring, packed, S, B, b0, warp, lane, live, r)
                                    : pass_one<true>(ring, packed, S, B, b0, warp, lane, live, r);
    bound.at_most(t0);
  }

  int count = 0;
  stream(ring, packed, S, B, b0, warp, [&](int rows, const int* col) {
    if (!live) return;
    // bit i of `bits`: row 32 i + lane of the tile passes
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < TR / 32; ++i)
      bits |= static_cast<unsigned>(bound.takes(__int_as_float(col[32 * i + lane])) & (32 * i + lane < rows)) << i;
    const int n = __popc(bits), total = static_cast<int>(__reduce_add_sync(FULL, n));
    if (!total) return;
    const int s0 = S - rows;  // the tile's first row
    if (count + total <= cap) {
      // the common case: the tile's few passing rows appended at once, each
      // lane's after the lower lanes' (the buffer's order is the sort's)
      int at = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, at, d);
        if (lane >= d) at += y;
      }
      at += count - n;
      for (unsigned m = bits; m; m &= m - 1) {
        const int row = 32 * (__ffs(m) - 1) + lane;
        buf[at++] = (static_cast<unsigned long long>(order_key(col[row])) << 32) | (s0 + row);
      }
      count += total;
      return;
    }
    // the buffer would overflow: row by row in order, cut to the r least
    // whenever the next 32 rows do not fit (every item's position is below
    // theirs), and from then on only keys below the r-th
#pragma unroll 1
    for (int i = 0; i < TR / 32; ++i) {
      const int row = 32 * i + lane;
      const float f = __int_as_float(col[row]);
      bool take = bound.takes(f) & (row < rows);
      unsigned m = __ballot_sync(FULL, take);
      if (!m) continue;
      if (count + __popc(m) > cap) {
        sort_items(buf, count, lane);
        count = r;
        bound.at_most(static_cast<unsigned>(buf[r - 1] >> 32) - 1);
        take = bound.takes(f) & (row < rows);
        m = __ballot_sync(FULL, take);
      }
      if (take) buf[count + __popc(m & ((1u << lane) - 1))] =
          (static_cast<unsigned long long>(order_key(__float_as_int(f))) << 32) | (s0 + row);
      count += __popc(m);
    }
  });
  if (!live) return;
  sort_items(buf, count, lane);
  const int have = count < r ? count : r;
  for (int j = lane; j < r; j += 32) {
    float d = INFINITY;
    int id = -1;
    if (j < have) {
      const int s = static_cast<int>(buf[j] & 0xffffffffu);
      const int v = packed[static_cast<size_t>(s) * B + b];
      d = __uint_as_float(static_cast<unsigned>(v) & ~127u);
      id = (s >> 4) * 2048 + (s & 15) + (v & 127) * 16;
      if (d >= 1e38f) {
        d = INFINITY;
        id = -1;
      }
    }
    out_d[static_cast<size_t>(b) * r + j] = d;
    out_i[static_cast<size_t>(b) * r + j] = id;
  }
}

size_t smem_bytes(int cap) {
  return static_cast<size_t>(NSTAGE) * STAGE_WORDS * 4 + static_cast<size_t>(QT) * cap * 8;
}

}  // namespace

// packed (S, B) int32 row-major; out_d (B, r) f32, out_i (B, r) int32;
// 0 <= r <= R_MAX.  Each warp's buffer holds cap items, the least power of
// two >= 2 r and at least CAP_MIN (room for a warp's 32 after a cut to r).
extern "C" int vecdb_select_survivors(const void* packed, void* out_d, void* out_i, int S, int B, int r,
                                      void* stream) {
  if (S < 0 || B < 0 || r < 0 || r > R_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || r == 0) return static_cast<int>(cudaSuccess);  // nothing to write
  int cap = CAP_MIN;
  while (cap < 2 * r) cap <<= 1;
  const size_t smem = smem_bytes(cap);
  // the attribute is each device's: set once a device (a repeat is harmless)
  static bool attr_set[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !attr_set[dev]) {
    err = cudaFuncSetAttribute(select_survivors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(CAP_MAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attr_set[dev] = true;
  }
  select_survivors_kernel<<<(B + QT - 1) / QT, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), S, B, r, cap, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
