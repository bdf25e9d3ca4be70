// K4 (beam_pre): dedup + novel-first compaction of one lock-step iteration's
// neighbor tile, and the ring shift, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_beam.py:beam_pre (Pallas body
// _pre_kernel: _dedup_compact + _ring_shift).
//
// For each query b, with the sorted beam ids beam_i (B, W), the visited ring
// (B, R), this iteration's expanded ids selq (B, 128; lanes 0..E-1) and the
// gathered neighbor ids nbrs (B, EL):
//
//   fresh[t] = nbrs[t] >= 0, not in beam_i[b, :], not in ring[b, :], and in
//              no lane t' < t of the tile
//   comp[b]  = the fresh ids in lane order, then -1 up to W
//   ring'[b] = [selq[b, 0..E), ring[b, 0..R-E)]      (shift register)
//   cnt[b]   = the fresh count, in all 128 lanes
//
// What bounds it on the H100: neither bytes (a few KB per query) nor
// arithmetic; it is latency-bound at B = 1000.  One CTA per query, 256
// threads (EL when wider), four barriers, no scan of the beam:
//
//   - the beam's and the ring's ids >= 0 go into an open-addressing hash
//     set in shared memory (beam_body.cuh's set_insert, shared with K3:
//     linear probing, atomicCAS; a power of two >= 2 (W + R) slots, so
//     probes stay short);
//   - the tile's ids go into a second small table (>= 2 EL slots) whose
//     slot also keeps the smallest lane holding the id (atomicMin);
//   - tile lane t is fresh iff its id is >= 0, missing from the set, and t
//     is its id's smallest lane: one or two probes instead of W + R + t
//     compares;
//   - the compaction is a block prefix count of the fresh flags (warp
//     ballots).
//
// Integer-only, and membership and smallest lane do not depend on the order
// of insertion or probing, so it equals its plain version bit for bit.

#include <limits.h>

#include "beam_body.cuh"

namespace {

constexpr int MIN_THREADS = 256;
constexpr int MAX_SET_SLOTS = 32768;  // 128 KB; a wider beam and ring fill it past one half
constexpr int BATCH = 4;              // ids loaded ahead of their inserts

int log2_ceil(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

__global__ void __launch_bounds__(1024)
beam_pre_kernel(const int* __restrict__ beam_i, const int* __restrict__ ring,
                const int* __restrict__ selq, const int* __restrict__ nbrs,
                int* __restrict__ comp, int* __restrict__ ring_out, int* __restrict__ cnt, int W,
                int R, int EL, int E, int log2_set, int log2_tile) {
  extern __shared__ int smem[];
  const int n_set = 1 << log2_set, n_tile = 1 << log2_tile;
  int* s_set = smem;                 // n_set: the beam's and the ring's ids
  int* s_tid = s_set + n_set;        // n_tile: the tile's ids
  int* s_tlane = s_tid + n_tile;     // n_tile: the smallest lane of each
  int* warp_tot = s_tlane + n_tile;  // 32
  const size_t b = blockIdx.x;
  const int t = threadIdx.x, T = blockDim.x;
  const int id = t < EL ? nbrs[b * EL + t] : -1;
  for (int j = t; j < n_set; j += T) s_set[j] = -1;
  for (int j = t; j < n_tile; j += T) {
    s_tid[j] = -1;
    s_tlane[j] = INT_MAX;
  }
  __syncthreads();
  for (int base = t; base < W + R; base += BATCH * T) {
    int v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = base + u * T;
      v[u] = j < W ? beam_i[b * W + j] : j < W + R ? ring[b * R + (j - W)] : -1;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (v[u] >= 0) vecdb::set_insert(s_set, log2_set, v[u]);
  }
  int tslot = 0;
  if (id >= 0) {
    tslot = vecdb::set_insert(s_tid, log2_tile, id);
    atomicMin(s_tlane + tslot, t);
  }
  __syncthreads();
  const bool fresh = id >= 0 && s_tlane[tslot] == t && !vecdb::set_has(s_set, log2_set, id);
  int count;
  const int rank = vecdb::block_rank(fresh, warp_tot, count);
  if (fresh) comp[b * W + rank - 1] = id;
  for (int j = count + t; j < W; j += T) comp[b * W + j] = -1;
  for (int j = t; j < R; j += T)
    ring_out[b * R + j] = j < E ? selq[b * vecdb::SEL_LANES + j] : ring[b * R + j - E];
  for (int j = t; j < vecdb::SEL_LANES; j += T) cnt[b * vecdb::SEL_LANES + j] = count;
}

}  // namespace

extern "C" int vecdb_beam_pre(const void* beam_i, const void* ring, const void* selq,
                              const void* nbrs, void* comp, void* ring_out, void* cnt, int B,
                              int W, int R, int EL, int E, void* stream) {
  if (B <= 0) return 0;
  int log2_set = log2_ceil(2 * (W + R));
  while ((1 << log2_set) > MAX_SET_SLOTS && (1 << (log2_set - 1)) > W + R) --log2_set;
  const int log2_tile = log2_ceil(2 * EL);
  const int threads = EL > MIN_THREADS ? EL : MIN_THREADS;
  const size_t smem = sizeof(int) * ((size_t{1} << log2_set) + (size_t{2} << log2_tile) + 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_pre_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(beam_i), static_cast<const int*>(ring),
      static_cast<const int*>(selq), static_cast<const int*>(nbrs), static_cast<int*>(comp),
      static_cast<int*>(ring_out), static_cast<int*>(cnt), W, R, EL, E, log2_set, log2_tile);
  return static_cast<int>(cudaGetLastError());
}
