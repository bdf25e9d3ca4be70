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
// arithmetic (~EL * (W + R + EL) int compares); it is launch- and
// latency-bound at B = 1000.  One CTA per query, one thread per tile lane
// (EL = 128 or 256 threads): the beam, ring and tile sit in shared memory
// and every thread scans them for its id (all threads read the same word at
// once: broadcasts, no bank conflicts); the compaction is a block prefix
// count of the fresh flags (warp ballots).  Integer-only, so it equals its
// plain version bit for bit.  The body is shared with K3 (beam_body.cuh).

#include "beam_body.cuh"

namespace {

__global__ void beam_pre_kernel(const int* __restrict__ beam_i, const int* __restrict__ ring,
                                const int* __restrict__ selq, const int* __restrict__ nbrs,
                                int* __restrict__ comp, int* __restrict__ ring_out,
                                int* __restrict__ cnt, int W, int R, int EL, int E) {
  extern __shared__ int smem[];
  int* s_beam = smem;      // W
  int* s_ring = s_beam + W;  // R
  int* s_nbrs = s_ring + R;  // EL
  int* s_comp = s_nbrs + EL;  // W
  int* warp_tot = s_comp + W;  // 32
  const size_t b = blockIdx.x;
  const int t = threadIdx.x;
  for (int j = t; j < W; j += blockDim.x) s_beam[j] = beam_i[b * W + j];
  for (int j = t; j < R; j += blockDim.x) s_ring[j] = ring[b * R + j];
  for (int j = t; j < EL; j += blockDim.x) s_nbrs[j] = nbrs[b * EL + j];
  __syncthreads();
  const int count = vecdb::dedup_compact(s_nbrs, EL, s_beam, W, s_ring, R, s_comp, W, warp_tot);
  for (int j = t; j < W; j += blockDim.x) comp[b * W + j] = s_comp[j];
  for (int j = t; j < R; j += blockDim.x)
    ring_out[b * R + j] = j < E ? selq[b * vecdb::SEL_LANES + j] : s_ring[j - E];
  for (int j = t; j < vecdb::SEL_LANES; j += blockDim.x) cnt[b * vecdb::SEL_LANES + j] = count;
}

}  // namespace

extern "C" int vecdb_beam_pre(const void* beam_i, const void* ring, const void* selq,
                              const void* nbrs, void* comp, void* ring_out, void* cnt, int B,
                              int W, int R, int EL, int E, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = sizeof(int) * (2 * static_cast<size_t>(W) + R + EL + 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_pre_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_pre_kernel<<<B, EL, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(beam_i), static_cast<const int*>(ring),
      static_cast<const int*>(selq), static_cast<const int*>(nbrs), static_cast<int*>(comp),
      static_cast<int*>(ring_out), static_cast<int*>(cnt), W, R, EL, E);
  return static_cast<int>(cudaGetLastError());
}
