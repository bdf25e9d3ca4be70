// K5 (beam_post): merge of the scored tile into the sorted beam, the ef
// re-mask and the next expansion select, for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_beam.py:beam_post (Pallas body
// _post_kernel: _merge_select, on the bitonic network of
// ops/pallas_merge.py).
//
// For each query b, with the beam (d, i, e) (B, W) ascending and the scored
// tile (nd, nids) (B, W):
//
//   keys     beam lane j: (d, j<<1 | e); tile lane j: (nd, (W+j)<<1)
//   merged   the W smallest of the 2W keys, ascending by (d, re): ties go
//            to the beam, then to the lower lane
//   re-mask  lanes >= ef, non-finite d or id < 0 become (inf, -1, 0)
//   select   the E lowest-lane entries with e == 0 and id >= 0 get e = 1 and
//            go to sel[0..E); sel is -1 elsewhere (128 lanes)
//
// What bounds it on the H100: latency, not bytes (24W bytes per query) or
// compares.  One CTA of 256 threads per query sorts the 2W keys in shared
// memory with a bitonic network (log2(2W)(log2(2W)+1)/2 stages, one barrier
// each); the TPU kernel merged instead (it sorted only the tile and used
// that the beam arrives sorted), which a later PR can copy.  Every key is
// distinct, so the result is the unique sorted order and equals the plain
// version's stable sort bit for bit.  The body is shared with K3
// (beam_body.cuh).

#include "beam_body.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
beam_post_kernel(const float* __restrict__ beam_d, const int* __restrict__ beam_i,
                 const int* __restrict__ beam_e, const float* __restrict__ nd,
                 const int* __restrict__ nids, float* __restrict__ od, int* __restrict__ oi,
                 int* __restrict__ oe, int* __restrict__ sel, int W, int ef, int E) {
  extern __shared__ int smem[];
  float* kd = reinterpret_cast<float*>(smem);  // 2W
  int* kre = smem + 2 * W;                      // 2W
  int* kid = kre + 2 * W;                       // 2W
  int* s_sel = kid + 2 * W;                     // 128
  int* warp_tot = s_sel + vecdb::SEL_LANES;     // 32
  const size_t b = blockIdx.x;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    kd[j] = beam_d[b * W + j];
    kid[j] = beam_i[b * W + j];
    kre[j] = beam_e[b * W + j];
  }
  __syncthreads();
  vecdb::stage_merge(kd, kre, kid, W, nd + b * W, nids + b * W, W);
  vecdb::bitonic_sort(kd, kre, kid, 2 * W);
  vecdb::remask_select(kd, kre, kid, W, ef, E, s_sel, warp_tot);
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    od[b * W + j] = kd[j];
    oi[b * W + j] = kid[j];
    oe[b * W + j] = kre[j];
  }
  for (int j = threadIdx.x; j < vecdb::SEL_LANES; j += blockDim.x)
    sel[b * vecdb::SEL_LANES + j] = s_sel[j];
}

}  // namespace

extern "C" int vecdb_beam_post(const void* beam_d, const void* beam_i, const void* beam_e,
                               const void* nd, const void* nids, void* od, void* oi, void* oe,
                               void* sel, int B, int W, int ef, int E, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = sizeof(int) * (6 * static_cast<size_t>(W) + vecdb::SEL_LANES + 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_post_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(beam_d), static_cast<const int*>(beam_i),
      static_cast<const int*>(beam_e), static_cast<const float*>(nd),
      static_cast<const int*>(nids), static_cast<float*>(od), static_cast<int*>(oi),
      static_cast<int*>(oe), static_cast<int*>(sel), W, ef, E);
  return static_cast<int>(cudaGetLastError());
}
