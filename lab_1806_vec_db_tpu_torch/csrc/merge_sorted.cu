// K6 (merge_sorted): merge of a sorted beam with an unsorted scored tile,
// for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_merge.py:merge_sorted (Pallas body
// _merge_kernel), the merge of the classic lock-step beam loop
// (ops/beam.py, `fused=False`).
//
// For each query b, with the beam (d, i, e) (B, ef) ascending and the tile
// (nd, nids) (B, EL):
//
//   keys     beam lane j: (d, j<<1 | e); tile lane j: (nd, (ef+j)<<1)
//   out      the ef smallest keys, ascending by (d, rank): ties go to the
//            beam, then to the lower lane (lax.top_k's stable order)
//
// Every key is distinct, so the order is unique: it equals the plain
// version's stable sort of [beam, tile] bit for bit, the +inf tail included
// (its ranks keep the concatenation's order).
//
// What bounds it on the H100: latency, not bytes (12 (ef + EL) bytes in and
// 12 ef out per query) or compares.  One CTA of 256 threads per query sorts
// the n = pow2(ef + EL) keys in shared memory with the bitonic network of
// beam_body.cuh (K5's); padding keys (+inf, rank >= ef + EL) sort last.  The
// TPU kernel sorted only the tile and merged it with the sorted beam on lane
// rotates; a merge-path form that uses the beam's order is later work.

#include "beam_body.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
merge_sorted_kernel(const float* __restrict__ beam_d, const int* __restrict__ beam_i,
                    const int* __restrict__ beam_e, const float* __restrict__ nd,
                    const int* __restrict__ nids, float* __restrict__ od, int* __restrict__ oi,
                    int* __restrict__ oe, int ef, int EL, int n) {
  extern __shared__ int smem[];
  float* kd = reinterpret_cast<float*>(smem);  // n
  int* kre = smem + n;                          // n
  int* kid = kre + n;                           // n
  const size_t b = blockIdx.x;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    if (j < ef) {
      kd[j] = beam_d[b * ef + j];
      kid[j] = beam_i[b * ef + j];
      kre[j] = (j << 1) | (beam_e[b * ef + j] & 1);
    } else if (j < ef + EL) {
      kd[j] = nd[b * EL + (j - ef)];
      kid[j] = nids[b * EL + (j - ef)];
      kre[j] = j << 1;
    } else {
      kd[j] = INFINITY;
      kid[j] = -1;
      kre[j] = j << 1;
    }
  }
  __syncthreads();
  vecdb::bitonic_sort(kd, kre, kid, n);
  for (int j = threadIdx.x; j < ef; j += blockDim.x) {
    od[b * ef + j] = kd[j];
    oi[b * ef + j] = kid[j];
    oe[b * ef + j] = kre[j] & 1;
  }
}

}  // namespace

extern "C" int vecdb_merge_sorted(const void* beam_d, const void* beam_i, const void* beam_e,
                                  const void* nd, const void* nids, void* od, void* oi, void* oe,
                                  int B, int ef, int EL, int n, void* stream) {
  if (B <= 0 || ef <= 0) return 0;
  const size_t smem = 3 * sizeof(int) * static_cast<size_t>(n);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_sorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_sorted_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(beam_d), static_cast<const int*>(beam_i),
      static_cast<const int*>(beam_e), static_cast<const float*>(nd),
      static_cast<const int*>(nids), static_cast<float*>(od), static_cast<int*>(oi),
      static_cast<int*>(oe), ef, EL, n);
  return static_cast<int>(cudaGetLastError());
}
