// Device code shared by the graph-search kernels, for Hopper (sm_90a):
//
//   row_dist / query_norm   the exact per-row distance (K2, K3; f32 or bf16 rows)
//   block_rank              block-wide ballot prefix count (K3, K4)
//   dedup_compact           K3's tile dedup + novel-first compaction
//   bitonic_sort            K3's merge: sort of the 2W (d, rank<<1|e) keys
//   remask_select           K3's epilogue: ef re-mask + expansion select
//   order_key / count_below the merge by rank of K5 and K6: a float's u32
//                           order key, the co-rank of a key in a sorted run
//   copy_lanes              K5's and K6's vector lane copies
//
// K3 (csrc/traverse.cu) is one CTA's whole loop on these and gives the same
// bits as K2 (csrc/gather_dists.cu).  K4 and K5 (csrc/beam_pre.cu,
// csrc/beam_post.cu) have bodies of their own, a hash-set dedup and a merge
// by rank, with the same semantics: those of
// lab_1806_vec_db_tpu/ops/pallas_beam.py (_dedup_compact, _ring_shift,
// _merge_select), whose plain PyTorch versions are in ops/beam_fused.py and
// against which all three kernels are tested.
//
// Block-level functions expect every thread of the block to call them
// (they contain __syncthreads) and blockDim.x a multiple of 32.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vecdb {

constexpr int SEL_LANES = 128;  // width of the sel / cnt rows

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// |q| for the cosine distance; every lane of the warp gets it.  dim4 = dim/4
// when the float4 path is allowed, else 0.
__device__ __forceinline__ float query_norm(const float* qb, int dim, int dim4, int lane) {
  const float4* qb4 = reinterpret_cast<const float4*>(qb);
  float qq = 0.f;
  for (int i = lane; i < dim4; i += 32) {
    const float4 c = qb4[i];
    qq += c.x * c.x + c.y * c.y + c.z * c.z + c.w * c.w;
  }
  for (int i = dim4 * 4 + lane; i < dim; i += 32) qq += qb[i] * qb[i];
  return sqrtf(warp_sum(qq));
}

// Row loads for row_dist: f32 rows as they are, bf16 rows (their raw 16
// bits, uint16_t) upcast exactly to f32 (a bf16 is the high half of an f32).
__device__ __forceinline__ float4 load4(const float* v, int i) {
  return reinterpret_cast<const float4*>(v)[i];
}
__device__ __forceinline__ float4 load4(const uint16_t* v, int i) {
  const uint2 u = reinterpret_cast<const uint2*>(v)[i];
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float load1(const float* v, int i) { return v[i]; }
__device__ __forceinline__ float load1(const uint16_t* v, int i) {
  return __uint_as_float(static_cast<unsigned>(v[i]) << 16);
}

// Exact f32 distance of row v (f32, or bf16 upcast to f32) to query qb, one
// warp, 4-element vector loads when dim4 > 0; every lane gets the result.
//   l2sqr:  sum_k (v[k] - q[k])^2 (no cached norms)
//   cosine: 1 - dot / max(|v| * qn, 1e-10), |v| from the upcast row
template <typename T>
__device__ __forceinline__ float row_dist(const T* __restrict__ v, const float* qb, int dim,
                                          int dim4, bool cosine, float qn, int lane) {
  const float4* qb4 = reinterpret_cast<const float4*>(qb);
  float acc = 0.f, vv = 0.f;
  if (!cosine) {
    for (int i = lane; i < dim4; i += 32) {
      const float4 a = load4(v, i), c = qb4[i];
      const float dx = a.x - c.x, dy = a.y - c.y, dz = a.z - c.z, dw = a.w - c.w;
      acc += dx * dx + dy * dy + dz * dz + dw * dw;
    }
    for (int i = dim4 * 4 + lane; i < dim; i += 32) {
      const float dx = load1(v, i) - qb[i];
      acc += dx * dx;
    }
    return warp_sum(acc);
  }
  for (int i = lane; i < dim4; i += 32) {
    const float4 a = load4(v, i), c = qb4[i];
    acc += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    vv += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
  }
  for (int i = dim4 * 4 + lane; i < dim; i += 32) {
    const float a = load1(v, i);
    acc += a * qb[i];
    vv += a * a;
  }
  const float dot = warp_sum(acc);
  const float vn = sqrtf(warp_sum(vv));
  return 1.f - dot / fmaxf(vn * qn, 1e-10f);
}

// Block-wide inclusive count of `flag` in thread order: a flagged thread
// gets its 1-based rank, and `total` the number of flagged threads.
// warp_tot: blockDim.x / 32 ints of shared memory.
__device__ __forceinline__ int block_rank(bool flag, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  const int r = __popc(m & ((1u << lane) - 1u)) + (flag ? 1 : 0);
  if (lane == 0) warp_tot[warp] = __popc(m);
  __syncthreads();
  int off = 0, tot = 0;
  for (int w = 0; w < nw; ++w) {
    const int c = warp_tot[w];
    off += w < warp ? c : 0;
    tot += c;
  }
  __syncthreads();  // warp_tot is free again
  total = tot;
  return off + r;
}

// K3's dedup.  Thread t < EL holds tile lane t (needs blockDim.x >= EL).  A
// lane is fresh when its id is >= 0, not in beam_i[0, W) or ring[0, R), and
// in no earlier lane.  Fresh ids are compacted to comp[0, count) in lane
// order, -1 fills comp[count, comp_w) (comp_w >= EL).  Returns count on every
// thread.
__device__ __forceinline__ int dedup_compact(const int* nbrs, int EL, const int* beam_i, int W,
                                             const int* ring, int R, int* comp, int comp_w,
                                             int* warp_tot) {
  const int t = threadIdx.x;
  int id = -1;
  bool fresh = false;
  if (t < EL) {
    id = nbrs[t];
    fresh = id >= 0;
    for (int j = 0; fresh && j < t; ++j) fresh = nbrs[j] != id;
    for (int j = 0; fresh && j < W; ++j) fresh = beam_i[j] != id;
    for (int j = 0; fresh && j < R; ++j) fresh = ring[j] != id;
  }
  for (int j = t; j < comp_w; j += blockDim.x) comp[j] = -1;
  int count;
  const int rank = block_rank(fresh, warp_tot, count);  // its barrier orders the -1 fill first
  if (fresh) comp[rank - 1] = id;
  __syncthreads();
  return count;
}

// u32 image of d, monotone in the float order; -0 and +0 give one key, NaN
// the largest.
__device__ __forceinline__ unsigned order_key(float d) {
  if (isnan(d)) return 0xffffffffu;
  const unsigned u = __float_as_uint(d == 0.f ? 0.f : d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Number of a[0, n) (ascending) that are < x, or with `or_equal` <= x.
template <bool or_equal>
__device__ __forceinline__ int count_below(const unsigned* a, int n, unsigned x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (or_equal ? a[mid] <= x : a[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// V adjacent lanes moved as one V * sizeof(T)-byte access (V = 1, 2 or 4).
template <int V, typename T>
struct alignas(sizeof(T) * V) Lanes {
  T v[V];
};
template <int V, typename T>
__device__ __forceinline__ void copy_lanes(T* dst, const T* src) {
  *reinterpret_cast<Lanes<V, T>*>(dst) = *reinterpret_cast<const Lanes<V, T>*>(src);
}

// Ascending bitonic sort of n (a power of two) keys (kd, kre) carrying kid.
// Keys compare as (d, re) lexicographically and must be distinct, so the
// order is unique: the stable sort of the plain version gives it too.
__device__ __forceinline__ void bitonic_sort(float* kd, int* kre, int* kid, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int a = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int b = a + j;
        const float da = kd[a], db = kd[b];
        const int ra = kre[a], rb = kre[b];
        const bool gt = da > db || (da == db && ra > rb);
        if (gt == ((a & k) == 0)) {
          kd[a] = db;
          kd[b] = da;
          kre[a] = rb;
          kre[b] = ra;
          const int t = kid[a];
          kid[a] = kid[b];
          kid[b] = t;
        }
      }
      __syncthreads();
    }
  }
}

// K3's epilogue on the sorted keys' first W lanes: lanes >= ef, non-finite
// d and id < 0 become (inf, -1, e 0); the E lowest-lane unexpanded entries
// are marked expanded and written to sel[0, E), -1 after.  Leaves kre[j] = e.
__device__ __forceinline__ void remask_select(float* kd, int* kre, int* kid, int W, int ef, int E,
                                              int* sel, int* warp_tot) {
  for (int j = threadIdx.x; j < SEL_LANES; j += blockDim.x) sel[j] = -1;
  int offset = 0;
  for (int base = 0; base < W; base += blockDim.x) {
    const int j = base + threadIdx.x;
    bool unexp = false;
    float d = INFINITY;
    int id = -1, e = 0;
    if (j < W) {
      d = kd[j];
      id = kid[j];
      e = kre[j] & 1;
      if (!(j < ef && isfinite(d) && id >= 0)) {
        d = INFINITY;
        id = -1;
        e = 0;
      }
      unexp = e == 0 && id >= 0;
    }
    int total;
    const int rank = offset + block_rank(unexp, warp_tot, total);
    if (unexp && rank <= E) {
      e = 1;
      sel[rank - 1] = id;
    }
    if (j < W) {
      kd[j] = d;
      kid[j] = id;
      kre[j] = e;
    }
    offset += total;
  }
  __syncthreads();
}

// Load the merge keys: beam lanes [0, W) get re = j<<1 | e (e in kre[j]);
// the tile goes to [W, 2W) with re = (W+j)<<1 (tile lanes >= T are empty).
__device__ __forceinline__ void stage_merge(float* kd, int* kre, int* kid, int W, const float* td,
                                            const int* ti, int T) {
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    kre[j] = (j << 1) + kre[j];
    kd[W + j] = j < T ? td[j] : INFINITY;
    kid[W + j] = j < T ? ti[j] : -1;
    kre[W + j] = (W + j) << 1;
  }
  __syncthreads();
}

}  // namespace vecdb
