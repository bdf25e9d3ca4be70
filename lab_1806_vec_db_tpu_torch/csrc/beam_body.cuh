// Device code shared by the graph-search kernels, for Hopper (sm_90a):
//
//   row_dist / query_norm   the exact per-row distance (K2, K3; f32 or bf16 rows)
//   row_dists               row_dist of NR rows at once, the same bits (K3)
//   block_rank              block-wide ballot prefix count (K4)
//   set_insert / set_has    the open-addressing id set of the dedup (K3, K4)
//   order_key / count_below the merge by rank of K3, K5 and K6: a float's u32
//                           order key, the co-rank of a key in a sorted run
//   copy_lanes              K5's and K6's vector lane copies
//
// K3 (csrc/traverse.cu) is one CTA's whole loop, with K4's dedup and K5's
// merge by rank on shared memory, and gives the same bits as K2
// (csrc/gather_dists.cu).  K4 and K5 (csrc/beam_pre.cu, csrc/beam_post.cu)
// are one iteration's halves, with the semantics of
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

// row_dist of NR rows at once (v[r] == nullptr: no row, out[r] untouched),
// for more bytes in flight: each step issues the loads of U steps of the
// lane's stride for every row before it adds any of them.  Each lane adds
// its elements in row_dist's order and the warp sums as row_dist does, so
// every distance has row_dist's bits.  One loop nest a metric, so l2sqr
// holds no |v| sums.
template <bool COSINE, int NR, int U, typename T>
__device__ __forceinline__ void row_dists_metric(const T* const (&v)[NR], const float* qb, int dim,
                                                 int dim4, float qn, int lane, float (&out)[NR]) {
  const float4* qb4 = reinterpret_cast<const float4*>(qb);
  float acc[NR], vv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = vv[r] = 0.f;
#pragma unroll 1
  for (int i0 = lane; i0 < dim4; i0 += 32 * U) {
    float4 a[U][NR];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (v[r] && i0 + 32 * u < dim4) a[u][r] = load4(v[r], i0 + 32 * u);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + 32 * u >= dim4) break;
      const float4 c = qb4[i0 + 32 * u];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (!v[r]) continue;
        const float4 x = a[u][r];
        if (COSINE) {
          acc[r] += x.x * c.x + x.y * c.y + x.z * c.z + x.w * c.w;
          vv[r] += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
        } else {
          const float dx = x.x - c.x, dy = x.y - c.y, dz = x.z - c.z, dw = x.w - c.w;
          acc[r] += dx * dx + dy * dy + dz * dz + dw * dw;
        }
      }
    }
  }
  for (int i = dim4 * 4 + lane; i < dim; i += 32) {
    const float c = qb[i];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (!v[r]) continue;
      const float x = load1(v[r], i);
      if (COSINE) {
        acc[r] += x * c;
        vv[r] += x * x;
      } else {
        const float dx = x - c;
        acc[r] += dx * dx;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (!v[r]) continue;
    if (COSINE) {
      const float dot = warp_sum(acc[r]);
      const float vn = sqrtf(warp_sum(vv[r]));
      out[r] = 1.f - dot / fmaxf(vn * qn, 1e-10f);
    } else {
      out[r] = warp_sum(acc[r]);
    }
  }
}

template <int NR, int U, typename T>
__device__ __forceinline__ void row_dists(const T* const (&v)[NR], const float* qb, int dim, int dim4,
                                          bool cosine, float qn, int lane, float (&out)[NR]) {
  if (cosine)
    row_dists_metric<true, NR, U>(v, qb, dim, dim4, qn, lane, out);
  else
    row_dists_metric<false, NR, U>(v, qb, dim, dim4, qn, lane, out);
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

// The dedup's id sets: open addressing with linear probing in shared
// memory, 2^log2_slots slots, -1 = empty; never full (the callers size them
// to at least twice their ids).  Membership does not depend on the order of
// insertion or probing.
__device__ __forceinline__ unsigned hash_slot(int id, int log2_slots) {
  return (static_cast<unsigned>(id) * 0x9e3779b1u) >> (32 - log2_slots);
}

// Put id (>= 0) into the set unless it is there; returns its slot.
__device__ __forceinline__ int set_insert(int* table, int log2_slots, int id) {
  const unsigned mask = (1u << log2_slots) - 1u;
  for (unsigned s = hash_slot(id, log2_slots);; s = (s + 1) & mask) {
    const int prev = atomicCAS(table + s, -1, id);
    if (prev == -1 || prev == id) return static_cast<int>(s);
  }
}

__device__ __forceinline__ bool set_has(const int* table, int log2_slots, int id) {
  const unsigned mask = (1u << log2_slots) - 1u;
  for (unsigned s = hash_slot(id, log2_slots);; s = (s + 1) & mask) {
    const int v = table[s];
    if (v == id) return true;
    if (v == -1) return false;
  }
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

}  // namespace vecdb
