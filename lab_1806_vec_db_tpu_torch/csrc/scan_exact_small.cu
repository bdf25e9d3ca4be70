// The exact small-batch scan: the whole exact kNN of a few queries over an
// f32 store, one pass over the rows and one selection, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's exact scan
// (lab_1806_vec_db_tpu/ops/topk.py:knn_scan) is plain XLA: a blocked f32
// GEMM, a sort of each block and a merge.  Its PyTorch form launches ~30
// library operations a 65,536-row block, and at one query the host spends
// longer enqueuing them than the card spends running them.  This kernel is
// that scan for B <= 16 queries and k <= 32 (ops/scan_small.py picks it by
// shape; larger batches keep the GEMM chain).
//
// What it computes, for queries q (B, dim) f32, rows x (n, dim) f32 read in
// place (rows >= n are never read) and, for cosine, |x| (n,) f32:
//
//   l2sqr:  d = sum_j (x[j] - q[j])^2                (the difference form)
//   cosine: d = 1 - dot / max(|q| * |x|, 1e-10)      (|q| summed in f64,
//                                                     rounded once to f32)
//
// and the k smallest (d, id) of each query, ascending, ties to the lower id,
// (+inf, -1) past the rows there are and id -1 wherever d is not finite.
//
// What bounds it on the H100: bytes.  Each row is read once (3,840 bytes at
// dim 960) and costs ~2 flops a byte a query, far under the card's ~20 f32
// flops a byte, so at 200,000 x 960 the bound is 768 MB / 3.35 TB/s =
// 0.229 ms.  The design keeps that many bytes moving and does little else:
//
// - Load.  A one-wave persistent grid (the occupancy calculator's CTAs a SM
//   times the SMs); CTA c owns a contiguous slab of rows.  Each warp takes R
//   rows at a time and issues all R x U 16-byte loads of a 1,024-float chunk
//   before it adds any of them (`ld.global.nc.L1::no_allocate`: the stream
//   never evicts anything), so an SM keeps ~100 KB of row bytes in flight.
//   Loads past the row's end or the slab's end are clamped to an address
//   inside it and their products dropped, so the loads are unconditional.
// - Score.  The queries sit in shared memory; each float4 read of a query
//   serves the warp's R rows.  A warp sums a row with __shfl_xor_sync, which
//   gives every lane the same bits, so what follows is warp-uniform.
// - Select.  Each warp keeps a sorted k-list per query, entry j in lane j.
//   A row is offered only if it beats the list's k-th (distance, id): one
//   compare for almost every row.  An insertion is one ballot, one shuffle
//   up and a shuffle of the new k-th.
// - Finish.  The warps' lists meet in shared memory and one warp a query
//   merges them into the CTA's k best; a second tiny launch (one CTA a
//   query, 32 warps) merges the grid's k-lists and writes the padded
//   outputs.
//
// A row's distance does not depend on which warp or CTA scores it (each
// lane adds its own float4s in one order, the warp sums in one order), so
// the result is the same for any grid and any slicing of the rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 8;                 // float4 loads a lane a row per chunk: 1,024 floats a chunk
constexpr int K_MAX = 32;            // one list entry a lane
constexpr int B_MAX = 16;            // the widest query variant
constexpr int SMEM_MAX = 192 * 1024; // dynamic shared memory a CTA may ask for
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ID = 0x7fffffff;    // the empty entry's id: after every row id

__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// (d, i) orders before (e, j): by distance, then by id.  NaN orders nowhere.
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// One warp's k best (distance, id), ascending: lane j holds entry j (lanes
// >= k hold what fell off the end, or the empty entry); kd is entry k-1's
// distance on every lane, ki its id.
struct TopK {
  float d, kd;
  int i, ki;
};

__device__ __forceinline__ void topk_init(TopK& t) {
  t.d = t.kd = INFINITY;
  t.i = t.ki = NO_ID;
}

// Offer a warp-uniform (d, i) to the list.
__device__ __forceinline__ void offer(TopK& t, float d, int i, int lane, int k) {
  if (!before(d, i, t.kd, t.ki)) return;
  // the entries after the new one are a suffix; lane k-1's is among them
  const int pos = __ffs(__ballot_sync(FULL, before(d, i, t.d, t.i))) - 1;
  const float ud = __shfl_up_sync(FULL, t.d, 1);
  const int ui = __shfl_up_sync(FULL, t.i, 1);
  if (lane > pos) {
    t.d = ud;
    t.i = ui;
  } else if (lane == pos) {
    t.d = d;
    t.i = i;
  }
  t.kd = __shfl_sync(FULL, t.d, k - 1);
  t.ki = __shfl_sync(FULL, t.i, k - 1);
}

// Offer cd[j], ci[j] for j = s + lane, s = first, first + step, ..., j < count:
// LOADS chunks of 32 loaded before any is offered, 32 candidates a ballot,
// only those that beat the k-th offered one by one.
template <int LOADS>
__device__ __forceinline__ void absorb(TopK& t, const float* cd, const int* ci, int count,
                                       int first, int step, int lane, int k) {
  for (int s = first; s < count; s += LOADS * step) {
    float d[LOADS];
    int i[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int j = s + u * step + lane;
      d[u] = j < count ? cd[j] : INFINITY;
      i[u] = j < count ? ci[j] : NO_ID;
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      unsigned m = __ballot_sync(FULL, before(d[u], i[u], t.kd, t.ki));
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        offer(t, __shfl_sync(FULL, d[u], src), __shfl_sync(FULL, i[u], src), lane, k);
      }
    }
  }
}

// |q| as D.dist_cache defines it: the squares summed in float64, the root
// rounded once to f32.  Every lane gets it.
__device__ __forceinline__ float query_norm64(const float* qb, int dim, int lane) {
  double s = 0.0;
  for (int j = lane; j < dim; j += 32) {
    const double v = qb[j];
    s += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return static_cast<float>(sqrt(s));
}

__host__ __device__ constexpr int rows_per_step(int nq) { return nq <= 8 ? 2 : 1; }

// Dynamic shared memory: the B queries, later the warps' k-lists (ids and
// distances) of every query.
inline size_t smem_bytes(int B, int dim, int k) {
  const size_t qs = static_cast<size_t>(B) * dim * 4, lists = static_cast<size_t>(WARPS) * B * k * 8;
  return qs > lists ? qs : lists;
}

// Grid: one CTA a slab of `slab` rows.  Writes each query's CTA k-list to
// part[(b * gridDim.x + cta) * k + j].
template <int NQ, bool COS>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const float* __restrict__ base,
            const float* __restrict__ norms, int B, int dim, int n, int k, int slab,
            float* __restrict__ part_d, int* __restrict__ part_i) {
  constexpr int R = rows_per_step(NQ);
  extern __shared__ float4 smem4[];
  __shared__ float qn[NQ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dim4 = dim >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* base4 = reinterpret_cast<const float4*>(base);
  for (int j = threadIdx.x; j < B * dim4; j += THREADS) smem4[j] = q4[j];
  if (COS)
    for (int b = warp; b < B; b += WARPS) {
      const float v = query_norm64(q + static_cast<size_t>(b) * dim, dim, lane);
      if (lane == 0) qn[b] = v;
    }
  __syncthreads();

  TopK top[NQ];
#pragma unroll
  for (int b = 0; b < NQ; ++b) topk_init(top[b]);
  const long long first = static_cast<long long>(blockIdx.x) * slab;
  const int row0 = static_cast<int>(first < n ? first : n);
  const int row1 = static_cast<int>(first + slab < n ? first + slab : n);

#pragma unroll 1
  for (int r = row0 + warp * R; r < row1; r += WARPS * R) {
    float acc[NQ][R];
#pragma unroll
    for (int b = 0; b < NQ; ++b)
#pragma unroll
      for (int rr = 0; rr < R; ++rr) acc[b][rr] = 0.f;
#pragma unroll 1
    for (int c = lane; c < dim4 + lane; c += 32 * U) {
      float4 x[R][U];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float4* row = base4 + static_cast<size_t>(min(r + rr, row1 - 1)) * dim4;
#pragma unroll
        for (int u = 0; u < U; ++u) x[rr][u] = ld_stream(row + min(c + 32 * u, dim4 - 1));
      }
#pragma unroll
      for (int b = 0; b < NQ; ++b) {
        if (b >= B) break;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (c + 32 * u >= dim4) break;
          const float4 y = smem4[b * dim4 + c + 32 * u];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float4 v = x[rr][u];
            float a = acc[b][rr];
            if (COS) {
              a = fmaf(v.x, y.x, a);
              a = fmaf(v.y, y.y, a);
              a = fmaf(v.z, y.z, a);
              a = fmaf(v.w, y.w, a);
            } else {
              const float dx = v.x - y.x, dy = v.y - y.y, dz = v.z - y.z, dw = v.w - y.w;
              a = fmaf(dx, dx, a);
              a = fmaf(dy, dy, a);
              a = fmaf(dz, dz, a);
              a = fmaf(dw, dw, a);
            }
            acc[b][rr] = a;
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const int row = r + rr;
      if (row >= row1) break;
      const float xn = COS ? __ldg(norms + row) : 0.f;
#pragma unroll
      for (int b = 0; b < NQ; ++b) {
        if (b >= B) break;
        float s = acc[b][rr];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        const float d = COS ? 1.f - s / fmaxf(qn[b] * xn, 1e-10f) : s;
        offer(top[b], d, row, lane, k);
      }
    }
  }

  // the CTA's merge: every warp's list of query b at lists[(b * WARPS + warp) * k]
  __syncthreads();  // the queries' shared memory is free
  float* ld = reinterpret_cast<float*>(smem4);
  int* li = reinterpret_cast<int*>(ld + static_cast<size_t>(WARPS) * B * k);
#pragma unroll
  for (int b = 0; b < NQ; ++b) {
    if (b >= B) break;
    if (lane < k) {
      ld[(b * WARPS + warp) * k + lane] = top[b].d;
      li[(b * WARPS + warp) * k + lane] = top[b].i;
    }
  }
  __syncthreads();
  for (int b = warp; b < B; b += WARPS) {
    TopK t;
    topk_init(t);
    absorb<1>(t, ld + b * WARPS * k, li + b * WARPS * k, WARPS * k, 0, 32, lane, k);
    if (lane < k) {
      const size_t o = (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * k + lane;
      part_d[o] = t.d;
      part_i[o] = t.i;
    }
  }
}

// Grid: one CTA a query.  Merges the G CTAs' k-lists of query b into out:
// 32 warps, each with up to 4 chunks of candidates in flight (a warp that
// loads one chunk at a time waits on ~G * k / 256 loads in a row), then one
// warp merges their lists.
constexpr int MERGE_WARPS = 32;

__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i, int G, int k,
             float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float ld[MERGE_WARPS * K_MAX];
  __shared__ int li[MERGE_WARPS * K_MAX];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t off = static_cast<size_t>(b) * G * k;
  TopK t;
  topk_init(t);
  absorb<4>(t, part_d + off, part_i + off, G * k, warp * 32, MERGE_WARPS * 32, lane, k);
  if (lane < k) {
    ld[warp * k + lane] = t.d;
    li[warp * k + lane] = t.i;
  }
  __syncthreads();
  if (warp) return;
  topk_init(t);
  absorb<4>(t, ld, li, MERGE_WARPS * k, 0, 32, lane, k);
  if (lane < k) {
    out_d[static_cast<size_t>(b) * k + lane] = t.d;
    out_i[static_cast<size_t>(b) * k + lane] = isfinite(t.d) ? t.i : -1;
  }
}

template <int NQ, bool COS>
int variant(bool occupancy, int* ctas, const float* q, const float* base, const float* norms, int B,
            int dim, int n, int k, int grid, int slab, float* part_d, int* part_i,
            cudaStream_t st) {
  const size_t smem = smem_bytes(B, dim, k);
  if (smem > 48 * 1024) {  // the attribute is the current device's: set it at each such call
    const cudaError_t err = cudaFuncSetAttribute(
        scan_kernel<NQ, COS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (occupancy)
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, scan_kernel<NQ, COS>, THREADS, smem));
  scan_kernel<NQ, COS><<<grid, THREADS, smem, st>>>(q, base, norms, B, dim, n, k, slab, part_d,
                                                     part_i);
  return static_cast<int>(cudaGetLastError());
}

// The variant of B queries (the smallest NQ >= B) and metric.
int dispatch(bool occupancy, int* ctas, const float* q, const float* base, const float* norms,
             int B, int dim, int n, int k, int grid, int slab, float* part_d, int* part_i,
             bool cosine, cudaStream_t st) {
#define VECDB_SMALL_VARIANT(NQ)                                                                   \
  if (B <= NQ)                                                                                    \
    return cosine ? variant<NQ, true>(occupancy, ctas, q, base, norms, B, dim, n, k, grid, slab,  \
                                      part_d, part_i, st)                                         \
                  : variant<NQ, false>(occupancy, ctas, q, base, norms, B, dim, n, k, grid, slab, \
                                       part_d, part_i, st);
  VECDB_SMALL_VARIANT(1)
  VECDB_SMALL_VARIANT(2)
  VECDB_SMALL_VARIANT(4)
  VECDB_SMALL_VARIANT(8)
  VECDB_SMALL_VARIANT(16)
#undef VECDB_SMALL_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid(int B, int dim, int k) {
  return B >= 1 && B <= B_MAX && k >= 1 && k <= K_MAX && dim >= 4 && dim % 4 == 0 &&
         smem_bytes(B, dim, k) <= static_cast<size_t>(SMEM_MAX);
}

}  // namespace

// CTAs of the (B, dim, k, metric) variant resident on one SM of the current
// device: the wrapper's grid is this times the SMs, or fewer for few rows.
extern "C" int vecdb_scan_exact_small_ctas_per_sm(int B, int dim, int k, int cosine, int* ctas) {
  if (!valid(B, dim, k)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(true, ctas, nullptr, nullptr, nullptr, B, dim, 0, k, 0, 0, nullptr, nullptr,
                  cosine != 0, nullptr);
}

// q (B, dim), base (>= n, dim) row-major, norms (>= n,) (cosine only), all
// f32 and 16-byte aligned; part (B, grid, k) f32 and int32 scratch; out
// (B, k) f32 and int32.  grid * slab >= n.
extern "C" int vecdb_scan_exact_small(const void* q, const void* base, const void* norms,
                                      void* part_d, void* part_i, void* out_d, void* out_i, int B,
                                      int dim, int n, int k, int grid, int slab, int cosine,
                                      void* stream) {
  if (!valid(B, dim, k) || n < 0 || grid < 1 || static_cast<long long>(grid) * slab < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = dispatch(false, nullptr, static_cast<const float*>(q),
                           static_cast<const float*>(base), static_cast<const float*>(norms), B,
                           dim, n, k, grid, slab, static_cast<float*>(part_d),
                           static_cast<int*>(part_i), cosine != 0, st);
  if (err != 0) return err;
  merge_kernel<<<B, MERGE_WARPS * 32, 0, st>>>(static_cast<const float*>(part_d),
                                      static_cast<const int*>(part_i), grid, k,
                                      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
