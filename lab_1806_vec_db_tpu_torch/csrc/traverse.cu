// K3 (traverse): the whole level-0 HNSW beam search of a query in one CTA,
// for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_traverse.py:traverse (Pallas body
// _traverse_kernel).
//
// For query b, from entry[b] (-1 = padding query), with W = pow2(max(ef,
// 128)) beam lanes, R <= 256 ring slots and E * L == 128 tile lanes:
//
//   init    the scored entry merged into an empty beam; select E
//   repeat  until no id is selected or max_iters iterations:
//     1. tile lane e*L + j = links0[sel[e], j] (-1 where sel[e] < 0)
//     2. dedup + compaction against the beam and the ring (K4's semantics)
//     3. ring' = [sel[0..E), ring[0..R-E)] with the ids expanded now
//     4. exact distances of the novel rows (K2's row_dist: the same bits)
//     5. merge, re-mask, select the next E (K5's semantics, by a full sort)
//   out     the first ef lanes of the beam: exact f32 distances, ascending
//
// That is the reference's iteration order (pallas_traverse.py:171-224) and
// the fused lock-step loop of ops/beam.py; the plain version traverse_ref
// runs that loop on the plain K4, K5 and K2 versions.
//
// Per-query termination: the reference stops a whole tile of queries on one
// flag.  A converged query selects nothing, so its tile is empty and its beam
// can no longer change: stopping each query on its own gives the same beam.
//
// What bounds it on the H100: latency.  The work is B x (novel rows scored)
// row reads of 4*dim bytes (2*dim for bf16 rows; the bound PERF.md prices),
// but each iteration waits on a chain: links read -> dedup -> row reads ->
// sort, so halving the row bytes does not shorten it.  One CTA per query
// (B = 1000 CTAs, several per SM) keeps the beam, the rings, the tile, the
// sort keys and the query row in shared memory for the whole search, so
// nothing but links and rows is read from device memory and only the final
// beam is written.  The links are read in place from the (cap, L) matrix:
// the reference's (N, 128) packed table with the node id in lane 0 was a
// TPU DMA-alignment device.  Each novel row is one warp's 4-lane vector
// loads (16 bytes of f32, 8 of bf16); 8 warps take the rows in turn.
// Overlapping the row reads of one iteration with the sort of the previous
// (cp.async, prefetch) is later work.
//
// The rows are f32 (the full store's) or bf16 (the lean tier's rerank rows,
// their raw 16 bits as uint16_t): the kernel is a template on the row type,
// reads a bf16 row in place (half the bytes) and upcasts each lane to f32
// before the arithmetic, as the reference's candidate-row scratch takes the
// slab's dtype and upcasts at its distance epilogue (pallas_traverse.py:
// 324-327).  row_dist is K2's, so the bits equal K2's on the same rows.
//
// flags: bit 0 = cosine, bit 1 = vector path allowed (dim % 4 == 0, the rows
// 16-byte (f32) / 8-byte (bf16) aligned; the wrapper checks), bit 2 = bf16
// rows.

#include "beam_body.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 128;  // E * L

template <typename T>
__global__ void __launch_bounds__(THREADS)
traverse_kernel(const float* __restrict__ q, const T* __restrict__ base,
                const int* __restrict__ links0, const int* __restrict__ entry,
                float* __restrict__ out_d, int* __restrict__ out_i, int dim, long long n_rows,
                int L, int ef, int W, int R, int E, int max_iters, int flags) {
  extern __shared__ float4 smem4[];
  const int dim_pad = (dim + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem4);  // dim_pad, 16-byte aligned
  float* kd = qs + dim_pad;                     // 2W merge keys: beam, then tile
  int* kre = reinterpret_cast<int*>(kd + 2 * W);  // 2W (beam lanes hold e between merges)
  int* kid = kre + 2 * W;                          // 2W
  int* ring_a = kid + 2 * W;                       // R
  int* ring_b = ring_a + R;                        // R
  int* nbrs = ring_b + R;                          // TILE
  int* comp = nbrs + TILE;                         // TILE
  float* td = reinterpret_cast<float*>(comp + TILE);  // TILE
  int* sel = reinterpret_cast<int*>(td + TILE);       // SEL_LANES
  int* warp_tot = sel + vecdb::SEL_LANES;             // WARPS

  const size_t b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool cosine = flags & 1;
  const int dim4 = (flags & 2) ? dim >> 2 : 0;

  for (int k = t; k < dim; k += THREADS) qs[k] = q[b * dim + k];
  for (int j = t; j < W; j += THREADS) {
    kd[j] = INFINITY;
    kid[j] = -1;
    kre[j] = 0;
  }
  for (int j = t; j < R; j += THREADS) ring_a[j] = -1;
  __syncthreads();
  const float qn = cosine ? vecdb::query_norm(qs, dim, dim4, lane) : 0.f;

  // the scored entry, merged into the empty beam
  const int e0 = entry[b];
  if (warp == 0) {
    float d = INFINITY;
    if (e0 >= 0 && e0 < n_rows)
      d = vecdb::row_dist(base + static_cast<size_t>(e0) * dim, qs, dim, dim4, cosine, qn, lane);
    if (lane == 0) {
      td[0] = d;
      comp[0] = e0;
    }
  }
  __syncthreads();
  vecdb::stage_merge(kd, kre, kid, W, td, comp, 1);
  vecdb::bitonic_sort(kd, kre, kid, 2 * W);
  vecdb::remask_select(kd, kre, kid, W, ef, E, sel, warp_tot);

  int* ring = ring_a;
  int* ring_next = ring_b;
  for (int it = 0; it < max_iters; ++it) {
    bool any = false;
    for (int e = 0; e < E; ++e) any |= sel[e] >= 0;
    if (!any) break;  // uniform: sel is in shared memory, synced

    // 1. links of the selected ids, e-major
    if (t < TILE) {
      const int e = t / L, j = t - e * L;
      const int s = sel[e];
      nbrs[t] = s >= 0 ? links0[static_cast<size_t>(s) * L + j] : -1;
    }
    __syncthreads();
    // 2. dedup + compaction against the beam and the ring before the shift
    const int count = vecdb::dedup_compact(nbrs, TILE, kid, W, ring, R, comp, TILE, warp_tot);
    // 3. the ring shifted with this iteration's expanded ids
    for (int j = t; j < R; j += THREADS) ring_next[j] = j < E ? sel[j] : ring[j - E];
    // 4. exact distances of the novel rows
    for (int j = warp; j < count; j += WARPS) {
      const int id = comp[j];
      float d = INFINITY;
      if (id < n_rows)
        d = vecdb::row_dist(base + static_cast<size_t>(id) * dim, qs, dim, dim4, cosine, qn, lane);
      if (lane == 0) td[j] = d;
    }
    __syncthreads();
    int* tmp = ring;
    ring = ring_next;
    ring_next = tmp;
    // 5. merge + re-mask + the next selection
    vecdb::stage_merge(kd, kre, kid, W, td, comp, count);
    vecdb::bitonic_sort(kd, kre, kid, 2 * W);
    vecdb::remask_select(kd, kre, kid, W, ef, E, sel, warp_tot);
  }
  for (int j = t; j < ef; j += THREADS) {
    out_d[b * ef + j] = kd[j];
    out_i[b * ef + j] = kid[j];
  }
}

template <typename T>
int launch(const void* q, const void* base, const void* links0, const void* entry, void* out_d,
           void* out_i, int B, int dim, long long n_rows, int L, int ef, int W, int R, int E,
           int max_iters, int flags, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  traverse_kernel<T><<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(base), static_cast<const int*>(links0),
      static_cast<const int*>(entry), static_cast<float*>(out_d), static_cast<int*>(out_i), dim,
      n_rows, L, ef, W, R, E, max_iters, flags);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vecdb_traverse(const void* q, const void* base, const void* links0,
                              const void* entry, void* out_d, void* out_i, int B, int dim,
                              long long n_rows, int L, int ef, int W, int R, int E, int max_iters,
                              int flags, void* stream) {
  if (B <= 0) return 0;
  if (E * L != TILE || R > 256 || E > R || ef > W) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (((dim + 3) & ~3) + 6 * static_cast<size_t>(W) + 2 * R +
                                       3 * TILE + vecdb::SEL_LANES + WARPS);
  return (flags & 4) ? launch<uint16_t>(q, base, links0, entry, out_d, out_i, B, dim, n_rows, L,
                                         ef, W, R, E, max_iters, flags, smem, stream)
                     : launch<float>(q, base, links0, entry, out_d, out_i, B, dim, n_rows, L, ef,
                                     W, R, E, max_iters, flags, smem, stream);
}
