// K3 (traverse): the whole level-0 HNSW beam search of a query in one CTA,
// for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_traverse.py:traverse (Pallas body
// _traverse_kernel).
//
// For query b, from entry[b] (-1 = padding query), with ef beam lanes, R <=
// 256 ring slots and E * L == 128 tile lanes:
//
//   init    the scored entry merged into an empty beam; select E
//   repeat  until no id is selected or max_iters iterations:
//     1. tile lane e*L + j = links0[sel[e], j] (-1 where sel[e] < 0)
//     2. dedup + compaction against the beam and the ring (K4's semantics)
//     3. ring' = [sel[0..E), ring[0..R-E)] with the ids expanded now
//     4. exact distances of the novel rows (K2's row_dist: the same bits)
//     5. merge, re-mask, select the next E (K5's semantics)
//   out     the first ef lanes of the beam: exact f32 distances, ascending
//
// That is the reference's iteration order (pallas_traverse.py:171-224) and
// the fused lock-step loop of ops/beam.py; the plain version traverse_ref
// runs that loop on the plain K4, K5 and K2 versions.  The reference's beam
// has W = pow2(max(ef, 128)) lanes, but lanes >= ef are re-masked after
// every merge, so only ef lanes are kept here.
//
// Per-query termination: the reference stops a whole tile of queries on one
// flag.  A converged query selects nothing, so its tile is empty and its beam
// can no longer change: stopping each query on its own gives the same beam.
//
// What bounds it on the H100: bytes, and for bf16 rows the rate of random
// row reads.  The work is B x (novel rows scored) row reads of 4*dim bytes
// (2*dim for bf16 rows); the rest of an iteration (links, dedup, merge) is
// a chain of barriers on shared memory, and a query runs ~33 iterations at
// ef 120.  The design keeps every CTA's loop short and many rows in flight:
//
//   - one wave: 128 threads (a thread per tile lane), at most 64 registers
//     (__launch_bounds__(128, 8); 56 used, no spill) and a shared-memory
//     plan (ops/traverse.py:k3_plan) under 27.5 KB a CTA up to ef 360, so
//     B = 1000 CTAs are resident at once on 132 SMs, 8 a SM.  The plan's
//     section offsets reach the kernel as a parameter (`Layout`), read from
//     the constant bank instead of held in registers;
//   - K4's dedup: the beam's and the ring's ids in an open-addressing set,
//     the tile's in a table that keeps each id's smallest lane (atomicMin),
//     one or two probes a lane instead of a scan of the beam and the ring;
//     the set is built while the links loads are in flight;
//   - the ring is a circular buffer: the shift overwrites its E oldest ids;
//   - each warp scores NR novel rows at once, U load steps of each issued
//     before any is added (row_dists: row_dist's per-lane order, so K2's
//     bits): 3 rows x 1 step of 8-byte loads for bf16 rows, 2 x 2 of 16
//     bytes for f32.  bf16 rows gain from more rows in flight, not from
//     more steps of one row: a random row read of 1,920 bytes costs much
//     more than half one of 3,840 (bench/k3_phases.py's gather rates,
//     PERF.md), and an L2 prefetch of every novel row only added traffic;
//   - K5's merge by rank, no sort: each tile key's rank among the tile
//     keys (counted) plus the beam keys at or below it (binary search), each
//     beam lane at j plus the tile keys below it, then one pass re-masks
//     and selects with one block prefix count; eight barriers an iteration.
//
// The beam, the ring, the sets, the tile and the query row stay in shared
// memory for the whole search; only links and rows are read from device
// memory and only the final beam is written.  The links are read in place
// from the (cap, L) matrix: the reference's (N, 128) packed table with the
// node id in lane 0 was a TPU DMA-alignment device.
//
// The rows are f32 (the full store's) or bf16 (the lean tier's rerank rows,
// their raw 16 bits as uint16_t): the kernel is a template on the row type,
// reads a bf16 row in place (half the bytes) and upcasts each lane to f32
// before the arithmetic, as the reference's candidate-row scratch takes the
// slab's dtype and upcasts at its distance epilogue (pallas_traverse.py:
// 324-327).
//
// Keys (beam_body.cuh's order_key) order the floats as the plain version's
// stable sort does, ties to the beam and then to the lower lane; values are
// moved, never recomputed, and the set's membership does not depend on the
// order of insertion, so the loop is the plain version's step for step.
//
// flags: bit 0 = cosine, bit 1 = vector path allowed (dim % 4 == 0, the rows
// 16-byte (f32) / 8-byte (bf16) aligned; the wrapper checks), bit 2 = bf16
// rows.

#include <limits.h>

#include "beam_body.cuh"

namespace {

constexpr int THREADS = 128;  // one thread per tile lane
constexpr int WARPS = THREADS / 32;
constexpr int MIN_CTAS = 8;   // 8 x 132 SMs >= B = 1000: one wave
constexpr int TILE = 128;     // E * L
constexpr int LOG2_TILE_SLOTS = 8;  // the tile's id table: 2 * TILE slots
constexpr int TILE_SLOTS = 1 << LOG2_TILE_SLOTS;

// One CTA's shared memory, as word offsets: the query row (dim rounded up
// to 4 words, at 0), two beams of mp = ef rounded up to 4 lanes (this one
// and the merge's output; d, id, e), the id set, the tile table (ids and
// smallest lanes), the ring, the compacted tile (ids, distances), sel and
// two rows of warp totals.  Each section is a multiple of 4 words, so each
// is 16-byte aligned (the merge's 8-byte tile keys reuse the set's words).
// The kernel takes the offsets as a parameter: read from the constant bank,
// they hold no registers.  ops/traverse.py:k3_plan computes the same bytes.
struct Layout {
  int mp, bd, bi, be, set, tid, tlane, ring, comp, td, sel, wt, log2_set;
};

Layout smem_layout(int dim, int ef, int R, int log2_set) {
  Layout l;
  l.mp = (ef + 3) & ~3;
  l.bd = (dim + 3) & ~3;
  l.bi = l.bd + 2 * l.mp;
  l.be = l.bi + 2 * l.mp;
  l.set = l.be + 2 * l.mp;
  l.tid = l.set + (1 << log2_set);
  l.tlane = l.tid + TILE_SLOTS;
  l.ring = l.tlane + TILE_SLOTS;
  l.comp = l.ring + ((R + 3) & ~3);
  l.td = l.comp + TILE;
  l.sel = l.td + TILE;
  l.wt = l.sel + vecdb::SEL_LANES;
  l.log2_set = log2_set;
  return l;
}

size_t smem_bytes(const Layout& l) { return 4 * static_cast<size_t>(l.wt + 2 * WARPS); }

// Number of beam lanes j < m whose key is <= k (the beam is ascending).
__device__ __forceinline__ int beam_at_or_below(const float* bd, int m, unsigned k) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (vecdb::order_key(bd[mid]) <= k)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The merge of the scored tile (tkey, td, comp: n lanes, tkey[j] =
// order_key(td[j]) << 32 | j) into the beam (cd, ci, ce: ef lanes), written
// to (nd, ni, ne); then the re-mask and the next selection into sel[0, E).
// Lanes of +inf or NaN take part: they rank after every finite key and land
// at or past ef, where the re-mask would drop them.  Clears the set, whose
// words tkey and tsd reuse, once they are read.  Ends on a barrier.
__device__ __forceinline__ void merge_select(const float* cd, const int* ci, const int* ce,
                                             float* nd, int* ni, int* ne,
                                             const unsigned long long* tkey, unsigned* tsd,
                                             const float* td, const int* comp, int n, int ef, int E,
                                             int* sel, int* wt, int* set, int n_set) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // B: g threads count the tile keys below each tile key (its rank); the
  // rank plus the beam keys at or below it is its merged position
  int g = 1;
  while (g < 32 && 2 * g * n <= THREADS) g <<= 1;
  for (int base = 0; base < n; base += THREADS / g) {  // one trip when n <= 128
    const int i = base + t / g, p = t & (g - 1);
    const unsigned long long key = i < n ? tkey[i] : 0ull;
    int below = 0;
    if (i < n)
      for (int j = p; j < n; j += g) below += tkey[j] < key;
    for (int o = 1; o < g; o <<= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
    if (i < n && p == 0) {
      const unsigned k = static_cast<unsigned>(key >> 32);
      tsd[below] = k;
      const int pos = below + beam_at_or_below(cd, ef, k);
      if (pos < ef) {
        nd[pos] = td[i];
        ni[pos] = comp[i];
        ne[pos] = 0;
      }
    }
  }
  __syncthreads();
  // C: beam lane j goes to j + the tile keys below it
  for (int j = t; j < ef; j += THREADS) {
    const float d = cd[j];
    const int pos = j + vecdb::count_below<false>(tsd, n, vecdb::order_key(d));
    if (pos < ef) {
      nd[pos] = d;
      ni[pos] = ci[j];
      ne[pos] = ce[j];
    }
  }
  __syncthreads();
  // D: re-mask lanes [t*K, t*K + K) (non-finite d or id < 0 become (inf,
  // -1, 0)); rank the unexpanded entries block-wide; the first E are
  // marked expanded and go to sel
  const int K = (ef + THREADS - 1) / THREADS;  // <= 32: ef <= 4096
  const int j0 = t * K;
  unsigned unexp = 0;
  for (int q = 0; q < K && j0 + q < ef; ++q) {
    const int j = j0 + q;
    const float d = nd[j];
    const int id = ni[j];
    if (!(isfinite(d) && id >= 0)) {
      nd[j] = INFINITY;
      ni[j] = -1;
      ne[j] = 0;
    } else if (ne[j] == 0) {
      unexp |= 1u << q;
    }
  }
  const int cnt = __popc(unexp);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wt[warp] = incl;
  for (int j = t; j < n_set; j += THREADS) set[j] = -1;  // tkey / tsd are read
  __syncthreads();
  int off = incl - cnt, total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = wt[w];
    off += w < warp ? c : 0;
    total += c;
  }
  for (unsigned u = unexp; u && off < E; u &= u - 1, ++off) {
    const int j = j0 + __ffs(u) - 1;
    ne[j] = 1;
    sel[off] = ni[j];
  }
  for (int j = min(total, E) + t; j < E; j += THREADS) sel[j] = -1;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
traverse_kernel(const float* __restrict__ q, const T* __restrict__ base,
                const int* __restrict__ links0, const int* __restrict__ entry,
                float* __restrict__ out_d, int* __restrict__ out_i, int dim, long long n_rows,
                int L, int ef, int R, int E, int max_iters, int flags, const Layout lay) {
  extern __shared__ float4 smem4[];
  int* const sm = reinterpret_cast<int*>(smem4);
  const int mp = lay.mp, n_set = 1 << lay.log2_set;
  float* qs = reinterpret_cast<float*>(sm);                       // the query row
  float* bd = reinterpret_cast<float*>(sm + lay.bd);              // 2 x mp: beam d (this, next)
  int* bi = sm + lay.bi;                                          // 2 x mp: beam ids
  int* be = sm + lay.be;                                          // 2 x mp: expanded flags
  int* set = sm + lay.set;                                        // n_set: beam and ring ids
  auto* tkey = reinterpret_cast<unsigned long long*>(set);        // TILE, in the set's words
  auto* tsd = reinterpret_cast<unsigned*>(tkey + TILE);           // TILE: the tile keys, ranked
  int* tid = sm + lay.tid;                                        // TILE_SLOTS: the tile's ids
  int* tlane = sm + lay.tlane;                                    // TILE_SLOTS: smallest lanes
  int* ring = sm + lay.ring;                                      // R, circular
  int* comp = sm + lay.comp;                                      // TILE: the novel ids
  float* td = reinterpret_cast<float*>(sm + lay.td);              // TILE: their distances
  int* sel = sm + lay.sel;                                        // SEL_LANES
  int* wt = sm + lay.wt;                                          // 2 x WARPS

  const size_t b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool cosine = flags & 1;
  const int dim4 = (flags & 2) ? dim >> 2 : 0;
  // a warp scores NR novel rows at once with U load steps of each in
  // flight: 3 x 1 loads of 8 bytes a lane for bf16 rows, 2 x 2 of 16 for
  // f32 (the most rows that fit 56 registers without a spill)
  constexpr int NR = sizeof(T) == 2 ? 3 : 2;
  constexpr int U = sizeof(T) == 2 ? 1 : 2;

  for (int k = t; k < dim; k += THREADS) qs[k] = q[b * dim + k];
  for (int j = t; j < mp; j += THREADS) {
    bd[j] = INFINITY;
    bi[j] = -1;
    be[j] = 0;
  }
  for (int j = t; j < R; j += THREADS) ring[j] = -1;
  for (int j = t; j < n_set; j += THREADS) set[j] = -1;
  for (int j = t; j < TILE_SLOTS; j += THREADS) {
    tid[j] = -1;
    tlane[j] = INT_MAX;
  }
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
      tkey[0] = static_cast<unsigned long long>(vecdb::order_key(d)) << 32;
    }
  }
  __syncthreads();
  int cur = 0;  // the beam is buffer cur, the merge writes buffer cur ^ 1
  merge_select(bd, bi, be, bd + mp, bi + mp, be + mp, tkey, tsd, td, comp, 1, ef, E, sel, wt + WARPS,
               set, n_set);
  cur = 1;

  int head = 0;  // ring slot j (0 = the newest) is ring[(head + j) % R]
  for (int it = 0; it < max_iters; ++it) {
    bool any = false;
    for (int e = 0; e < E; ++e) any |= sel[e] >= 0;
    if (!any) break;  // uniform: sel is in shared memory, synced
    const float* cd = bd + cur * mp;
    const int* ci = bi + cur * mp;
    const int* ce = be + cur * mp;

    // 1. the links of the selected ids (e-major) in flight while the beam's
    // and the ring's ids go into the set; then the tile's into its table
    int id = -1;
    {
      const int e = t / L, s = sel[e];
      if (s >= 0) id = links0[static_cast<size_t>(s) * L + (t - e * L)];
    }
    for (int j = t; j < ef + R; j += THREADS) {
      const int v = j < ef ? ci[j] : ring[j - ef];
      if (v >= 0) vecdb::set_insert(set, lay.log2_set, v);
    }
    int tslot = 0;
    if (id >= 0) {
      tslot = vecdb::set_insert(tid, LOG2_TILE_SLOTS, id);
      atomicMin(tlane + tslot, t);
    }
    __syncthreads();

    // 2. fresh: id >= 0, in neither the beam nor the ring, at its id's
    // smallest lane; compacted in lane order.  The ring shifts: its E
    // oldest slots take this iteration's selection.
    const bool fresh = id >= 0 && tlane[tslot] == t && !vecdb::set_has(set, lay.log2_set, id);
    const unsigned fm = __ballot_sync(0xffffffffu, fresh);
    if (lane == 0) wt[warp] = __popc(fm);
    head = (head + R - E) % R;
    if (t < E) ring[(head + t) % R] = sel[t];
    __syncthreads();
    int count = 0, off = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = wt[w];
      off += w < warp ? c : 0;
      count += c;
    }
    if (fresh) comp[off + __popc(fm & ((1u << lane) - 1u))] = id;
    __syncthreads();

    // 3. exact distances of the novel rows, NR a warp at once, and their
    // merge keys; the tile table is free again
    for (int j = t; j < TILE_SLOTS; j += THREADS) {
      tid[j] = -1;
      tlane[j] = INT_MAX;
    }
    for (int r0 = warp * NR; r0 < count; r0 += WARPS * NR) {
      const T* rows[NR];
      float d[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int j = r0 + r;
        const int v = j < count ? comp[j] : -1;
        rows[r] = v >= 0 && v < n_rows ? base + static_cast<size_t>(v) * dim : nullptr;
        d[r] = INFINITY;
      }
      vecdb::row_dists<NR, U>(rows, qs, dim, dim4, cosine, qn, lane, d);
      if (lane < NR && r0 + lane < count) {
        float dl = d[0];
#pragma unroll
        for (int r = 1; r < NR; ++r) dl = lane == r ? d[r] : dl;
        td[r0 + lane] = dl;
        tkey[r0 + lane] = (static_cast<unsigned long long>(vecdb::order_key(dl)) << 32) | (r0 + lane);
      }
    }
    __syncthreads();

    // 4. merge, re-mask, select
    merge_select(cd, ci, ce, bd + (cur ^ 1) * mp, bi + (cur ^ 1) * mp, be + (cur ^ 1) * mp, tkey,
                 tsd, td, comp, count, ef, E, sel, wt + WARPS, set, n_set);
    cur ^= 1;
  }
  for (int j = t; j < ef; j += THREADS) {
    out_d[b * ef + j] = bd[cur * mp + j];
    out_i[b * ef + j] = bi[cur * mp + j];
  }
}

template <typename T>
int launch(const void* q, const void* base, const void* links0, const void* entry, void* out_d,
           void* out_i, int B, int dim, long long n_rows, int L, int ef, int R, int E,
           int max_iters, int flags, const Layout& lay, void* stream) {
  const size_t smem = smem_bytes(lay);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  traverse_kernel<T><<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(base), static_cast<const int*>(links0),
      static_cast<const int*>(entry), static_cast<float*>(out_d), static_cast<int*>(out_i), dim,
      n_rows, L, ef, R, E, max_iters, flags, lay);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ctas_per_sm(size_t smem, int* ctas) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, traverse_kernel<T>, THREADS, smem));
}

}  // namespace

// smem and log2_set come from ops/traverse.py:k3_plan; a plan that does not
// match this file's layout is refused.
extern "C" int vecdb_traverse(const void* q, const void* base, const void* links0,
                              const void* entry, void* out_d, void* out_i, int B, int dim,
                              long long n_rows, int L, int ef, int R, int E, int max_iters,
                              int log2_set, long long smem, int flags, void* stream) {
  if (B <= 0) return 0;
  const Layout lay = smem_layout(dim, ef, R, log2_set);
  if (E * L != TILE || R > 256 || E > R || ef < 1 || ef > 32 * THREADS ||
      (1 << log2_set) < 2 * (ef + R) || (1 << log2_set) < 3 * TILE ||  // the merge's keys fit
      static_cast<size_t>(smem) != smem_bytes(lay))
    return static_cast<int>(cudaErrorInvalidValue);
  return (flags & 4) ? launch<uint16_t>(q, base, links0, entry, out_d, out_i, B, dim, n_rows, L,
                                         ef, R, E, max_iters, flags, lay, stream)
                     : launch<float>(q, base, links0, entry, out_d, out_i, B, dim, n_rows, L, ef,
                                     R, E, max_iters, flags, lay, stream);
}

// CTAs of K3 resident on one SM at this shared-memory size (the
// occupancy calculator: registers, threads and shared memory).
extern "C" int vecdb_traverse_ctas_per_sm(int bf16, long long smem, int* ctas) {
  return bf16 ? ctas_per_sm<uint16_t>(smem, ctas) : ctas_per_sm<float>(smem, ctas);
}
