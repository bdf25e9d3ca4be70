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
// compares.  So the kernel does no sort of the 2W keys and has five block
// barriers per query (one clears the live count), and, as the TPU kernel
// did, it uses that the beam arrives sorted:
//
//   A  only beam lanes j < m = min(ef, W) are read (a lane j >= ef lands at
//      a position >= j >= ef, so it is re-masked whatever it holds); the
//      tile lanes with d < +inf (finite and -inf) are appended to shared
//      memory, one atomic per warp.  +inf and NaN tile lanes sort after
//      every other key in the plain version and are re-masked wherever
//      they land, so they need no place.
//   B  each live tile key's rank among the live keys is the count of the
//      keys below it (a few threads per key, no barrier: in the loop there
//      are at most 128 of them; a wider tile, up to W, takes the same path
//      with more work per thread); that rank plus the number of beam keys
//      at or below it (binary search over the beam) is its merged position.
//   C  a beam lane j goes to j plus the number of tile keys below it
//      (binary search over the ranked tile).  Keys are distinct, so the
//      positions of the m + n keys are a permutation and fill [0, m).
//   D  one pass re-masks and selects: each thread owns W / blockDim.x
//      adjacent lanes, and one block-wide prefix count of the unexpanded
//      entries (warp shuffles, one barrier for the warp totals) ranks them.
//
// Order keys (beam_body.cuh's order_key, shared with K6): a float d maps to
// a u32 whose unsigned order is the float order (-0 and +0 share one key,
// NaN sits above +inf as in the plain version's sort).  Values are moved,
// never recomputed, so the result equals the plain version's stable sort
// bit for bit.

#include "beam_body.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// Shared memory of one query, in bytes (mp = m rounded up to 4 lanes).
size_t smem_bytes(int W, int mp, int threads) {
  return sizeof(unsigned long long) * W  // live tile keys (order key << 32 | lane)
         + sizeof(int) * 4 * mp          // merged d, i, e; the beam's order keys
         + sizeof(unsigned) * W          // the live tile's order keys, ranked
         + sizeof(int) * (threads / 32 + 1);  // warp totals, the live count
}

// K tile lanes per thread in pass A and K adjacent lanes in pass D:
// W = K * blockDim.x (K = 1 and blockDim.x = max(W, 32) when W <= 256).
template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
beam_post_kernel(const float* __restrict__ beam_d, const int* __restrict__ beam_i,
                 const int* __restrict__ beam_e, const float* __restrict__ nd,
                 const int* __restrict__ nids, float* __restrict__ od, int* __restrict__ oi,
                 int* __restrict__ oe, int* __restrict__ sel, int W, int ef, int E) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = min(ef, W), mp = (m + 3) & ~3;
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  auto* s_tkey = reinterpret_cast<unsigned long long*>(smem_raw);  // W
  float* s_od = reinterpret_cast<float*>(s_tkey + W);              // mp
  int* s_oi = reinterpret_cast<int*>(s_od + mp);                   // mp
  int* s_oe = s_oi + mp;                                           // mp
  unsigned* s_bkey = reinterpret_cast<unsigned*>(s_oe + mp);       // mp
  unsigned* s_tsd = s_bkey + mp;                                   // W
  int* s_wt = reinterpret_cast<int*>(s_tsd + W);                   // T / 32
  int* s_n = s_wt + (T >> 5);                                      // 1
  const size_t row = static_cast<size_t>(blockIdx.x) * W;
  const float* bd = beam_d + row;
  const float* td = nd + row;
  const int* ti = nids + row;

  if (t == 0) *s_n = 0;
  __syncthreads();
  // A: the beam's order keys; the live tile lanes (thread t holds lanes
  // q*T + t), appended in any order, one atomic per warp
  for (int j = t; j < m; j += T) s_bkey[j] = vecdb::order_key(bd[j]);
  float dt[K];
  unsigned live[K];
  int warp_live = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) dt[q] = q * T + t < W ? td[q * T + t] : INFINITY;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    live[q] = __ballot_sync(0xffffffffu, dt[q] < INFINITY);
    warp_live += __popc(live[q]);
  }
  int slot = 0;
  if (lane == 0 && warp_live) slot = atomicAdd(s_n, warp_live);
  slot = __shfl_sync(0xffffffffu, slot, 0);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (dt[q] < INFINITY)
      s_tkey[slot + __popc(live[q] & ((1u << lane) - 1u))] =
          (static_cast<unsigned long long>(vecdb::order_key(dt[q])) << 32) | (q * T + t);
    slot += __popc(live[q]);
  }
  __syncthreads();

  // B: g threads count the live keys below each live key (its rank); the
  // rank plus the beam keys at or below it is its merged position
  const int n = *s_n;
  int g = 1;
  while (g < 32 && 2 * g * n <= T) g <<= 1;
  for (int base = 0; base < n; base += T / g) {  // the same trip count on every thread
    const int i = base + t / g, p = t & (g - 1);
    const unsigned long long key = i < n ? s_tkey[i] : 0ull;
    int below = 0;
    if (i < n)
      for (int j = p; j < n; j += g) below += s_tkey[j] < key;
    for (int o = 1; o < g; o <<= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
    if (i < n && p == 0) {
      const unsigned k = static_cast<unsigned>(key >> 32);
      const int j = static_cast<int>(key & 0xffffffffu);
      s_tsd[below] = k;
      const int pos = below + vecdb::count_below<true>(s_bkey, m, k);
      if (pos < m) {
        s_od[pos] = td[j];
        s_oi[pos] = ti[j];
        s_oe[pos] = 0;
      }
    }
  }
  __syncthreads();

  // C: beam lane j goes to j + the live tile keys below it
  for (int j = t; j < m; j += T) {
    const int pos = j + vecdb::count_below<false>(s_tsd, n, s_bkey[j]);
    if (pos < m) {
      s_od[pos] = bd[j];
      s_oi[pos] = beam_i[row + j];
      s_oe[pos] = beam_e[row + j];
    }
  }
  __syncthreads();

  // D: re-mask lanes [t*K, t*K + K), read and written V at a time (lanes
  // [m, mp) are read unwritten and re-masked); rank the unexpanded entries
  // block-wide
  constexpr int V = K < 4 ? K : 4;
  const int j0 = t * K;
  alignas(4 * V) float d[K];
  alignas(4 * V) int id[K], e[K];
#pragma unroll
  for (int v = 0; v < K; v += V) {
    if (j0 + v < m) {
      vecdb::copy_lanes<V>(d + v, s_od + j0 + v);
      vecdb::copy_lanes<V>(id + v, s_oi + j0 + v);
      vecdb::copy_lanes<V>(e + v, s_oe + j0 + v);
    }
  }
  unsigned unexp = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if (!(j0 + q < m && isfinite(d[q]) && id[q] >= 0)) {
      d[q] = INFINITY;
      id[q] = -1;
      e[q] = 0;
    }
    if (e[q] == 0 && id[q] >= 0) unexp |= 1u << q;
  }
  const int cnt = __popc(unexp);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_wt[warp] = incl;
  __syncthreads();
  int off = incl - cnt, total = 0;
  for (int w = 0; w < (T >> 5); ++w) {
    const int c = s_wt[w];
    off += w < warp ? c : 0;
    total += c;
  }
  int* sel_b = sel + static_cast<size_t>(blockIdx.x) * vecdb::SEL_LANES;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    if ((unexp >> q) & 1u) {
      const int r = off + __popc(unexp & ((1u << q) - 1u));
      if (r < E) {
        e[q] = 1;
        sel_b[r] = id[q];
      }
    }
  }
  if (j0 < W) {
#pragma unroll
    for (int v = 0; v < K; v += V) {
      vecdb::copy_lanes<V>(od + row + j0 + v, d + v);
      vecdb::copy_lanes<V>(oi + row + j0 + v, id + v);
      vecdb::copy_lanes<V>(oe + row + j0 + v, e + v);
    }
  }
  for (int j = min(total, E) + t; j < vecdb::SEL_LANES; j += T) sel_b[j] = -1;
}

template <int K>
int launch(const void* beam_d, const void* beam_i, const void* beam_e, const void* nd,
           const void* nids, void* od, void* oi, void* oe, void* sel, int B, int W, int ef, int E,
           cudaStream_t stream) {
  const int threads = W / K < 32 ? 32 : W / K;
  const size_t smem = smem_bytes(W, (min(ef, W) + 3) & ~3, threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_post_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_post_kernel<K><<<B, threads, smem, stream>>>(
      static_cast<const float*>(beam_d), static_cast<const int*>(beam_i),
      static_cast<const int*>(beam_e), static_cast<const float*>(nd),
      static_cast<const int*>(nids), static_cast<float*>(od), static_cast<int*>(oi),
      static_cast<int*>(oe), static_cast<int*>(sel), W, ef, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vecdb_beam_post(const void* beam_d, const void* beam_i, const void* beam_e,
                               const void* nd, const void* nids, void* od, void* oi, void* oe,
                               void* sel, int B, int W, int ef, int E, void* stream) {
  if (B <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (W / MAX_THREADS) {  // W is a power of two <= 4096
    case 0:
    case 1: return launch<1>(beam_d, beam_i, beam_e, nd, nids, od, oi, oe, sel, B, W, ef, E, s);
    case 2: return launch<2>(beam_d, beam_i, beam_e, nd, nids, od, oi, oe, sel, B, W, ef, E, s);
    case 4: return launch<4>(beam_d, beam_i, beam_e, nd, nids, od, oi, oe, sel, B, W, ef, E, s);
    case 8: return launch<8>(beam_d, beam_i, beam_e, nd, nids, od, oi, oe, sel, B, W, ef, E, s);
    case 16: return launch<16>(beam_d, beam_i, beam_e, nd, nids, od, oi, oe, sel, B, W, ef, E, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
