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
//   keys     beam lane j: (d, rank j); tile lane j: (nd, rank ef + j)
//   out      the ef smallest keys, ascending by (d, rank): ties go to the
//            beam, then to the lower lane (lax.top_k's stable order)
//
// Every key is distinct, so the order is unique: it equals the plain
// version's stable sort of [beam, tile] bit for bit, the +inf and NaN tail
// included.
//
// What bounds it on the H100: latency, not bytes (9 ef + 8 EL bytes in and 9
// ef out per query) or compares.  So the kernel sorts nothing and has three
// block barriers per query; as the TPU kernel did, it uses that the beam
// arrives sorted and that only ef keys come out.  One CTA per query:
//
//   A  the beam's d, i, e and order keys, and the tile's d, i and keys
//      (order_key(d) << 32 | lane), into shared memory.
//   B  each tile key's rank among the tile is the count of the tile keys
//      below it (g threads per key, K5's pass B on every lane); its order
//      key goes to slot `rank` of the sorted tile, and rank plus the number
//      of beam keys at or below it (binary search over the beam) is its
//      merged position.
//   C  beam lane j goes to j plus the number of tile keys below it (binary
//      search over the sorted tile).  The positions of the ef + EL keys are
//      a permutation, so those below ef fill [0, ef) exactly: no lane, +inf
//      or NaN, is dropped, and the tail needs no rebuilding.
//   then the ef merged lanes go out, coalesced.
//
// Order keys (beam_body.cuh, shared with K5): a float maps to a u32 whose
// unsigned order is the float order (-0 and +0 share one key, NaN sits above
// +inf as in the plain version's sort).  Values are moved, never recomputed;
// e moves as the bytes of torch.bool storage.  Rows are 4 ef and 4 EL bytes
// apart, so 16-byte lane copies (V = 4) run only when ef and EL are
// multiples of 4 and every pointer is aligned to them; else V = 1.

#include "beam_body.cuh"

namespace {

constexpr int MAX_THREADS = 256;

// Shared memory of one query, in bytes (efp, elp: ef, EL rounded up to 4
// lanes, so every array starts 16-byte aligned).
size_t smem_bytes(int efp, int elp) {
  return sizeof(unsigned long long) * elp  // tile keys
         + sizeof(int) * 5 * efp           // beam order keys, d, i; merged d, i
         + sizeof(int) * 3 * elp           // tile d, i; sorted tile order keys
         + 2 * efp;                        // beam e, merged e
}

template <int V>
__global__ void __launch_bounds__(MAX_THREADS)
merge_sorted_kernel(const float* __restrict__ beam_d, const int* __restrict__ beam_i,
                    const uint8_t* __restrict__ beam_e, const float* __restrict__ nd,
                    const int* __restrict__ nids, float* __restrict__ od, int* __restrict__ oi,
                    uint8_t* __restrict__ oe, int ef, int EL) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int efp = (ef + 3) & ~3, elp = (EL + 3) & ~3;
  const int T = blockDim.x, t = threadIdx.x;
  auto* s_tkey = reinterpret_cast<unsigned long long*>(smem_raw);  // elp
  unsigned* s_bkey = reinterpret_cast<unsigned*>(s_tkey + elp);    // efp
  float* s_bd = reinterpret_cast<float*>(s_bkey + efp);            // efp
  int* s_bi = reinterpret_cast<int*>(s_bd + efp);                  // efp
  float* s_od = reinterpret_cast<float*>(s_bi + efp);              // efp
  int* s_oi = reinterpret_cast<int*>(s_od + efp);                  // efp
  float* s_td = reinterpret_cast<float*>(s_oi + efp);              // elp
  int* s_ti = reinterpret_cast<int*>(s_td + elp);                  // elp
  unsigned* s_tsd = reinterpret_cast<unsigned*>(s_ti + elp);       // elp
  uint8_t* s_be = reinterpret_cast<uint8_t*>(s_tsd + elp);         // efp
  uint8_t* s_oe = s_be + efp;                                      // efp
  const size_t rb = static_cast<size_t>(blockIdx.x) * ef;
  const size_t rt = static_cast<size_t>(blockIdx.x) * EL;

  // A: V lanes a thread at a time
  for (int j = t * V; j < ef; j += T * V) {
    const auto d = *reinterpret_cast<const vecdb::Lanes<V, float>*>(beam_d + rb + j);
    *reinterpret_cast<vecdb::Lanes<V, float>*>(s_bd + j) = d;
    vecdb::copy_lanes<V>(s_bi + j, beam_i + rb + j);
    vecdb::copy_lanes<V>(s_be + j, beam_e + rb + j);
#pragma unroll
    for (int q = 0; q < V; ++q) s_bkey[j + q] = vecdb::order_key(d.v[q]);
  }
  for (int j = t * V; j < EL; j += T * V) {
    const auto d = *reinterpret_cast<const vecdb::Lanes<V, float>*>(nd + rt + j);
    *reinterpret_cast<vecdb::Lanes<V, float>*>(s_td + j) = d;
    vecdb::copy_lanes<V>(s_ti + j, nids + rt + j);
#pragma unroll
    for (int q = 0; q < V; ++q)
      s_tkey[j + q] = (static_cast<unsigned long long>(vecdb::order_key(d.v[q])) << 32) | (j + q);
  }
  __syncthreads();

  // B: g threads count the tile keys below each tile key (its rank)
  int g = 1;
  while (g < 32 && 2 * g * EL <= T) g <<= 1;
  for (int base = 0; base < EL; base += T / g) {  // the same trip count on every thread
    const int i = base + t / g, p = t & (g - 1);
    const unsigned long long key = i < EL ? s_tkey[i] : 0ull;
    int below = 0;
    if (i < EL)
      for (int j = p; j < EL; j += g) below += s_tkey[j] < key;
    for (int o = 1; o < g; o <<= 1) below += __shfl_xor_sync(0xffffffffu, below, o);
    if (i < EL && p == 0) {
      const unsigned k = static_cast<unsigned>(key >> 32);
      s_tsd[below] = k;
      const int pos = below + vecdb::count_below<true>(s_bkey, ef, k);
      if (pos < ef) {
        s_od[pos] = s_td[i];
        s_oi[pos] = s_ti[i];
        s_oe[pos] = 0;
      }
    }
  }
  __syncthreads();

  // C: beam lane j goes to j + the tile keys below it
  for (int j = t; j < ef; j += T) {
    const int pos = j + vecdb::count_below<false>(s_tsd, EL, s_bkey[j]);
    if (pos < ef) {
      s_od[pos] = s_bd[j];
      s_oi[pos] = s_bi[j];
      s_oe[pos] = s_be[j];
    }
  }
  __syncthreads();

  for (int j = t * V; j < ef; j += T * V) {
    vecdb::copy_lanes<V>(od + rb + j, s_od + j);
    vecdb::copy_lanes<V>(oi + rb + j, s_oi + j);
    vecdb::copy_lanes<V>(oe + rb + j, s_oe + j);
  }
}

template <int V>
int launch(const void* beam_d, const void* beam_i, const void* beam_e, const void* nd,
           const void* nids, void* od, void* oi, void* oe, int B, int ef, int EL,
           cudaStream_t stream) {
  int threads = 32;  // pow2(max(ef, EL)), 32 to 256, as K5 sizes its CTA from W
  while (threads < MAX_THREADS && (threads < ef || threads < EL)) threads <<= 1;
  const size_t smem = smem_bytes((ef + 3) & ~3, (EL + 3) & ~3);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_sorted_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  merge_sorted_kernel<V><<<B, threads, smem, stream>>>(
      static_cast<const float*>(beam_d), static_cast<const int*>(beam_i),
      static_cast<const uint8_t*>(beam_e), static_cast<const float*>(nd),
      static_cast<const int*>(nids), static_cast<float*>(od), static_cast<int*>(oi),
      static_cast<uint8_t*>(oe), ef, EL);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// beam_e and oe are torch.bool storage (one byte a lane, 0 or 1).
extern "C" int vecdb_merge_sorted(const void* beam_d, const void* beam_i, const void* beam_e,
                                  const void* nd, const void* nids, void* od, void* oi, void* oe,
                                  int B, int ef, int EL, void* stream) {
  if (B <= 0 || ef <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = ef % 4 == 0 && EL % 4 == 0 && aligned(beam_d, 16) && aligned(beam_i, 16) &&
                   aligned(nd, 16) && aligned(nids, 16) && aligned(od, 16) && aligned(oi, 16) &&
                   aligned(beam_e, 4) && aligned(oe, 4);
  return vec ? launch<4>(beam_d, beam_i, beam_e, nd, nids, od, oi, oe, B, ef, EL, s)
             : launch<1>(beam_d, beam_i, beam_e, nd, nids, od, oi, oe, B, ef, EL, s);
}
