// K13 and K14: the q-resident int8 scans with a bf16 epilogue, for Hopper
// (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_scan.py:scan_dist_int8 (K13,
// Pallas body _dist_kernel_int8) and :scan_chunkmin_int8_t (K14, body
// _scan_kernel_int8_t), which share their dot and epilogue.
//
// What they compute, for row-quantized int8 queries q8 (B, D) with their
// scales qs and raw cache qc (B,), the int8 base rows (N, D) with their
// scales and raw cache (N,) (l2sqr: cache |x|^2, qc |q|^2; cosine: cache
// |x|, qc |q|) and a row bound n_valid, with bf(v) = round-to-nearest-even
// of v to bf16 and every f32 operation rounded once:
//
//   dot = sum_k q8[b, k] * base[x, k]                          (exact int32)
//   p   = bf(bf(dot) * bf(qs[b] * scale[x]))
//   l2sqr:  d = bf(bf(qc[b] + cache[x]) - bf(2 * p))
//   cosine: d = bf(1 - bf(p / bf(max(qc[b] * cache[x], 1e-10))))
//   d = +inf for x >= n_valid
//
//   K13: out (B, N_pad) bf16, out[b, x] = d
//   K14: out_d (N_pad/128, B) f32, out_i (N_pad/128, B) int32: the min of d
//        over x in [128 c, 128 c + 128) and the lowest x that attains it
//
// Rows in [N, N_pad) read as zero rows with scale and cache 0 (TMA's zero
// fill and guarded loads), as if the base had been zero-padded: the base is
// read in place, never copied.
//
// That rounding order is the one the reference's interpret mode computes on
// the CPU (XLA upcasts each bf16 operation to f32 and rounds its result back
// to bf16, with no excess precision kept between the reference body's
// operations): the plain versions scan_dist_int8_ref / scan_chunkmin_int8_t_ref
// round in the same places, and both kernels equal them bit for bit.
// float(dot) is exact because |dot| <= 127^2 * 1040 < 2^24; bf(2 p) = 2 p
// exactly (p is a bf16 value and bf16 shares f32's exponent range), so that
// rounding is not performed.
//
// What bounds them on the H100: the int8 products, 1.92e12 operations at
// N = 1M, B = 1000, D = 960 (0.97 ms at the card's int8 peak); K13 also
// writes its 2.0 GB matrix (0.60 ms of bytes); behind both, the L2 reads
// that feed the tensor cores (every query tile reads every row) and the
// epilogue's 1e9 (query, row) pairs, each an int -> float conversion and
// five roundings to bf16.  The design:
//
// - A CTA takes 128 queries and walks 128-row chunks: chunks y, y + G, ...
//   of its query tile (`ops/scan_resident.py:k12_plan`), so the query
//   tiles of one chunk run together and share its rows in L2.  The chunks
//   alternate between two consumer warpgroups (warpgroups 1 and 2): the
//   CTA's i-th chunk is consumer i % 2's.  Each consumer holds the whole
//   128-query x 128-row product of its chunk in two m64n128 accumulators
//   (queries 0-63 and 64-127 as the wgmma A operand, the chunk's rows as B),
//   so while one consumer runs its epilogue the other's products are in
//   flight.
// - The 128-query tile stays in shared memory for the CTA's whole run (128 x
//   D bytes, loaded once by TMA in 128-byte boxes with the 128-byte swizzle)
//   where D <= 1024; past that each ring stage carries its query box beside
//   its row box.  Lane 0 of warp p of warpgroup 0 streams consumer p's
//   chunks, one 128-row x 128-byte box of the base per stage, by TMA into
//   that consumer's own ring under full / empty mbarriers.  Rows past N are
//   TMA's zero fill.
// - Each box runs wgmma.mma_async m64n128k32 s32.s8.s8 over its four k32
//   steps, A and B both read from shared memory, K-major; steps past D
//   multiply TMA's zero columns (a branch between the wgmmas splits their
//   batch).  The consumer index is broadcast from lane 0 so that ptxas sees
//   it warp-uniform: a thread-dependent branch around the wgmmas makes it
//   serialize them.
// - The epilogue is the bottleneck once the products are pipelined: 1e9
//   (query, row) pairs at resident_1m.  It works in the accumulator layout
//   (`k12_acc_coords`): a lane holds queries 16 w + g (+ 8) of each half and
//   rows 8 nt + 2 t + j of the chunk, so rows j = 0, 1 travel as one bf16x2
//   word: one cvt.rn.bf16x2.f32 rounds both, and the steps whose operands
//   are bf16 values (p = bf(dot) * bf(qs scale), a - 2 p, 1 - r) run as one
//   fma.rn.bf16x2 each, exact then rounded once, which equals the
//   reference's f32 operation rounded to bf16 (`pair_d`).  The chunk's
//   scale / cache lines are prefetched into L1 before its products and read
//   as float2 pairs.  K14 keeps each lane's minima of rows j = 0 and 1 in
//   one bf16x2 word (strict <, so the first of equals stays), then merges
//   them, then the quad's lanes by two shuffles (the lowest row wins ties:
//   bf16 values tie often); each lane of a quad writes one of its four
//   queries' survivors.  K13 leaves each pair's word in place of the
//   accumulator, then stages the 64 x 128 tile of each half in shared
//   memory (two 64 x 64 boxes with the 128-byte swizzle, so the 32 lanes of
//   a store hit 32 banks) and writes it with two TMA stores through a tensor
//   map over the (B, N_pad) output, which clip the query rows past B; the
//   writes run on while the consumer's next chunk is multiplied.  A half's
//   arithmetic runs before it waits for the staging buffer, so the other
//   half's store drains behind it.
//
// Requirements, checked by the Python wrapper: D % 16 == 0 (TMA's row
// stride; the wrapper zero-pads the columns otherwise), 16-byte aligned
// contiguous operands, scale / cache 8-byte aligned, n_pad % 128 == 0.
//
// It includes csrc/scan_wgmma.cuh (the wgmma shape, the mbarrier wait that
// traps, the tensor maps; shared with K1, K10 and K12) and through it K7's
// header for the mbarrier, TMA, descriptor and wgmma fence helpers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "scan_wgmma.cuh"

namespace {

using k7::keep_min;
using k7::mbar_arrive;
using k7::mbar_expect_tx;
using k7::mbar_init;
using k7::smem_u32;

constexpr int CHUNK = 128;             // rows per chunk (the wgmma N)
constexpr int BQ = 64;                 // queries per accumulator (the wgmma M)
constexpr int QT = 2 * BQ;             // queries per CTA, both in each consumer
constexpr int BK = 128;                // int8 lanes per box (one 128-byte swizzle row)
constexpr int ROW_BOX = CHUNK * BK;    // 16 KB
constexpr int Q_BOX = QT * BK;         // 16 KB
constexpr int OUT_BOX = BQ * 128;      // 8 KB: 64 queries x 64 bf16 rows, one TMA store
constexpr int STAGING = 2 * OUT_BOX;   // a consumer's staged half: 64 queries x 128 rows
constexpr int RESIDENT_KT = 8;         // boxes of the resident query tile: D <= 1024
constexpr int THREADS = 384;           // warpgroup 0 produces, 1 and 2 consume
constexpr int SMEM_MAX = 232448;

struct Layout {
  int resident, stage, ring;
  size_t qres, staging, chan, bars, bytes;
};

// shared memory, after a 1024-byte alignment pad: the resident query tile,
// the two consumers' rings (ring / 2 stages each: the row box, then the
// streamed query box), K13's two staging buffers, the 2 x 128 query
// channels, the full / empty / query mbarriers
__host__ __device__ inline Layout layout(int KT, bool chunkmin) {
  Layout L;
  L.resident = KT <= RESIDENT_KT;
  L.stage = ROW_BOX + (L.resident ? 0 : Q_BOX);
  L.qres = L.resident ? static_cast<size_t>(KT) * Q_BOX : 0;
  const size_t staging = chunkmin ? 0 : 2 * STAGING;
  const size_t fixed = 1024 + L.qres + staging + 2 * QT * 4 + 8;
  L.ring = static_cast<int>((SMEM_MAX - fixed) / (L.stage + 16)) & ~1;
  if (L.ring > 16) L.ring = 16;
  L.staging = L.qres + static_cast<size_t>(L.ring) * L.stage;
  L.chan = L.staging + staging;
  L.bars = L.chan + 2 * QT * 4;
  L.bytes = 1024 + L.bars + (2 * L.ring + 1) * 8;
  return L;
}

// bf16x2 words: the low half holds row r, the high half row r + 1
constexpr uint32_t NEG_ZERO2 = 0x80008000u, NEG_ONE2 = 0xbf80bf80u, NEG_TWO2 = 0xc000c000u,
                   ONE2 = 0x3f803f80u, INF_LO = 0x00007f80u, INF_HI = 0x7f800000u;

// the bf16x2 word of two f32 values, each rounded to nearest even (one
// cvt.rn.bf16x2.f32)
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// a * b + c on bf16x2 words: the exact value rounded once to bf16 (nearest
// even), subnormals kept
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// d of rows r, r + 1 of one query as a bf16x2 word.  The operations whose
// operands are bf16 values run on bf16x2 words, exact then rounded once:
// bf(dot) * bf(qs * scale) is exact in f32 (8 x 8 significant bits, both
// multiples of bf16's smallest subnormal), and a - 2 p (or 1 - r) is exact in
// f32 unless the two exponents lie more than 16 apart, where the smaller
// operand sits below 2^-16 of the larger and both roundings give the same
// bf16 value; so each equals the reference's f32 operation rounded to bf16
template <bool COSINE>
__device__ __forceinline__ uint32_t pair_d(int dot0, int dot1, float qs, float qc, float2 sc, float2 ca) {
  const uint32_t d = pack2(__int2float_rn(dot0), __int2float_rn(dot1));  // float(dot) is exact
  const uint32_t p = fma2(d, pack2(__fmul_rn(qs, sc.x), __fmul_rn(qs, sc.y)), NEG_ZERO2);
  if (COSINE) {
    const uint32_t m = pack2(fmaxf(__fmul_rn(qc, ca.x), 1e-10f), fmaxf(__fmul_rn(qc, ca.y), 1e-10f));
    const uint32_t r = pack2(__fdiv_rn(lo_f(p), lo_f(m)), __fdiv_rn(hi_f(p), hi_f(m)));
    return fma2(r, NEG_ONE2, ONE2);
  }
  return fma2(p, NEG_TWO2, pack2(__fadd_rn(qc, ca.x), __fadd_rn(qc, ca.y)));
}

// v[r], v[r + 1] (r even): one float2 load, or guarded loads (0 past N) in
// an EDGE chunk
template <bool EDGE>
__device__ __forceinline__ float2 load2(const float* __restrict__ v, int r, int N) {
  if (!EDGE) return __ldg(reinterpret_cast<const float2*>(v + r));
  return make_float2(r < N ? __ldg(v + r) : 0.f, r + 1 < N ? __ldg(v + r + 1) : 0.f);
}

// rows r, r + 1 at or past n_valid score +inf
__device__ __forceinline__ uint32_t mask2(uint32_t x, int r, int n_valid) {
  if (r >= n_valid) x = (x & 0xffff0000u) | INF_LO;
  if (r + 1 >= n_valid) x = (x & 0xffffu) | INF_HI;
  return x;
}

// K14: the (d, row) survivor of each of this lane's two queries of one
// accumulator over the chunk's 128 rows, the quad's lanes folded in.  Rows
// r (low halves) and r + 1 (high halves) keep separate minima in one bf16x2
// word, each updated on a strict < (rows ascend, so the first of equals
// stays); the two then meet, the lower row winning a tie
template <bool COSINE, bool EDGE>
__device__ __forceinline__ void chunk_min(const int (&acc)[64], const float (&qs)[2], const float (&qc)[2],
                                          const float* __restrict__ scale, const float* __restrict__ cache,
                                          int row0, int t, int N, int n_valid, float (&best)[2],
                                          int (&brow)[2]) {
  uint32_t b2[2] = {INF_HI | INF_LO, INF_HI | INF_LO};
  int r_lo[2], r_hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r_lo[h] = row0 + 2 * t;  // the lane's first rows: a chunk of +inf keeps them
    r_hi[h] = row0 + 2 * t + 1;
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int r = row0 + 8 * nt + 2 * t;
    const float2 sc = load2<EDGE>(scale, r, N), ca = load2<EDGE>(cache, r, N);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t x = pair_d<COSINE>(acc[nt * 4 + 2 * h], acc[nt * 4 + 2 * h + 1], qs[h], qc[h], sc, ca);
      if (EDGE) x = mask2(x, r, n_valid);
      asm("{\n.reg .b16 xl, xh, bl, bh;\n.reg .pred p, q;\n"
          "mov.b32 {xl, xh}, %3;\nmov.b32 {bl, bh}, %2;\n"
          "setp.lt.bf16 p, xl, bl;\nsetp.lt.bf16 q, xh, bh;\n"
          "@p mov.b32 %0, %4;\n@q add.s32 %1, %4, 1;\n"
          "min.bf16x2 %2, %2, %3;\n}\n"
          : "+r"(r_lo[h]), "+r"(r_hi[h]), "+r"(b2[h])
          : "r"(x), "r"(r));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best[h] = lo_f(b2[h]);
    brow[h] = r_lo[h];
    keep_min(best[h], brow[h], hi_f(b2[h]), r_hi[h]);
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      keep_min(best[h], brow[h], __shfl_xor_sync(0xffffffffu, best[h], off),
               __shfl_xor_sync(0xffffffffu, brow[h], off));
  }
}

// K13: the chunk's d of one accumulator as bf16x2 words, in place: register
// 2 nt + h takes rows (8 nt + 2 t, + 1) of query 16 w + g + 8 h (it was
// read at step (nt / 2, ...) or earlier, so no input is overwritten)
template <bool COSINE, bool EDGE>
__device__ __forceinline__ void dist_pairs(int (&acc)[64], const float (&qs)[2], const float (&qc)[2],
                                           const float* __restrict__ scale, const float* __restrict__ cache,
                                           int row0, int t, int N, int n_valid) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int r = row0 + 8 * nt + 2 * t;
    const float2 sc = load2<EDGE>(scale, r, N), ca = load2<EDGE>(cache, r, N);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t x = pair_d<COSINE>(acc[nt * 4 + 2 * h], acc[nt * 4 + 2 * h + 1], qs[h], qc[h], sc, ca);
      if (EDGE) x = mask2(x, r, n_valid);
      acc[nt * 2 + h] = static_cast<int>(x);
    }
  }
}

// K13: the packed pairs into a 64-query x 128-row staging buffer, two TMA
// store boxes of 64 rows (128 bytes) x 64 queries with the 128-byte swizzle:
// query q's 16-byte piece s of a box lies at q * 128 + 16 (s ^ (q % 8))
__device__ __forceinline__ void stage_pairs(const int (&acc)[64], uint8_t* stg, int warp, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 16 * warp + g + 8 * h;  // q % 8 == g
      uint8_t* dst = stg + (nt >> 3) * OUT_BOX + q * 128 + (((nt & 7) ^ g) << 4) + 4 * t;
      *reinterpret_cast<int*>(dst) = acc[nt * 2 + h];
    }
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col, int row) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(col), "r"(row)
               : "memory");
}

// K13: half a of the chunk (queries n0 + 64 a ...) from its accumulator to
// the output: the pairs computed in place, then (once the consumer's last
// store has read the staging buffer) staged and written by two TMA stores
template <bool COSINE>
__device__ __forceinline__ void store_half(int (&acc)[64], int a, const float (&qs)[2], const float (&qc)[2],
                                           const float* __restrict__ scale, const float* __restrict__ cache,
                                           const CUtensorMap* o_map, uint8_t* stg, int row0, int n0, int B,
                                           int N, int n_valid, bool edge, int p, int warp, int g, int t,
                                           bool leader) {
  if (edge)
    dist_pairs<COSINE, true>(acc, qs, qc, scale, cache, row0, t, N, n_valid);
  else
    dist_pairs<COSINE, false>(acc, qs, qc, scale, cache, row0, t, N, n_valid);
  if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  scan::named_sync(1 + p, 128);
  stage_pairs(acc, stg, warp, g, t);
  scan::fence_proxy_async();  // the generic-proxy writes, before the TMA engine reads them
  scan::named_sync(1 + p, 128);
  if (leader && n0 + BQ * a < B) {
    tma_store(o_map, stg, row0, n0 + BQ * a);
    tma_store(o_map, stg + OUT_BOX, row0 + 64, n0 + BQ * a);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <bool CHUNKMIN, bool COSINE>
__global__ void __launch_bounds__(THREADS, 1)
scan_int8_bf16_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap r_map,
                      const __grid_constant__ CUtensorMap o_map, const float* __restrict__ qs,
                      const float* __restrict__ qc, const float* __restrict__ scale,
                      const float* __restrict__ cache, float* __restrict__ out_d, int32_t* __restrict__ out_i,
                      int B, int N, int KT, int n_valid, int S) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  const Layout L = layout(KT, CHUNKMIN);
  uint8_t* qres = base;
  uint8_t* ring = base + L.qres;
  float* qs_s = reinterpret_cast<float*>(base + L.chan);
  float* qc_s = qs_s + QT;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);  // consumer p's slots p * rc ...
  uint64_t* empty = full + L.ring;
  uint64_t* qbar = empty + L.ring;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * QT;
  const int rc = L.ring / 2;  // stages a consumer's own ring holds

  if (tid == 0) {
    for (int i = 0; i < L.ring; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < QT; i += THREADS) {
    qs_s[i] = n0 + i < B ? qs[n0 + i] : 0.f;
    qc_s[i] = n0 + i < B ? qc[n0 + i] : 0.f;
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: lane 0 of warp p feeds consumer p
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0 && L.resident) {
      mbar_expect_tx(qbar, KT * Q_BOX);
      for (int kt = 0; kt < KT; ++kt) k7::tma_load(qres + kt * Q_BOX, &q_map, kt * BK, n0, qbar);
    }
    if ((tid & 31) == 0 && tid < 64) {
      const int p = tid >> 5;
      int it = 0, i = 0;
      for (int c = blockIdx.y; c < S; c += gridDim.y, ++i) {
        if ((i & 1) != p) continue;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int slot = p * rc + it % rc;
          if (it >= rc) scan::wait(&empty[slot], ((it / rc) - 1) & 1);
          uint8_t* st = ring + slot * L.stage;
          mbar_expect_tx(&full[slot], L.stage);
          k7::tma_load(st, &r_map, kt * BK, c * CHUNK, &full[slot]);
          if (!L.resident) k7::tma_load(st + ROW_BOX, &q_map, kt * BK, n0, &full[slot]);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int ct = tid - 128;
  // the consumer index, broadcast from lane 0 so that the compiler sees it
  // warp-uniform: a branch on a thread-dependent value around the wgmmas
  // makes ptxas serialize them
  const int p = __shfl_sync(0xffffffffu, ct >> 7, 0), warp = (ct >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool leader = (ct & 127) == 0;
  float qsv[2][2], qcv[2][2];  // [half][h]: query 64 half + 16 warp + g + 8 h
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qsv[a][h] = qs_s[BQ * a + 16 * warp + g + 8 * h];
      qcv[a][h] = qc_s[BQ * a + 16 * warp + g + 8 * h];
    }
  uint8_t* stg = base + L.staging + p * STAGING;
  if (L.resident) scan::wait(qbar, 0);

  int acc0[64], acc1[64];
  int it = 0, i = 0;  // this consumer's box count; the CTA's chunk count
  for (int c = blockIdx.y; c < S; c += gridDim.y, ++i) {
    if ((i & 1) != p) continue;
    k7::wgmma_fence();  // the epilogue wrote the accumulators' registers
    k7::fence_acc(acc0);
    k7::fence_acc(acc1);
    if ((ct & 127) < 8) {  // the chunk's scale / cache lines into L1 for the epilogue
      const int r = c * CHUNK + 32 * (ct & 3);
      if (r < N) asm volatile("prefetch.global.L1 [%0];\n" ::"l"(((ct & 127) < 4 ? scale : cache) + r));
    }
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const int slot = p * rc + it % rc;
      scan::wait(&full[slot], static_cast<unsigned>((it / rc) & 1));
      const uint8_t* st = ring + slot * L.stage;
      const uint8_t* qa = L.resident ? qres + kt * Q_BOX : st + ROW_BOX;
      // every k32 step, those past D too (TMA's zero columns): a branch
      // between them splits the wgmma batch
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = k7::desc_sw128(st + 32 * kk);
        scan::wgmma_s8(acc0, k7::desc_sw128(qa + 32 * kk), db, kt | kk);
        scan::wgmma_s8(acc1, k7::desc_sw128(qa + BQ * BK + 32 * kk), db, kt | kk);
      }
      k7::wgmma_commit();
      if (kt > 0) {  // the box before has completed: free its stage
        k7::wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = slot;
    }
    k7::wgmma_wait<0>();
    k7::fence_acc(acc0);
    k7::fence_acc(acc1);
    mbar_arrive(&empty[prev]);

    const int row0 = c * CHUNK;
    // an edge chunk has a row past N (guarded channel loads) or at or past
    // n_valid (+inf)
    const bool edge = row0 + CHUNK > N || row0 + CHUNK > n_valid;
    if (CHUNKMIN) {
      float b0[2], b1[2];
      int r0[2], r1[2];
      if (edge) {
        chunk_min<COSINE, true>(acc0, qsv[0], qcv[0], scale, cache, row0, t, N, n_valid, b0, r0);
        chunk_min<COSINE, true>(acc1, qsv[1], qcv[1], scale, cache, row0, t, N, n_valid, b1, r1);
      } else {
        chunk_min<COSINE, false>(acc0, qsv[0], qcv[0], scale, cache, row0, t, N, n_valid, b0, r0);
        chunk_min<COSINE, false>(acc1, qsv[1], qcv[1], scale, cache, row0, t, N, n_valid, b1, r1);
      }
      // lane t of the quad writes query (half t / 2, h = t % 2)
      const int a = t >> 1, h = t & 1;
      const float bd = a ? (h ? b1[1] : b1[0]) : (h ? b0[1] : b0[0]);
      const int br = a ? (h ? r1[1] : r1[0]) : (h ? r0[1] : r0[0]);
      const int q = n0 + BQ * a + 16 * warp + g + 8 * h;
      if (q < B) {
        out_d[static_cast<size_t>(c) * B + q] = bd;
        out_i[static_cast<size_t>(c) * B + q] = br;
      }
    } else {
      store_half<COSINE>(acc0, 0, qsv[0], qcv[0], scale, cache, &o_map, stg, row0, n0, B, N, n_valid, edge, p,
                         warp, g, t, leader);
      store_half<COSINE>(acc1, 1, qsv[1], qcv[1], scale, cache, &o_map, stg, row0, n0, B, N, n_valid, edge, p,
                         warp, g, t, leader);
    }
  }
  if (!CHUNKMIN && leader) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// flags: bit 0 cosine, bit 1 K14 (chunk-min into out_d f32 / out_i);
// without it K13 (out_d is the (B, n_pad) bf16 matrix, out_i unused).
// grid: (ceil(B / 128) query tiles, ctas CTAs each); N rows of the base
// (D % 16 == 0 lanes), n_pad = S * 128 >= N
extern "C" int vecdb_scan_int8_bf16(const void* q8, const void* qs, const void* qc, const void* base,
                                    const void* scale, const void* cache, void* out_d, void* out_i, int B, int N,
                                    int n_pad, int D, int n_valid, int flags, int ctas, void* stream) {
  if (B <= 0 || n_pad <= 0) return 0;
  if (N <= 0 || D <= 0 || D % 16 || n_pad % CHUNK || N > n_pad || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cosine = flags & 1, chunkmin = flags & 2;
  CUtensorMap q_map, r_map, o_map;
  memset(&o_map, 0, sizeof(o_map));
  if (scan::tensor_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q8, D, B, D, BK, QT) != CUDA_SUCCESS ||
      scan::tensor_map(&r_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, D, N, D, BK, CHUNK) != CUDA_SUCCESS ||
      (!chunkmin && scan::tensor_map(&o_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out_d, n_pad, B, 2LL * n_pad, 64,
                                     BQ) != CUDA_SUCCESS))
    return static_cast<int>(cudaErrorInvalidValue);
  const int KT = (D + BK - 1) / BK;
  const Layout L = layout(KT, chunkmin);
  if (L.ring < 4) return static_cast<int>(cudaErrorInvalidValue);  // two stages a consumer
  auto kern = chunkmin ? (cosine ? scan_int8_bf16_kernel<true, true> : scan_int8_bf16_kernel<true, false>)
                       : (cosine ? scan_int8_bf16_kernel<false, true> : scan_int8_bf16_kernel<false, false>);
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((B + QT - 1) / QT, ctas);
  kern<<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      q_map, r_map, o_map, static_cast<const float*>(qs), static_cast<const float*>(qc),
      static_cast<const float*>(scale), static_cast<const float*>(cache), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_i), B, N, KT, n_valid, n_pad / CHUNK);
  return static_cast<int>(cudaGetLastError());
}
