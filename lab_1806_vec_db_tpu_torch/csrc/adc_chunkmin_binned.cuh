// K11: binned PQ-ADC chunk-min over probed posting lists, for Hopper
// (sm_90a): the kernel, instantiated per chunk by csrc/adc_chunkmin_binned.cu
// (chunks 8-32 and the entry point) and csrc/adc_chunkmin_binned_small.cu
// (chunks 1-4), two sources that nvcc builds in parallel.
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_adc.py:adc_chunkmin_binned (Pallas
// body _adc_chunkmin_binned_kernel), row-major codes, chunk 1, 2, 4, 8, 16
// or 32.
//
// What it computes: the IVF-PQ codes are cluster-sorted, list l owning the
// lpad-row segment [l lpad, (l + 1) lpad) of the nibble-packed codes
// (nlist lpad, cw) uint8, of which the first lens[l] rows are valid.  Bin
// column j of list l holds query b = bins[l, j] (-1: none).  For every list
// row x and filled column, with query b's int8 LUT row lut[b] (B, Kd),
// Kd = 32 cw, its scale scales[b] and norm qn[b]:
//
//   acc = sum_g lut_b[g*16 + code(x, g)]                         (exact int32)
//   d   = float(acc) * scales[b]
//   cosine: c_sq = float(sum_g cs[g*16 + code(x, g)]) * cs_scale
//           d = 1 - d / max(sqrt(max(c_sq, 0)) * qn[b], 1e-10)
//   d = +inf where x >= lens[l]
//
// and out_d[l, j, s], out_p[l, j, s] = the min of d over list rows
// [chunk s, chunk (s + 1)) and the lowest GLOBAL slot l lpad + x that
// reaches it.  Empty columns come out +inf with the chunk's first slot.
// The epilogue rounds in the reference's order (__fmul_rn / __fdiv_rn /
// __fsub_rn, IEEE sqrtf), so the result equals the plain PyTorch version
// (ops/adc.py) bit for bit.
//
// What bounds it on the H100: the one-hot product over the valid rows and
// the FILLED columns only, 2 m 16 int8 operations a (valid row, filled
// column) pair (2.65e8 pairs at codes_ivfpq_10m, 48 probes: 1.37 ms at the
// int8 peak), against ~0.5 ms of codes from device memory.  The design:
//
// - One CTA: one list, 2048 of its rows in LUT passes, 64 bin columns.
//   Bins fill from column 0, so the CTA reads its 64 columns first and
//   picks its wgmma N: 32 when no column past 32 is filled, else 64 (two
//   loops, each compiled with its own N).  N = 32 halves the operations of
//   a list with at most 32 queries (the common case at codes_ivfpq_10m: 23
//   filled columns a list on average; forcing N = 64 everywhere cost 28%);
//   a CTA without a filled column, and every pass at or past lens[l], only
//   writes its +inf survivors.
// - Warpgroup 2 is the producer: its 128 threads gather each stage's LUT
//   rows through `bins` (a pointer table in shared memory; the LUT is never
//   copied per list, unlike the reference's (nlist, W, QB) block) with
//   16-byte cp.async to the 128-byte-swizzle addresses that the wgmma B
//   descriptor reads (`k11_stage_offset` in ops/adc.py; TMA's tiled mode
//   cannot gather rows), and the pass's code rows (16 bytes a row a stage:
//   one copy, one L1 line visit), then arrive on the stage's full mbarrier
//   (cp.async.mbarrier.arrive.noinc).  A stage is 512 LUT columns (four
//   128-column sub-stages); a ring of 4 stages.
// - Warpgroups 0 and 1 consume.  At 384 threads ptxas gives every thread
//   168 registers (setmaxnreg moves registers at run time, not in ptxas's
//   allocation: a consumer asking for 232 still spilled), so a consumer
//   holds at most 64 accumulators: at N = 32 four m64 tiles (a 512-row
//   pass, twice K7's rows per LUT read), at N = 64 two (a 256-row pass).
//   Per sub-stage it builds the one-hot A in registers from each row's
//   code word, every register before the sub-stage's first wgmma (one
//   written while a wgmma is in flight makes ptxas serialize them), then
//   runs wgmma.mma_async m64nNk32 s32.s8.s8.  A consumer whose rows all
//   lie past lens[l] skips its product.  Cosine is its own instantiation,
//   so l2sqr carries no centroid-sqnorm sums.
// - The one-hot register of code c for lane t (bytes j = (c == 4t + j)) is
//   1 << 8 ((c - 4t) mod 16), PTX's clamped shift giving 0 from 32 up: 4t
//   is subtracted from a code word's 8 nibbles at once, then 3 integer
//   operations a register (K7's compare-and-select took twice the time).
// - Rows map to accumulators as in K7, a warp owning 16 MT consecutive rows
//   (tile mt, half h, lane group g -> row 16 MT warp + 16 mt + 8 h + g), so
//   K7's chunk-min epilogue carries over: in registers and shuffles.
//
// Requirements, checked by the wrapper: nibble-packed codes, cw % 4 == 0,
// Kd == 32 cw, lpad % 512 == 0, codes hold at least nlist * lpad rows,
// nlist * lpad < 2^31, a 16-byte aligned LUT and codes, contiguous tensors.

#pragma once

#include "scan_wgmma.cuh"  // the cp.async arrival and proxy fence; through it K7's mbarrier and wgmma helpers

namespace k11 {

using k7::desc_sw128;
using k7::keep_min;
using k7::mbar_arrive;
using k7::mbar_init;
using k7::mbar_wait;
using k7::smem_u32;
using k7::wgmma_commit;
using k7::wgmma_fence;
using k7::wgmma_wait;
using scan::cp_async_arrive;
using scan::fence_proxy_async;

constexpr int BLOCK = 64;                    // bin columns per CTA (the widest N)
constexpr int SUB = 128;                     // LUT columns per sub-stage: 8 groups, one code word
constexpr int SUBS = 4;                      // sub-stages per ring stage: 16 code bytes a row
constexpr int PASS = 512;                    // rows per LUT pass at N 32 (the code stage's rows)
constexpr int ROWS_PER_CTA = 2048;
constexpr int LUT_STAGE = SUBS * BLOCK * SUB;  // 32 KB
constexpr int CODE_STAGE = PASS * 16;          // 8 KB
constexpr int RING = 4;
constexpr int CONSUMERS = 256;               // warpgroups 0 and 1
constexpr int PRODUCERS = 128;               // warpgroup 2
constexpr int THREADS = CONSUMERS + PRODUCERS;

inline size_t smem_bytes(int Kd, bool cosine) {
  return 1024 + RING * (LUT_STAGE + CODE_STAGE) + 2 * RING * sizeof(uint64_t) +
         BLOCK * (sizeof(void*) + 2 * sizeof(float) + sizeof(int)) + 16 + (cosine ? Kd : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// 4 bytes, zero-filled past src_bytes (0 or 4)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// the code word w with 4t subtracted from each of its 8 nibbles, mod 16
// (lane t's k-columns 4t..4t+3 of a group hold codes 4t..4t+3)
__device__ __forceinline__ unsigned nibbles_minus(unsigned w, unsigned k4t) {
  constexpr unsigned H = 0x88888888u;
  return ((w | H) - (k4t & ~H)) ^ ((w ^ ~k4t) & H);
}

// one-hot A register of nibble e of a `nibbles_minus` word d: byte j holds
// (code == 4t + j), i.e. 1 << 8 (code - 4t) with PTX's clamped shift (a
// shift of 32 or more gives 0; a negative difference wraps to 96-120)
template <int E>
__device__ __forceinline__ unsigned onehot(unsigned d) {
  unsigned s;
  if constexpr (E == 0)
    s = (d << 3) & 0x78u;
  else
    s = (d >> (4 * E - 3)) & 0x78u;
  unsigned r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(1u), "r"(s));
  return r;
}

template <int N>
struct Acc {
  int d[N / 2];  // m64nN: N / 2 int32 a thread
};

template <int N>
__device__ __forceinline__ void fence_acc(Acc<N>& a) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+r"(a.d[i])::"memory");
}

// d (+)= A (64 x 32, registers) x B (32 x N, shared memory): accumulate == 0
// overwrites d
__device__ __forceinline__ void wgmma(Acc<64>& c, const unsigned (&a)[4], uint64_t desc,
                                      int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc));
}

__device__ __forceinline__ void wgmma(Acc<32>& c, const unsigned (&a)[4], uint64_t desc,
                                      int accumulate) {
  int* d = c.d;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(accumulate), "l"(desc));
}

// +inf survivors, each at its chunk's first slot, for bin columns [c_lo,
// c_hi) and list rows [x_lo, x_hi) of list l (threads i0, i0 + step, ...)
template <int CHUNK>
__device__ __forceinline__ void fill_inf(float* __restrict__ out_d, int32_t* __restrict__ out_p,
                                         int l, int lpad, int QB, int c_lo, int c_hi, int x_lo,
                                         int x_hi, int i0, int step) {
  const int SL = lpad / CHUNK;
  const int s0 = x_lo / CHUNK, ns = max(0, (x_hi - x_lo) / CHUNK);
  const int nc = max(0, min(c_hi, QB) - c_lo);
  for (int i = i0; i < nc * ns; i += step) {
    const int col = c_lo + i / ns, s = s0 + i % ns;
    const size_t o = (static_cast<size_t>(l) * QB + col) * SL + s;
    out_d[o] = INFINITY;
    out_p[o] = l * lpad + s * CHUNK;
  }
}

struct Shared {
  uint8_t* ring;        // RING x LUT_STAGE, 1024-aligned
  uint8_t* code_ring;   // RING x CODE_STAGE
  uint64_t* full;       // RING
  uint64_t* empty;      // RING
  const int8_t** rows;  // BLOCK: each column's LUT row (row 0 for an empty column)
  float* sc;            // BLOCK
  float* qn;            // BLOCK
  int* ok;              // BLOCK: whether the column holds a query
  int* nfill;           // 1 + the last filled column, 0 if none
  int8_t* cs;           // Kd (cosine)
};

// the CTA's passes with the N-column wgmma loop
template <int CHUNK, bool COSINE, int N>
__device__ __forceinline__ void run(const Shared& sh, const uint8_t* __restrict__ codes,
                                    float cs_scale, float* __restrict__ out_d,
                                    int32_t* __restrict__ out_p, int l, int lpad, int QB, int cw,
                                    int c0, int x_begin, int x_end, int len) {
  constexpr int MT = N == 64 ? 2 : 4;                // m64 tiles a consumer: <= 64 accumulators
  constexpr int PASS_ROWS = 128 * MT;                // rows a LUT pass: 512 at N 32, 256 at N 64
  constexpr int GROUP = CHUNK >= 8 ? CHUNK / 8 : 1;  // 8-row halves per chunk
  constexpr int LANES = CHUNK >= 8 ? 8 : CHUNK;      // rows g per chunk within a half
  const int tid = threadIdx.x;
  const int KT = cw / 4;                 // sub-stages per pass
  const int NS = (KT + SUBS - 1) / SUBS;  // stages per pass
  const int live_end = min(x_end, len);
  const int n_pass = live_end > x_begin ? (live_end - x_begin + PASS_ROWS - 1) / PASS_ROWS : 0;
  const long long base = static_cast<long long>(l) * lpad;

  if (tid >= CONSUMERS) {
    const int pt = tid - CONSUMERS;
    const int c = pt & 31;  // this thread's 16-byte chunk of a stage row: sub-stage c / 8
    int it = 0;
    for (int p = 0; p < n_pass; ++p) {
      const uint8_t* crow = codes + (base + x_begin + p * PASS_ROWS) * cw;
      for (int s = 0; s < NS; ++s, ++it) {
        const int slot = it % RING;
        if (it >= RING) mbar_wait(&sh.empty[slot], ((it / RING) - 1) & 1);
        const int nsub = min(SUBS, KT - s * SUBS);
        uint8_t* st = sh.ring + slot * LUT_STAGE;
        if ((c >> 3) < nsub)
          for (int n = pt >> 5; n < N; n += PRODUCERS / 32)
            cp_async16(st + (c >> 3) * (N * SUB) + n * SUB + (((c & 7) ^ (n & 7)) << 4),
                       sh.rows[n] + s * (SUBS * SUB) + 16 * c);
        uint8_t* cst = sh.code_ring + slot * CODE_STAGE;
        if (cw % 16 == 0) {
          for (int r = pt; r < PASS_ROWS; r += PRODUCERS)
            cp_async16(cst + 16 * r, crow + static_cast<long long>(r) * cw + 16 * s);
        } else {
          for (int i = pt; i < PASS_ROWS * 4; i += PRODUCERS) {
            const int r = i >> 2, w = i & 3;
            const bool in = s * SUBS + w < KT;
            cp_async4(cst + 16 * r + 4 * w, in ? crow + static_cast<long long>(r) * cw + 16 * s + 4 * w : codes,
                      in ? 4 : 0);
          }
        }
        cp_async_arrive(&sh.full[slot]);
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const unsigned k4t = 0x44444444u * t;
  // this lane's row of half f in a pass: rw + 8 f (pass-relative)
  const int rw = wg * (PASS_ROWS / 2) + warp * (16 * MT) + g;

  Acc<N> acc[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt].d[i] = 0;
  int csum[COSINE ? 2 * MT : 1];
#pragma unroll
  for (int f = 0; f < (COSINE ? 2 * MT : 1); ++f) csum[f] = 0;

  // the block's survivors: column col's at od[col * (lpad / CHUNK)] (32-bit
  // offsets: 64-bit ones per column get hoisted out of the loop and spill)
  const size_t block_out = (static_cast<size_t>(l) * QB + c0) * (lpad / CHUNK);
  float* __restrict__ od = out_d + block_out;
  int32_t* __restrict__ op = out_p + block_out;
  int it = 0;
  for (int p = 0; p < n_pass; ++p) {
    const int x0 = x_begin + p * PASS_ROWS;
    const bool live = x0 + wg * (PASS_ROWS / 2) < len;  // warpgroup-uniform
    for (int s = 0; s < NS; ++s, ++it) {
      const int slot = it % RING;
      mbar_wait(&sh.full[slot], static_cast<unsigned>((it / RING) & 1));
      if (live) {
        fence_proxy_async();
        const int nsub = min(SUBS, KT - s * SUBS);
        const uint8_t* st = sh.ring + slot * LUT_STAGE;
        const unsigned* cst = reinterpret_cast<const unsigned*>(sh.code_ring + slot * CODE_STAGE);
        for (int q = 0; q < nsub; ++q) {
          // the sub-stage's A registers (k-step kk: groups 2 kk, 2 kk + 1),
          // all built before its first wgmma; tile mt's rows are halves
          // 2 mt and 2 mt + 1
          unsigned a[4][MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const unsigned w0 = cst[(rw + 16 * mt) * 4 + q], w1 = cst[(rw + 16 * mt + 8) * 4 + q];
            if constexpr (COSINE) {
              const int kt = s * SUBS + q;
#pragma unroll
              for (int e = 2 * t; e < 2 * t + 2; ++e) {
                csum[2 * mt] += sh.cs[(8 * kt + e) * 16 + ((w0 >> (4 * e)) & 15u)];
                csum[2 * mt + 1] += sh.cs[(8 * kt + e) * 16 + ((w1 >> (4 * e)) & 15u)];
              }
            }
            const unsigned d0 = nibbles_minus(w0, k4t), d1 = nibbles_minus(w1, k4t);
            a[0][mt][0] = onehot<0>(d0), a[0][mt][1] = onehot<0>(d1);
            a[0][mt][2] = onehot<1>(d0), a[0][mt][3] = onehot<1>(d1);
            a[1][mt][0] = onehot<2>(d0), a[1][mt][1] = onehot<2>(d1);
            a[1][mt][2] = onehot<3>(d0), a[1][mt][3] = onehot<3>(d1);
            a[2][mt][0] = onehot<4>(d0), a[2][mt][1] = onehot<4>(d1);
            a[2][mt][2] = onehot<5>(d0), a[2][mt][3] = onehot<5>(d1);
            a[3][mt][0] = onehot<6>(d0), a[3][mt][1] = onehot<6>(d1);
            a[3][mt][2] = onehot<7>(d0), a[3][mt][3] = onehot<7>(d1);
          }
          const uint8_t* sub = st + q * (N * SUB);
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t desc = desc_sw128(sub + 32 * kk);
            const int accumulate = s | q | kk;  // the pass's first k-step overwrites
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) wgmma(acc[mt], a[kk][mt], desc, accumulate);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        }
      }
      mbar_arrive(&sh.empty[slot]);  // this thread is done with the stage
    }

    // epilogue of the pass: a chunk is GROUP consecutive halves, or LANES
    // rows g of one half; a consumer past lens[l] writes +inf
    float csq[COSINE ? 2 * MT : 1];
#pragma unroll
    for (int f = 0; f < (COSINE ? 2 * MT : 1); ++f) {
      int v = csum[f];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      csq[f] = __fmul_rn(__int2float_rn(v), cs_scale);
      csum[f] = 0;
    }
    const int xb = x0 + rw;
#pragma unroll
    for (int f0 = 0; f0 < 2 * MT; f0 += GROUP) {
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nt * 8 + t * 2 + j;
          const float qs = sh.sc[col], qnn = sh.qn[col];
          const bool ok = sh.ok[col] != 0;
          float best = INFINITY;
          int best_p = static_cast<int>(base) + xb + 8 * f0;
#pragma unroll
          for (int f = f0; f < f0 + GROUP; ++f) {  // rows ascending: a strict < keeps the lowest
            const int x = xb + 8 * f;
            float d = __fmul_rn(__int2float_rn(acc[f >> 1].d[nt * 4 + 2 * (f & 1) + j]), qs);
            if constexpr (COSINE) {
              const float norm0 = sqrtf(fmaxf(csq[f], 0.f));
              d = __fsub_rn(1.f, __fdiv_rn(d, fmaxf(__fmul_rn(norm0, qnn), 1e-10f)));
            }
            if (ok && x < len && d < best) {
              best = d;
              best_p = static_cast<int>(base) + x;
            }
          }
#pragma unroll
          for (int o = 4; o < 4 * LANES; o <<= 1) {
            const float d2 = __shfl_xor_sync(0xffffffffu, best, o);
            const int p2 = __shfl_xor_sync(0xffffffffu, best_p, o);
            keep_min(best, best_p, d2, p2);
          }
          if ((g & (LANES - 1)) == 0 && c0 + col < QB) {
            const int o = col * (lpad / CHUNK) + (xb + 8 * f0) / CHUNK;
            od[o] = best;
            op[o] = best_p;
          }
        }
    }
  }

  // the rows of no pass, and the block's columns past N: +inf
  fill_inf<CHUNK>(out_d, out_p, l, lpad, QB, c0, c0 + N, x_begin + n_pass * PASS_ROWS, x_end, tid,
                  CONSUMERS);
  fill_inf<CHUNK>(out_d, out_p, l, lpad, QB, c0 + N, c0 + BLOCK, x_begin, x_end, tid, CONSUMERS);
}

template <int CHUNK, bool COSINE>
__global__ void __launch_bounds__(THREADS, 1)
adc_chunkmin_binned_kernel(const uint8_t* __restrict__ codes, const int8_t* __restrict__ lut,
                           const float* __restrict__ scales, const float* __restrict__ qn,
                           const int8_t* __restrict__ cs, float cs_scale,
                           const int32_t* __restrict__ lens, const int32_t* __restrict__ bins,
                           float* __restrict__ out_d, int32_t* __restrict__ out_p, int lpad, int QB,
                           int cw, int spans) {
  static_assert(CHUNK == 1 || CHUNK == 2 || CHUNK == 4 || CHUNK == 8 || CHUNK == 16 || CHUNK == 32,
                "CHUNK must be 1, 2, 4, 8, 16 or 32");
  extern __shared__ uint8_t smem_raw[];
  Shared sh;
  sh.ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // swizzle atoms: 1024-aligned
  sh.code_ring = sh.ring + RING * LUT_STAGE;
  sh.full = reinterpret_cast<uint64_t*>(sh.code_ring + RING * CODE_STAGE);
  sh.empty = sh.full + RING;
  sh.rows = reinterpret_cast<const int8_t**>(sh.empty + RING);
  sh.sc = reinterpret_cast<float*>(sh.rows + BLOCK);
  sh.qn = sh.sc + BLOCK;
  sh.ok = reinterpret_cast<int*>(sh.qn + BLOCK);
  sh.nfill = sh.ok + BLOCK;
  sh.cs = reinterpret_cast<int8_t*>(sh.nfill + 4);

  const int tid = threadIdx.x;
  const int l = blockIdx.x / spans, span = blockIdx.x % spans;
  const int c0 = blockIdx.y * BLOCK;
  const int x_begin = span * ROWS_PER_CTA, x_end = min(lpad, x_begin + ROWS_PER_CTA);
  const int len = lens[l];
  const int Kd = 32 * cw;

  if (tid == 0) {
    *sh.nfill = 0;
    for (int i = 0; i < RING; ++i) {
      mbar_init(&sh.full[i], PRODUCERS);
      mbar_init(&sh.empty[i], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < BLOCK) {
    const int col = c0 + tid;
    const int b = col < QB ? bins[static_cast<size_t>(l) * QB + col] : -1;
    sh.rows[tid] = lut + static_cast<size_t>(b >= 0 ? b : 0) * Kd;
    sh.sc[tid] = b >= 0 ? scales[b] : 0.f;
    sh.qn[tid] = b >= 0 ? qn[b] : 0.f;
    sh.ok[tid] = b >= 0;
    if (b >= 0) atomicMax(sh.nfill, tid + 1);
  }
  if (COSINE)
    for (int i = tid; i < Kd; i += THREADS) sh.cs[i] = cs[i];
  __syncthreads();

  const int nfill = *sh.nfill;
  if (nfill == 0 || x_begin >= len) {  // no query, or every row masked: +inf survivors only
    fill_inf<CHUNK>(out_d, out_p, l, lpad, QB, c0, c0 + BLOCK, x_begin, x_end, tid, THREADS);
    return;
  }
  if (nfill > 32)
    run<CHUNK, COSINE, 64>(sh, codes, cs_scale, out_d, out_p, l, lpad, QB, cw, c0, x_begin, x_end, len);
  else
    run<CHUNK, COSINE, 32>(sh, codes, cs_scale, out_d, out_p, l, lpad, QB, cw, c0, x_begin, x_end, len);
}

template <int CHUNK, bool COSINE>
int launch_kernel(const void* codes, const void* lut, const void* scales, const void* qn,
                  const void* cs, float cs_scale, const void* lens, const void* bins, void* out_d,
                  void* out_p, int nlist, int lpad, int QB, int cw, void* stream) {
  const size_t smem = smem_bytes(32 * cw, COSINE);
  const cudaError_t err = cudaFuncSetAttribute(adc_chunkmin_binned_kernel<CHUNK, COSINE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int spans = (lpad + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  dim3 grid(nlist * spans, (QB + BLOCK - 1) / BLOCK);
  adc_chunkmin_binned_kernel<CHUNK, COSINE><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(lut),
      static_cast<const float*>(scales), static_cast<const float*>(qn),
      static_cast<const int8_t*>(cs), cs_scale, static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(bins), static_cast<float*>(out_d), static_cast<int32_t*>(out_p),
      lpad, QB, cw, spans);
  return static_cast<int>(cudaGetLastError());
}

// one launch of the chunk's kernel (l2sqr, or cosine when cs is given); its
// instantiations live in the three .cu files
template <int CHUNK>
int launch(const void* codes, const void* lut, const void* scales, const void* qn, const void* cs,
           float cs_scale, const void* lens, const void* bins, void* out_d, void* out_p, int nlist,
           int lpad, int QB, int cw, void* stream) {
  return (cs != nullptr ? launch_kernel<CHUNK, true> : launch_kernel<CHUNK, false>)(
      codes, lut, scales, qn, cs, cs_scale, lens, bins, out_d, out_p, nlist, lpad, QB, cw, stream);
}

}  // namespace k11
