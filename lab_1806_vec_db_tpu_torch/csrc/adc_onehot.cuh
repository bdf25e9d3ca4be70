// The one-hot mma.sync s8 pipeline of the ADC chunk-min, shared by K7
// (csrc/adc_scan_chunkmin.cu) and K11 (csrc/adc_chunkmin_binned.cu).
//
// One CTA scores 128-row sub-tiles of 4-bit (or 8-bit) PQ codes against up
// to 128 int8 LUT rows (one per query column) and keeps, for each column,
// the minimum of every CHUNK consecutive rows with its lowest position:
//
//   acc[x, n] = sum_g lut_n[g*16 + code(x, g)]                   (exact int32)
//   d         = float(acc) * scale[n]
//   cosine:     c_sq = float(sum_g cs[g*16 + code(x, g)]) * cs_scale
//               d = 1 - d / max(sqrt(max(c_sq, 0)) * qn[n], 1e-10)
//   d = +inf where the caller masks row x
//
// The ADC sum is a (rows, Kd) one-hot x (Kd, 128) int8 product on the
// tensor cores (mma.sync m16n8k32), Kd = 16 * mk.  The A operand is never
// loaded: a thread's A register for row r and k-columns 4t..4t+3 of group g
// is 1 << 8*(code & 3) when code >> 2 == t, else 0, generated in registers
// from the codes staged unpacked in shared memory ([group][row],
// conflict-free for the fragment loads).  The LUT streams in 64-column
// slices through a two-stage cp.async pipeline; each column's LUT row is
// the caller's (K7: query n0 + n; K11: the query binned to column n, from a
// pointer table in shared memory), so no per-CTA LUT copy exists in device
// memory, and in K11 a warp whose 32 columns have no row skips the
// product.  The epilogue and the
// chunk-min run in registers and warp shuffles; it rounds in the
// reference's order with __fmul_rn / __fdiv_rn / __fsub_rn and IEEE sqrtf,
// so the result equals the plain PyTorch versions bit for bit.
//
// Warps: 2 (rows: 64 each) x 4 (columns: 32 each).  A warp's 64 rows are
// four 16-row MMA tiles mt, each two 8-row halves h (row mt*16 + 8h + g of
// lane g*4 + t): a chunk of 8 rows is one half (the shuffle over g), 16
// one tile, 32 two tiles; chunks below 8 shuffle over the low bits of g.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace adc {

constexpr int BM = 128;       // rows per sub-tile
constexpr int BN = 128;       // LUT rows (query columns) per CTA
constexpr int BK = 64;        // LUT columns per pipeline stage (4 groups)
constexpr int LDS = BK + 16;  // padded smem row stride in bytes
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int MIN_CTAS = 2;   // CTAs per SM the kernels are built for: <= 128 registers a thread

// dynamic shared memory of one CTA: two LUT stages, the column row
// pointers, the rows' centroid-sqnorm sums, the int8 cs column, the codes
inline size_t smem_bytes(int mk, bool cosine) {
  return 2 * BN * LDS + BN * sizeof(void*) + BM * sizeof(float) + (cosine ? mk * 16 : 0) +
         static_cast<size_t>(mk) * BM;
}

struct Tile {
  int8_t* smB;          // 2 x BN x LDS
  const int8_t** rows;  // BN: each column's LUT row (nullptr: none), K11's
  float* csq;           // BM
  int8_t* cs_s;         // Kd (cosine)
  uint8_t* codes_s;     // mk x BM
  __device__ Tile(uint8_t* smem, int mk, bool cosine) {
    smB = reinterpret_cast<int8_t*>(smem);
    rows = reinterpret_cast<const int8_t**>(smem + 2 * BN * LDS);
    csq = reinterpret_cast<float*>(smem + 2 * BN * LDS + BN * sizeof(void*));
    cs_s = reinterpret_cast<int8_t*>(csq + BM);
    codes_s = reinterpret_cast<uint8_t*>(cs_s + (cosine ? mk * 16 : 0));
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one-hot A register: bytes j = 0..3 hold (code == 4t + j)
__device__ __forceinline__ unsigned onehot4(unsigned code, int t) {
  return (code >> 2) == static_cast<unsigned>(t) ? 1u << ((code & 3u) << 3) : 0u;
}

// (d, pos) lexicographic min: the smaller distance, then the lower position
__device__ __forceinline__ void keep_min(float& d, int& p, float d2, int p2) {
  if (d2 < d || (d2 == d && p2 < p)) {
    d = d2;
    p = p2;
  }
}

// the CTA column of this thread's accumulator (nt, j)
__device__ __forceinline__ int lane_col(int nt, int j) {
  return ((threadIdx.x >> 5) >> 1) * 32 + nt * 8 + (threadIdx.x & 3) * 2 + j;
}

// Scan n_sub 128-row sub-tiles of `codes` (row stride cw bytes, cw % 4 == 0;
// rows at or past `rows_avail` read as code 0) against one LUT row per
// column (Kd = 16 mk int8 bytes), and reduce each CHUNK rows of every
// column.  q_s / q_n: this thread's columns' scales and query norms
// (lane_col order).
//   lut_row(n):            column n's LUT row, nullptr for none (zeros);
//   row_ok(x), row_pos(x): whether CTA row x in [0, n_sub * BM) counts, and
//                          its position (masked rows keep theirs: ties);
//   emit(c, n, d, p):      survivor c (CTA rows [c CHUNK, (c + 1) CHUNK)) of
//                          column n, called by one lane per (c, n).
// SKIP_DEAD: a warp whose 32 columns have no LUT row skips the product
// (K11's sparse bins); K7's columns are all filled but the last block's,
// and its loop keeps no branch.
template <int CHUNK, bool SKIP_DEAD, class LutRow, class RowOk, class RowPos, class Emit>
__device__ __forceinline__ void chunkmin_scan(const Tile& tl, const uint8_t* __restrict__ codes,
                                              long long rows_avail, int n_sub, int cw, int mk,
                                              bool packed, const int8_t* __restrict__ cs,
                                              float cs_scale, const float (&q_s)[4][2],
                                              const float (&q_n)[4][2], LutRow lut_row,
                                              RowOk row_ok, RowPos row_pos, Emit emit) {
  static_assert(CHUNK == 1 || CHUNK == 2 || CHUNK == 4 || CHUNK == 8 || CHUNK == 16 || CHUNK == 32,
                "CHUNK must be 1, 2, 4, 8, 16 or 32");
  constexpr int GROUP = CHUNK >= 8 ? CHUNK / 8 : 1;  // 8-row halves per chunk
  constexpr int LANES = CHUNK >= 8 ? 8 : CHUNK;      // rows g per chunk within a half
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int Kd = mk * 16;
  const int KT = Kd / BK;
  const int steps = n_sub * KT;
  const int words = cw >> 2;
  const int groups_in_codes = packed ? 2 * cw : cw;
  const bool cosine = cs != nullptr;

  if (cosine)
    for (int i = tid; i < Kd; i += THREADS) tl.cs_s[i] = cs[i];
  __syncthreads();  // the caller's shared state and cs_s are visible

  bool warp_live = !SKIP_DEAD;  // whether any of this warp's 32 columns has a LUT row
  if (SKIP_DEAD)
    for (int c = 0; c < 32; ++c) warp_live |= lut_row(warp_n * 32 + c) != nullptr;

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  auto load_stage = [&](int stage, int step) {
    const int kt = step % KT;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 columns x 64 bytes = 512 16-byte pieces
      const int id = tid + i * THREADS;
      const int r = id >> 2, c = (id & 3) * 16;
      const int8_t* src = lut_row(r);  // columns without a row are zero-filled
      cp_async16(&tl.smB[(stage * BN + r) * LDS + c],
                 src ? static_cast<const void*>(src + kt * BK + c) : static_cast<const void*>(codes),
                 src ? 16 : 0);
    }
  };

  // stage the codes of sub-tile `sub` unpacked as codes_s[group * BM + row],
  // and for cosine each row's centroid-sqnorm sum
  auto stage_codes = [&](int sub) {
    const long long r0 = static_cast<long long>(sub) * BM;
    for (int i = tid; i < words * BM; i += THREADS) {
      const int row = i % BM, w = i / BM;
      const long long x = r0 + row;
      const unsigned v =
          x < rows_avail ? __ldg(reinterpret_cast<const unsigned*>(codes + x * cw) + w) : 0u;
      if (packed) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int grp = 8 * w + e;
          if (grp < mk) tl.codes_s[grp * BM + row] = (v >> (4 * e)) & 15u;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int grp = 4 * w + e;
          if (grp < mk) tl.codes_s[grp * BM + row] = (v >> (8 * e)) & 255u;
        }
      }
    }
    for (int i = groups_in_codes * BM + tid; i < mk * BM; i += THREADS) tl.codes_s[i] = 0;
    __syncthreads();
    if (cosine && tid < BM) {
      int s = 0;
      for (int grp = 0; grp < mk; ++grp) s += tl.cs_s[grp * 16 + tl.codes_s[grp * BM + tid]];
      tl.csq[tid] = __fmul_rn(__int2float_rn(s), cs_scale);
    }
    // the barrier of the first k-step orders these writes before their reads
  };

  stage_codes(0);
  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_stage((s + 1) & 1, s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* Bq = tl.smB + (s & 1) * BN * LDS;
    const int kt = s % KT;
    if (!SKIP_DEAD || warp_live) {  // warp-uniform: a warp without columns builds no A
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        const int grp = kt * 4 + kk / 16;  // groups grp (a[0], a[1]) and grp + 1 (a[2], a[3])
        unsigned af[4][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = warp_m * 64 + mt * 16 + g;
          af[mt][0] = onehot4(tl.codes_s[grp * BM + r], t);
          af[mt][1] = onehot4(tl.codes_s[grp * BM + r + 8], t);
          af[mt][2] = onehot4(tl.codes_s[(grp + 1) * BM + r], t);
          af[mt][3] = onehot4(tl.codes_s[(grp + 1) * BM + r + 8], t);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = warp_n * 32 + nt * 8 + g;
          bf[nt][0] = *reinterpret_cast<const unsigned*>(&Bq[n * LDS + kk + t * 4]);
          bf[nt][1] = *reinterpret_cast<const unsigned*>(&Bq[n * LDS + kk + 16 + t * 4]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
      }
    }

    if (kt == KT - 1) {
      // epilogue of sub-tile `sub`: half f = 2 mt + h holds the warp's rows
      // mt*16 + 8h + g; a chunk is GROUP consecutive halves, or LANES rows g
      const int sub = s / KT;
#pragma unroll
      for (int f0 = 0; f0 < 8; f0 += GROUP) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float best = INFINITY;
            int best_p = 0x7fffffff;
#pragma unroll
            for (int f = f0; f < f0 + GROUP; ++f) {
              const int mt = f >> 1, h = f & 1;
              const int row = warp_m * 64 + mt * 16 + 8 * h + g;
              const int x = sub * BM + row;
              float d = __fmul_rn(__int2float_rn(acc[mt][nt][2 * h + j]), q_s[nt][j]);
              if (cosine) {
                const float norm0 = sqrtf(fmaxf(tl.csq[row], 0.f));
                d = __fsub_rn(1.f, __fdiv_rn(d, fmaxf(__fmul_rn(norm0, q_n[nt][j]), 1e-10f)));
              }
              if (!row_ok(x)) d = INFINITY;
              keep_min(best, best_p, d, row_pos(x));
            }
#pragma unroll
            for (int o = 4; o < 4 * LANES; o <<= 1) {
              const float d2 = __shfl_xor_sync(0xffffffffu, best, o);
              const int p2 = __shfl_xor_sync(0xffffffffu, best_p, o);
              keep_min(best, best_p, d2, p2);
            }
            if ((g & (LANES - 1)) == 0) {
              const int x0 = sub * BM + warp_m * 64 + (f0 >> 1) * 16 + (f0 & 1) * 8 + g;
              emit(x0 / CHUNK, warp_n * 32 + nt * 8 + t * 2 + j, best, best_p);
            }
          }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
      __syncthreads();  // every warp is done with codes_s / csq of this sub-tile
      if (sub + 1 < n_sub) stage_codes(sub + 1);
    } else {
      __syncthreads();  // stage s&1 is refilled by the next iteration's prefetch
    }
  }
}

// one host launch per CHUNK: the kernel template instantiated for each
template <template <int> class Launch, class... Args>
int dispatch_chunk(int chunk, Args... args) {
  switch (chunk) {
    case 1: return Launch<1>::run(args...);
    case 2: return Launch<2>::run(args...);
    case 4: return Launch<4>::run(args...);
    case 8: return Launch<8>::run(args...);
    case 16: return Launch<16>::run(args...);
    case 32: return Launch<32>::run(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace adc
