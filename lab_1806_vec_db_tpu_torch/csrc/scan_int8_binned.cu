// K10: segmented (binned) int8 group-min scan for Hopper (sm_90a).
//
// Replaces lab_1806_vec_db_tpu/ops/pallas_scan.py:scan_chunkmin_int8_binned
// (Pallas bodies _scan_kernel_int8_binned and _scan_kernel_int8_binned_bc,
// which differ only in the TPU channel layout).
//
// The binned IVF search scans each posting list ONCE against the block of
// (up to) QB = 128 queries that probe it.  Inputs: the padded int8 queries
// q8 (B_pad, D) with their channels qs2 / qc (B_pad,), the per-list query
// bins (nlist, 128) int32 (-1 on empty slots), and the cluster-sorted int8
// mirror base (>= nlist * lpad, D) with its channels scale / cache.  List l
// owns mirror rows [l * lpad, (l + 1) * lpad); pad rows carry scale 0 and
// cache +BIG, so no row needs a mask.  For 512-row tile T of list l:
//
//   q(c)      = max(bins[l, c], 0)            (an empty slot scores query 0,
//                                              like the reference; the caller
//                                              never reads it back)
//   dot[x, c] = sum_k base[x, k] * q8[q(c), k]                  (exact int32)
//   d[x, c]   = (cache[x] + qc[q(c)]) - float(dot) * (scale[x] * qs2[q(c)]),
//               the multiply-subtract fused (one rounding)
//   out[T*128 + s, c] = int32 min over level = 0..3 of
//                       (bits(d) & ~3) | level   at row x = T*512 + level*128 + s
//
// so out is (nlist * lpad / 4, 128) int32, the reference's layout exactly.
// Only rows below nlist * lpad are read: the ingest-sorted lean mirror keeps
// its overflow segment and capacity padding after them.
//
// What bounds it on the H100: memory.  Each list is read once for its 128
// queries (2 * 128 int8 operations per mirror byte, under the card's
// ~590 int8 ops per HBM byte), and the (R/4, 128) int32 output adds 128
// bytes per mirror row of 1024: at R = 1.5M rows the floor is ~0.5 ms.
// Design: one CTA per (list, 512-row tile) with the mma.sync m16n8k32
// pipeline (csrc/int8_mma.cuh).  The tile's four 128-row sub-tiles are
// exactly its four levels, so the group-min is an elementwise running min in
// registers across sub-tiles (each thread keeps its rows' survivors from the
// first sub-tile to the last).  The B operand is read through `bins` inside
// the kernel: the reference's (nlist, D, 128) transposed query copy (134 MB
// at nlist 1024) never exists.  The query rows of one list are shared by its
// tiles through L2.
//
// The epilogue (vecdb::i8::epilogue_fms) fuses the multiply-subtract into one
// rounding, which is how XLA computes the reference's body (its interpret
// mode agrees element for element); the plain version
// scan_chunkmin_int8_binned_ref emulates that single rounding exactly, so the
// output equals it bit for bit.
//
// Requirements, checked by the Python wrapper: lpad % 512 == 0, D % 64 == 0,
// contiguous tensors.  The caller guarantees every bins value lies in
// [-1, B_pad) (binning.bin_queries builds them so); the wrapper does not read
// bins back, which would stall the host on every search.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

using namespace vecdb::i8;

constexpr int TILE_ROWS = 512;  // _NB_BIN: one grid step of the reference
constexpr int LEVELS = TILE_ROWS / BM;  // 4 = _GS, the 2 packed low bits
constexpr int QB = BN;                  // queries per list bin

__global__ void __launch_bounds__(THREADS)
scan_int8_binned_kernel(const int8_t* __restrict__ q8, const float* __restrict__ qs2,
                        const float* __restrict__ qc, const int32_t* __restrict__ bins,
                        const int8_t* __restrict__ base, const float* __restrict__ scale,
                        const float* __restrict__ cache, int32_t* __restrict__ out, int D,
                        int tiles_per_list) {
  __shared__ __align__(16) int8_t smA[2][BM * LDS];
  __shared__ __align__(16) int8_t smB[2][BN * LDS];
  __shared__ int32_t qid[QB];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const size_t tile = blockIdx.x;
  const size_t list = tile / tiles_per_list;
  const size_t row0 = tile * TILE_ROWS;
  const int KT = D / BK;
  const int steps = LEVELS * KT;

  if (tid < QB) {
    const int b = bins[list * QB + tid];
    qid[tid] = b < 0 ? 0 : b;
  }
  __syncthreads();

  // this thread's 8 query columns: c = warp_n*32 + nt*8 + t*2 + j
  float q_s[4][2], q_c[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = qid[warp_n * 32 + nt * 8 + t * 2 + j];
      q_s[nt][j] = qs2[q];
      q_c[nt][j] = qc[q];
    }

  // running packed minima over the levels: [mt][h][nt][j] for sub-tile row
  // s = warp_m*64 + mt*16 + g + 8h and column warp_n*32 + nt*8 + t*2 + j
  int32_t mins[4][2][4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mins[mt][h][nt][0] = mins[mt][h][nt][1] = 0x7fffffff;

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  auto load_stage = [&](int stage, int step) {
    const int sub = step / KT, kt = step - (step / KT) * KT;
    const int8_t* a_src = base + (row0 + static_cast<size_t>(sub) * BM) * D + kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 128 rows x 64 bytes = 512 16-byte pieces per operand
      const int id = tid + i * THREADS;
      const int r = id >> 2, c = (id & 3) * 16;
      cp_async16(&smA[stage][r * LDS + c], a_src + static_cast<size_t>(r) * D + c, 16);
      cp_async16(&smB[stage][r * LDS + c], q8 + static_cast<size_t>(qid[r]) * D + kt * BK + c, 16);
    }
  };

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
    mma_step(smA[s & 1], smB[s & 1], acc, warp_m, warp_n, g, t);
    __syncthreads();  // stage s&1 is refilled by the next iteration's prefetch

    if (s % KT == KT - 1) {
      // epilogue of sub-tile `level`: tile rows level*128 + warp_m*64 + mt*16 + {g, g+8}
      const int level = s / KT;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const size_t r_lo = row0 + level * BM + warp_m * 64 + mt * 16 + g;
        const float sc[2] = {scale[r_lo], scale[r_lo + 8]};
        const float ca[2] = {cache[r_lo], cache[r_lo + 8]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float d = epilogue_fms(acc[mt][nt][2 * h + j], ca[h], q_c[nt][j], sc[h], q_s[nt][j]);
              const int32_t m = (__float_as_int(d) & ~(LEVELS - 1)) | level;
              mins[mt][h][nt][j] = min(mins[mt][h][nt][j], m);
              acc[mt][nt][2 * h + j] = 0;
            }
      }
    }
  }

  // survivors s of this tile -> out rows tile*128 + s; two adjacent columns
  // per 8-byte store (each warp writes 8 rows x 32 contiguous bytes per store)
  int32_t* o = out + tile * BM * QB;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int s_row = warp_m * 64 + mt * 16 + g + 8 * h;
        const int c = warp_n * 32 + nt * 8 + t * 2;
        *reinterpret_cast<int2*>(&o[s_row * QB + c]) = make_int2(mins[mt][h][nt][0], mins[mt][h][nt][1]);
      }
}

}  // namespace

extern "C" int vecdb_scan_int8_binned(const void* q8, const void* qs2, const void* qc,
                                      const void* bins, const void* base, const void* scale,
                                      const void* cache, void* out, int nlist, int lpad, int D,
                                      void* stream) {
  if (nlist <= 0 || lpad <= 0) return 0;
  const int tiles_per_list = lpad / TILE_ROWS;
  const long long grid = static_cast<long long>(nlist) * tiles_per_list;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  scan_int8_binned_kernel<<<static_cast<unsigned>(grid), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q8), static_cast<const float*>(qs2),
      static_cast<const float*>(qc), static_cast<const int32_t*>(bins),
      static_cast<const int8_t*>(base), static_cast<const float*>(scale),
      static_cast<const float*>(cache), static_cast<int32_t*>(out), D, tiles_per_list);
  return static_cast<int>(cudaGetLastError());
}
