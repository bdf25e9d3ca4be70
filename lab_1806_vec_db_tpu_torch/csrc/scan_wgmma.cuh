// Helpers shared by the wgmma + TMA scans for Hopper (sm_90a): K1
// (scan_int8_packed.cu), K10 (scan_int8_binned.cu), K12
// (scan_bf16_chunkmin.cu) and K13 / K14 (scan_int8_bf16.cu); K11
// (adc_chunkmin_binned.cuh) takes its cp.async arrival and proxy fence from
// here.
//
// K7's header (adc_scan_chunkmin.cuh) gives the mbarrier, TMA, descriptor
// and wgmma fence helpers; this one adds the m64n128 wgmma shapes with both
// operands in shared memory (int8 and bf16), the 16-byte cp.async that
// gathers rows into a swizzled tile, an mbarrier wait that traps instead of
// hanging, a named barrier, and the tensor maps of the TMA loads.

#pragma once

#include "adc_scan_chunkmin.cuh"

namespace scan {

using k7::smem_u32;

// d (+)= A (64 x 32 int8, shared memory) x B (32 x 128 int8, shared
// memory), both K-major through 128-byte-swizzle descriptors: accumulate
// == 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A (64 x 16 bf16, shared memory) x B (16 x 128 bf16, shared memory)
// in f32, both K-major through 128-byte-swizzle descriptors: accumulate ==
// 0 overwrites d
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// keeps the compiler from moving f32 accumulator reads / writes across wgmma
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wait until the phase of `bar` with this parity has completed; trap (a
// launch error the wrapper reports) if it has not after ~2^35 clocks, many
// seconds, so a protocol fault ends the kernel instead of hanging the card
__device__ __forceinline__ void wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  long long t0 = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred P;\nmbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\nselp.u32 %0, 1, 0, P;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 35)) __trap();
  }
}

// 16 bytes, zero-filled past src_bytes (0 or 16)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.asyncs have landed (the
// barrier's expected count includes the arrival)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15) over `threads` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a 2-D tensor map of `type` elements (cols x rows, row stride
// `row_bytes`), 128-byte swizzled boxes of box_cols x box_rows, zero-filled
// outside the tensor; CUDA_SUCCESS or the driver's error
inline CUresult tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, int cols,
                           long long rows, long long row_bytes, int box_cols, int box_rows) {
  const k7::EncodeTiled encode = k7::encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace scan
