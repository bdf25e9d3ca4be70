// K7's entry point and its chunk 8, 16 and 32 kernels (the kernel and its
// design: csrc/adc_scan_chunkmin.cuh; chunks 1-4: adc_scan_chunkmin_small.cu).

#include "adc_scan_chunkmin.cuh"

template int k7::launch<8>(const void*, const void*, const void*, const void*, const void*, float,
                           void*, void*, int, int, int, int, int, void*);
template int k7::launch<16>(const void*, const void*, const void*, const void*, const void*, float,
                            void*, void*, int, int, int, int, int, void*);
template int k7::launch<32>(const void*, const void*, const void*, const void*, const void*, float,
                            void*, void*, int, int, int, int, int, void*);
extern template int k7::launch<1>(const void*, const void*, const void*, const void*, const void*, float,
                                  void*, void*, int, int, int, int, int, void*);
extern template int k7::launch<2>(const void*, const void*, const void*, const void*, const void*, float,
                                  void*, void*, int, int, int, int, int, void*);
extern template int k7::launch<4>(const void*, const void*, const void*, const void*, const void*, float,
                                  void*, void*, int, int, int, int, int, void*);

extern "C" int vecdb_adc_chunkmin(const void* codes, const void* lut, const void* scales,
                                  const void* qn, const void* cs, float cs_scale, void* out_d,
                                  void* out_p, int B, int N, int n_valid, int cw, int mk, int S,
                                  int packed, int chunk, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (!packed || mk != 2 * cw || cw % 4) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = [&](auto launch) {
    return launch(codes, lut, scales, qn, cs, cs_scale, out_d, out_p, B, N, n_valid, cw, S, stream);
  };
  switch (chunk) {
    case 1: return run(k7::launch<1>);
    case 2: return run(k7::launch<2>);
    case 4: return run(k7::launch<4>);
    case 8: return run(k7::launch<8>);
    case 16: return run(k7::launch<16>);
    case 32: return run(k7::launch<32>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
