// K11's entry point and its chunk 16 and 32 kernels (the kernel and its
// design: csrc/adc_chunkmin_binned.cuh; chunks 1 and 2:
// adc_chunkmin_binned_small.cu, 4 and 8: adc_chunkmin_binned_mid.cu).

#include "adc_chunkmin_binned.cuh"

#define K11_LAUNCH(C)                                                                            \
  int k11::launch<C>(const void*, const void*, const void*, const void*, const void*, float,     \
                     const void*, const void*, void*, void*, int, int, int, int, void*)

template K11_LAUNCH(16);
template K11_LAUNCH(32);
extern template K11_LAUNCH(1);
extern template K11_LAUNCH(2);
extern template K11_LAUNCH(4);
extern template K11_LAUNCH(8);

extern "C" int vecdb_adc_chunkmin_binned(const void* codes, const void* lut, const void* scales,
                                         const void* qn, const void* cs, float cs_scale,
                                         const void* lens, const void* bins, void* out_d,
                                         void* out_p, int nlist, int lpad, int QB, int cw, int mk,
                                         int packed, int chunk, void* stream) {
  if (nlist <= 0 || QB <= 0) return 0;
  if (!packed || mk != 2 * cw || cw % 4 || lpad % k11::PASS) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = [&](auto launch) {
    return launch(codes, lut, scales, qn, cs, cs_scale, lens, bins, out_d, out_p, nlist, lpad, QB,
                  cw, stream);
  };
  switch (chunk) {
    case 1: return run(k11::launch<1>);
    case 2: return run(k11::launch<2>);
    case 4: return run(k11::launch<4>);
    case 8: return run(k11::launch<8>);
    case 16: return run(k11::launch<16>);
    case 32: return run(k11::launch<32>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
