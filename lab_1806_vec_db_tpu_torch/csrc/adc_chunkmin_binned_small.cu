// K11's chunk 1 and 2 kernels (csrc/adc_chunkmin_binned.cuh), built beside
// adc_chunkmin_binned.cu's and adc_chunkmin_binned_mid.cu's so that nvcc
// compiles the six in parallel thirds.

#include "adc_chunkmin_binned.cuh"

#define K11_LAUNCH(C)                                                                            \
  int k11::launch<C>(const void*, const void*, const void*, const void*, const void*, float,     \
                     const void*, const void*, void*, void*, int, int, int, int, void*)

template K11_LAUNCH(1);
template K11_LAUNCH(2);
