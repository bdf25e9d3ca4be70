// K11's chunk 4 and 8 kernels (csrc/adc_chunkmin_binned.cuh), built beside
// adc_chunkmin_binned.cu's and adc_chunkmin_binned_small.cu's so that nvcc
// compiles the six in parallel thirds.

#include "adc_chunkmin_binned.cuh"

#define K11_LAUNCH(C)                                                                            \
  int k11::launch<C>(const void*, const void*, const void*, const void*, const void*, float,     \
                     const void*, const void*, void*, void*, int, int, int, int, void*)

template K11_LAUNCH(4);
template K11_LAUNCH(8);
