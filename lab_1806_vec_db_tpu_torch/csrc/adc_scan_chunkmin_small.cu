// K7's chunk 1, 2 and 4 kernels (csrc/adc_scan_chunkmin.cuh), built beside
// adc_scan_chunkmin.cu's so that nvcc compiles the six in parallel halves.

#include "adc_scan_chunkmin.cuh"

template int k7::launch<1>(const void*, const void*, const void*, const void*, const void*, float,
                           void*, void*, int, int, int, int, int, void*);
template int k7::launch<2>(const void*, const void*, const void*, const void*, const void*, float,
                           void*, void*, int, int, int, int, int, void*);
template int k7::launch<4>(const void*, const void*, const void*, const void*, const void*, float,
                           void*, void*, int, int, int, int, int, void*);
