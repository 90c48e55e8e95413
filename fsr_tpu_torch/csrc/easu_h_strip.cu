// K6's strip-source form (fsr_easu_h_strip): easu_h.cu compiled a second
// time with FSR_STRIP_TU, which keeps its kernels and emits only the strip
// entry point.  A translation unit of its own, so that nvcc compiles the
// strip instantiations beside the whole-frame ones (kernels/_build.py
// starts one nvcc per .cu source) and the build takes no longer.
#define FSR_STRIP_TU
#include "easu_h.cu"
