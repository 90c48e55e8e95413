// K6 with the frame tail on whole frames (fsr_easu_h_tail): easu_h.cu
// compiled a third time with FSR_TAIL_TU, which keeps its kernels and emits
// only the tail entry point.  A translation unit of its own, so that nvcc
// compiles the tail forms' instantiations beside the others
// (kernels/_build.py starts one nvcc per .cu source) and the build takes no
// longer.
#define FSR_TAIL_TU
#include "easu_h.cu"
