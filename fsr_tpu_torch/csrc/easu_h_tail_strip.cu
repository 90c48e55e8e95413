// K6 with the frame tail on row strips read in place
// (fsr_easu_h_tail_strip): easu_h.cu compiled with FSR_TAIL_TU and
// FSR_STRIP_TU, which keep its kernels and emit only the strip tail entry
// point, in a translation unit of its own (easu_h_tail.cu's reason).
#define FSR_TAIL_TU
#define FSR_STRIP_TU
#include "easu_h.cu"
