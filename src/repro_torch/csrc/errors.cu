// Error text for the Python launchers (kernels/build.py:check).
#include <cuda_runtime.h>

#include "gemm_sm90.cuh"

extern "C" const char* kernel_error_string(int err) {
  if (err == -1) return "no kernel instance for the planned tile shape";
  if (err >= sm90::kEncodeError)
    return "cuTensorMapEncodeTiled refused the tensor map (CUresult = "
           "code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
