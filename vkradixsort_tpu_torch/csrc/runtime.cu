// Error reporting for the ctypes binding (ops/kernels.py): the kernels'
// C entry points return a cudaError_t, and this names it.
#include <cuda_runtime.h>

extern "C" const char* vkrs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
