// Error reporting for the ctypes binding (bitnuc_tpu_torch/kernels/_build.py).
#include "common.cuh"

extern "C" const char* bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
