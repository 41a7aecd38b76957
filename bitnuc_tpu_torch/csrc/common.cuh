// Helpers shared by the kernel sources of bitnuc_tpu_torch.
//
// Each source exports plain C entry points (no PyTorch headers: the library
// builds in seconds and loads with ctypes). An entry point takes device
// pointers and the cudaStream_t as void*, launches on that stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bn {

// Streaming multiprocessors of the current device (132 on an H100 SXM).
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Grid size for a grid-stride loop over n items: enough blocks to cover n,
// capped at `per_sm` resident blocks per SM.
inline unsigned grid_for(int64_t n, int threads, int per_sm) {
  int64_t want = (n + threads - 1) / threads;
  int64_t cap = (int64_t)sm_count() * per_sm;
  if (want > cap) want = cap;
  return (unsigned)(want > 0 ? want : 1);
}

// Mask keeping the low 2*v bits of a word (v valid bases, clamped to
// 0..16); a shift by 32 is undefined, so both ends are taken apart. Keep
// the branches: the form `v = clamp(v, 0, 16); v == 16 ? ~0u :
// (1u << 2v) - 1u` compiles with nvcc 12.9 for sm_90a into a VIMNMX whose
// predicate output replaces the v == 16 test, and returned ~0u for every
// v >= 0 on an H100.
__device__ __forceinline__ uint32_t base_mask(int v) {
  if (v <= 0) return 0u;
  if (v >= 16) return 0xFFFFFFFFu;
  return 0xFFFFFFFFu >> (32 - 2 * v);
}

}  // namespace bn
