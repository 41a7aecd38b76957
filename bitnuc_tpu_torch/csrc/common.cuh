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

// prmt.b32 a, 0, sel: byte k of the result is byte (nibble k of sel) of a,
// or 0 for nibbles 4..7, for the low four nibbles of sel (__byte_perm would
// mask each nibble to three bits first). No nibble may have bit 3 set (the
// sign-replicating mode).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(a), "r"(sel));
  return r;
}

// One 16-byte copy from device to shared memory that does not wait
// (cp.async, L2 only), so a thread has all its chunks in flight at once.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// cp.async of 4 bytes, through L1.
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most `pending` of this thread's committed groups are in flight.
template <int pending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace bn
