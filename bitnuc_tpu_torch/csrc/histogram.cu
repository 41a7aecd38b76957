// K3a and K3b: dense k-mer histograms, [4^k] int32 counts for k <= 12.
//
// K3a hist_keys replaces bitnuc_tpu/ops/pallas/histogram.py::
// histogram_from_keys: int32 keys in [0, 4^k] -> counts, the sentinel 4^k
// (and any other key outside [0, 4^k)) not counted.
//
// K3b hist_words replaces histogram.py::histogram_from_words (through
// _histogram_from_words_slab): the same histogram with the window keys made
// in the kernel from the packed words. Window p = 16*col + j of a read takes
// bases [p, p+k) and counts where p <= len - k.
//
// Bound on the card: atomics. Each window costs one atomicAdd; the inputs
// are 4 B per key (K3a) or 0.25 B per base (K3b), so memory is not the
// limit. Where the histogram fits in shared memory (4 * 4^k bytes, k <= 7,
// 64 KB) each block keeps a private copy, counts into it with shared-memory
// atomics, and merges its non-zero bins into the output once. At k = 8..12
// (256 KB to 64 MB) the bins are spread wide enough that global atomics
// rarely collide, and the kernel adds into the output directly. Int32
// atomics are exact, so the TPU kernel's f32 MXU one-hots and their
// 2^22/2^23 exact-f32 slabbing have no counterpart here.
//
// K3b design: one thread per packed word. It loads the word and its right
// neighbour (zero past the row) and makes the 16 window keys as the funnel
// shift ((w >> 2j) | (next << (32 - 2j))) & mask, with j = 0 taken apart
// since a shift by 32 is undefined. There is no word-axis padding, so the
// TPU's short-read padding rule has no counterpart either.
#include "common.cuh"

namespace {

constexpr int kSmemMaxK = 7;  // 4 * 4^7 bytes = 64 KB of shared memory

template <bool kShared>
__device__ __forceinline__ void count(int32_t* sh, int32_t* hist, uint32_t key) {
  if (kShared) {
    atomicAdd(sh + key, 1);
  } else {
    atomicAdd(hist + key, 1);
  }
}

template <bool kShared>
__device__ __forceinline__ void zero_private(int32_t* sh, int nbins) {
  if (kShared) {
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) sh[i] = 0;
    __syncthreads();
  }
}

template <bool kShared>
__device__ __forceinline__ void merge_private(const int32_t* sh, int32_t* hist,
                                              int nbins) {
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
      const int32_t c = sh[i];
      if (c) atomicAdd(hist + i, c);
    }
  }
}

template <bool kShared>
__global__ void hist_keys_kernel(const int32_t* __restrict__ keys, int64_t n,
                                 int nbins, int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];
  zero_private<kShared>(sh, nbins);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t key = (uint32_t)keys[i];  // negative keys wrap out of range
    if (key < (uint32_t)nbins) count<kShared>(sh, hist, key);
  }
  merge_private<kShared>(sh, hist, nbins);
}

template <bool kShared>
__global__ void hist_words_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ lengths,
                                  int64_t B, int64_t W, int k,
                                  int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];
  const int nbins = 1 << (2 * k);
  const uint32_t mask = (uint32_t)nbins - 1u;
  zero_private<kShared>(sh, nbins);
  const int64_t total = B * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t row = idx / W;
    const int64_t col = idx - row * W;
    const int64_t last = (int64_t)lengths[row] - k;  // windows p <= last
    const int64_t p0 = 16 * col;
    if (p0 > last) continue;
    const int nwin = last - p0 >= 15 ? 16 : (int)(last - p0 + 1);
    const uint32_t w = words[idx];
    const uint32_t nx = col + 1 < W ? words[idx + 1] : 0u;
    count<kShared>(sh, hist, w & mask);
#pragma unroll
    for (int j = 1; j < 16; ++j) {
      if (j < nwin) {
        const uint32_t key = ((w >> (2 * j)) | (nx << (32 - 2 * j))) & mask;
        count<kShared>(sh, hist, key);
      }
    }
  }
  merge_private<kShared>(sh, hist, nbins);
}

// Launch `kern` privatised (k <= kSmemMaxK) or on global atomics.
template <typename Shared, typename Global, typename... Args>
int launch(Shared shared_kern, Global global_kern, int k, int64_t n_items,
           cudaStream_t stream, Args... args) {
  if (n_items <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  if (k <= kSmemMaxK) {
    const size_t bytes = sizeof(int32_t) << (2 * k);
    cudaFuncSetAttribute(shared_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    // few blocks: each merges up to 4^k bins into the output
    const unsigned blocks = bn::grid_for(n_items, threads * 16, 2);
    shared_kern<<<blocks, threads, bytes, stream>>>(args...);
  } else {
    const unsigned blocks = bn::grid_for(n_items, threads, 8);
    global_kern<<<blocks, threads, 0, stream>>>(args...);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bn_hist_keys(const void* keys, int64_t n, int k, void* hist,
                            void* stream) {
  return launch(hist_keys_kernel<true>, hist_keys_kernel<false>, k, n,
                (cudaStream_t)stream, (const int32_t*)keys, n, 1 << (2 * k),
                (int32_t*)hist);
}

extern "C" int bn_hist_words(const void* words, const void* lengths, int64_t B,
                             int64_t W, int k, void* hist, void* stream) {
  return launch(hist_words_kernel<true>, hist_words_kernel<false>, k, B * W,
                (cudaStream_t)stream, (const uint32_t*)words,
                (const int32_t*)lengths, B, W, k, (int32_t*)hist);
}
