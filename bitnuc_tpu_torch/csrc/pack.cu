// K1: ASCII reads -> 2-bit packed words, plus each read's first invalid base.
//
// Replaces bitnuc_tpu/ops/pallas/pack.py::encode_reads_pallas. Same function:
// words[b, w] holds bases [16w, 16w+16) of read b, LSB-first (A=0 C=1 G=2
// T=3), zero past the read's length; first_bad[b] is the earliest offset
// below the length whose byte is not in ACGTacgt, or -1. Bytes at or past a
// read's length are never inspected.
//
// Bound on the card: memory. It reads 1 B and writes 0.25 B per base, with a
// few integer operations per byte, far below the issue rate.
//
// Design: one thread per output word. The thread takes its 16 ASCII bytes as
// one 16-byte load when the row segment is 16-byte aligned (the row stride L
// need not be a multiple of 16, so many rows are not) and as byte loads
// otherwise. It codes four bytes at a time with ((v>>1)^(v>>2)) & 0x03030303,
// folds the four codes of each 32-bit lane into one byte, and masks the word
// to the length. The invalid offset is reduced per word, then per warp over
// the lanes that share a read (__match_any_sync + __reduce_min_sync), and
// combined per read with one atomicMin into a buffer the wrapper fills with
// INT_MAX; the wrapper maps INT_MAX to -1. The TPU kernel's lane-local
// bitcasts and tiled min-accumulator are Mosaic artefacts and are not kept.
#include <climits>

#include "common.cuh"

namespace {

__device__ __forceinline__ bool is_acgt(uint32_t byte) {
  const uint32_t lower = byte | 0x20u;
  return lower == 'a' || lower == 'c' || lower == 'g' || lower == 't';
}

__global__ void pack_kernel(const uint8_t* __restrict__ ascii,
                            const int32_t* __restrict__ lengths, int64_t B,
                            int64_t L, int64_t W, uint32_t* __restrict__ words,
                            int32_t* __restrict__ first_bad) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < B * W;
  long long row = -1;  // lanes past the end form their own group
  int bad = INT_MAX;
  if (live) {
    row = idx / W;
    const int64_t base0 = 16 * (idx - row * W);
    int64_t len = lengths[row];
    len = len < 0 ? 0 : (len > L ? L : len);
    const int64_t left = len - base0;
    const int nvalid = left <= 0 ? 0 : (left >= 16 ? 16 : (int)left);
    uint32_t word = 0;
    if (nvalid > 0) {
      const uint8_t* src = ascii + row * L + base0;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (base0 + 16 <= L && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
        const uint4 q = *reinterpret_cast<const uint4*>(src);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (base0 + j < L) v[j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t c = ((v[i] >> 1) ^ (v[i] >> 2)) & 0x03030303u;
        const uint32_t p = (c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xFFu;
        word |= p << (8 * i);
      }
      word &= bn::base_mask(nvalid);
      for (int j = 0; j < nvalid; ++j) {
        if (!is_acgt((v[j >> 2] >> (8 * (j & 3))) & 0xFFu)) {
          bad = (int)(base0 + j);
          break;
        }
      }
    }
    words[idx] = word;
  }
  // every lane reaches this point: the block size is a multiple of 32
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, row);
  const int m = __reduce_min_sync(peers, bad);
  const int leader = __ffs(peers) - 1;
  if (live && (int)(threadIdx.x & 31) == leader && m != INT_MAX) {
    atomicMin(first_bad + row, m);
  }
}

}  // namespace

extern "C" int bn_pack(const void* ascii, const void* lengths, int64_t B,
                       int64_t L, int64_t W, void* words, void* first_bad,
                       void* stream) {
  const int64_t total = B * W;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    pack_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)ascii, (const int32_t*)lengths, B, L, W,
        (uint32_t*)words, (int32_t*)first_bad);
  }
  return (int)cudaGetLastError();
}
