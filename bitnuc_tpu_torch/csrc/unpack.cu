// K2: 2-bit packed words -> ASCII reads.
//
// Replaces bitnuc_tpu/ops/pallas/unpack.py::decode_reads_pallas. Same
// function as the plain decode (codec.decode_reads_torch): out[b, p] is the
// ASCII letter (A, C, G, T) of base p of read b for p below both the read's
// length and the words' capacity 16 * W, and 0 elsewhere, for p in
// [0, max_len). max_len may be smaller or larger than 16 * W.
//
// Bound on the card: memory. It reads 0.25 B and writes 1 B per output base
// with a few integer operations per word.
//
// Design: one thread per (row, 16-byte chunk of the output row). Chunk c
// expands word c of the row: each byte of the word holds four codes, which
// become a selector for __byte_perm over the word 'A','C','G','T'; bytes at
// or past the length are masked with bn::base_mask (explicit branches). The
// row stride is max_len, which need not be a multiple of 16 (150 is not), so
// a chunk is stored as one 16-byte vector only where its address is 16-byte
// aligned, as four 4-byte words where it is 4-byte aligned, and byte by byte
// elsewhere and at the ragged end of a row. The TPU kernel's u8 bitcasts and
// lane-local layout are Mosaic artefacts and are not kept.
#include "common.cuh"

namespace {

constexpr uint32_t kAcgt = 0x54474341u;  // bytes 'A', 'C', 'G', 'T'

// The four ASCII letters of the four codes in one byte, first base lowest.
__device__ __forceinline__ uint32_t expand4(uint32_t byte) {
  const uint32_t sel = (byte & 0x03u) | ((byte & 0x0Cu) << 2) |
                       ((byte & 0x30u) << 4) | ((byte & 0xC0u) << 6);
  return __byte_perm(kAcgt, 0u, sel);
}

__global__ void unpack_kernel(const uint32_t* __restrict__ words,
                              const int32_t* __restrict__ lengths, int64_t B,
                              int64_t W, int64_t max_len, int64_t chunks,
                              uint8_t* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * chunks) return;
  const int64_t row = idx / chunks;
  const int64_t c = idx - row * chunks;
  const int64_t base0 = 16 * c;
  // bases of this chunk below the length; none past the words' capacity
  const int64_t left = c < W ? (int64_t)lengths[row] - base0 : 0;
  const int nvalid = left <= 0 ? 0 : (left >= 16 ? 16 : (int)left);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (nvalid > 0) {
    const uint32_t w = words[row * W + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = expand4((w >> (8 * i)) & 0xFFu) & bn::base_mask(4 * (nvalid - 4 * i));
    }
  }
  uint8_t* dst = out + row * max_len + base0;
  const int64_t room = max_len - base0;  // >= 1 bytes of this row left
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst);
  if (room >= 16 && (addr & 15u) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if (room >= 16 && (addr & 3u) == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) reinterpret_cast<uint32_t*>(dst)[i] = v[i];
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // unrolled: v stays in registers
      if (j < room) dst[j] = (uint8_t)(v[j >> 2] >> (8 * (j & 3)));
    }
  }
}

}  // namespace

extern "C" int bn_unpack(const void* words, const void* lengths, int64_t B,
                         int64_t W, int64_t max_len, void* out, void* stream) {
  const int64_t chunks = (max_len + 15) / 16;
  const int64_t total = B * chunks;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    unpack_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (const int32_t*)lengths, B, W, max_len, chunks,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
