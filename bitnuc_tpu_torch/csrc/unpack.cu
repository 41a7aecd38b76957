// K2: 2-bit packed words -> ASCII reads.
//
// Replaces bitnuc_tpu/ops/pallas/unpack.py::decode_reads_pallas. Same
// function as the plain decode (codec.decode_reads_torch): out[b, p] is the
// ASCII letter (A, C, G, T) of base p of read b for p below both the read's
// length and the words' capacity 16 * W, and 0 elsewhere, for p in
// [0, max_len). max_len may be smaller or larger than 16 * W, and B, W and
// max_len may each be 0.
//
// Bound on the card: bytes. It reads 0.25 B (the words) and writes 1 B (the
// letters) a base of the output, so the stores are four fifths of the
// traffic; a 16-byte chunk of output costs about 80 int32 operations
// here, which at 64 a clock an SM take about 80% of its bytes' time at
// the HBM rate.
//
// Design. The [B, max_len] output is one contiguous byte stream, whatever
// max_len mod 16, and the kernel writes it as such: each thread stores whole
// 16-byte chunks aligned in device memory, consecutive threads consecutive
// chunks, so a warp's store is one contiguous 512-byte write; only the bytes
// before a block's first aligned chunk and after its last, fewer than 16
// each, are stored singly. A block takes a tile of whole rows, up to
// kTileBytes of output (on an H100, 32-KB tiles ran 9-18% faster than 8-KB
// tiles at 150 and 300 bp, 16-KB tiles in between; PERF.md §6), with rows a
// multiple of 16 / gcd(max_len, 16) where that fits, so that every tile
// after the first starts aligned and has no single bytes. It first stages
// in shared memory the tile's words, with 16-byte asynchronous copies
// aligned to the words' own address (the words may be a row-offset view,
// 4-byte aligned), and each row's length clamped to the row's capacity,
// read once a row. A chunk is then made in registers from the stage: the
// row and base of its first byte (one multiply-high by the inverse of
// max_len), then for each row the chunk touches (one or two at max_len >=
// 16) a funnel shift of two staged words gives the row's next 16 codes,
// masked to its valid bases (bn::base_mask) and placed at the chunk's byte.
// The 16 codes spread into two __byte_perm selectors a pair of output
// words, and a byte at or past its row's length gets selector 6, which
// picks a zero byte, so letters and zeros come from one permute a word. The
// output is never staged: written in chunks of a row (row * max_len + 16 c),
// it would sit in shared memory at offsets aligned for no vector store.
// Rows longer than kShortRowMax bytes are cut into segments of kSegBytes, a
// block each, so that a long row spreads over the card. Index arithmetic
// inside a tile is 32-bit; only a tile's base offset into the output is
// 64-bit. The TPU kernel's u8 bitcasts and lane-local layout are Mosaic
// artefacts and are not kept.
#include <climits>
#include <numeric>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 32768;    // output bytes a tile of whole rows holds at most
constexpr int kMaxTileRows = 4096;
constexpr int kMaxTileWords = 4096;  // staged words a tile
constexpr int kShortRowMax = 4096;   // longer rows are cut into segments
constexpr int kSegBytes = 4096;      // output bytes a segment
constexpr uint32_t kAcgt = 0x54474341u;  // bytes 'A', 'C', 'G', 'T'

// The eight 2-bit codes in bits 0..15 of x, code k moved to bits 4k..4k+1
// (a __byte_perm selector a code): the bytes apart with one permute, then
// the nibbles, then the codes.
__device__ __forceinline__ uint32_t spread_codes(uint32_t x) {
  x = bn::prmt(x, 0x4140u);
  x = (x | (x << 4)) & 0x0F0F0F0Fu;
  return (x | (x << 2)) & 0x33333333u;
}

// n = clamp(left, 0, most), written with branches (see bn::base_mask).
__device__ __forceinline__ int clamp_bases(int left, int most) {
  if (left <= 0) return 0;
  if (left >= most) return most;
  return left;
}

// Row r of a tile: r = s / L for a byte offset s in the tile, by a
// multiply-high with inv = ceil(2^32 / L) (exact while s * L < 2^32, which
// holds in a tile), and r = 0 where inv is 0 (a segment, or a tile of one
// row), r = s where L is 1.
__device__ __forceinline__ int row_of(uint32_t s, uint32_t L, uint32_t inv) {
  return L == 1u ? (int)s : (int)__umulhi(s, inv);
}

// Puts src[0, n) words on its way into stage at word offset h = (src / 4)
// mod 4 and returns h: 16-byte asynchronous copies of the aligned chunks,
// and the words before the first chunk and after the last (fewer than four
// each) loaded singly.
__device__ __forceinline__ int stage_words(const uint32_t* __restrict__ src, int n,
                                           uint32_t* stage) {
  const int h = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3u);
  const int lead = h ? 4 - h : 0;  // words before the first chunk
  const int chunks = n > lead ? (n - lead) >> 2 : 0;
  const int tail = lead + 4 * chunks;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    bn::copy16_async(stage + h + lead + 4 * k, src + lead + 4 * k);
  }
  const int t = threadIdx.x;
  if (!chunks) {
    if (t < n) stage[h + t] = src[t];
  } else if (t < lead) {
    stage[h + t] = src[t];
  } else if (t >= 4 && t - 4 < n - tail) {
    stage[h + tail + t - 4] = src[tail + t - 4];
  }
  return h;
}

// Decodes a tile: nr rows of L bytes each to dst[0, nr * L), from the
// staged words st (row r's at st + r * sw; a row's bases [16 c, 16 c + 16)
// in its word c) and each row's valid bases lim[r] (<= min(16 sw, L)).
// Called by all threads of the block after the stage is complete.
__device__ __forceinline__ void decode_tile(const uint32_t* st, const int* lim, int nr, int sw,
                                            int L, uint32_t inv, uint8_t* __restrict__ dst) {
  const int n = nr * L;
  const int lead = (int)((16u - (uint32_t)(reinterpret_cast<uintptr_t>(dst) & 15u)) & 15u);
  const int chunks = n > lead ? (n - lead) >> 4 : 0;
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    const int s0 = lead + 16 * k;
    int r = row_of((uint32_t)s0, (uint32_t)L, inv);
    int p = s0 - r * L;
    uint32_t codes = 0u, valid = 0u;  // 2 bits a byte of the chunk
    int j = 0;
    do {  // the pieces of rows r, r + 1, ... in the chunk, from byte j on
      const int e = min(16 - j, L - p);  // bytes of row r here
      const int v = clamp_bases(lim[r] - p, e);
      if (v > 0) {
        const uint32_t* w = st + r * sw + (p >> 4);
        const uint32_t m = bn::base_mask(v);
        codes |= (__funnelshift_r(w[0], w[1], 2 * p) & m) << (2 * j);
        valid |= m << (2 * j);
      }
      j += e;
      ++r;
      p = 0;
    } while (j < 16);
    // selector nibble: the code (0..3, a letter of kAcgt), or 6 (a zero byte)
    // where the byte is past its row's length; codes there are 0
    const uint32_t lo = spread_codes(codes) | (spread_codes(~valid) << 1);
    const uint32_t hi = spread_codes(codes >> 16) | (spread_codes(~valid >> 16) << 1);
    *reinterpret_cast<uint4*>(dst + s0) =
        make_uint4(bn::prmt(kAcgt, lo), bn::prmt(kAcgt, lo >> 16), bn::prmt(kAcgt, hi),
                   bn::prmt(kAcgt, hi >> 16));
  }
  // the bytes before the first chunk and after the last, one a thread
  const int tail = lead + 16 * chunks;
  const int t = threadIdx.x;
  int s = -1;
  if (!chunks) {
    if (t < n) s = t;
  } else if (t < lead) {
    s = t;
  } else if (t >= 16 && tail + (t - 16) < n) {
    s = tail + (t - 16);
  }
  if (s >= 0) {
    const int r = row_of((uint32_t)s, (uint32_t)L, inv);
    const int p = s - r * L;
    uint32_t letter = 0u;
    if (p < lim[r]) {
      const uint32_t code = (st[r * sw + (p >> 4)] >> (2 * (p & 15))) & 3u;
      letter = (kAcgt >> (8 * code)) & 0xFFu;
    }
    dst[s] = (uint8_t)letter;
  }
}

// A tile of `rows` whole rows a block (L <= kShortRowMax): its words, the
// first sw of each row (sw = min(W, ceil(L / 16)), all of them where sw =
// W), and its rows' lengths clamped to [0, cap], cap = min(16 W, L).
__global__ void __launch_bounds__(kThreads)
    unpack_rows_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lengths,
                       int64_t B, int64_t W, int L, int sw, int rows, int cap, uint32_t inv,
                       uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t stage[kMaxTileWords + 8];
  __shared__ int lim[kMaxTileRows];
  const int64_t r0 = (int64_t)blockIdx.x * rows;
  const int nr = (int)(B - r0 < rows ? B - r0 : rows);
  for (int r = threadIdx.x; r < nr; r += kThreads) lim[r] = clamp_bases(lengths[r0 + r], cap);
  const uint32_t* src = words + r0 * W;
  int h = 0;
  if (sw == W) {
    h = stage_words(src, nr * sw, stage);
  } else {  // the first sw words of each row: a rows' stride apart
    for (int i = threadIdx.x; i < nr * sw; i += kThreads) {
      const int r = i / sw;
      stage[i] = src[r * W + (i - r * sw)];
    }
  }
  bn::copies_commit();
  bn::copies_wait<0>();
  __syncthreads();
  decode_tile(stage + h, lim, nr, sw, L, inv, out + r0 * L);
}

// A segment of kSegBytes bytes of one row a block (L > kShortRowMax): the
// row's bases [q0, q0 + kSegBytes), decoded as a tile of one row.
__global__ void __launch_bounds__(kThreads)
    unpack_segments_kernel(const uint32_t* __restrict__ words,
                           const int32_t* __restrict__ lengths, int64_t W, int64_t L,
                           int64_t segs, int64_t cap, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t stage[kSegBytes / 16 + 8];
  __shared__ int lim;
  const int64_t row = blockIdx.x / segs;
  const int64_t q0 = (blockIdx.x - row * segs) * (int64_t)kSegBytes;
  const int len = (int)(L - q0 < kSegBytes ? L - q0 : kSegBytes);
  const int64_t n = lengths[row];
  const int64_t left = (n < 0 ? 0 : (n > cap ? cap : n)) - q0;  // valid bases from q0 on
  const int v = left <= 0 ? 0 : (left < len ? (int)left : len);
  if (threadIdx.x == 0) lim = v;
  const int h = stage_words(words + row * W + q0 / 16, (v + 15) / 16, stage);
  bn::copies_commit();
  bn::copies_wait<0>();
  __syncthreads();
  decode_tile(stage + h, &lim, 1, 0, len, 0u, out + row * L + q0);
}

}  // namespace

extern "C" int bn_unpack(const void* words, const void* lengths, int64_t B,
                         int64_t W, int64_t max_len, void* out, void* stream) {
  if (B <= 0 || max_len <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t cap = 16 * W < max_len ? 16 * W : max_len;  // a row's valid bases at most
  if (max_len <= kShortRowMax) {
    const int L = (int)max_len;
    const int64_t sw = W < (L + 15) / 16 ? W : (L + 15) / 16;
    int64_t rows = kTileBytes / L;
    if (rows > kMaxTileRows) rows = kMaxTileRows;
    if (sw > 0 && rows * sw > kMaxTileWords) rows = kMaxTileWords / sw;
    // whole 16-byte chunks a tile, where a tile holds that many rows
    const int step = 16 / std::gcd(L, 16);
    if (rows >= step) rows -= rows % step;
    const int64_t tiles = (B + rows - 1) / rows;
    if (tiles > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    const uint32_t inv = rows > 1 && L > 1 ? 0xFFFFFFFFu / (uint32_t)L + 1u : 0u;
    unpack_rows_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
        (const uint32_t*)words, (const int32_t*)lengths, B, W, L, (int)sw, (int)rows,
        (int)cap, inv, (uint8_t*)out);
  } else {
    const int64_t segs = (max_len + kSegBytes - 1) / kSegBytes;
    if (B > INT_MAX / segs) return (int)cudaErrorInvalidConfiguration;
    unpack_segments_kernel<<<(unsigned)(B * segs), kThreads, 0, s>>>(
        (const uint32_t*)words, (const int32_t*)lengths, W, max_len, segs, cap,
        (uint8_t*)out);
  }
  return (int)cudaGetLastError();
}
