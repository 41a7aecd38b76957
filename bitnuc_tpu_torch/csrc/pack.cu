// K1: ASCII reads -> 2-bit packed words, plus each read's first invalid base.
//
// Replaces bitnuc_tpu/ops/pallas/pack.py::encode_reads_pallas. Same function:
// words[b, w] holds bases [16w, 16w+16) of read b, LSB-first (A=0 C=1 G=2
// T=3), zero past the read's length and past L; first_bad[b] is the earliest
// offset below the clamped length whose byte is not in ACGTacgt, or -1.
// Bytes at or past a read's length are never inspected. Any even W >=
// ceil(L / 16) works, and so do L = 0 and B = 0.
//
// Bound on the card: bytes. It reads 1 B and writes 0.25 B a base; its
// SWAR coding needs about 4 int32 operations a base (a four-byte lane:
// the codes 3, their fold into the word 2, the selector 2, two byte
// permutes, the compare 1, the nonzero-byte test 3, the lane's bits into
// the word's mask 1), and at 64 a clock an SM those take about 60% of the
// bytes' time at the HBM rate. So the fold and the validity test spend few
// operations a byte, and a block's copies run ahead of its coding.
//
// Design. The [B, L] batch is one contiguous byte stream, whatever L mod 16
// and the base pointer's offset. A block stages a piece of it in shared
// memory with 16-byte asynchronous copies (cp.async) aligned to the stream;
// only the bytes before the first aligned chunk and after the last, fewer
// than 16 each, are loaded singly. So each warp request is one contiguous
// 512-byte read, and a thread has all its copies in flight at once. Rows of
// up to kShortRowMax bytes are staged as tiles of whole rows (up to
// kStageBytes); pack_rows_kernel runs kBlocksPerSm persistent blocks an SM
// over the tiles, with two stages a block, so the next tile's copies (its
// bytes and row lengths) are in flight while the block codes this one
// (on an H100, 150-bp and 300-bp reads ran 7-13% faster this way than
// at one tile a block, and 1-kb and 4-kb reads 8% slower; PERF.md §6).
// Longer rows are cut into segments of kSegWords words, a block each
// (pack_segments_kernel), so that one long row spreads over the card.
// A thread codes a word from shared memory: five 32-bit reads and
// __funnelshift_r give its 16 bytes at any byte offset; the codes
// ((x >> 1) ^ (x >> 2)) & 3 of four bytes fold into one byte of the word
// with one multiply, and the same codes check the four bytes' validity with
// no loop over bytes (bad_bytes). first_bad is finished in the kernel: a
// tile of whole rows reduces each row's minimum in shared memory and writes
// -1 or the offset once, so an encode of short rows is one launch; a
// segment reduces its minimum in shared memory and makes one unsigned
// atomicMin into first_bad, which bn_pack sets to all ones first (UINT_MAX
// reads as -1 in int32, and offsets are below 2^31). The TPU kernel's
// lane-local bitcasts and tiled min-accumulator are Mosaic artefacts and are
// not kept.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kShortRowMax = 4096;   // longer rows are cut into segments
constexpr int kStageBytes = 8192;    // a tile of whole rows, two a block
constexpr int kMaxTileRows = 512;
constexpr int kMaxTileWords = 4096;  // unless one row has more
constexpr int kBlocksPerSm = 4;      // the rows kernel's grid: persistent blocks
constexpr int kSegWords = kThreads;  // a segment: one word a thread
// a stage's head offset (< 16) and the 20 bytes read for a word's last 16
constexpr int kSlack = 48;

// The invalid bytes of a four-byte lane v whose byte codes are c, one bit a
// byte in bits 28..31 (bit 28 + k: byte k is not in ACGTacgt; the bits
// below are not defined). A lower-cased byte x with code c is in acgt
// exactly when x == "acgt"[c], the only way (x | 0x20) can be one of a, c,
// g, t: the four codes, moved into the nibbles of a selector (bytes 0 and 2
// of c | c >> 4), pick the expected bytes with one byte permute, and a byte
// of the difference is nonzero exactly when its top bit is set in
// ((d & 0x7F..) + 0x7F..) | d. The multiply by 2^21 + 2^14 + 2^7 + 1 moves
// the four top bits (7, 15, 23, 31) to 28..31; its other terms sum below
// 2^24, so they carry nothing into them.
__device__ __forceinline__ uint32_t bad_bytes(uint32_t v, uint32_t c) {
  const uint32_t sel = bn::prmt(c | (c >> 4), 0x0020u);
  const uint32_t d = (v | 0x20202020u) ^ bn::prmt(0x74676361u, sel);
  const uint32_t hi = (((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d) & 0x80808080u;
  return hi * 0x00204081u;
}

// A 32-bit load from a shared-memory address.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// The word of the 16 staged bytes at shared-memory address `addr`, of which
// the first n (0..16) lie below the read's length; *bad is the index in the
// word of the first invalid one of those n, or -1.
__device__ __forceinline__ uint32_t code_word(uint32_t addr, int n, int* bad) {
  const uint32_t p = addr & ~3u;
  const uint32_t shift = 8u * (addr & 3u);
  uint32_t x[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) x[j] = lds32(p + 4u * j);
  // the four codes of a lane fold into bits 24..31 of c * (2^24 + 2^18 +
  // 2^12 + 2^6); the other terms sum below 2^24
  uint32_t word = 0u, bits = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t v = __funnelshift_r(x[i], x[i + 1], shift);
    const uint32_t c = ((v >> 1) ^ (v >> 2)) & 0x03030303u;
    word |= ((c * 0x01041040u) >> (24 - 8 * i)) & (0xFFu << (8 * i));
    bits |= (bad_bytes(v, c) >> (28 - 4 * i)) & (0xFu << (4 * i));
  }
  bits &= 0xFFFFu >> (16 - n);
  *bad = __ffs(bits) - 1;
  return word & bn::base_mask(n);
}

// A byte a thread loads singly, held in a register until stage_single
// stores it, so that its load, like the asynchronous copies, is in flight
// while the thread does other work.
struct Single {
  int pos;  // offset in the piece, or -1
  uint32_t byte;
};

// Puts src[0, n) on its way into the stage at byte offset head = src mod 16
// and returns head: 16-byte asynchronous copies of the aligned chunks, and
// the bytes before the first chunk and after the last (fewer than 16 each;
// all of a piece that holds no chunk, then at most 30) loaded singly, at
// most one a thread, into *single.
__device__ __forceinline__ uint32_t stage_issue(const uint8_t* __restrict__ src, int64_t n,
                                                uint32_t* stage, Single* single) {
  const uint32_t head = (uint32_t)(reinterpret_cast<uintptr_t>(src) & 15u);
  const int64_t lead = head ? 16 - head : 0;  // bytes before the first chunk
  const int64_t chunks = n > lead ? (n - lead) >> 4 : 0;
  const int64_t tail = lead + 16 * chunks;
  uint4* d = reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(stage) + head + lead);
  const uint4* g = reinterpret_cast<const uint4*>(src + lead);
  for (int64_t k = threadIdx.x; k < chunks; k += blockDim.x) bn::copy16_async(d + k, g + k);
  const int t = threadIdx.x;
  int64_t pos = -1;
  if (!chunks) {
    if (t < n) pos = t;
  } else if (t < lead) {
    pos = t;
  } else if (t >= 16 && tail + (t - 16) < n) {
    pos = tail + (t - 16);
  }
  single->pos = (int)pos;
  single->byte = pos >= 0 ? src[pos] : 0u;
  return head;
}

__device__ __forceinline__ void stage_single(uint32_t* stage, uint32_t head, Single single) {
  if (single.pos >= 0) reinterpret_cast<uint8_t*>(stage)[head + single.pos] = (uint8_t)single.byte;
}

// n = clamp(left, 0, 16), written with branches (see bn::base_mask).
template <typename T>
__device__ __forceinline__ int bases_in_word(T left) {
  if (left <= 0) return 0;
  if (left >= 16) return 16;
  return (int)left;
}

// Puts tile `tile` of `rows` whole rows on its way into a stage and its
// row lengths into len; returns the stage's head offset.
__device__ __forceinline__ uint32_t issue_tile(const uint8_t* __restrict__ ascii,
                                               const int32_t* __restrict__ lengths, int64_t B,
                                               int64_t L, int rows, int64_t tile,
                                               uint32_t* stage, int* len, Single* single) {
  const int64_t r0 = tile * rows;
  const int nr = (int)(B - r0 < rows ? B - r0 : rows);
  for (int r = threadIdx.x; r < nr; r += kThreads) bn::copy4_async(len + r, lengths + r0 + r);
  return stage_issue(ascii + r0 * L, nr * L, stage, single);
}

// Tiles of `rows` whole rows (rows * L bytes, rows * W words), tile t of
// `tiles` in block t mod gridDim.x, each staged in one of two buffers: the
// next tile's copies are in flight while the block codes this one, a word
// a thread at a time, and writes each of its rows' first_bad.
__global__ void __launch_bounds__(kThreads)
    pack_rows_kernel(const uint8_t* __restrict__ ascii, const int32_t* __restrict__ lengths,
                     int64_t B, int64_t L, int64_t W, int rows, int64_t tiles,
                     uint32_t* __restrict__ words, int32_t* __restrict__ first_bad) {
  __shared__ __align__(16) uint32_t stage[2][(kStageBytes + kSlack) / 4];
  __shared__ __align__(16) int row_len[2][kMaxTileRows];
  __shared__ int row_bad[kMaxTileRows];
  for (int r = threadIdx.x; r < kMaxTileRows; r += kThreads) row_bad[r] = INT_MAX;
  // r = i / W as a multiply by ceil(2^32 / W): exact while i * W < 2^32,
  // which holds where a tile has two rows or more (at most kMaxTileWords
  // words, so W <= kMaxTileWords / 2); a tile of one row has r = 0
  const uint32_t w32 = (uint32_t)W;
  const uint32_t inv_w = rows > 1 && w32 > 0 ? 0xFFFFFFFFu / w32 + 1u : 0u;
  const int l32 = (int)L;  // at most kShortRowMax
  int64_t t = blockIdx.x;
  int b = 0;
  Single single;
  uint32_t head = issue_tile(ascii, lengths, B, L, rows, t, stage[b], row_len[b], &single);
  bn::copies_commit();
  while (t < tiles) {
    stage_single(stage[b], head, single);
    const int64_t next = t + gridDim.x;
    Single next_single{-1, 0u};
    uint32_t next_head = 0u;
    if (next < tiles) {
      next_head = issue_tile(ascii, lengths, B, L, rows, next, stage[b ^ 1], row_len[b ^ 1],
                             &next_single);
    }
    bn::copies_commit();
    bn::copies_wait<1>();
    __syncthreads();
    const int64_t r0 = t * rows;
    const int nr = (int)(B - r0 < rows ? B - r0 : rows);
    const uint32_t n_words = (uint32_t)nr * w32;
    const uint32_t st = (uint32_t)__cvta_generic_to_shared(stage[b]) + head;
    const int* len = row_len[b];
    uint32_t* out = words + r0 * W + threadIdx.x;
    // no branch on n: a warp's words of short and long rows run together;
    // a word with n = 0 reads the stage's start and codes to 0
    for (uint32_t i = threadIdx.x; i < n_words; i += kThreads, out += kThreads) {
      const uint32_t r = __umulhi(i, inv_w), w = i - r * w32;
      // a negative length gives n = 0, and so do words past L (w is taken
      // below kShortRowMax / 16 so that 16 w stays in int32)
      const int n = bases_in_word(min(len[r], l32) - 16 * (int)min(w, kShortRowMax / 16u));
      int bad;
      const uint32_t word = code_word(n > 0 ? st + r * (uint32_t)l32 + 16u * w : st, n, &bad);
      if (bad >= 0) atomicMin(&row_bad[r], 16 * (int)w + bad);
      *out = word;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      first_bad[r0 + r] = row_bad[r] == INT_MAX ? -1 : row_bad[r];
      row_bad[r] = INT_MAX;
    }
    t = next;
    b ^= 1;
    head = next_head;
    single = next_single;
  }
}

// A segment of kSegWords words of one row a block, staged up to the row's
// length; the segment's first invalid offset goes to first_bad[row] with
// one unsigned atomicMin.
__global__ void __launch_bounds__(kThreads)
    pack_segments_kernel(const uint8_t* __restrict__ ascii,
                         const int32_t* __restrict__ lengths, int64_t L, int64_t W,
                         int64_t segs, uint32_t* __restrict__ words,
                         int32_t* __restrict__ first_bad) {
  __shared__ __align__(16) uint32_t stage[(16 * kSegWords + kSlack) / 4];
  __shared__ int seg_bad;
  const int64_t row = blockIdx.x / segs;
  const int64_t w0 = (blockIdx.x - row * segs) * kSegWords;
  const int64_t len = lengths[row];
  const int64_t left = (len < 0 ? 0 : (len > L ? L : len)) - 16 * w0;
  const int64_t nbytes = left <= 0 ? 0 : (left < 16 * kSegWords ? left : 16 * kSegWords);
  if (threadIdx.x == 0) seg_bad = INT_MAX;
  Single single;
  const uint32_t head = stage_issue(ascii + row * L + 16 * w0, nbytes, stage, &single);
  stage_single(stage, head, single);
  bn::copies_commit();
  bn::copies_wait<0>();
  __syncthreads();
  const int w = threadIdx.x;
  const int n = bases_in_word(nbytes - 16 * w);
  int bad = -1;
  uint32_t word = 0u;
  const uint32_t st = (uint32_t)__cvta_generic_to_shared(stage) + head;
  if (n > 0) word = code_word(st + 16u * w, n, &bad);
  if (w0 + w < W) words[row * W + w0 + w] = word;
  const int m = __reduce_min_sync(0xFFFFFFFFu, bad >= 0 ? 16 * w + bad : INT_MAX);
  if ((w & 31) == 0 && m != INT_MAX) atomicMin(&seg_bad, m);
  __syncthreads();
  if (threadIdx.x == 0 && seg_bad != INT_MAX) {
    atomicMin(reinterpret_cast<unsigned int*>(first_bad) + row,
              (unsigned int)(16 * w0 + seg_bad));
  }
}

}  // namespace

extern "C" int bn_pack(const void* ascii, const void* lengths, int64_t B,
                       int64_t L, int64_t W, void* words, void* first_bad,
                       void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (W > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (L <= kShortRowMax) {
    int64_t rows = kStageBytes / (L > 0 ? L : 1);
    if (rows > kMaxTileRows) rows = kMaxTileRows;
    if (W > 0 && rows * W > kMaxTileWords) rows = W >= kMaxTileWords ? 1 : kMaxTileWords / W;
    // whole rounds of a word a thread where a round holds two rows or more;
    // rows of more than kThreads / 2 words fill the stage instead
    if (rows * W > kThreads && 2 * W <= kThreads) rows = rows * W / kThreads * kThreads / W;
    const int64_t tiles = (B + rows - 1) / rows;
    const int64_t blocks = (int64_t)bn::sm_count() * kBlocksPerSm;
    pack_rows_kernel<<<(unsigned)(tiles < blocks ? tiles : blocks), kThreads, 0, s>>>(
        (const uint8_t*)ascii, (const int32_t*)lengths, B, L, W, (int)rows, tiles,
        (uint32_t*)words, (int32_t*)first_bad);
  } else {
    const int64_t segs = (W + kSegWords - 1) / kSegWords;
    if (B * segs > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    const cudaError_t e = cudaMemsetAsync(first_bad, 0xFF, 4 * B, s);
    if (e != cudaSuccess) return (int)e;
    pack_segments_kernel<<<(unsigned)(B * segs), kThreads, 0, s>>>(
        (const uint8_t*)ascii, (const int32_t*)lengths, L, W, segs, (uint32_t*)words,
        (int32_t*)first_bad);
  }
  return (int)cudaGetLastError();
}
