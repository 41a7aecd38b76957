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
// Int32 atomics are exact, so the TPU kernel's f32 MXU one-hots and their
// 2^22/2^23 exact-f32 slabbing have no counterpart here. Where the
// histogram fits in shared memory (4 * 4^k bytes, k <= 7, 64 KB) each block
// keeps a private copy, counts into it with shared-memory atomics, and
// merges its non-zero bins into the output once (both kernels).
//
// K3a at k >= kSliceMinK (256 KB to 64 MB of bins) counts in slices. Its
// bound is the bytes: 4 N of keys and 4 * 4^k of table. One global atomic
// per key misses L2 where the table is larger than the card's 50 MB L2 (k =
// 12), and piles up on a few bins where keys repeat (k = 8, poly-A). So the
// keys are partitioned by slice first, and each slice of 2^kSliceBits bins
// (64 KB) is counted in shared memory. Four passes, all here:
//   1. bucket_count: each valid key's bucket, key >> kSliceBits, counted in
//      shared memory; one global add per block and non-zero bucket.
//   2. plan (one block): the exclusive scan of the bucket counts gives each
//      bucket's range and cursor; each bucket is cut into equal chunks of at
//      most kChunkKeys keys. The chunk count is at most
//      ceil(N / kChunkKeys) + buckets, which the host launches pass 4 with;
//      the surplus blocks exit.
//   3. scatter: each block counts its tile's buckets in shared memory,
//      reserves a range a bucket with one atomic on its cursor, orders the
//      tile by bucket in shared memory, and writes each valid key's offset
//      in its slice, key & (2^kSliceBits - 1), as a uint16 into its
//      bucket's range: a run of consecutive stores a bucket, not a scattered
//      2-byte store a key (the order inside a range is free).
//   4. slice_count (one block a chunk): the chunk's offsets counted in a
//      shared-memory slice; a bucket that is one chunk stores its whole
//      slice with plain stores, one cut into several chunks adds its
//      non-zero bins with atomics. No bin gets both.
// In each of these shared-memory counts the lanes that share lane 0's id add
// with one atomic (warp_add), so a poly-A warp costs one atomic, not 32.
// On an H100 the slices beat one global atomic a key from k = 8 on (the
// flagship's k = 8 batch and the count's k = 12 batch both; PERF.md), so
// kSliceMinK is the first k past the private tables. The tile sizes and
// kChunkKeys were chosen there too: a 16,384-key scatter tile gives k = 12
// runs of about 16 keys a bucket; chunks of 2^16 keys were no faster.
//
// K3b design: one thread per packed word, its row and column stepped with
// the grid's stride (no division a word). It loads the word and its right
// neighbour (zero past the row) and makes the 16 window keys by funnel
// shifts, masked to 2k bits. There is no word-axis padding, so the TPU's
// short-read padding rule has no counterpart either. With `canonical` each
// key becomes min(key, revcomp(key)) in registers: the reverse complement of
// the word and of its neighbour is made once a word (__brev of the
// complement, then a pair swap), and each window's by a funnel shift of the
// two and a mask. So a canonical count is one launch, as a plain one is; the
// TPU kernel counts plain windows only (its MXU one-hots), and the JAX
// package makes canonical keys with XLA.
// Counting: k <= 7 in private shared-memory tables (above); k = 8, the
// flagship's, in tables split between the two blocks of a pair: its 256-KB
// table does not fit one block's 227 KB of shared memory, so each block of a
// pair holds the bins of one parity of the key (128 KB, a block an SM), both
// read the pair's words, and each counts only the keys it owns. No block
// adds to another's table, so no thread-block cluster is needed. Parity
// splits canonical keys, which lean to small values, evenly. The adds are
// plain shared-memory atomics: on an H100 they take a warp's equal keys
// (poly-A) as fast as distinct ones, and warp_add's shuffles cost more than
// they saved. Each block adds its non-zero bins to the output once. k =
// 9..12: one global atomic per window. On an H100 (PERF.md) the pair ran in
// less than half the time of a 2-block cluster that adds each key to its
// owner block through distributed shared memory, and 4-block clusters of 64
// KB were slower still.

#include "common.cuh"

namespace {

constexpr int kSmemMaxK = 7;  // 4 * 4^7 bytes = 64 KB of shared memory
constexpr int kThreads = 256;

// K3a's slices (see the top of the file)
constexpr int kSliceMinK = kSmemMaxK + 1;
constexpr int kSliceBits = 14;  // 16,384 bins: 64 KB, three blocks an SM
constexpr int kSliceBins = 1 << kSliceBits;
constexpr int kMaxBuckets = (1 << 24) >> kSliceBits;  // 1,024 at k = 12
constexpr int kChunkKeys = 1 << 17;  // most keys a pass-4 block counts
constexpr int kCountTile = 8192;  // keys a pass-1 block takes at once
constexpr int kCountThreads = 512;
constexpr int kCountItems = kCountTile / kCountThreads;
constexpr int kScatterTile = 16384;  // keys a pass-3 block orders
constexpr int kScatterThreads = 1024;
constexpr int kScatterItems = kScatterTile / kScatterThreads;
constexpr int kScatterSmem = 4 * kScatterTile;  // tile_off and tile_bucket
constexpr int kSliceThreads = 512;
constexpr int kSliceItems = 8;  // offsets a thread loads at once in pass 4
constexpr unsigned kFull = 0xFFFFFFFFu;

// K3b at k = kSplitK in the two blocks of a pair (see the top of the file)
constexpr int kSplitK = kSmemMaxK + 1;  // 65,536 bins, 256 KB
constexpr int kSplitThreads = 1024;  // a block an SM (128 KB of shared memory)
constexpr int kSplitSmem = (int)(sizeof(int32_t) << (2 * kSplitK)) / 2;

__global__ void hist_keys_kernel(const int32_t* __restrict__ keys, int64_t n,
                                 int nbins, int32_t* __restrict__ hist) {
  extern __shared__ int32_t sh[];
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t key = (uint32_t)keys[i];  // negative keys wrap out of range
    if (key < (uint32_t)nbins) atomicAdd(sh + key, 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const int32_t c = sh[i];
    if (c) atomicAdd(hist + i, c);
  }
}

// -- K3a in slices (k >= kSliceMinK) ------------------------------------------

// counters[id] += 1 for each lane whose id >= 0. The lanes that share lane
// 0's id add with one atomic by lane 0, so a warp of equal ids (poly-A)
// costs one; each other lane adds its own. With kRank, returns each lane's
// rank among all the adds to counters[id] (the value before its add, plus
// the lanes below it in lane 0's group). Every lane of the warp calls it
// together, and it does not branch, so calls for several keys overlap.
// (__match_any_sync would aggregate every group, but it costs more the more
// distinct ids a warp holds, and uniform keys hold 32.)
template <bool kRank>
__device__ __forceinline__ int warp_add(int* counters, int id) {
  const int lane = threadIdx.x & 31;
  const bool in0 = id == __shfl_sync(kFull, id, 0);
  const unsigned same = __ballot_sync(kFull, in0);
  const int add = in0 ? (lane == 0 ? __popc(same) : 0) : 1;
  int old = 0;
  if (id >= 0 && add) old = atomicAdd(counters + id, add);
  if (!kRank) return 0;
  const int base0 = __shfl_sync(kFull, old, 0);
  return in0 ? base0 + __popc(same & ((1u << lane) - 1u)) : old;
}

// The bucket of the key at i, or -1 past the end or out of [0, nbins).
__device__ __forceinline__ int bucket_of(const int32_t* keys, int64_t i, int64_t n,
                                         uint32_t nbins) {
  if (i >= n) return -1;
  const uint32_t key = (uint32_t)keys[i];  // negative keys wrap out of range
  return key < nbins ? (int)(key >> kSliceBits) : -1;
}

// Pass 1: counts[b] = valid keys of bucket b.
__global__ void __launch_bounds__(kCountThreads)
bucket_count_kernel(const int32_t* __restrict__ keys, int64_t n, uint32_t nbins,
                    int nbuckets, unsigned long long* __restrict__ counts) {
  __shared__ int cnt[kMaxBuckets];
  for (int b = threadIdx.x; b < nbuckets; b += kCountThreads) cnt[b] = 0;
  __syncthreads();
  for (int64_t t0 = (int64_t)blockIdx.x * kCountTile; t0 < n;
       t0 += (int64_t)gridDim.x * kCountTile) {
    int id[kCountItems];
#pragma unroll
    for (int j = 0; j < kCountItems; ++j)
      id[j] = bucket_of(keys, t0 + j * kCountThreads + threadIdx.x, n, nbins);
#pragma unroll
    for (int j = 0; j < kCountItems; ++j) warp_add<false>(cnt, id[j]);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nbuckets; b += kCountThreads)
    if (cnt[b]) atomicAdd(counts + b, (unsigned long long)cnt[b]);
}

struct Chunk {
  long long begin;  // first offset in the scratch
  int len;
  int bucket_multi;  // bucket << 1 | (its bucket is cut into several chunks)
};

// Exclusive scan of v over the block (a multiple of 32 threads); warp_sums
// is 32 values of shared memory.
template <typename T>
__device__ T block_exclusive_scan(T v, T* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : T(0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const T out = x - v + (warp ? warp_sums[warp - 1] : T(0));
  __syncthreads();  // warp_sums is reused by the next scan
  return out;
}

// Pass 2, one block of kMaxBuckets threads: cursors, chunks and their count.
__global__ void __launch_bounds__(kMaxBuckets)
plan_kernel(const unsigned long long* __restrict__ counts, int nbuckets,
            unsigned long long* __restrict__ cursors, Chunk* __restrict__ chunks,
            int* __restrict__ n_chunks) {
  __shared__ unsigned long long warp_sums[32];
  const int b = threadIdx.x;
  const unsigned long long c = b < nbuckets ? counts[b] : 0ull;
  const unsigned long long q = (c + kChunkKeys - 1) / kChunkKeys;
  const unsigned long long begin = block_exclusive_scan(c, warp_sums);
  const unsigned long long first = block_exclusive_scan(q, warp_sums);
  if (b < nbuckets) cursors[b] = begin;
  if (b == kMaxBuckets - 1) *n_chunks = (int)(first + q);
  if (q == 0) return;
  const unsigned long long len = c / q, extra = c % q;  // equal chunks <= kChunkKeys
  for (unsigned long long j = 0; j < q; ++j) {
    Chunk ch;
    ch.begin = (long long)(begin + j * len + (j < extra ? j : extra));
    ch.len = (int)(len + (j < extra));
    ch.bucket_multi = b << 1 | (q > 1);
    chunks[first + j] = ch;
  }
}

// Pass 3: each valid key's slice offset into its bucket's range. The tile
// is ordered by bucket in shared memory first, so each bucket's keys leave
// as one run of consecutive stores, not one scattered store a key.
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const int32_t* __restrict__ keys, int64_t n, uint32_t nbins,
               unsigned long long* __restrict__ cursors, uint16_t* __restrict__ offsets) {
  constexpr int kPer = kMaxBuckets / kScatterThreads;  // buckets a thread scans
  __shared__ int cnt[kMaxBuckets];             // tile's keys a bucket, then its start
  __shared__ long long shift[kMaxBuckets];     // global start - start in the tile
  extern __shared__ uint16_t tile_off[];  // kScatterTile, then tile_bucket
  uint16_t* tile_bucket = tile_off + kScatterTile;
  __shared__ int warp_sums[32];
  __shared__ int n_valid;
  for (int b = threadIdx.x; b < kMaxBuckets; b += kScatterThreads) cnt[b] = 0;
  __syncthreads();
  const int64_t t0 = (int64_t)blockIdx.x * kScatterTile;
  uint32_t key[kScatterItems];
  int rank[kScatterItems];
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j) {
    const int64_t i = t0 + j * kScatterThreads + threadIdx.x;
    key[j] = i < n ? (uint32_t)keys[i] : nbins;  // negative keys wrap out of range
  }
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j)
    rank[j] = warp_add<true>(cnt, key[j] < nbins ? (int)(key[j] >> kSliceBits) : -1);
  __syncthreads();
  // each thread scans kPer consecutive buckets
  int c[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) sum += (c[j] = cnt[kPer * threadIdx.x + j]);
  int start = block_exclusive_scan(sum, warp_sums);
  if (threadIdx.x == kScatterThreads - 1) n_valid = start + sum;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = kPer * threadIdx.x + j;
    if (c[j]) shift[b] = (long long)atomicAdd(cursors + b, (unsigned long long)c[j]) - start;
    cnt[b] = start;
    start += c[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kScatterItems; ++j) {
    if (key[j] < nbins) {
      const int b = key[j] >> kSliceBits;
      const int at = cnt[b] + rank[j];
      tile_off[at] = (uint16_t)(key[j] & (kSliceBins - 1));
      tile_bucket[at] = (uint16_t)b;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_valid; i += kScatterThreads)
    offsets[shift[tile_bucket[i]] + i] = tile_off[i];
}

// Pass 4, one block a chunk: the chunk's offsets counted in a shared-memory
// slice, then written to the slice's bins of hist.
__global__ void __launch_bounds__(kSliceThreads)
slice_count_kernel(const uint16_t* __restrict__ offsets, const Chunk* __restrict__ chunks,
                   const int* __restrict__ n_chunks, int32_t* __restrict__ hist) {
  extern __shared__ int4 slice4[];  // kSliceBins int32
  int* slice = reinterpret_cast<int*>(slice4);
  if ((int)blockIdx.x >= *n_chunks) return;
  const Chunk ch = chunks[blockIdx.x];
  for (int i = threadIdx.x; i < kSliceBins / 4; i += kSliceThreads)
    slice4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const uint16_t* src = offsets + ch.begin;
  for (int t0 = 0; t0 < ch.len; t0 += kSliceThreads * kSliceItems) {
    int id[kSliceItems];
#pragma unroll
    for (int j = 0; j < kSliceItems; ++j) {
      const int i = t0 + j * kSliceThreads + threadIdx.x;
      id[j] = i < ch.len ? (int)src[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kSliceItems; ++j) warp_add<false>(slice, id[j]);
  }
  __syncthreads();
  int32_t* out = hist + (int64_t)(ch.bucket_multi >> 1) * kSliceBins;
  if (ch.bucket_multi & 1) {
    for (int i = threadIdx.x; i < kSliceBins; i += kSliceThreads)
      if (slice[i]) atomicAdd(out + i, slice[i]);
  } else {
    int4* out4 = reinterpret_cast<int4*>(out);
    for (int i = threadIdx.x; i < kSliceBins / 4; i += kSliceThreads) out4[i] = slice4[i];
  }
}

// Byte offsets of pass 1-4's scratch for n keys at k (one buffer).
struct SliceScratch {
  int nbuckets;
  int64_t max_chunks, counts, cursors, n_chunks, chunks, offsets, total;
  SliceScratch(int64_t n, int k) {
    nbuckets = 1 << (2 * k - kSliceBits);
    max_chunks = (n + kChunkKeys - 1) / kChunkKeys + nbuckets;
    counts = 0;
    cursors = counts + 8 * (int64_t)nbuckets;
    n_chunks = cursors + 8 * (int64_t)nbuckets;
    chunks = n_chunks + 16;
    offsets = chunks + (int64_t)sizeof(Chunk) * max_chunks;
    total = offsets + 2 * n;
  }
};

// Dynamic shared memory past 48 KB for passes 3 and 4, set once.
cudaError_t allow_slice_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScatterSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(slice_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(int32_t) * kSliceBins));
}

cudaError_t hist_keys_slices(const int32_t* keys, int64_t n, int k, int32_t* hist,
                             char* scratch, cudaStream_t stream) {
  static const cudaError_t attr = allow_slice_smem();
  if (attr != cudaSuccess) return attr;
  const SliceScratch s(n, k);
  const uint32_t nbins = 1u << (2 * k);
  auto* counts = reinterpret_cast<unsigned long long*>(scratch + s.counts);
  auto* cursors = reinterpret_cast<unsigned long long*>(scratch + s.cursors);
  auto* n_chunks = reinterpret_cast<int*>(scratch + s.n_chunks);
  auto* chunks = reinterpret_cast<Chunk*>(scratch + s.chunks);
  auto* offsets = reinterpret_cast<uint16_t*>(scratch + s.offsets);
  cudaError_t err = cudaMemsetAsync(counts, 0, 8 * (size_t)s.nbuckets, stream);
  if (err != cudaSuccess) return err;
  bucket_count_kernel<<<bn::grid_for(n, kCountTile, 4), kCountThreads, 0, stream>>>(
      keys, n, nbins, s.nbuckets, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  plan_kernel<<<1, kMaxBuckets, 0, stream>>>(counts, s.nbuckets, cursors, chunks, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<<<(unsigned)((n + kScatterTile - 1) / kScatterTile), kScatterThreads,
                   kScatterSmem, stream>>>(
      keys, n, nbins, cursors, offsets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  slice_count_kernel<<<(unsigned)s.max_chunks, kSliceThreads, sizeof(int32_t) * kSliceBins,
                       stream>>>(offsets, chunks, n_chunks, hist);
  return cudaGetLastError();
}

// The reverse complement of the 16 bases of x: __brev of the complement
// reverses the bases and swaps the two bits of each, the pair swap puts them
// back.
__device__ __forceinline__ uint32_t revcomp16(uint32_t x) {
  const uint32_t b = __brev(~x);
  return ((b >> 1) & 0x55555555u) | ((b & 0x55555555u) << 1);
}

// add(key, valid) for each of the 16 windows that start in word w (nx is
// the next word of the row, 0 past it); window j is valid for j < nwin. With
// kCanonical the key is min(key, revcomp(key)): the pair's reverse
// complement rc(w):rc(nx), shifted down by 32 - 2k into hi:lo, holds window
// j's at bit 32 - 2j (k <= 16).
template <bool kCanonical, typename Add>
__device__ __forceinline__ void word_windows(uint32_t w, uint32_t nx, int nwin, int k,
                                             Add add) {
  const uint32_t mask = (1u << (2 * k)) - 1u;
  uint32_t hi = 0, lo = 0;
  if (kCanonical) {
    const uint32_t rw = revcomp16(w), rn = revcomp16(nx);
    hi = rw >> (32 - 2 * k);
    lo = __funnelshift_r(rn, rw, 32 - 2 * k);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    uint32_t key = __funnelshift_r(w, nx, 2 * j) & mask;
    if (kCanonical) key = min(key, (j == 0 ? hi : __funnelshift_r(lo, hi, 32 - 2 * j)) & mask);
    add(key, j < nwin);
  }
}

// The word at flat index idx of a [B, W] batch with its row and column,
// stepped by the grid's stride with no division in the loop (one a thread
// to start). Rows and columns fit 32 bits with a stride to spare
// (bn_hist_words takes B below 2^30 and W below 2^26).
struct WordCursor {
  int64_t idx;
  int row, col, step_rows, step_cols;
  __device__ WordCursor(int64_t start, int64_t stride, int W)
      : idx(start), row((int)(start / W)), col((int)(start % W)),
        step_rows((int)(stride / W)), step_cols((int)(stride % W)) {}
  __device__ void advance(int64_t stride, int W) {
    idx += stride;
    row += step_rows;
    col += step_cols;
    if (col >= W) {
      col -= W;
      ++row;
    }
  }
};

// The word's windows that count (0..16) and its two words, or 0 windows.
__device__ __forceinline__ int load_word(const uint32_t* words, const int32_t* lengths,
                                         const WordCursor& c, int W, int k, uint32_t* w,
                                         uint32_t* nx) {
  const int64_t last = (int64_t)lengths[c.row] - k;  // windows p <= last
  const int64_t p0 = 16 * (int64_t)c.col;
  if (p0 > last) return 0;
  *w = words[c.idx];
  *nx = c.col + 1 < W ? words[c.idx + 1] : 0u;
  return last - p0 >= 15 ? 16 : (int)(last - p0 + 1);
}

// K3b. kParts = 0 (k > kSplitK): one global atomic a window. kParts = 1 (k
// <= kSmemMaxK): each block counts into its own [4^k] table in shared
// memory. kParts = 2 (k = kSplitK): the table is split between the two
// blocks of a pair by the key's low bit; both read the pair's words, and
// each counts only the keys it owns, at bin key >> 1. A block with a table
// adds its non-zero bins to the output once.
template <bool kCanonical, int kParts>
__global__ void __launch_bounds__(kSplitThreads)
hist_words_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lengths,
                  int64_t B, int W, int k, int32_t* __restrict__ hist) {
  constexpr int kGroup = kParts > 0 ? kParts : 1;  // blocks that read the same words
  extern __shared__ int32_t sh[];
  if (kParts == 2) k = kSplitK;  // known when compiled
  const int nbins = (1 << (2 * k)) / kGroup;
  if (kParts > 0) {
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) sh[i] = 0;
    __syncthreads();
  }
  const int part = (int)blockIdx.x % kGroup;
  const int64_t total = B * W;
  const int64_t stride = (int64_t)(gridDim.x / kGroup) * blockDim.x;
  for (WordCursor c((int64_t)(blockIdx.x / kGroup) * blockDim.x + threadIdx.x, stride, W);
       c.idx < total; c.advance(stride, W)) {
    uint32_t w, nx;
    const int nwin = load_word(words, lengths, c, W, k, &w, &nx);
    if (nwin == 0) continue;
    word_windows<kCanonical>(w, nx, nwin, k, [&](uint32_t key, bool valid) {
      if (!valid) return;
      if (kParts == 0)
        atomicAdd(hist + key, 1);
      else if ((int)(key % kGroup) == part)
        atomicAdd(sh + key / kGroup, 1);
    });
  }
  if (kParts > 0) {
    __syncthreads();
    for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
      const int32_t n = sh[i];
      if (n) atomicAdd(hist + (i * kGroup + part), n);
    }
  }
}

// Launch `kern` on `blocks` x `threads` with `smem` bytes of dynamic shared
// memory, of which it is allowed kMaxSmem. The kernel is a template
// argument, so each kernel has its own instantiation and sets its attribute
// once (two kernels of one type would share a function parameter's static).
template <auto kern, int kMaxSmem, typename... Args>
cudaError_t launch_shared(unsigned blocks, int threads, size_t smem, cudaStream_t stream,
                          Args... args) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  kern<<<blocks, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

constexpr int kPrivateSmem = (int)(sizeof(int32_t) << (2 * kSmemMaxK));

// Private tables: few blocks, as each merges up to 4^k bins into the output.
unsigned private_blocks(int64_t n_items) { return bn::grid_for(n_items, kThreads * 16, 2); }

template <bool kCanonical>
cudaError_t hist_words(const uint32_t* w, const int32_t* len, int64_t B, int W, int k,
                       int32_t* h, cudaStream_t s) {
  if (k <= kSmemMaxK)
    return launch_shared<hist_words_kernel<kCanonical, 1>, kPrivateSmem>(
        private_blocks(B * W), kThreads, sizeof(int32_t) << (2 * k), s, w, len, B, W, k, h);
  if (k == kSplitK) {  // as many pairs as a block an SM allows, fewer for a small batch
    const unsigned most = (unsigned)bn::sm_count() / 2;
    const unsigned want = bn::grid_for(B * W, kSplitThreads, 1);
    const unsigned pairs = want < most ? want : (most > 0 ? most : 1);
    return launch_shared<hist_words_kernel<kCanonical, 2>, kSplitSmem>(
        2 * pairs, kSplitThreads, kSplitSmem, s, w, len, B, W, k, h);
  }
  hist_words_kernel<kCanonical, 0><<<bn::grid_for(B * W, kThreads, 8), kThreads, 0, s>>>(
      w, len, B, W, k, h);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch bn_hist_keys needs for n keys at k.
extern "C" int bn_hist_keys_scratch(int64_t n, int k, int64_t* bytes) {
  *bytes = k >= kSliceMinK && n > 0 ? SliceScratch(n, k).total : 0;
  return 0;
}

extern "C" int bn_hist_keys(const void* keys, int64_t n, int k, void* hist, void* scratch,
                            void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (k >= kSliceMinK)
    return (int)hist_keys_slices((const int32_t*)keys, n, k, (int32_t*)hist, (char*)scratch,
                                 (cudaStream_t)stream);
  return (int)launch_shared<hist_keys_kernel, kPrivateSmem>(
      private_blocks(n), kThreads, sizeof(int32_t) << (2 * k), (cudaStream_t)stream,
      (const int32_t*)keys, n, 1 << (2 * k), (int32_t*)hist);
}

extern "C" int bn_hist_words(const void* words, const void* lengths, int64_t B,
                             int64_t W, int k, int canonical, void* hist, void* stream) {
  if (B * W <= 0) return (int)cudaGetLastError();
  if (B >= (1 << 30) || W >= (1 << 26)) return (int)cudaErrorInvalidValue;
  const auto* w = (const uint32_t*)words;
  const auto* len = (const int32_t*)lengths;
  auto* h = (int32_t*)hist;
  const auto s = (cudaStream_t)stream;
  return (int)(canonical ? hist_words<true>(w, len, B, (int)W, k, h, s)
                         : hist_words<false>(w, len, B, (int)W, k, h, s));
}
