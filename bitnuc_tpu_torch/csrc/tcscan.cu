// K6 tc_scan: per-base Hamming distances of Q packed queries against a
// word-major database, [Q, W] x [W, D] -> [Q, D] int32, on the int8 tensor
// cores.
//
// Replaces bitnuc_tpu/ops/pallas/hamming.py::hdist_scan_batch_mxu (its
// pallas_call at hamming.py:268). With x0, x1 the +-1 codes of a base's two
// bits and x01 = x0 x1, S = sum over the first nb bases of x0q x0d + x1q x1d
// + x01q x01d is 4 matches - nb, so the distance is (3 nb - S) / 4, exactly
// (3 nb - S) >> 2. S is one int8 product [Q, 48W] x [48W, D] with int32
// sums. The distances equal K4/K5 and ops.hamming.hdist_many_to_many for any
// n_bases (clamped to 16 W; the TPU kernel counts 3 n_bases past the words),
// any W (the TPU's 48 W <= 4096 gate is a VMEM limit) and any Q.
//
// Bound on the card: the tensor cores (2 Q D 48 W int8 operations) and the
// [Q, D] int32 output (8.6 GB at Q = 512, D = 4,194,304). The database is
// read Q / 128 times (a quarter byte a base), the query planes once a block
// from L2.
//
// Design: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. The caller
// builds the query planes in PyTorch (zero past nb) and lays them out as the
// A operands in load order (ops.hamming._a_fragments): one 16-row tile's A
// of one k-step is 32 x 16 contiguous bytes, one 16-byte register set a
// lane. Plane order: word pair p, then group g (x0, x1, x01), then the
// pair's 32 bases, so a k-step of 32 is one group of one word pair and a
// pair is three k-steps; an odd W gets a zero word. A block of 8 warps
// computes 128 queries x 128 entries, each warp 64 x 32 (4 x 4 tiles of
// 16 x 8, 64 int32 sums a lane). For every word pair the block stages the
// operands of its three k-steps in shared memory: the A operands of its
// 128 queries, copied once (the four warps along D share them; a copy
// loaded from L2 by each warp makes the kernel L2-bound), and the B operands,
// expanded from its 128 entries' two words (two registers of four +-1 bytes
// per lane, tile and k-step), swizzled so that the expansion's stores and
// the warps' 8-byte loads avoid bank conflicts. The database planes are
// never written to device memory. The next pair's operands are loaded into
// registers while the tensor cores work on this pair's. The epilogue writes
// (3 nb - S) >> 2 straight from the accumulators, two neighbouring entries
// a store, with a streaming hint. wgmma, TMA and a persistent schedule are
// later work.
//
// K6 tc_search: the same main loop with a top-k epilogue, for the many-query
// search (PackedDB.search_batch): for every query the k smallest keys
// dist << 32 | index, so the [Q, D] matrix is never written (4.3 GB at
// Q = 256, D = 4,194,304) nor read back as int64 keys. Bound on the card:
// the tensor cores, as tc_scan; its output is [Q, G, k] int64 candidates.
// A grid of n_qtiles x G blocks; each block walks a contiguous range of
// 128-entry tiles, so its per-row lists live across many tiles. Shared
// memory (dynamic, past 48 KB) holds, beside the operand stage, each of the
// block's 128 rows' sorted list of up to k <= kSearchMax keys, its
// limit (a sum, derived from the k-th key's distance; INT_MIN until the
// list is full) and a buffer of candidates. After a tile's sums, the warps
// offer their sums in two halves of their column tiles (a row then gets at
// most 64 candidates a half): a sum above its row's limit is appended to
// the row's buffer through an atomicAdd on its count, as (dist << 8 | entry
// in the tile). If any sum was offered (__syncthreads_or), one thread a row
// then inserts the candidates whose key is below the list's k-th key into
// the sorted list, dropping the largest key of a full list, and sets the
// limit; keys are unique, so the order is exact whatever order the lanes
// offered them in. Random entries sit near 3/4 of n_bases, so after a
// row's first tile few sums pass: most tiles' epilogue is one int32 compare
// a sum and a barrier a half. Entries past D and rows past Q never enter a
// list.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // 8 warps: 2 along the queries x 4 along D
constexpr int kTileQ = 128;
constexpr int kTileD = 128;
constexpr int kRowTiles = kTileQ / 16;
constexpr int kSteps = 3;            // k-steps of one word pair
constexpr int kAVecs = kRowTiles * kSteps * 32;  // int4 A registers of one pair
static_assert(kAVecs % kThreads == 0, "A staging: whole vectors a thread");
constexpr int kAPerThread = kAVecs / kThreads;

// The operands of one word pair. a: [row tile][k-step][lane], as in
// device memory. b: [k-step][entry][4 lanes of a group] x (word 2p's four
// bytes, word 2p + 1's), lane slot swizzled by the entry.
struct Stage {
  int4 a[kRowTiles][kSteps][32];
  uint2 b[kSteps][kTileD][4];
};

__device__ __forceinline__ int slot(int entry, int c) { return c ^ ((entry >> 2) & 3); }

// The four bases of byte c of a word as +-1 int8 bytes of the three planes:
// x0 = 2 b0 - 1, x1 = 2 b1 - 1, x01 = 1 - 2 (b0 ^ b1).
__device__ __forceinline__ void expand_byte(uint32_t x, int c, uint32_t& x0, uint32_t& x1,
                                            uint32_t& x01) {
  const uint32_t e = (x >> (8 * c)) & 0xFFu;
  const uint32_t u0 = (e & 1u) | ((e << 6) & 0x100u) | ((e << 12) & 0x10000u) |
                      ((e << 18) & 0x1000000u);
  const uint32_t u1 = ((e >> 1) & 1u) | ((e << 5) & 0x100u) | ((e << 11) & 0x10000u) |
                      ((e << 17) & 0x1000000u);
  x0 = (u0 * 0xFEu) ^ 0xFFFFFFFFu;  // per byte: 1 -> 0x01, 0 -> 0xFF
  x1 = (u1 * 0xFEu) ^ 0xFFFFFFFFu;
  x01 = ((u0 ^ u1) * 0xFEu) ^ 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int4& a, const uint2& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// A thread's share of word pair p's operands, into registers: kAPerThread
// A vectors of the block's row tiles, and the pair's two words of entry d.
__device__ __forceinline__ void load_pair(const int4* __restrict__ ablk, int S,
                                          const uint32_t* __restrict__ db, int W, int64_t D,
                                          int64_t d, int p, int4 (&ra)[kAPerThread],
                                          uint32_t& x, uint32_t& y) {
#pragma unroll
  for (int k = 0; k < kAPerThread; ++k) {
    const int idx = threadIdx.x + k * kThreads;  // [row tile][k-step, lane]
    const int t = idx / (kSteps * 32), r = idx % (kSteps * 32);
    ra[k] = __ldg(ablk + ((int64_t)t * S + kSteps * p) * 32 + r);
  }
  const int w0 = 2 * p;
  x = (d < D && w0 < W) ? __ldg(db + (int64_t)w0 * D + d) : 0u;
  y = (d < D && w0 + 1 < W) ? __ldg(db + (int64_t)(w0 + 1) * D + d) : 0u;
}

// K6's main loop, shared by tc_scan and tc_search: the sums S of the
// block's 128 queries (A operands at ablk) against entries [d0, d0 + 128),
// into acc as mma.sync's C fragments (warp (wq, wd): row tile wq * 4 + i,
// entries wd * 32 + j * 8 + 2 tid (+1), rows gid and gid + 8). Every word
// pair starts with a barrier, so a call may follow any use of sm.
__device__ __forceinline__ void tile_sums(Stage& sm, const int4* __restrict__ ablk, int S, int P,
                                          const uint32_t* __restrict__ db, int W, int64_t D,
                                          int64_t d0, int (&acc)[4][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tid = lane & 3;
  const int wq = warp >> 2, wd = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // expansion work of a thread: entry e of the tile, bytes 2h and 2h + 1
  const int e = threadIdx.x & (kTileD - 1);
  const int h = threadIdx.x / kTileD;
  const int64_t d = d0 + e;
  int4 ra[kAPerThread];
  uint32_t x = 0u, y = 0u;
  if (P > 0) load_pair(ablk, S, db, W, D, d, 0, ra, x, y);
  for (int p = 0; p < P; ++p) {
    __syncthreads();  // every warp is done with the previous pair's operands
    int4* sa = &sm.a[0][0][0];
#pragma unroll
    for (int k = 0; k < kAPerThread; ++k) sa[threadIdx.x + k * kThreads] = ra[k];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = 2 * h + cc;
      uint32_t x0, x1, x01, y0, y1, y01;
      expand_byte(x, c, x0, x1, x01);
      expand_byte(y, c, y0, y1, y01);
      const int sl = slot(e, c);
      sm.b[0][e][sl] = make_uint2(x0, y0);
      sm.b[1][e][sl] = make_uint2(x1, y1);
      sm.b[2][e][sl] = make_uint2(x01, y01);
    }
    __syncthreads();
    if (p + 1 < P) load_pair(ablk, S, db, W, D, d, p + 1, ra, x, y);
#pragma unroll
    for (int ls = 0; ls < kSteps; ++ls) {
      int4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[wq * 4 + i][ls][lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ent = wd * 32 + j * 8 + gid;
        const uint2 b = sm.b[ls][ent][slot(ent, tid)];
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], a[i], b);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tc_scan_kernel(const int4* __restrict__ afrag, const uint32_t* __restrict__ db,
               int64_t Q, int W, int64_t D, int nb, int64_t n_qtiles,
               int32_t* __restrict__ out) {
  __shared__ Stage sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tid = lane & 3;
  const int wq = warp >> 2, wd = warp & 3;
  const int64_t qt = blockIdx.x % n_qtiles;
  const int64_t d0 = (blockIdx.x / n_qtiles) * kTileD;
  const int P = (W + 1) / 2, S = kSteps * P;
  const int4* ablk = afrag + qt * kRowTiles * (int64_t)S * 32;
  int acc[4][4][4];
  tile_sums(sm, ablk, S, P, db, W, D, d0, acc);

  // registers 0, 1 (and 2, 3) of a tile hold neighbouring entries dc and
  // dc + 1 of one row: one 8-byte store where the row keeps them aligned
  const int three_nb = 3 * nb;
  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t dc = d0 + wd * 32 + j * 8 + 2 * tid;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t qq = (qt * kRowTiles + wq * 4 + i) * 16 + gid + 8 * half;
        if (qq >= Q) continue;
        const int v0 = (three_nb - acc[i][j][2 * half]) >> 2;
        const int v1 = (three_nb - acc[i][j][2 * half + 1]) >> 2;
        int32_t* o = out + qq * D + dc;
        if (pairs && dc < D) {
          __stcs(reinterpret_cast<int2*>(o), make_int2(v0, v1));
        } else {
          if (dc < D) __stcs(o, v0);
          if (dc + 1 < D) __stcs(o + 1, v1);
        }
      }
    }
  }
}

constexpr int kSearchMax = 32;   // ops.hamming.SEARCH_TOPK_MAX
constexpr int kCandSlots = 64;   // a row's candidates in one half of a tile

// tc_search's per-row state; the lists, [kTileQ][k | 1] keys (an odd
// stride: the merge's threads, one a row, then hit distinct banks), follow
// it.
struct SearchState {
  int lim[kTileQ];                    // offer a sum above it: see tc_search_kernel
  int cnt[kTileQ];                    // keys in the list
  int ncand[kTileQ];                  // candidates in the buffer
  uint32_t cand[kTileQ][kCandSlots + 1];  // dist << 8 | entry in the tile (odd stride)
};

__device__ __forceinline__ long long cand_key(uint32_t c, int64_t d0) {
  return ((long long)(c >> 8) << 32) | (long long)(d0 + (c & 0xFFu));
}

__global__ void __launch_bounds__(kThreads, 2)
tc_search_kernel(const int4* __restrict__ afrag, const uint32_t* __restrict__ db,
                 int64_t Q, int W, int64_t D, int nb, int k, int64_t n_qtiles, int64_t G,
                 int64_t per_block, long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage& sm = *reinterpret_cast<Stage*>(smem);
  SearchState& st = *reinterpret_cast<SearchState*>(smem + sizeof(Stage));
  long long* lists = reinterpret_cast<long long*>(smem + sizeof(Stage) + sizeof(SearchState));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tid = lane & 3;
  const int wq = warp >> 2, wd = warp & 3;
  const int64_t qt = blockIdx.x % n_qtiles, g = blockIdx.x / n_qtiles;
  const int64_t n_dtiles = (D + kTileD - 1) / kTileD;
  const int64_t t_end = (g + 1) * per_block < n_dtiles ? (g + 1) * per_block : n_dtiles;
  const int P = (W + 1) / 2, S = kSteps * P;
  const int4* ablk = afrag + qt * kRowTiles * (int64_t)S * 32;
  const int three_nb = 3 * nb;
  const int ks = k | 1;
  for (int r = threadIdx.x; r < kTileQ; r += kThreads) {
    st.lim[r] = INT_MIN;
    st.cnt[r] = 0;
    st.ncand[r] = 0;
  }
  __syncthreads();

  int acc[4][4][4];
  for (int64_t t = g * per_block; t < t_end; ++t) {
    const int64_t d0 = t * kTileD;
    tile_sums(sm, ablk, S, P, db, W, D, d0, acc);
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      // offer: every warp compares the sums of its column tiles 2 part and
      // 2 part + 1 (64 entries a row in all) with its rows' limits. A full
      // list's limit is 3 nb - 4 (dist_k + 1), dist_k the distance of its
      // k-th key: a sum above it is a distance <= dist_k, which may tie
      // dist_k at a lower index. The merge tests the exact key.
      bool offered = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int row = (wq * 4 + i) * 16 + gid + 8 * rh;
          if (qt * kTileQ + row >= Q) continue;
          const int lim = st.lim[row];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * part + jj;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = wd * 32 + j * 8 + 2 * tid + c;
              const int sum = acc[i][j][2 * rh + c];
              if (sum > lim && d0 + col < D) {
                const int at = atomicAdd(&st.ncand[row], 1);
                st.cand[row][at] = ((uint32_t)((three_nb - sum) >> 2) << 8) | (uint32_t)col;
                offered = true;
              }
            }
          }
        }
      }
      // merge, only where a sum was offered: one thread a row inserts its
      // candidates whose key is below the list's k-th into the sorted list
      if (__syncthreads_or(offered)) {
        if (threadIdx.x < kTileQ && st.ncand[threadIdx.x] > 0) {
          const int row = threadIdx.x, n = st.ncand[row];
          long long* L = lists + row * ks;
          int m = st.cnt[row];
          long long th = m == k ? L[k - 1] : LLONG_MAX;
          for (int c = 0; c < n; ++c) {
            const long long key = cand_key(st.cand[row][c], d0);
            if (key >= th) continue;
            int pos = m < k ? m : k - 1;  // a full list drops its largest key
            while (pos > 0 && L[pos - 1] > key) {
              L[pos] = L[pos - 1];
              --pos;
            }
            L[pos] = key;
            if (m < k) ++m;
            if (m == k) th = L[k - 1];
          }
          st.cnt[row] = m;
          st.lim[row] = m == k ? three_nb - 4 * ((int)(th >> 32) + 1) : INT_MIN;
          st.ncand[row] = 0;
        }
        __syncthreads();
      }
    }
  }

  // each query's list, padded with INT64_MAX, at out[q][g][0..k)
  for (int row = warp; row < kTileQ; row += kThreads / 32) {
    const int64_t q = qt * kTileQ + row;
    if (q >= Q) continue;
    long long* o = out + (q * G + g) * k;
    const int m = st.cnt[row];
    for (int s = lane; s < k; s += 32) o[s] = s < m ? lists[row * ks + s] : LLONG_MAX;
  }
}

}  // namespace

// afrag: the A operands of the query planes (ops.hamming._a_fragments),
// ceil(Q / 128) * 8 tiles x 3 ceil(W / 2) k-steps x 32 lanes x 16 bytes;
// db [W, D] uint32 word-major; out [Q, D] int32; nb in [0, 16 W].
extern "C" int bn_tc_scan(const void* afrag, const void* db, int64_t Q, int64_t W,
                          int64_t D, int nb, void* out, void* stream) {
  if (Q < 0 || W < 0 || D < 0 || nb < 0 || nb > 16 * W || W > (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  if (Q == 0 || D == 0) return (int)cudaGetLastError();
  const int64_t n_qtiles = (Q + kTileQ - 1) / kTileQ;
  const int64_t blocks = n_qtiles * ((D + kTileD - 1) / kTileD);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  tc_scan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)afrag, (const uint32_t*)db, Q, (int)W, D, nb, n_qtiles,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

// afrag as for bn_tc_scan; db [W, D] uint32 word-major; out [Q, G, k] int64:
// block g's k smallest keys dist << 32 | index of each query, ascending,
// padded with INT64_MAX. Block g walks tiles [g per_block, (g + 1)
// per_block) of 128 entries; G per_block must cover D. 1 <= k <= 32.
extern "C" int bn_tc_search(const void* afrag, const void* db, int64_t Q, int64_t W,
                            int64_t D, int nb, int k, int64_t G, int64_t per_block, void* out,
                            void* stream) {
  if (Q < 0 || W < 0 || D < 0 || D > 0x7FFFFFFF || nb < 0 || nb > 16 * W || W >= (1 << 19) ||
      k < 1 || k > kSearchMax) {
    return (int)cudaErrorInvalidValue;
  }
  if (Q == 0 || D == 0) return (int)cudaGetLastError();
  const int64_t n_qtiles = (Q + kTileQ - 1) / kTileQ;
  const int64_t n_dtiles = (D + kTileD - 1) / kTileD;
  if (G < 1 || per_block < 1 || G * per_block < n_dtiles) return (int)cudaErrorInvalidValue;
  const int64_t blocks = n_qtiles * G;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(Stage) + sizeof(SearchState) + (size_t)kTileQ * (k | 1) * sizeof(long long);
  cudaError_t err = cudaFuncSetAttribute(tc_search_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tc_search_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int4*)afrag, (const uint32_t*)db, Q, (int)W, D, nb, k, n_qtiles, G, per_block,
      (long long*)out);
  return (int)cudaGetLastError();
}
