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
