// K4/K5: per-base Hamming distances of packed queries against a word-major
// database, [Q, W] x [W, D] -> [Q, D] int32.
//
// Replaces bitnuc_tpu/ops/pallas/hamming.py::hdist_scan_pallas (K4, one
// query) and ::hdist_scan_batch_pallas (K5, a query batch): one kernel,
// with K4 its Q = 1 case. For each (query, entry) pair it counts the bases,
// among the first n_bases, whose 2-bit codes differ.
//
// Arithmetic, a pair of words at a time. With d0, d1 the XORs of words w and
// w + 1, c0 = d0 | d0 >> 1 holds word w's mismatches in its even bits and
// c1 = d1 | d1 << 1 word w + 1's in its odd bits, so one popcount of
// (c0 & E) | (c1 & ~E), E = 0x55555555, counts both words. The masks
// distribute over the XORs, so each side merges its two words into two once:
// a = w0 & E | w1 & ~E and b = (w0 >> 1) & E | (w1 << 1) & ~E (merge_pair),
// and the count is popc((a ^ qa) | (b ^ qb)). The database side merges once
// an entry, the query side once a block, into shared memory; per query and
// word pair that leaves one XOR, one three-input op, one popcount and half
// an add (two pairs' counts go into one three-input add).
//
// Bound on the card (chip_smoke.scan_bounds): memory for a few queries (4W
// bytes an entry read once, the [Q, D] output written once); for more, the
// popcount unit, at half a popcount a (query, word, entry) beside 1.25
// int32 operations (from about 16 queries of 32-word entries).
//
// Design: threads run along D, so a warp's loads of db[w, d:d+32] are
// coalesced. A block takes a tile of queries, keeps their merged word pairs
// in shared memory, two pairs a 16-byte broadcast load, and holds each
// merged quad of database words in registers while it serves every query
// of the tile; the database is read once per tile. The tile is sized to Q:
// TQ in {1, 2, 4, 8, 16, 32}, the smallest that covers Q, and ceil(Q / 32)
// tiles of 32 above (halved while its queries overflow shared memory). A
// tile computes only the queries it has (nq <= TQ, see run_slot), so no
// slot works for a query that is not there. Only the last word can be
// partial: it alone is masked, in the query and in the database word. The
// last word's pair runs alone when the pairs are odd, so no slot counts a
// zero pair. n_bases is a runtime argument and words wholly past it are
// never loaded. The TPU kernel's 8-row broadcast output tile and
// literal-baked masks are Mosaic artefacts and are not kept.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;  // the largest query tile
constexpr size_t kMaxSmem = 227 * 1024;
constexpr uint32_t kEven = 0x55555555u;

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// Words w0 and w0 + 1 merged into the two words that one popcount of
// (a ^ qa) | (b ^ qb) needs (see the top of the file).
__device__ __forceinline__ uint2 merge_pair(uint32_t w0, uint32_t w1) {
  return make_uint2((w0 & kEven) | (w1 & ~kEven), ((w0 >> 1) & kEven) | ((w1 << 1) & ~kEven));
}

// The slot layout of a tile that serves nq of its TQ slots. nq == TQ fills
// every slot in order. Otherwise each set bit b of nq is a run of 2^b slots
// from run_slot(TQ, b), holding the queries from run_query(b, nq) (nq's
// bits above b) on: every run's offset is a compile-time constant, and a
// tile runs exactly the runs of nq's bits. slot_query (the fill), bit_runs
// (the scan) and store_bit_runs (the store) all take the layout from here.
__host__ __device__ constexpr int run_slot(int TQ, int b) { return TQ - (2 << b); }
__host__ __device__ constexpr int run_query(int b, int nq) { return nq >> (b + 1) << (b + 1); }

// The query held in slot s, or -1.
template <int TQ>
__device__ __forceinline__ int slot_query(int s, int nq) {
  if (nq == TQ) return s;
  for (int b = 0; (1 << b) < TQ; ++b) {
    const int off = run_slot(TQ, b);
    if ((nq >> b & 1) && s >= off && s < off + (1 << b)) return run_query(b, nq) + s - off;
  }
  return -1;
}

// P merged word pairs of one entry (P = 2, or 1 for a lone last pair)
// against the N slots from OFF; sq holds each slot's two merged pairs.
template <int N, int OFF, int TQ, int P>
__device__ __forceinline__ void run_quad(int (&acc)[TQ], const uint4* sq, uint2 x0, uint2 x1) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (P == 2) {
      const uint4 q = sq[OFF + i];
      acc[OFF + i] += __popc((x0.x ^ q.x) | (x0.y ^ q.y)) + __popc((x1.x ^ q.z) | (x1.y ^ q.w));
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(sq + OFF + i);
      acc[OFF + i] += __popc((x0.x ^ q.x) | (x0.y ^ q.y));
    }
  }
}

template <int TQ, int P, int B>
__device__ __forceinline__ void bit_runs(int (&acc)[TQ], const uint4* sq, uint2 x0, uint2 x1,
                                         int nq) {
  if (nq >> B & 1) run_quad<(1 << B), run_slot(TQ, B), TQ, P>(acc, sq, x0, x1);
  if constexpr (B > 0) bit_runs<TQ, P, B - 1>(acc, sq, x0, x1, nq);
}

// P merged pairs against the tile's nq queries (branches uniform).
template <int TQ, int P>
__device__ __forceinline__ void tile_quad(int (&acc)[TQ], const uint4* sq, uint2 x0, uint2 x1,
                                          int nq) {
  if (nq == TQ) {
    run_quad<TQ, 0, TQ, P>(acc, sq, x0, x1);
  } else if constexpr (TQ > 1) {
    bit_runs<TQ, P, log2i(TQ) - 1>(acc, sq, x0, x1, nq);
  }
}

// The N slots from OFF, holding the queries from j0 on, into their rows of
// out (at this thread's entry).
template <int N, int OFF, int TQ>
__device__ __forceinline__ void store_run(const int (&acc)[TQ], int32_t* out, int64_t D, int j0) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[(j0 + i) * D] = acc[OFF + i];
}

template <int TQ, int B>
__device__ __forceinline__ void store_bit_runs(const int (&acc)[TQ], int32_t* out, int64_t D,
                                               int nq) {
  if (nq >> B & 1) store_run<(1 << B), run_slot(TQ, B), TQ>(acc, out, D, run_query(B, nq));
  if constexpr (B > 0) store_bit_runs<TQ, B - 1>(acc, out, D, nq);
}

// The tile's nq distances, run by run as run_slot and run_query lay them out.
template <int TQ>
__device__ __forceinline__ void store_tile(const int (&acc)[TQ], int32_t* out, int64_t D, int nq) {
  if (nq == TQ) {
    store_run<TQ, 0, TQ>(acc, out, D, 0);
  } else if constexpr (TQ > 1) {
    store_bit_runs<TQ, log2i(TQ) - 1>(acc, out, D, nq);
  }
}

template <int TQ>
__global__ void __launch_bounds__(kThreads)
hdist_scan_kernel(const uint32_t* __restrict__ queries, const uint32_t* __restrict__ db,
                  int64_t Q, int64_t W, int64_t D, int weff, int n_bases,
                  int32_t* __restrict__ out) {
  extern __shared__ uint4 sq[];  // [quads, TQ slots]: words 4u..4u+3, merged
  const int64_t q0 = (int64_t)blockIdx.y * TQ;
  const int nq = Q - q0 < TQ ? (int)(Q - q0) : TQ;
  const int last = weff - 1;  // the only word that may be partial
  const uint32_t last_mask = bn::base_mask(n_bases - 16 * last);
  const int nquads = (weff + 3) / 4;
  for (int i = threadIdx.x; i < nquads * TQ; i += blockDim.x) {
    const int u = i / TQ;
    const int j = slot_query<TQ>(i - u * TQ, nq);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (j >= 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int wi = 4 * u + k;
        if (wi < weff) w[k] = queries[(q0 + j) * W + wi] & (wi == last ? last_mask : ~0u);
      }
    }
    const uint2 a = merge_pair(w[0], w[1]), b = merge_pair(w[2], w[3]);
    sq[i] = make_uint4(a.x, a.y, b.x, b.y);
  }
  __syncthreads();
  const int64_t d = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  int acc[TQ];
#pragma unroll
  for (int s = 0; s < TQ; ++s) acc[s] = 0;
  const uint32_t* col = db + d;
  const int lp = (weff + 1) / 2 - 1;  // the pair that holds the last word
  const int full = lp / 2;            // quads of two pairs before it
#pragma unroll(TQ <= 8 ? 2 : 1)
  for (int u = 0; u < full; ++u) {
    const uint32_t* c = col + 4 * u * D;
    tile_quad<TQ, 2>(acc, sq + u * TQ, merge_pair(c[0], c[D]), merge_pair(c[2 * D], c[3 * D]),
                     nq);
  }
  if (weff > 0) {  // from word 4 * full: two pairs when lp is odd, else one
    uint32_t x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int wi = 4 * full + k;
      x[k] = wi < weff ? col[wi * D] & (wi == last ? last_mask : ~0u) : 0u;
    }
    if (lp & 1)
      tile_quad<TQ, 2>(acc, sq + full * TQ, merge_pair(x[0], x[1]), merge_pair(x[2], x[3]), nq);
    else
      tile_quad<TQ, 1>(acc, sq + full * TQ, merge_pair(x[0], x[1]), make_uint2(0u, 0u), nq);
  }
  store_tile<TQ>(acc, out + q0 * D + d, D, nq);
}

template <int TQ>
int launch(const uint32_t* queries, const uint32_t* db, int64_t Q, int64_t W, int64_t D,
           int weff, int n_bases, size_t smem, int32_t* out, cudaStream_t stream) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(hdist_scan_kernel<TQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const unsigned bx = (unsigned)((D + kThreads - 1) / kThreads);
  const int64_t max_tiles = 65535;  // gridDim.y limit
  for (int64_t qs = 0; qs < Q; qs += max_tiles * TQ) {
    const int64_t qn = Q - qs < max_tiles * TQ ? Q - qs : max_tiles * TQ;
    const dim3 grid(bx, (unsigned)((qn + TQ - 1) / TQ));
    hdist_scan_kernel<TQ><<<grid, kThreads, smem, stream>>>(
        queries + qs * W, db, qn, W, D, weff, n_bases, out + qs * D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bn_hdist_scan(const void* queries, const void* db, int64_t Q,
                             int64_t W, int64_t D, int n_bases, void* out,
                             void* stream) {
  if (Q <= 0 || D <= 0) return (int)cudaGetLastError();
  int64_t weff = n_bases <= 0 ? 0 : ((int64_t)n_bases + 15) / 16;
  if (weff > W) weff = W;
  // the smallest tile that covers Q, halved while its slots overflow
  const size_t per_slot = sizeof(uint4) * (size_t)(weff > 0 ? (weff + 3) / 4 : 1);
  int tq = Q == 1 ? 1 : Q == 2 ? 2 : Q <= 4 ? 4 : Q <= 8 ? 8 : Q <= 16 ? 16 : kMaxTile;
  while (tq > 1 && per_slot * tq > kMaxSmem) tq /= 2;
  if (per_slot * tq > kMaxSmem) return (int)cudaErrorInvalidValue;
  const uint32_t* q = (const uint32_t*)queries;
  const uint32_t* d = (const uint32_t*)db;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int we = (int)weff;
  const size_t smem = per_slot * tq;
  switch (tq) {
    case 1: return launch<1>(q, d, Q, W, D, we, n_bases, smem, o, s);
    case 2: return launch<2>(q, d, Q, W, D, we, n_bases, smem, o, s);
    case 4: return launch<4>(q, d, Q, W, D, we, n_bases, smem, o, s);
    case 8: return launch<8>(q, d, Q, W, D, we, n_bases, smem, o, s);
    case 16: return launch<16>(q, d, Q, W, D, we, n_bases, smem, o, s);
    default: return launch<kMaxTile>(q, d, Q, W, D, we, n_bases, smem, o, s);
  }
}
