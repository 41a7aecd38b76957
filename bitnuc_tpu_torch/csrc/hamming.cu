// K4/K5: per-base Hamming distances of packed queries against a word-major
// database, [Q, W] x [W, D] -> [Q, D] int32.
//
// Replaces bitnuc_tpu/ops/pallas/hamming.py::hdist_scan_pallas (K4, one
// query) and ::hdist_scan_batch_pallas (K5, a query batch): one kernel,
// with K4 its Q = 1 case. For each (query, entry) pair it sums over the
// words popcount(c(q ^ d) & m), where c collapses each 2-bit group to one
// bit, (x | x >> 1) & 0x55555555, and m keeps the first n_bases bases.
//
// Bound on the card: at Q = 1, memory (4W bytes per entry, each read once);
// at large Q, integer issue (about six integer operations and one popc per
// query, word and entry).
//
// Design: threads run along D, so a warp's loads of db[w, d:d+32] are
// coalesced. A block takes a tile of TQ queries, keeps them pre-masked in
// shared memory, and holds each loaded database word in a register while it
// serves all TQ queries; the database is read once per query tile instead
// of once per query. n_bases is a runtime argument: the per-word masks are
// computed in the kernel, and words wholly past n_bases are never loaded.
// The TPU kernel's 8-row broadcast output tile and literal-baked masks are
// Mosaic artefacts and are not kept.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 16;
constexpr size_t kMaxSmem = 227 * 1024;

template <int TQ>
__global__ void hdist_scan_kernel(const uint32_t* __restrict__ queries,
                                  const uint32_t* __restrict__ db, int64_t Q,
                                  int64_t W, int64_t D, int weff, int n_bases,
                                  int32_t* __restrict__ out) {
  extern __shared__ uint32_t sq[];  // [TQ, weff] masked query words
  const int64_t q0 = (int64_t)blockIdx.y * TQ;
  for (int i = threadIdx.x; i < TQ * weff; i += blockDim.x) {
    const int t = i / weff;
    const int w = i - t * weff;
    sq[i] = q0 + t < Q ? queries[(q0 + t) * W + w] & bn::base_mask(n_bases - 16 * w)
                       : 0u;
  }
  __syncthreads();
  const int64_t d = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  int acc[TQ];
#pragma unroll
  for (int t = 0; t < TQ; ++t) acc[t] = 0;
  for (int w = 0; w < weff; ++w) {
    const uint32_t x = db[(int64_t)w * D + d] & bn::base_mask(n_bases - 16 * w);
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      const uint32_t diff = x ^ sq[t * weff + w];
      acc[t] += __popc((diff | (diff >> 1)) & 0x55555555u);
    }
  }
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    if (q0 + t < Q) out[(q0 + t) * D + d] = acc[t];
  }
}

template <int TQ>
int launch(const uint32_t* queries, const uint32_t* db, int64_t Q, int64_t W,
           int64_t D, int weff, int n_bases, int32_t* out, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * TQ * (size_t)(weff > 0 ? weff : 1);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(hdist_scan_kernel<TQ>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  const uint32_t* q = (const uint32_t*)queries;
  const uint32_t* d = (const uint32_t*)db;
  int32_t* o = (int32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (Q == 1) return launch<1>(q, d, Q, W, D, (int)weff, n_bases, o, s);
  return launch<kTileQ>(q, d, Q, W, D, (int)weff, n_bases, o, s);
}
