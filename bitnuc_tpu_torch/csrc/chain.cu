// C1 chain: the collinear chaining DP of ops/chain.py, one warp a row.
//
// Replaces no TPU kernel. bitnuc_tpu/ops/chain.py::chain_anchors is a
// lax.scan over each row's sorted anchors, which XLA runs as one device
// loop; eager PyTorch has no such loop, and the plain version
// (ops.chain.chain_sorted_torch) launches some 45 small operations a step,
// about 400,000 a batch of long reads. This kernel is that loop on the card.
//
// Input: anchors already sorted by signed (r, q) within each row
// (ops.chain.sort_anchors, torch.sort), invalid ones as (2^30, 2^30) at the
// end. Output: (score, start_r, end_r, start_q, end_q) of each row's best
// chain, equal to the plain version bit for bit.
//
// Bound on the card: integer operations and the latency of a chain of
// dependent steps. Step i compares anchor i with the lookback ring's LB
// slots (two differences, five tests, the drift penalty) and takes five
// ordered max-reductions over them; the inputs (8 bytes an anchor) are read
// once.
//
// Design: a warp walks one row. The ring's five int32 columns (f, r, q,
// sr, sq) sit in shared memory, LB slots each (LB = min(lookback, A), sized
// at launch), and lane L owns slots L, L + 32, .... Anchors come in by one
// coalesced load of 32 at a time and a shuffle each. The predecessor is
// five __reduce_max_sync (one redux.sync each), as the plain version's five
// masked maxima: the best candidate score, then the largest r among the
// slots at that score, the largest q among those, and the largest sr and sq
// among the slots that tie on all three. Each lane first takes its own
// slots' max with the plain version's fill of -1 outside the selection (a
// lane with no slot brings INT_MIN, the identity), so each reduction equals
// the plain max, negative coordinates included. A slot's candidate is
// recomputed from the ring for each pass rather than kept. The last four
// run only where the best candidate is positive, the only case that reads
// them. The walk stops at the
// row's first dead anchor (r >= 2^30): the sort puts every later anchor
// after it, dead too, and a dead anchor never changes the best chain.
// Differences wrap modulo 2^32 (unsigned arithmetic), as the plain
// version's int32 tensors do.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kNeg = -(1 << 30);
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kColumns = 5;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Floor division of x >= 0 by d != 0 (Python's and torch's // for ints).
__device__ __forceinline__ int floor_div(int x, int d) {
  int v = x / d;
  if (d < 0 && v * d != x) --v;
  return v;
}

// The candidate score of ring slot s for anchor (ri, qi): f - |dr - dq| //
// gap_unit where the slot qualifies as a predecessor, else -2^30.
__device__ __forceinline__ int slot_cand(const int* ring_f, const int* ring_r,
                                         const int* ring_q, int s, int ri, int qi,
                                         int max_gap, int gap_unit) {
  const int f = ring_f[s];
  const int dr = wrap_sub(ri, ring_r[s]);
  const int dq = wrap_sub(qi, ring_q[s]);
  if (f > 0 && dr > 0 && dq > 0 && dr <= max_gap && dq <= max_gap) {
    const int drift = dr > dq ? dr - dq : dq - dr;
    return wrap_sub(f, floor_div(drift, gap_unit));
  }
  return kNeg;
}

__global__ void chain_kernel(const int* __restrict__ rs, const int* __restrict__ qs,
                             int64_t B, int64_t A, int max_gap, int gap_unit, int LB,
                             int* __restrict__ score, int* __restrict__ start_r,
                             int* __restrict__ end_r, int* __restrict__ start_q,
                             int* __restrict__ end_q) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // the whole warp leaves together
  int* ring_f = smem + (size_t)warp * kColumns * LB;
  int* ring_r = ring_f + LB;
  int* ring_q = ring_r + LB;
  int* ring_sr = ring_q + LB;
  int* ring_sq = ring_sr + LB;
  for (int s = lane; s < LB; s += 32) {
    ring_f[s] = 0;  // an empty slot never qualifies
    ring_r[s] = kBig;
    ring_q[s] = kBig;
    ring_sr[s] = -1;
    ring_sq[s] = -1;
  }
  __syncwarp();

  const int* r_row = rs + row * A;
  const int* q_row = qs + row * A;
  int best = 0, best_sr = -1, best_er = -1, best_sq = -1, best_eq = -1;
  int slot = 0;
  bool dead = false;
  for (int64_t base = 0; base < A && !dead; base += 32) {
    const int64_t idx = base + lane;
    const int my_r = idx < A ? r_row[idx] : kBig;
    const int my_q = idx < A ? q_row[idx] : kBig;
    const int n = (int)(A - base < 32 ? A - base : 32);
    for (int t = 0; t < n; ++t) {
      const int ri = __shfl_sync(kFull, my_r, t);
      const int qi = __shfl_sync(kFull, my_q, t);
      if (ri >= kBig) {  // warp-uniform
        dead = true;
        break;
      }
      int pbest = INT_MIN;
      for (int s = lane; s < LB; s += 32) {
        pbest = max(pbest, slot_cand(ring_f, ring_r, ring_q, s, ri, qi, max_gap, gap_unit));
      }
      pbest = __reduce_max_sync(kFull, pbest);
      int f_i = 1, sr_i = ri, sq_i = qi;
      if (pbest > 0) {  // warp-uniform: the chain extends its predecessor's
        int pr = INT_MIN;
        for (int s = lane; s < LB; s += 32) {
          const bool sel =
              slot_cand(ring_f, ring_r, ring_q, s, ri, qi, max_gap, gap_unit) == pbest;
          pr = max(pr, sel ? ring_r[s] : -1);
        }
        pr = __reduce_max_sync(kFull, pr);
        int pq = INT_MIN;
        for (int s = lane; s < LB; s += 32) {
          const bool sel =
              slot_cand(ring_f, ring_r, ring_q, s, ri, qi, max_gap, gap_unit) == pbest &&
              ring_r[s] == pr;
          pq = max(pq, sel ? ring_q[s] : -1);
        }
        pq = __reduce_max_sync(kFull, pq);
        int psr = INT_MIN, psq = INT_MIN;
        for (int s = lane; s < LB; s += 32) {
          const bool take =
              slot_cand(ring_f, ring_r, ring_q, s, ri, qi, max_gap, gap_unit) == pbest &&
              ring_r[s] == pr && ring_q[s] == pq;
          psr = max(psr, take ? ring_sr[s] : -1);
          psq = max(psq, take ? ring_sq[s] : -1);
        }
        sr_i = __reduce_max_sync(kFull, psr);
        sq_i = __reduce_max_sync(kFull, psq);
        f_i = 1 + pbest;
      }
      __syncwarp();  // every lane has read the ring before the slot is overwritten
      if ((slot & 31) == lane) {
        ring_f[slot] = f_i;
        ring_r[slot] = ri;
        ring_q[slot] = qi;
        ring_sr[slot] = sr_i;
        ring_sq[slot] = sq_i;
      }
      __syncwarp();
      if (++slot == LB) slot = 0;
      if (f_i > best) {
        best = f_i;
        best_sr = sr_i;
        best_er = ri;
        best_sq = sq_i;
        best_eq = qi;
      }
    }
  }
  if (lane == 0) {
    score[row] = best;
    start_r[row] = best_sr;
    end_r[row] = best_er;
    start_q[row] = best_sq;
    end_q[row] = best_eq;
  }
}

}  // namespace

// rs, qs [B, A] int32, each row sorted by signed (r, q) with invalid
// anchors (2^30, 2^30) last; LB = min(lookback, A) ring slots, LB >= 1
// unless A == 0, 5 * 4 * LB bytes of shared memory a warp at most 227 KB;
// gap_unit != 0. Outputs [B] int32 each.
extern "C" int bn_chain(const void* rs, const void* qs, int64_t B, int64_t A, int max_gap,
                        int gap_unit, int LB, void* score, void* start_r, void* end_r,
                        void* start_q, void* end_q, void* stream) {
  if (B < 0 || A < 0 || LB < 0 || LB > A || (A > 0 && LB < 1) || gap_unit == 0 ||
      (int64_t)kColumns * 4 * LB > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  const size_t ring = (size_t)kColumns * 4 * LB;
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && (size_t)warps * ring > 48 * 1024) --warps;
  const size_t smem = (size_t)warps * ring;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const unsigned blocks = (unsigned)((B + warps - 1) / warps);
  chain_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const int*)rs, (const int*)qs, B, A, max_gap, gap_unit, LB, (int*)score, (int*)start_r,
      (int*)end_r, (int*)start_q, (int*)end_q);
  return (int)cudaGetLastError();
}
