// C1 chain: chain_anchors of ops/chain.py on the card, from each row's
// unsorted anchors to its best chain.
//
// Replaces no TPU kernel. bitnuc_tpu/ops/chain.py::chain_anchors sorts each
// row by (r, q) and runs a lax.scan over it, which XLA compiles into one
// device loop; eager PyTorch has no such loop. This kernel is the whole
// function: no [B, A] sort key and no torch.sort.
//
// Input: rpos, qpos [B, A] int32 and valid [B, A] bool, in any order within
// a row. Output: (score, start_r, end_r, start_q, end_q) of each row's best
// chain, equal to the plain version (ops.chain.chain_anchors_torch) bit for
// bit.
//
// Bound on the card: a row's steps form one chain of dependent steps, and
// each step does integer work over the lookback ring's LB slots (two
// differences, five tests, the drift penalty, the ordered maxima). The
// bytes are few: the valid flags, and the coordinates of valid anchors only
// (long-read rows hold about 1.4% live anchors).
//
// Design, one warp a row (chain_rows_kernel), a persistent grid of
// resident warps pulling rows from a counter in index order:
// 1. Compaction. Lanes read the row's valid flags 16 at a time (one 16-byte
//    load each, four in flight), then the 16-byte chunks of rpos and qpos
//    that hold a valid anchor, and nothing else. An anchor is live when it is
//    valid and r < 2^30: every other anchor sorts at or after the row's first
//    dead one, never enters the ring, and never changes the best chain.
//    Each lane counts its live anchors (popcount of a 16-bit mask), a warp
//    scan gives each lane its place, and the keys
//    ((r + 2^31) << 32) | (q + 2^31), whose unsigned order is the signed
//    (r, q) order of ops.chain.sort_anchors, go to the warp's slice of
//    shared memory (kRowCap keys).
// 2. Sort. A bitonic network in the form whose comparators all put the
//    smaller key at the lower index, so the positions past the live count
//    act as +inf and are never touched: no padding. A lane's comparators
//    of a pass go eight at a time, loads before stores. Equal keys are
//    equal anchors, so the order among them does not matter.
// 3. DP. Lane L keeps ring slots L, L + 32, ... (S of them: 1, 2, 4 or 8,
//    a template, for LB up to kRegLookback = 256) in registers, each slot's
//    candidate computed once a step. Where every live r and q is >= -1, no
//    two live anchors are equal and gap_unit > 0 (dp_fast), a step takes one
//    __reduce_max_sync: the candidate times 256 plus the slot's rank in the
//    ring, whose maximum is the best candidate and the latest slot at it,
//    which is the predecessor by the plain version's tie-breaks (its (r, q)
//    is the largest among them, as the ring is in sorted order), and the
//    predecessor's chain start comes from shared memory. Else (dp_regs) the
//    five ordered maxima of the plain version (best candidate, then the
//    largest r, q, and the sr and sq of the slots that tie on all three)
//    each take a lane-local max over registers with its -1 fill (INT_MIN
//    for a slot past LB), then one __reduce_max_sync. The owning lane
//    writes the new slot by an unrolled select. The division of the drift
//    by gap_unit is chosen once a launch: a shift for a positive power of
//    two, a multiply-high by a reciprocal for another positive divisor, the
//    exact floor for a negative one (the host's ops.chain.gap_divider; its
//    Python model is held to // in the CPU tests).
//
// Rows past the warp's shared memory (more than kRowCap live anchors), and
// every row when LB > kRegLookback, go to chain_big_kernel: a block of 512
// threads a row, pulled from a queue that chain_rows_kernel fills. The block
// compacts the row into its slice of device memory, sorts it there, or in
// shared memory where it fits (about 29,000 keys), with the same network,
// and one warp runs the same DP: the register ring, or above kRegLookback
// the ring's five columns in shared memory with each slot's candidate
// recomputed for each pass. Both kernels launch on every call, so no count
// comes back to the host.
//
// Differences wrap modulo 2^32 (unsigned arithmetic), as the plain
// version's int32 tensors do.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kNeg = -(1 << 30);
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kGranule = 16;       // anchors a lane reads at a time
constexpr int kInFlight = 4;       // granules a lane has in flight
constexpr int kRowWarps = 2;       // rows in flight a block of chain_rows_kernel
// live anchors a warp sorts in shared memory: 2 x 2016 x 8 bytes a block,
// seven blocks (14 rows) in an SM's 228 KB with their 1 KB each
constexpr int kRowCap = 2016;
constexpr int kRegLookback = 256;  // the largest ring kept in registers
constexpr int kBigThreads = 512;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kHeader = 16;  // chain_big_kernel's row and live count
constexpr int kColumns = 5;
constexpr int64_t kBigScratch = 64ll << 20;  // bytes of keys for chain_big_kernel

// scratch: three int counters, then the queue of rows for chain_big_kernel,
// then each of its blocks' A keys
enum { kNextRow = 0, kQueued = 1, kNextBig = 2, kCounters = 4 };

// The division of a drift x in [0, 2^31) by gap_unit (ops.chain.gap_divider):
// mode 0: x >> shift (gap_unit = 2^shift); mode 1: umulhi(2x, magic) >>
// shift, magic = ceil(2^(31 + shift) / gap_unit), shift = ceil(log2
// gap_unit); mode 2: the floor of x / d for d < 0.
struct Div {
  unsigned magic;
  int shift;
  int d;
};

template <int DIV>
__device__ __forceinline__ int div_drift(int x, const Div& dv) {
  if (DIV == 0) return x >> dv.shift;
  if (DIV == 1) return (int)(__umulhi((unsigned)x << 1, dv.magic) >> dv.shift);
  int v = x / dv.d;
  if (v * dv.d != x) --v;
  return v;
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ uint64_t make_key(int r, int q) {
  return ((uint64_t)((unsigned)r ^ 0x80000000u) << 32) | ((unsigned)q ^ 0x80000000u);
}
__device__ __forceinline__ int key_r(uint64_t k) {
  return (int)((unsigned)(k >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int key_q(uint64_t k) { return (int)((unsigned)k ^ 0x80000000u); }

// The candidate score of a ring slot (f, r, q) for anchor (ri, qi): f -
// |dr - dq| // gap_unit where the slot qualifies as a predecessor, else
// -2^30.
template <int DIV>
__device__ __forceinline__ int slot_cand(int f, int r, int q, int ri, int qi, int max_gap,
                                         const Div& dv) {
  const int dr = wrap_sub(ri, r);
  const int dq = wrap_sub(qi, q);
  const bool ok = f > 0 && dr > 0 && dq > 0 && dr <= max_gap && dq <= max_gap;
  const int drift = ok ? (dr > dq ? dr - dq : dq - dr) : 0;
  return ok ? wrap_sub(f, div_drift<DIV>(drift, dv)) : kNeg;
}

// Valid flags of anchors j .. j + 15 as bits (A % 16 == 0 and 16-byte
// aligned rows when vec).
__device__ __forceinline__ unsigned valid_bits(const uint8_t* v_row, int64_t j, int64_t A,
                                               bool vec) {
  if (j >= A) return 0u;
  if (vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(v_row + j));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned bits = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // bool bytes are 0 or 1
      const unsigned x = w[c];
      bits |= ((x & 1u) | ((x >> 7) & 2u) | ((x >> 14) & 4u) | ((x >> 21) & 8u)) << (4 * c);
    }
    return bits;
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kGranule; ++k) {
    if (j + k < A && v_row[j + k]) bits |= 1u << k;
  }
  return bits;
}

// The coordinates of the valid anchors among j .. j + 15 (the 16-byte
// chunks that hold one, when vec) and the mask of the live ones.
__device__ __forceinline__ unsigned load_live(const int* r_row, const int* q_row, int64_t j,
                                              unsigned vbits, bool vec, int (&r)[kGranule],
                                              int (&q)[kGranule]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int4 rr = make_int4(kBig, kBig, kBig, kBig), qq = rr;
      if ((vbits >> (4 * c)) & 0xFu) {
        rr = __ldg(reinterpret_cast<const int4*>(r_row + j + 4 * c));
        qq = __ldg(reinterpret_cast<const int4*>(q_row + j + 4 * c));
      }
      r[4 * c] = rr.x, r[4 * c + 1] = rr.y, r[4 * c + 2] = rr.z, r[4 * c + 3] = rr.w;
      q[4 * c] = qq.x, q[4 * c + 1] = qq.y, q[4 * c + 2] = qq.z, q[4 * c + 3] = qq.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kGranule; ++k) {
      const bool v = (vbits >> k) & 1u;
      r[k] = v ? r_row[j + k] : kBig;
      q[k] = v ? q_row[j + k] : kBig;
    }
  }
  unsigned keep = 0;
#pragma unroll
  for (int k = 0; k < kGranule; ++k) {
    if (((vbits >> k) & 1u) && r[k] < kBig) keep |= 1u << k;
  }
  return keep;
}

// Exclusive place of each lane's `c` keys in the warp's, and the warp's total.
__device__ __forceinline__ int warp_place(int c, int lane, int* total) {
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  *total = __shfl_sync(kFull, incl, 31);
  return incl - c;
}

__device__ __forceinline__ void put_keys(uint64_t* keys, int pos, unsigned keep,
                                         const int (&r)[kGranule], const int (&q)[kGranule]) {
#pragma unroll
  for (int k = 0; k < kGranule; ++k) {
    if ((keep >> k) & 1u) keys[pos++] = make_key(r[k], q[k]);
  }
}

// The live keys of a row into keys[0, n) by one warp; -1 once more than cap.
__device__ int compact_warp(const int* r_row, const int* q_row, const uint8_t* v_row,
                            int64_t A, bool vec, uint64_t* keys, int cap, int lane) {
  int n = 0;
  for (int64_t j0 = 0; j0 < A; j0 += (int64_t)kInFlight * 32 * kGranule) {
    unsigned vb[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      vb[u] = valid_bits(v_row, j0 + (int64_t)(u * 32 + lane) * kGranule, A, vec);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (!__any_sync(kFull, vb[u])) continue;
      const int64_t j = j0 + (int64_t)(u * 32 + lane) * kGranule;
      int r[kGranule], q[kGranule];
      const unsigned keep = load_live(r_row, q_row, j, vb[u], vec, r, q);
      const int c = __popc(keep);
      int total;
      const int place = warp_place(c, lane, &total);
      if (n + total > cap) return -1;  // warp-uniform
      put_keys(keys, n + place, keep, r, q);
      n += total;
    }
  }
  return n;
}

// Ascending sort of k[0, n) by the bitonic network whose comparators all
// put the smaller key at the lower index (each merge starts by comparing
// element o of a block with element size - 1 - o): positions at and past n
// hold +inf in effect, and a comparator that reaches one changes nothing.
// Threads t0, t0 + step, ... share the work; sync() separates the passes.
// A thread's comparators of a pass go kBatch at a time, every load of a
// batch before its stores (the pairs of a pass are disjoint), so their
// latencies overlap.
constexpr int kBatch = 8;

template <typename Sync>
__device__ __forceinline__ void bitonic_sort(uint64_t* k, int n, int t0, int step, Sync sync) {
  if (n < 2) return;
  const int half_p = 1 << (31 - __clz(n - 1));  // half the power of two >= n
  for (int size = 2; size <= 2 * half_p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool flip = stride == size >> 1;
      for (int tb = t0; tb < half_p; tb += kBatch * step) {
        int i[kBatch], j[kBatch];
        uint64_t a[kBatch], b[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int t = tb + u * step;
          i[u] = 2 * t - (t & (stride - 1));
          j[u] = flip ? i[u] ^ (size - 1) : i[u] + stride;
          if (t >= half_p) j[u] = n;  // no comparator
          if (j[u] < n) {
            a[u] = k[i[u]];
            b[u] = k[j[u]];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (j[u] < n && a[u] > b[u]) {
            k[i[u]] = b[u];
            k[j[u]] = a[u];
          }
        }
      }
      sync();
    }
  }
}

struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};
struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

// Each row's result.
struct Out {
  int* score;
  int* start_r;
  int* end_r;
  int* start_q;
  int* end_q;
  __device__ void put(int64_t row, const int (&o)[5]) const {
    score[row] = o[0];
    start_r[row] = o[1];
    end_r[row] = o[2];
    start_q[row] = o[3];
    end_q[row] = o[4];
  }
};

// The scan over a row's n sorted live keys with the ring in registers: lane
// L holds slots L + 32 t, t < S; slots at or past LB stay empty and bring
// INT_MIN (no slot) to the tie-breaking maxima. Every lane returns the
// result in o.
template <int S, int DIV>
__device__ __forceinline__ void dp_regs(const uint64_t* keys, int n, int LB, int max_gap,
                                        const Div& dv, int lane, int (&o)[5]) {
  int F[S], R[S], Q[S], SR[S], SQ[S], cand[S];
  bool real[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    F[t] = 0;  // an empty slot never qualifies
    R[t] = kBig;
    Q[t] = kBig;
    SR[t] = -1;
    SQ[t] = -1;
    real[t] = lane + 32 * t < LB;
  }
  int best = 0, b_sr = -1, b_er = -1, b_sq = -1, b_eq = -1;
  int slot = 0;
  uint64_t key = n > 0 ? keys[0] : 0;
  for (int i = 0; i < n; ++i) {
    const uint64_t next = i + 1 < n ? keys[i + 1] : 0;
    const int ri = key_r(key), qi = key_q(key);
    int pbest = INT_MIN;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      cand[t] = slot_cand<DIV>(F[t], R[t], Q[t], ri, qi, max_gap, dv);
      pbest = max(pbest, cand[t]);
    }
    pbest = __reduce_max_sync(kFull, pbest);
    int f_i = 1, sr_i = ri, sq_i = qi;
    if (pbest > 0) {  // warp-uniform: the chain extends its predecessor's
      int pr = INT_MIN;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        if (real[t]) pr = max(pr, cand[t] == pbest ? R[t] : -1);
      }
      pr = __reduce_max_sync(kFull, pr);
      int pq = INT_MIN;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        if (real[t]) pq = max(pq, cand[t] == pbest && R[t] == pr ? Q[t] : -1);
      }
      pq = __reduce_max_sync(kFull, pq);
      int psr = INT_MIN, psq = INT_MIN;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const bool take = cand[t] == pbest && R[t] == pr && Q[t] == pq;
        if (real[t]) {
          psr = max(psr, take ? SR[t] : -1);
          psq = max(psq, take ? SQ[t] : -1);
        }
      }
      sr_i = __reduce_max_sync(kFull, psr);
      sq_i = __reduce_max_sync(kFull, psq);
      f_i = (int)((unsigned)pbest + 1u);
    }
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if (slot == lane + 32 * t) {
        F[t] = f_i;
        R[t] = ri;
        Q[t] = qi;
        SR[t] = sr_i;
        SQ[t] = sq_i;
      }
    }
    if (++slot == LB) slot = 0;
    if (f_i > best) {
      best = f_i;
      b_sr = sr_i;
      b_er = ri;
      b_sq = sq_i;
      b_eq = qi;
    }
    key = next;
  }
  o[0] = best, o[1] = b_sr, o[2] = b_er, o[3] = b_sq, o[4] = b_eq;
}

// True when every live anchor of the sorted row has r >= -1 and q >= -1
// and no two are equal: then the plain version's -1 fill never wins a
// maximum, and the predecessor's (r, q), the largest among the slots at the
// best candidate, is that of the latest of them in the ring.
__device__ __forceinline__ bool simple_row(const uint64_t* keys, int n, int lane) {
  bool bad = false;
  for (int j = lane; j < n; j += 32) {
    const uint64_t k = keys[j];
    bad |= key_r(k) < -1 || key_q(k) < -1 || (j + 1 < n && keys[j + 1] == k);
  }
  return !__any_sync(kFull, bad);
}

constexpr int kPackMin = -(1 << 23);

// A slot's candidate for anchor (ri, qi), packed for dp_fast: the candidate
// clamped below at -2^23, times 256, plus the slot's rank; INT_MIN where the
// slot (f, r + 1, q + 1) does not qualify. 0 < dr <= max_gap is tested as
// 0 <= dr - 1 < max_gap, unsigned (mgu = max(max_gap, 0)).
template <int DIV>
__device__ __forceinline__ int packed_cand(int f, int r1, int q1, int ri, int qi, unsigned mgu,
                                           const Div& dv, int rank) {
  const int d1r = wrap_sub(ri, r1), d1q = wrap_sub(qi, q1);
  const bool ok = f > 0 && (unsigned)d1r < mgu && (unsigned)d1q < mgu;
  // DIV is a shift or a multiply-high here: no fault where !ok
  const int c = max(wrap_sub(f, div_drift<DIV>(abs(wrap_sub(d1r, d1q)), dv)), kPackMin);
  return ok ? c * 256 + rank : INT_MIN;
}

// The scan of dp_regs for a simple_row (n < 2^23) and gap_unit > 0, with one
// maximum a step: each slot's packed_cand, ranked 0 for the oldest of the
// ring's LB <= 256 slots, so the maximum gives the best candidate and,
// among the slots at it, the latest, whose (sr, sq) is the predecessor's.
// Positive candidates are at most f <= n and exact. Anchor i's (sr, sq)
// replaces its key in keys[i] (every lane writes the same and reads its
// own), read back where a later anchor takes it as its predecessor. The
// step is branch-free, and anchor i's (sr, sq) is stored a step later,
// between anchor i + 1's candidates and its maximum, so the predecessor's
// load is waited on off the chain of dependent steps.
template <int S, int DIV>
__device__ __forceinline__ void dp_fast(uint64_t* keys, int n, int LB, int max_gap,
                                        const Div& dv, int lane, int (&o)[5]) {
  const unsigned mgu = max_gap > 0 ? (unsigned)max_gap : 0u;
  int F[S], R1[S], Q1[S], AGE[S];  // R1, Q1: the slot's r + 1 and q + 1
#pragma unroll
  for (int t = 0; t < S; ++t) {
    F[t] = 0;  // an empty slot never qualifies
    R1[t] = kBig;
    Q1[t] = kBig;
    AGE[t] = 0;
  }
  int best = 0, best_i = 0;  // the best anchor's f and index
  uint64_t best_key = 0;
  uint64_t start = 0;  // anchor i - 1's (sr, sq), hi and lo, to store
  int slot = 0;
  uint64_t key = n > 0 ? keys[0] : 0;
  for (int i = 0; i < n; ++i) {
    const uint64_t next = keys[min(i + 1, n - 1)];
    const int ri = key_r(key), qi = key_q(key);
    const int base = i - LB;
    int m = INT_MIN;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      m = max(m, packed_cand<DIV>(F[t], R1[t], Q1[t], ri, qi, mgu, dv, AGE[t] - base));
    }
    keys[max(i - 1, 0)] = start;  // at i = 0 a placeholder over a key already read
    const int p = __reduce_max_sync(kFull, m);
    const bool ext = p >= 256;  // the best candidate is positive: extend its chain
    const uint64_t pred = keys[max(base + (p & 255), 0)];
    const int f_i = ext ? (p >> 8) + 1 : 1;
#pragma unroll
    for (int t = 0; t < S; ++t) {
      if (slot == lane + 32 * t) {
        F[t] = f_i;
        R1[t] = ri + 1;
        Q1[t] = qi + 1;
        AGE[t] = i;
      }
    }
    start = ext ? pred : ((uint64_t)(unsigned)ri << 32) | (unsigned)qi;
    const bool better = f_i > best;
    best = better ? f_i : best;
    best_i = better ? i : best_i;
    best_key = better ? key : best_key;
    slot = slot + 1 == LB ? 0 : slot + 1;
    key = next;
  }
  if (n > 0) keys[n - 1] = start;
  const uint64_t bs = n > 0 ? keys[best_i] : 0;
  o[0] = best;
  o[1] = n > 0 ? (int)(unsigned)(bs >> 32) : -1;
  o[2] = n > 0 ? key_r(best_key) : -1;
  o[3] = n > 0 ? (int)(unsigned)bs : -1;
  o[4] = n > 0 ? key_q(best_key) : -1;
}

// The scan with the ring in registers: dp_fast where it is exact, else
// dp_regs. Every lane of the warp calls it; keys may be overwritten.
template <int S, int DIV>
__device__ __forceinline__ void dp_ring(uint64_t* keys, int n, int LB, int max_gap,
                                        const Div& dv, int lane, int (&o)[5]) {
  if constexpr (DIV != 2) {  // gap_unit > 0: a candidate is at most its slot's f
    if (n < (1 << 23) && simple_row(keys, n, lane)) {
      dp_fast<S, DIV>(keys, n, LB, max_gap, dv, lane, o);
      return;
    }
  }
  dp_regs<S, DIV>(keys, n, LB, max_gap, dv, lane, o);
}

// The same scan with the ring's five columns of LB slots in shared memory
// (LB above kRegLookback): each pass recomputes a slot's candidate.
template <int DIV>
__device__ void dp_smem(const uint64_t* keys, int n, int LB, int max_gap, const Div& dv,
                        int* ring, int lane, int (&o)[5]) {
  int* ring_f = ring;
  int* ring_r = ring_f + LB;
  int* ring_q = ring_r + LB;
  int* ring_sr = ring_q + LB;
  int* ring_sq = ring_sr + LB;
  for (int s = lane; s < LB; s += 32) {
    ring_f[s] = 0;
    ring_r[s] = kBig;
    ring_q[s] = kBig;
    ring_sr[s] = -1;
    ring_sq[s] = -1;
  }
  __syncwarp();
  int best = 0, b_sr = -1, b_er = -1, b_sq = -1, b_eq = -1;
  int slot = 0;
  for (int i = 0; i < n; ++i) {
    const uint64_t key = keys[i];
    const int ri = key_r(key), qi = key_q(key);
#define CAND(s) slot_cand<DIV>(ring_f[s], ring_r[s], ring_q[s], ri, qi, max_gap, dv)
    int pbest = INT_MIN;
    for (int s = lane; s < LB; s += 32) pbest = max(pbest, CAND(s));
    pbest = __reduce_max_sync(kFull, pbest);
    int f_i = 1, sr_i = ri, sq_i = qi;
    if (pbest > 0) {
      int pr = INT_MIN;
      for (int s = lane; s < LB; s += 32) pr = max(pr, CAND(s) == pbest ? ring_r[s] : -1);
      pr = __reduce_max_sync(kFull, pr);
      int pq = INT_MIN;
      for (int s = lane; s < LB; s += 32) {
        pq = max(pq, CAND(s) == pbest && ring_r[s] == pr ? ring_q[s] : -1);
      }
      pq = __reduce_max_sync(kFull, pq);
      int psr = INT_MIN, psq = INT_MIN;
      for (int s = lane; s < LB; s += 32) {
        const bool take = CAND(s) == pbest && ring_r[s] == pr && ring_q[s] == pq;
        psr = max(psr, take ? ring_sr[s] : -1);
        psq = max(psq, take ? ring_sq[s] : -1);
      }
      sr_i = __reduce_max_sync(kFull, psr);
      sq_i = __reduce_max_sync(kFull, psq);
      f_i = (int)((unsigned)pbest + 1u);
    }
#undef CAND
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
      b_sr = sr_i;
      b_er = ri;
      b_sq = sq_i;
      b_eq = qi;
    }
  }
  o[0] = best, o[1] = b_sr, o[2] = b_er, o[3] = b_sq, o[4] = b_eq;
}

struct Args {
  const int* rs;
  const int* qs;
  const uint8_t* vs;
  int64_t B, A;
  int max_gap, LB;
  Div dv;
  bool vec;
  int* counters;
  int* queue;
  uint64_t* big_keys;  // A keys a block of chain_big_kernel
  Out out;
};

// A warp a row, rows pulled from counters[kNextRow]; a row with more than
// cap live anchors goes to the queue of chain_big_kernel.
template <int S, int DIV>
__global__ void __launch_bounds__(32 * kRowWarps) chain_rows_kernel(Args a, int cap) {
  extern __shared__ uint64_t row_keys[];
  const int lane = threadIdx.x & 31;
  uint64_t* keys = row_keys + (size_t)(threadIdx.x >> 5) * cap;
  for (;;) {
    int pulled = 0;
    if (lane == 0) pulled = atomicAdd(&a.counters[kNextRow], 1);
    const int64_t row = __shfl_sync(kFull, pulled, 0);
    if (row >= a.B) break;
    const int n = compact_warp(a.rs + row * a.A, a.qs + row * a.A, a.vs + row * a.A, a.A, a.vec,
                               keys, cap, lane);
    if (n < 0) {
      if (lane == 0) a.queue[atomicAdd(&a.counters[kQueued], 1)] = (int)row;
      continue;
    }
    __syncwarp();
    bitonic_sort(keys, n, lane, 32, WarpSync());
    int o[5];
    dp_ring<S, DIV>(keys, n, a.LB, a.max_gap, a.dv, lane, o);
    if (lane == 0) a.out.put(row, o);
    __syncwarp();  // the keys are read before the next row's overwrite them
  }
}

// A block a row, rows pulled from the queue (or every row, all_rows): the
// live keys go to the block's A keys of device memory, then to shared
// memory where they fit (smem_keys), are sorted, and warp 0 runs the scan
// (S = 0: the ring in shared memory).
template <int S, int DIV>
__global__ void __launch_bounds__(kBigThreads, 1) chain_big_kernel(Args a, bool all_rows,
                                                                  int smem_keys) {
  extern __shared__ __align__(16) unsigned char big_smem[];
  int* hdr = reinterpret_cast<int*>(big_smem);  // [0] the row, [1] its live count
  int* ring = reinterpret_cast<int*>(big_smem + kHeader);
  const size_t ring_bytes = S == 0 ? ((size_t)kColumns * 4 * a.LB + 7) / 8 * 8 : 0;
  uint64_t* s_keys = reinterpret_cast<uint64_t*>(big_smem + kHeader + ring_bytes);
  uint64_t* g_keys = a.big_keys + (size_t)blockIdx.x * a.A;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (;;) {
    if (threadIdx.x == 0) {
      const int idx = atomicAdd(&a.counters[kNextBig], 1);
      const int total = all_rows ? (int)a.B : *(volatile int*)&a.counters[kQueued];
      hdr[0] = idx < total ? (all_rows ? idx : a.queue[idx]) : -1;
      hdr[1] = 0;
    }
    __syncthreads();
    const int64_t row = hdr[0];
    if (row < 0) break;
    const int* r_row = a.rs + row * a.A;
    const int* q_row = a.qs + row * a.A;
    const uint8_t* v_row = a.vs + row * a.A;
    for (int64_t j = (int64_t)(warp * 32 + lane) * kGranule; j - lane * kGranule < a.A;
         j += (int64_t)warps * 32 * kGranule) {
      const unsigned vb = valid_bits(v_row, j, a.A, a.vec);
      if (!__any_sync(kFull, vb)) continue;
      int r[kGranule], q[kGranule];
      const unsigned keep = load_live(r_row, q_row, j, vb, a.vec, r, q);
      int total;
      const int place = warp_place(__popc(keep), lane, &total);
      int base = 0;
      if (lane == 0) base = atomicAdd(&hdr[1], total);
      put_keys(g_keys, __shfl_sync(kFull, base, 0) + place, keep, r, q);
    }
    __syncthreads();
    const int n = hdr[1];
    uint64_t* keys = g_keys;
    if (n <= smem_keys) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) s_keys[i] = g_keys[i];
      keys = s_keys;
      __syncthreads();
    }
    bitonic_sort(keys, n, threadIdx.x, blockDim.x, BlockSync());
    if (warp == 0) {
      int o[5];
      if constexpr (S == 0) {
        dp_smem<DIV>(keys, n, a.LB, a.max_gap, a.dv, ring, lane, o);
      } else {
        dp_ring<S, DIV>(keys, n, a.LB, a.max_gap, a.dv, lane, o);
      }
      if (lane == 0) a.out.put(row, o);
    }
    __syncthreads();  // the header and the keys are free again
  }
}

// Ring slots a lane keeps in registers for LB slots (0: the ring in shared
// memory).
int ring_regs(int LB) {
  if (LB <= 32) return 1;
  if (LB <= 64) return 2;
  if (LB <= 128) return 4;
  if (LB <= kRegLookback) return 8;
  return 0;
}

int64_t queue_ints(int64_t B) { return (B + 1) / 2 * 2; }  // 8-byte aligned after it

// Blocks of chain_big_kernel: one an SM at most, fewer where their keys
// would pass kBigScratch bytes.
int big_blocks(int64_t B, int64_t A) {
  int64_t n = bn::sm_count();
  const int64_t fit = kBigScratch / (8 * (A > 0 ? A : 1));
  if (n > fit) n = fit > 0 ? fit : 1;
  if (n > B) n = B;
  return (int)(n > 0 ? n : 1);
}

template <int S, int DIV>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool regs = S > 0;
  if constexpr (regs) {
    const int cap = (int)(a.A < kRowCap ? (a.A > 0 ? a.A : 1) : kRowCap);
    const size_t smem = (size_t)kRowWarps * cap * sizeof(uint64_t);
    cudaFuncSetAttribute(chain_rows_kernel<S, DIV>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chain_rows_kernel<S, DIV>,
                                                  32 * kRowWarps, smem);
    int64_t blocks = (a.B + kRowWarps - 1) / kRowWarps;
    const int64_t resident = (int64_t)bn::sm_count() * (per_sm > 0 ? per_sm : 1);
    if (blocks > resident) blocks = resident;
    chain_rows_kernel<S, DIV><<<(unsigned)blocks, 32 * kRowWarps, smem, stream>>>(a, cap);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const size_t ring_bytes = regs ? 0 : ((size_t)kColumns * 4 * a.LB + 7) / 8 * 8;
  const size_t smem = kMaxSmem;
  const int smem_keys = (int)((smem - kHeader - ring_bytes) / sizeof(uint64_t));
  cudaFuncSetAttribute(chain_big_kernel<S, DIV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  chain_big_kernel<S, DIV><<<big_blocks(a.B, a.A), kBigThreads, smem, stream>>>(a, !regs,
                                                                              smem_keys);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_div(const Args& a, int mode, cudaStream_t stream) {
  if (mode == 0) return launch<S, 0>(a, stream);
  if (mode == 1) return launch<S, 1>(a, stream);
  return launch<S, 2>(a, stream);
}

}  // namespace

// Bytes of scratch bn_chain needs for B rows of A anchors.
extern "C" int bn_chain_scratch(int64_t B, int64_t A, int64_t* bytes) {
  *bytes = 4 * (kCounters + queue_ints(B)) + 8 * (int64_t)big_blocks(B, A) * A;
  return 0;
}

// rs, qs [B, A] int32 and vs [B, A] bool (bytes 0 or 1), in any order
// within a row; LB = min(lookback, A) ring slots, LB >= 1 unless A == 0,
// and above kRegLookback 5 * 4 * LB + kHeader bytes of shared memory at
// most 227 KB; the division (mode, magic, shift) from
// ops.chain.gap_divider(gap_unit), gap_unit != 0; scratch of
// bn_chain_scratch(B, A) bytes. Outputs [B] int32 each.
extern "C" int bn_chain(const void* rs, const void* qs, const void* vs, int64_t B, int64_t A,
                        int max_gap, int mode, unsigned magic, int shift, int gap_unit, int LB,
                        void* scratch, void* score, void* start_r, void* end_r,
                        void* start_q, void* end_q, void* stream) {
  if (B < 0 || B > INT_MAX || A < 0 || LB < 0 || LB > A || (A > 0 && LB < 1) ||
      gap_unit == 0 || mode < 0 || mode > 2 || (mode == 2) != (gap_unit < 0) ||
      (LB > kRegLookback && (int64_t)kColumns * 4 * LB + kHeader > kMaxSmem)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (B == 0) return (int)cudaGetLastError();
  int* counters = static_cast<int*>(scratch);
  const cudaError_t e = cudaMemsetAsync(counters, 0, 4 * kCounters, s);
  if (e != cudaSuccess) return (int)e;
  const bool vec = A % kGranule == 0 && ((uintptr_t)rs | (uintptr_t)qs | (uintptr_t)vs) % 16 == 0;
  Args a{(const int*)rs, (const int*)qs, (const uint8_t*)vs, B, A, max_gap, LB,
         Div{magic, shift, gap_unit}, vec, counters, counters + kCounters,
         reinterpret_cast<uint64_t*>(counters + kCounters + queue_ints(B)),
         Out{(int*)score, (int*)start_r, (int*)end_r, (int*)start_q, (int*)end_q}};
  switch (ring_regs(LB)) {
    case 1: return (int)launch_div<1>(a, mode, s);
    case 2: return (int)launch_div<2>(a, mode, s);
    case 4: return (int)launch_div<4>(a, mode, s);
    case 8: return (int)launch_div<8>(a, mode, s);
    default: return (int)launch_div<0>(a, mode, s);
  }
}
