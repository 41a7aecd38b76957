// C2 traceback: the direction-recording wavefront of ops/align.py and its
// walk, the source of every CIGAR, on the card.
//
// Replaces no TPU kernel. bitnuc_tpu/ops/align.py::_wavefront_tb_codes
// (align.py:448) and _wavefront_tb_codes_banded (:585) are two lax.scans in
// one jit (a forward scan over the M + N diagonals that records a 4-bit
// candidate mask per cell, then a walk of M + N steps), which XLA compiles
// into device loops; eager PyTorch has no such loop. Both kernels here are
// both scans: (cost [B], end_j [B], ops [B, M + N] uint8 in forward order,
// OP_STOP-padded), equal bit for bit to the plain version
// (ops.align.align_ops_codes_torch / align_ops_codes_banded_torch) for
// lengths in [0, M] and [0, N]. A cell's mask: bit0 diag ties, bit1 up
// ties, bit2 left ties, bit3 diag is a match. The walk's tie policy:
// continue an INS on bit 1 or a DEL on bit 2, else diag > up > left.
//
// Bound on the card: integer ALU. A pair is m x n cells of about 12 int32
// operations (the code compare and substitution select, three candidate
// sums, two mins, three tie compares and the mask), then a serial walk of
// at most m + n steps; the bytes are the codes, read once, and the ops,
// written once.
//
// traceback_warp_kernel<CMAX>, the unbanded form where N + 1 <= 1,024 and
// a warp's plane fits in shared memory (ops.align._tb_warp_cells): a warp a
// pair, rows pipelined down the warp, as K9's sw_kernel<C>. Each pair runs
// at its own C, the fewest cells a lane of kCells that hold its n + 1
// columns (at most CMAX, the one for N + 1; a 150-base window takes C 5,
// 31 lanes, where C 8 would leave 13 of 32 idle). Lane L holds columns
// j = L C .. L C + C - 1 and at step s works row i = s - L, so no lane
// computes a row outside [1, m] and no barrier is needed: one
// __shfl_up_sync a step brings D[i][L C - 1] from lane L - 1 (made at step
// s - 1), and the value it brought one step earlier is the diagonal
// neighbour. The previous row's costs and the lane's codes of b stay in
// registers; a step reads one code of a, fetched a step ahead. A lane whose
// columns all lie past n keeps only the shuffles. Every cell runs the plain
// version's operations in its order (wadd, the j = 0 and i = 0 boundaries),
// and the cells past n inside a live lane are computed and never read.
// The masks go four bits a cell into the lane's ceil(C / 8) words, stored
// at plane[i][word][L]: a row is 32 words a word index, so lane L always
// hits bank L and a row costs one conflict-free store a word (the block
// form's byte plane put a warp's 32 stores on 4 banks). A warp's plane is
// (M + 1) x 128 ceil(CMAX / 8) bytes (20,608 at M 160, N 224, against the
// block form's 36,225), beside an (M + N)-byte buffer of ops; the launch
// takes the warps a block that keep the most warps resident an SM
// (occupancy query; 11 warps, one block, at M 160, N 224), and the warps
// stride over the pairs. The ends: without ends_free_b the cost is
// min(2^30, D[m][n]) (0 when m + n = 0), shuffled from the lane of column
// n; with it, each lane folds row m's columns <= n at step m + L (the
// first minimum, or with tie_late the last), and two warp reductions give
// the plain version's running fit. One lane then walks the nibble plane
// from (m, end_j), taking each op from a 32-bit table of the tie policy
// (kTabNone, kTabIns, kTabDel: a nibble for each of the 8 tie masks) and
// loading the words of the three cells it may move to before it decides,
// and writes the ops end first into the warp's buffer; the warp then
// writes the row forward, OP_STOP-padded, in 16-byte stores. The walk
// stays serial a pair; the other warps of the SM cover it. What bounds it
// now (NVIDIA H100, phase 7's chunk): integer instruction throughput,
// about 18 instructions a cell (12 on the ALU pipe: the code compare, the
// substitution and match selects, two mins, three tie compares and their
// selects, and the packing), with the mask a quarter of the time and the
// walk a fifth.
//
// traceback_kernel<kBanded> (the first form, kept for the banded form,
// N + 1 > 1,024 and planes past shared memory): one block a pair (a
// grid-stride loop over the pairs where the plane lives in device memory).
// The threads stride over the lanes of a diagonal; the last three
// diagonals live in a ring in shared memory (slot d % 3), or in the
// block's slice of device scratch past what shared memory holds. One
// __syncthreads a diagonal, so about 40% of a block works between two
// barriers on a 150 x 150 rectangle. Each cell's mask goes to a per-pair
// plane of bytes, in shared memory where the ring and plane fit in
// ops.align._TB_SMEM_BYTES, else in the block's scratch. Then thread 0
// walks the plane, writing the ops into the output row end first, and the
// block reverses the row in place and pads it with OP_STOP.
//
// Unbanded (K == 0): the walk of a pair with lengths in [0, M] x [0, N]
// never leaves the rectangle [0, m] x [0, n] (j = 0 records only "up" and
// i = 0 only "left", or stops the fit), and no cell of it depends on a cell
// outside it, so only its cells are computed: diagonal d covers j in
// [max(0, d - m), min(n, d)]. Their masks go to plane[i (N + 1) + j], the
// rectangle's layout, (M + 1) (N + 1) bytes a pair (36,225 at M 160, N 224,
// against the plain version's (M + N) (N + 1) = 86,400).
//
// Banded (K lanes, band start base(d) as ops.align._band_geometry): a walk
// whose path leaves the band reads, through the clamped lane and flat
// index of ops.align._wavefront_tb_codes_banded's lane_of, a neighbouring
// lane's mask, which may be a cell with i < 0 or past the lengths. So every
// lane of [0, K) is computed on every diagonal 1 .. m + n from the
// sentinel-padded codes, as the plain version does (a cell with j > d keeps
// its mask and takes the sentinel as its value), and the plane has the
// plain version's [d - 1][lane] layout, (M + N) K bytes a pair. The walk
// reads a diagonal <= m + end_j <= m + n, so no diagonal past m + n is
// needed.
//
// Costs are any int32 values: every sum and product wraps modulo 2^32
// (wadd, wmul: unsigned arithmetic cast back), as the plain version's int32
// tensors and the JAX package's int32 arrays do.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kPadA = 4;
constexpr int kPadB = 5;
constexpr int kOpEq = 1, kOpX = 2, kOpIns = 3, kOpDel = 4;
constexpr int kMaxSmem = 227 * 1024 - 64;  // dynamic, beside the static words
constexpr int kMaxThreads = 256;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// x[k], or the sentinel for a band lane outside [0, K).
__device__ __forceinline__ int ring_at(const int* x, int k, int K) {
  return (k >= 0 && k < K) ? x[k] : kBig;
}

struct Args {
  const int* ca;       // [B, M] codes of a
  const int* la;       // [B] lengths of a
  const int* cb;       // [B, N] codes of b
  const int* lb;       // [B] lengths of b
  const uint8_t* late; // [B] tie_late, or null
  int64_t B;
  int M, N;
  int mm, gp;
  int efb;             // ends_free_b
  int off_lo, K;       // K == 0: unbanded
  int ring_smem, plane_smem;
  int64_t ring_bytes, plane_bytes;
  uint8_t* scratch;    // per block: [ring unless ring_smem][plane unless plane_smem]
  int64_t stride;      // scratch bytes a block
  int* cost;
  int* endj;
  uint8_t* ops;        // [B, M + N]
};

template <bool kBanded>
__global__ void __launch_bounds__(kMaxThreads) traceback_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_cost, s_endj, s_steps;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int M = p.M, N = p.N, T = M + N, K = p.K;
  const int lanes = kBanded ? K : N + 1;  // ring lanes
  uint8_t* slice = p.scratch ? p.scratch + (int64_t)blockIdx.x * p.stride : nullptr;
  int* ring = reinterpret_cast<int*>(p.ring_smem ? smem : slice);
  uint8_t* plane = p.plane_smem ? smem + p.ring_bytes
                                : slice + (p.ring_smem ? 0 : p.ring_bytes);
  const int64_t plane_last = p.plane_bytes - 1;
  const int top = N + 1 - K > 0 ? N + 1 - K : 0;
  auto base = [&](int d) {
    const int v = (d + p.off_lo + 1) >> 1;  // floor((d + off_lo + 1) / 2)
    return v < 0 ? 0 : (v > top ? top : v);
  };
  for (int64_t r = blockIdx.x; r < p.B; r += gridDim.x) {
    // lengths outside [0, M] x [0, N] are refused by the wrapper; the clamps
    // only keep every access in bounds
    const int m = min(max(p.la[r], 0), M), n = min(max(p.lb[r], 0), N);
    const int* ra = p.ca + r * M;
    const int* rb = p.cb + r * N;
    const bool late = p.late != nullptr && p.late[r] != 0;
    const int efb = p.efb;
    if (tid == 0) {
      s_cost = efb ? (m == 0 ? 0 : kBig) : (m + n == 0 ? 0 : kBig);
      s_endj = efb ? 0 : n;
    }
    if (kBanded) {  // d = 0 in slot 0 (band starts at j = 0), d = -1 in slot 2
      for (int t = tid; t < K; t += nt) {
        ring[t] = t == 0 ? 0 : kBig;
        ring[2 * K + t] = kBig;
      }
    } else if (tid == 0) {
      ring[0] = 0;  // D[0, 0]; no other lane of d = 0 or d = -1 is read
    }
    __syncthreads();
    int b1 = 0, b2 = 0;  // base(d - 1), base(d - 2): base(0) = base(-1) = 0
    const int d_end = m + n;
    for (int d = 1; d <= d_end; ++d) {
      int* ND = ring + (d % 3) * lanes;
      const int* P = ring + ((d + 2) % 3) * lanes;
      const int* Q = ring + ((d + 1) % 3) * lanes;
      if (kBanded) {
        const int bd = base(d);
        const int d1 = bd - b1, d2 = bd - b2;
        uint8_t* row = plane + (int64_t)(d - 1) * K;
        for (int t = tid; t < K; t += nt) {
          const int j = bd + t, i = d - j;
          const int up = ring_at(P, t + d1, K);
          const int left = ring_at(P, t + d1 - 1, K);
          const int dg = ring_at(Q, t + d2 - 1, K);
          const int xa = i - 1, xb = j - 1;
          const int ca = (xa >= 0 && xa < m) ? __ldg(ra + xa) : kPadA;
          const int cb = (xb >= 0 && xb < n) ? __ldg(rb + xb) : kPadB;
          const bool eq = ca == cb;
          const int c_diag = wadd(dg, eq ? 0 : p.mm);
          const int c_up = wadd(up, p.gp), c_left = wadd(left, p.gp);
          int D = min(min(c_diag, c_up), c_left);
          int mask = (D == c_diag) | ((D == c_up) << 1) | ((D == c_left) << 2) | (eq << 3);
          if (j == 0) {
            D = wmul(d, p.gp);
            mask = 2;
          }
          if (j == d) {
            D = efb ? 0 : wmul(d, p.gp);
            mask = efb ? 0 : 4;
          }
          if (j > d) D = kBig;  // i < 0: no such cell (its mask stays)
          ND[t] = D;
          row[t] = (uint8_t)mask;
          if (efb) {
            if (i == m && j <= n && D < s_cost) {  // one lane a diagonal
              s_cost = D;
              s_endj = j;
            }
          } else if (j == n && d == d_end) {
            s_cost = min(s_cost, D);
          }
        }
        b2 = b1;
        b1 = bd;
      } else {
        const int jlo = max(0, d - m), jhi = min(n, d);
        for (int j = jlo + tid; j <= jhi; j += nt) {
          const int i = d - j;
          int D, mask;
          if (j == 0) {
            D = wmul(d, p.gp);
            mask = 2;
          } else if (i == 0) {
            D = efb ? 0 : wmul(d, p.gp);
            mask = efb ? 0 : 4;
          } else {  // codes in range: i <= m, j <= n
            const bool eq = __ldg(ra + i - 1) == __ldg(rb + j - 1);
            const int c_diag = wadd(Q[j - 1], eq ? 0 : p.mm);
            const int c_up = wadd(P[j], p.gp), c_left = wadd(P[j - 1], p.gp);
            D = min(min(c_diag, c_up), c_left);
            mask = (D == c_diag) | ((D == c_up) << 1) | ((D == c_left) << 2) | (eq << 3);
          }
          ND[j] = D;
          plane[(int64_t)i * (N + 1) + j] = (uint8_t)mask;
          if (i == m) {  // j = d - m: the lane jlo
            if (efb) {
              const int fit = s_cost;
              if (D < fit || (late && D == fit && D < kBig)) {
                s_cost = min(fit, D);
                s_endj = j;
              }
            } else if (j == n) {
              s_cost = min(s_cost, D);
            }
          }
        }
      }
      __syncthreads();
    }
    uint8_t* out = p.ops + r * T;
    if (tid == 0) {
      int i = m, j = s_endj, prev = 0, s = 0;
      for (; s < T; ++s) {
        if (!(efb ? i > 0 : (i > 0 || j > 0))) break;
        int64_t idx;
        if (kBanded) {
          const int d = i + j;
          const int lane = min(max(j - base(d), 0), K - 1);
          idx = (int64_t)(d - 1) * K + lane;
        } else {
          idx = (int64_t)i * (N + 1) + j;
        }
        idx = idx < 0 ? 0 : (idx > plane_last ? plane_last : idx);
        const int mask = plane[idx];
        int op;
        if (prev == kOpIns && (mask & 2)) {
          op = kOpIns;
        } else if (prev == kOpDel && (mask & 4)) {
          op = kOpDel;
        } else if (mask & 1) {
          op = (mask & 8) ? kOpEq : kOpX;
        } else {
          op = (mask & 2) ? kOpIns : kOpDel;
        }
        out[s] = (uint8_t)op;
        i -= op != kOpDel;
        j -= op != kOpIns;
        prev = op;
      }
      s_steps = s;
      p.cost[r] = s_cost;
      p.endj[r] = s_endj;
    }
    __syncthreads();
    const int steps = s_steps;
    for (int k = tid; k < steps / 2; k += nt) {  // end -> start into forward order
      const uint8_t x = out[k];
      out[k] = out[steps - 1 - k];
      out[steps - 1 - k] = x;
    }
    for (int k = steps + tid; k < T; k += nt) out[k] = 0;  // OP_STOP
    __syncthreads();  // the walk and the reads of s_* are done before the next pair
  }
}

constexpr unsigned kFull = 0xFFFFFFFFu;
// Warps a block of traceback_warp_kernel<CMAX>: 16, or 8 from CMAX 24 on,
// whose planes hold few warps an SM anyway, so that the widest rows get
// up to 255 registers a thread instead of 128.
__host__ __device__ constexpr int warp_max_warps(int cmax) { return cmax >= 24 ? 8 : 16; }
constexpr int kWarpMaxSmem = 227 * 1024;

struct WarpArgs {
  const int* ca;       // [B, M] codes of a
  const int* la;       // [B] lengths of a
  const int* cb;       // [B, N] codes of b
  const int* lb;       // [B] lengths of b
  const uint8_t* late; // [B] tie_late, or null
  int64_t B;
  int M, N;
  int mm, gp;
  int efb;             // ends_free_b
  int stride;          // shared bytes a warp: the plane, then the ops buffer
  int64_t nwarps;      // warps of the grid, striding over the pairs
  int* cost;
  int* endj;
  uint8_t* ops;        // [B, M + N]
};

constexpr int kCells[] = {1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32};  // the cases of C
// The walk's tie policy as tables: nibble (mask & 7) of each is the op
// after an EQ/X (or at the start), after an INS (an INS continues on bit 1)
// and after a DEL (a DEL continues on bit 2); otherwise diag (written as
// EQ, X where bit 3 is clear) > up (INS) > left (DEL).
constexpr uint32_t kTabNone = 0x13141314u;  // masks 7..0: EQ INS EQ DEL EQ INS EQ DEL
constexpr uint32_t kTabIns = 0x33143314u;
constexpr uint32_t kTabDel = 0x44441314u;

// One pair on one warp, lane L holding columns L C .. L C + C - 1 (32 C >=
// n + 1), its masks at plane[i][word][L] (ceil(C / 8) words a lane a row).
template <int C>
__device__ __forceinline__ void tb_pair(const WarpArgs& p, uint32_t* plane, uint8_t* buf,
                                        int64_t r, int m, int n, bool late, int lane) {
  constexpr int W = (C + 7) / 8;  // mask words a lane a row
  constexpr int kRow = 32 * W;    // words a row of the plane
  const int M = p.M, N = p.N, T = M + N, mm = p.mm, gp = p.gp;
  const bool efb = p.efb != 0;
  const int t0 = lane * C;  // lane L holds columns j = t0 .. t0 + C - 1
  const int* ra = p.ca + r * M;
  const int* rb = p.cb + r * N;
  const bool wide16 = (T & 15) == 0 && (reinterpret_cast<uintptr_t>(p.ops) & 15) == 0;
  const bool live = t0 <= n;  // the lane holds a column of [0, n]
  int hp[C], cbv[C];          // D of the lane's last row; b's codes
  uint32_t w0[W];
#pragma unroll
  for (int w = 0; w < W; ++w) w0[w] = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {  // row 0: D[0][j], mask "left" (none in a fit)
    const int j = t0 + c;
    hp[c] = (j == 0 || efb) ? 0 : wmul(j, gp);
    cbv[c] = (j >= 1 && j <= n) ? __ldg(rb + j - 1) : kPadB;
    w0[c / 8] |= (uint32_t)((j == 0 || efb) ? 0 : 4) << (4 * (c % 8));
  }
#pragma unroll
  for (int w = 0; w < W; ++w) plane[w * 32 + lane] = w0[w];
  // row m: the lane's least D over its columns <= n and its first (with
  // tie_late its last) column holding it; D[m][n] from the lane of column n
  int fmin = INT_MAX, fj = -1, dmn = 0;
  auto take_row_m = [&]() {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = t0 + c;
      if (j <= n) {
        const int v = hp[c];
        if (v < fmin || fj < 0) {
          fmin = v;
          fj = j;
        } else if (late && v == fmin) {
          fj = j;
        }
      }
      if (j == n) dmn = hp[c];
    }
  };
  if (m == 0 && live) take_row_m();
  // lane L works row s - L at step s; the lane of column n ends the pair
  const int steps = m > 0 ? m + n / C : 0;
  int hlast = hp[C - 1];  // D[i][t0 + C - 1] of the lane's last row
  int hdiag = 0;          // D[i - 1][t0 - 1] for the next row i
  int acode = (lane == 0 && m > 0) ? __ldg(ra) : kPadA;  // a[i - 1] of the next row
  for (int s = 1; s <= steps; ++s) {
    const int hl = __shfl_up_sync(kFull, hlast, 1);  // D[i][t0 - 1], lane L - 1's
    const int i = s - lane;
    if (live && i >= 1 && i <= m) {
      const int ca = acode;
      int h_left = hl, h_diag = hdiag;
      uint32_t wd[W];
#pragma unroll
      for (int w = 0; w < W; ++w) wd[w] = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool eq = ca == cbv[c];
        const int c_diag = wadd(h_diag, eq ? 0 : mm);
        const int c_up = wadd(hp[c], gp), c_left = wadd(h_left, gp);
        int D = min(min(c_diag, c_up), c_left);
        uint32_t mask = (uint32_t)(D == c_diag) | ((uint32_t)(D == c_up) << 1) |
                        ((uint32_t)(D == c_left) << 2) | ((uint32_t)eq << 3);
        if (c == 0 && lane == 0) {  // j = 0: "up" only
          D = wmul(i, gp);
          mask = 2;
        }
        h_diag = hp[c];
        hp[c] = D;
        h_left = D;
        wd[c / 8] |= mask << (4 * (c % 8));
      }
      hlast = h_left;
      uint32_t* row = plane + i * kRow + lane;
#pragma unroll
      for (int w = 0; w < W; ++w) row[w * 32] = wd[w];
      if (i == m) take_row_m();
    }
    const int x = s - lane;  // a[i] for row i + 1, one step ahead
    acode = (live && x >= 0 && x < m) ? __ldg(ra + x) : kPadA;
    hdiag = hl;
  }
  int cost, ej;
  if (efb) {
    // the plain version's running fit over j = 0 .. n: D < fit, or with
    // tie_late D == fit < 2^30, moves the end to j
    const int init = m == 0 ? 0 : kBig;
    const int mn = __reduce_min_sync(kFull, fmin);
    cost = min(init, mn);
    if (late) {
      const int lj = __reduce_max_sync(kFull, (fj >= 0 && fmin == cost) ? fj : -1);
      ej = cost < kBig ? max(lj, 0) : 0;
    } else {
      const int first = __reduce_min_sync(kFull, (fj >= 0 && fmin == mn) ? fj : INT_MAX);
      ej = mn < init ? first : 0;
    }
  } else {
    const int v = __shfl_sync(kFull, dmn, n / C);
    cost = m + n == 0 ? 0 : min(kBig, v);
    ej = n;
  }
  __syncwarp();  // every row is in the plane
  int nsteps = 0;
  if (lane == 0) {
    // the walk from (m, ej): the word of the current cell in hand, and the
    // words of the three cells it may move to loaded before the decision
    // that picks one, so no shared load waits on the previous step
    auto word_at = [&](int i, int L, int c) { return i * kRow + (c >> 3) * 32 + L; };
    int i = m, j = ej, L = (int)((unsigned)ej / C), c = ej - L * C, s = 0;
    uint32_t cur = plane[word_at(i, L, c)];
    uint32_t tab = kTabNone;
    for (; s < T; ++s) {
      if (!(efb ? i > 0 : (i > 0 || j > 0))) break;
      const int iu = max(i - 1, 0);  // rows and lanes clamped in range; such
      const int Ll = c > 0 ? L : max(L - 1, 0), cl = c > 0 ? c - 1 : C - 1;  // words go unused
      const uint32_t w_up = plane[word_at(iu, L, c)];
      const uint32_t w_diag = plane[word_at(iu, Ll, cl)];
      const uint32_t w_left = plane[word_at(i, Ll, cl)];
      const uint32_t mask = (cur >> (4 * (c & 7))) & 15u;
      int op = (int)(tab >> (4 * (mask & 7u))) & 15;
      op += op == kOpEq && !(mask & 8u);  // a mismatch
      buf[s] = (uint8_t)op;
      if (op == kOpIns) {
        i = iu;
        cur = w_up;
        tab = kTabIns;
      } else {
        L = Ll;
        c = cl;
        j -= 1;
        if (op == kOpDel) {
          cur = w_left;
          tab = kTabDel;
        } else {
          i = iu;
          cur = w_diag;
          tab = kTabNone;
        }
      }
    }
    nsteps = s;
    p.cost[r] = cost;
    p.endj[r] = ej;
  }
  nsteps = __shfl_sync(kFull, nsteps, 0);
  __syncwarp();  // the buffer is whole
  uint8_t* out = p.ops + r * T;
  if (wide16) {  // the row forward, OP_STOP-padded, 16 bytes a lane
    for (int k = 16 * lane; k < T; k += 512) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int kk = k + 4 * q + x;
          if (kk < nsteps) v[q] |= (uint32_t)buf[nsteps - 1 - kk] << (8 * x);
        }
      }
      *reinterpret_cast<uint4*>(out + k) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int k = lane; k < T; k += 32) out[k] = k < nsteps ? buf[nsteps - 1 - k] : 0;
  }
}

// tb_pair at the smallest C of kCells[K..] with 32 C >= n + 1, at most CMAX.
template <int CMAX, int K = 0>
__device__ __forceinline__ void tb_pair_fit(const WarpArgs& p, uint32_t* plane, uint8_t* buf,
                                            int64_t r, int m, int n, bool late, int lane) {
  constexpr int C = kCells[K];
  if constexpr (C >= CMAX) {
    tb_pair<CMAX>(p, plane, buf, r, m, n, late, lane);
  } else {
    if (n < 32 * C) {
      tb_pair<C>(p, plane, buf, r, m, n, late, lane);
    } else {
      tb_pair_fit<CMAX, K + 1>(p, plane, buf, r, m, n, late, lane);
    }
  }
}

// The warps of the grid stride over the pairs; each pair runs at the fewest
// cells a lane that hold its n + 1 columns (32 C >= N + 1 for the widest).
template <int CMAX>
__global__ void __launch_bounds__(32 * warp_max_warps(CMAX))
    traceback_warp_kernel(const WarpArgs p) {
  constexpr int kRowMax = 32 * ((CMAX + 7) / 8);
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* plane = reinterpret_cast<uint32_t*>(smem + (int64_t)warp * p.stride);
  uint8_t* buf = reinterpret_cast<uint8_t*>(plane + (p.M + 1) * kRowMax);
  for (int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp; r < p.B; r += p.nwarps) {
    // lengths outside [0, M] x [0, N] are refused by the wrapper; the clamps
    // only keep every access in bounds
    const int m = min(max(p.la[r], 0), p.M), n = min(max(p.lb[r], 0), p.N);
    const bool late = p.late != nullptr && p.late[r] != 0;
    tb_pair_fit<CMAX>(p, plane, buf, r, m, n, late, lane);
    __syncwarp();  // the plane and the buffer are free for the next pair
  }
}

// The cells a lane of traceback_warp_kernel: the smallest instantiated C
// with 32 C >= lanes, or 0 when there is none.
int warp_cells(int lanes) {
  for (int c : kCells) {
    if (32 * c >= lanes) return c;
  }
  return 0;
}

#define BN_TB_CELL_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(12) X(16) X(24) X(32)

// Launches traceback_warp_kernel<C> with the warps a block that keep the
// most warps resident an SM (the fewest on a tie), enough blocks for the
// pairs, at most those resident at once.
template <int C>
int launch_warp(WarpArgs a, cudaStream_t s) {
  auto kern = traceback_warp_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kWarpMaxSmem);
  if (e != cudaSuccess) return (int)e;
  int best = 0, wpb = 1, per_sm = 1;
  for (int w = 1; w <= warp_max_warps(C) && (int64_t)w * a.stride <= kWarpMaxSmem; ++w) {
    int nb = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, 32 * w, (size_t)w * a.stride);
    if (e != cudaSuccess) return (int)e;
    if (nb * w > best) {
      best = nb * w;
      wpb = w;
      per_sm = nb;
    }
  }
  if (best == 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (a.B + wpb - 1) / wpb;
  const int64_t cap = (int64_t)bn::sm_count() * per_sm;
  if (blocks > cap) blocks = cap;
  a.nwarps = blocks * wpb;
  traceback_warp_kernel<C><<<(unsigned)blocks, 32 * wpb, (size_t)wpb * a.stride, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// codes_a [B, M], codes_b [B, N] int32 (anything past each length); lens_a,
// lens_b [B] int32 in [0, M] and [0, N]; late [B] bytes or null (unbanded
// only); K == 0 for the unbanded form, else 2 <= K < N + 1 band lanes from
// off_lo <= 0. The ring (12 * lanes bytes rounded up to 16, lanes = K or
// N + 1) and the plane ((M + N) K bytes banded, (M + 1) (N + 1) unbanded)
// live in shared memory where ring_smem / plane_smem say so (a plane in
// shared memory needs the ring there too), else in the block's slice of
// scratch (stride bytes a block: the ring first when it is not in shared
// memory, then the plane); nblocks blocks stride over the pairs. Outputs
// cost, endj [B] int32 and ops [B, M + N] bytes.
extern "C" int bn_traceback(const void* codes_a, const void* lens_a, const void* codes_b,
                            const void* lens_b, const void* late, int64_t B, int M, int N,
                            int mismatch, int gap, int ends_free_b, int off_lo, int K,
                            int ring_smem, int plane_smem, void* scratch, int64_t stride,
                            int64_t nblocks, void* cost, void* endj, void* ops, void* stream) {
  const int lanes = K ? K : N + 1;
  const int64_t ring_bytes = (12 * (int64_t)lanes + 15) / 16 * 16;
  const int64_t plane_bytes = K ? (int64_t)(M + N) * K : (int64_t)(M + 1) * (N + 1);
  const int64_t smem = (ring_smem ? ring_bytes : 0) + (plane_smem ? plane_bytes : 0);
  const int64_t need = (ring_smem ? 0 : ring_bytes) + (plane_smem ? 0 : plane_bytes);
  if (B < 0 || M < 0 || N < 0 || (int64_t)M + N > INT_MAX / 2 || off_lo > 0 ||
      (K != 0 && (K < 2 || K >= N + 1)) || (K != 0 && late != nullptr) ||
      (plane_smem && !ring_smem) || smem > kMaxSmem || stride < need ||
      (need > 0 && scratch == nullptr) || nblocks < 1 || nblocks > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  Args a;
  a.ca = static_cast<const int*>(codes_a);
  a.la = static_cast<const int*>(lens_a);
  a.cb = static_cast<const int*>(codes_b);
  a.lb = static_cast<const int*>(lens_b);
  a.late = static_cast<const uint8_t*>(late);
  a.B = B;
  a.M = M;
  a.N = N;
  a.mm = mismatch;
  a.gp = gap;
  a.efb = ends_free_b ? 1 : 0;
  a.off_lo = off_lo;
  a.K = K;
  a.ring_smem = ring_smem ? 1 : 0;
  a.plane_smem = plane_smem ? 1 : 0;
  a.ring_bytes = ring_bytes;
  a.plane_bytes = plane_bytes;
  a.scratch = need > 0 ? static_cast<uint8_t*>(scratch) : nullptr;
  a.stride = stride;
  a.cost = static_cast<int*>(cost);
  a.endj = static_cast<int*>(endj);
  a.ops = static_cast<uint8_t*>(ops);
  // lanes a diagonal: the band, or the rectangle's widest diagonal
  const int widest = K ? K : min(M, N) + 1;
  const int threads = min(kMaxThreads, max(32, (widest + 31) / 32 * 32));
  cudaStream_t s = (cudaStream_t)stream;
  if (K) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(traceback_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    traceback_kernel<true><<<(unsigned)nblocks, threads, (size_t)smem, s>>>(a);
  } else {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(traceback_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    traceback_kernel<false><<<(unsigned)nblocks, threads, (size_t)smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The unbanded form on traceback_warp_kernel: codes_a [B, M], codes_b
// [B, N] int32 (anything past each length); lens_a, lens_b [B] int32 in
// [0, M] and [0, N]; late [B] bytes or null; N + 1 <= 1,024 and a warp's
// plane and ops buffer ((M + 1) 128 ceil(C / 8) + M + N rounded up to 16
// bytes) within 227 KB. Outputs cost, endj [B] int32 and ops [B, M + N]
// bytes.
extern "C" int bn_traceback_warp(const void* codes_a, const void* lens_a, const void* codes_b,
                                 const void* lens_b, const void* late, int64_t B, int M, int N,
                                 int mismatch, int gap, int ends_free_b, void* cost, void* endj,
                                 void* ops, void* stream) {
  const int C = (N >= 0 && N < 1024) ? warp_cells(N + 1) : 0;
  const int64_t stride = C ? (int64_t)(M + 1) * 128 * ((C + 7) / 8) +
                                 ((int64_t)M + N + 15) / 16 * 16
                           : 0;
  if (B < 0 || M < 0 || C == 0 || (int64_t)M + N > INT_MAX / 2 || stride > kWarpMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  WarpArgs a;
  a.ca = static_cast<const int*>(codes_a);
  a.la = static_cast<const int*>(lens_a);
  a.cb = static_cast<const int*>(codes_b);
  a.lb = static_cast<const int*>(lens_b);
  a.late = static_cast<const uint8_t*>(late);
  a.B = B;
  a.M = M;
  a.N = N;
  a.mm = mismatch;
  a.gp = gap;
  a.efb = ends_free_b ? 1 : 0;
  a.stride = (int)stride;
  a.nwarps = 0;
  a.cost = static_cast<int*>(cost);
  a.endj = static_cast<int*>(endj);
  a.ops = static_cast<uint8_t*>(ops);
  cudaStream_t s = (cudaStream_t)stream;
  int code = (int)cudaErrorInvalidValue;
  switch (C) {
#define BN_TB_CASE(c)               \
  case c:                           \
    code = launch_warp<c>(a, s);    \
    break;
    BN_TB_CELL_CASES(BN_TB_CASE)
#undef BN_TB_CASE
  }
  const int last = (int)cudaGetLastError();  // also clears a failed launch
  return code != 0 ? code : last;
}
