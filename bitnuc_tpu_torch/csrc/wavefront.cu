// K8 fit_banded, an anti-diagonal wavefront, and K9 sw_score, a row
// pipeline: the dynamic programs of ops/align.py, one warp per read pair.
//
// K8 replaces bitnuc_tpu/ops/pallas/wavefront.py::fit_distance_span_banded_pallas
// (its pallas_call at wavefront.py:315): the fitting alignment of read a into
// window b restricted to the band j - i in [off_lo, off_hi], returning
// (cost, start_j, end_j) with the earliest-end, smallest-start ties of
// ops.align.fit_distance_span_banded. K9 replaces sw_score_pallas (its
// pallas_call at wavefront.py:482): affine-gap Smith-Waterman over all N + 1
// lanes, (score, end_i, end_j) with max score, then the earliest diagonal,
// then the smallest j.
//
// Bound on the card: integer ALU and warp shuffles. A read is a chain of
// dependent steps of about 15 to 30 int32 operations per cell plus a few
// shuffles, and the inputs (a few dozen bytes per read) are read once.
//
// Common to both: one warp per read pair, cells in registers, lane L
// holding C consecutive cells (C a template parameter, the smallest of
// BN_CELL_CASES with 32 C >= the row's cells, so the arrays stay in
// registers). The warp unpacks its pair's 2-bit codes into shared memory
// once, padded with 4 (a) and 5 (b) as ops.align._codes pads them, and no
// [B, M + 2N] operand is ever made in device memory.
//
// K8, anti-diagonals: lane L holds band cells t = L C .. L C + C - 1 of
// the current and the two previous diagonals, with their span origins S,
// and each cell's codes of a at i - 1 and of b at j - 1. A cell's
// neighbours at band offsets -1, 0 and +1 are its own registers or one
// __shfl_up_sync / __shfl_down_sync of the next lane's edge cell, as the
// band slides (d1, d2) = (base(d) - base(d - 1), base(d) - base(d - 2))
// select them. The per-diagonal extraction at i = m is one shuffle from the
// lane that holds column j = d - m. A read stops at diagonal m + n, past
// which no cell reaches an output. Band cells the arithmetic must not see
// (t >= K) hold the sentinel, as out-of-band reads do in
// ops.align._band_shift, so every band cell equals the plain version's bit
// for bit.
//
// The slides and the boundary fixes are uniform across the warp and follow
// closed forms (off_lo <= 0 and top = N + 1 - K >= 1), so the diagonal loop
// runs in runs whose body takes them as template parameters:
//   d <= -off_lo:                  base 0, (d1, d2) = (0, 0);
//   -off_lo < d <= 2 top - off_lo: d2 = 1 and d1 = (d + off_lo) & 1, so
//                                  (1, 1) and (0, 1) alternate, two
//                                  diagonals a step;
//   d > 2 top - off_lo:            base top, (0, 0).
// A diagonal needs the fixes (j == 0, j == d, j > d) only while base(d) = 0
// or d - base(d) < K. d - base(d) never decreases, so they end at the fix
// prefix's last diagonal: the largest of -off_lo, 2 K - 1 + off_lo (in the
// alternating range) and N (in the top range); past it the bodies drop
// them, and keep the sentinel. A diagonal that a run cannot pair (the odd
// end of a run, or a run starting on (0, 1)) is a seam and goes through the
// generic body, which reads d1 and d2 at run time and applies every fix.
// At the mapper's band (-32, 124), N 240: 1-32 base 0 with fixes, 33-126
// alternating with row-0 fixes, seams 127 and 128, 129-354 alternating and
// 355-390 at top without fixes. A pair swaps the roles of the registers of
// d - 1 and d - 2, so nothing is copied between diagonals. The codes slide
// with the band: a diagonal with d1 = 1 shifts b's by one cell, one with
// d1 = 0 shifts a's, and each lane reads from shared memory the one code
// that enters its cells (the generic body reads all of them). At C = 32
// (K > 768) the state fills the register file, and the cells read their
// codes from shared memory instead.
//
// K9, a row pipeline: lane L holds columns j = L C .. L C + C - 1 of the
// full row (N + 1 columns), and the warp sweeps the rows of a with lane L
// working row i = s - L at step s, so no lane computes a cell outside the
// matrix, as a sweep of anti-diagonals over all 32 C lanes would (at M 160,
// N 224: 374 diagonals against 178 steps). A lane keeps the previous row's H
// and F of its columns, its C codes of b, and one E running across its
// columns; a step reads one code of a from shared memory. At the start of
// step s, one __shfl_up_sync each carries H[i][L C - 1] and E[i][L C - 1]
// from lane L - 1 (made at step s - 1) into column L C's h_left and e_left;
// the h_left received one step earlier is its h_diag. Lane 0's column -1 is
// -kBig, as _shift1 fills, and column 0 and row 0 are the boundary (H = 0,
// no gap state). Each cell runs the plain version's operations in its order,
// so the cells equal it bit for bit. A cell counts iff 1 <= i <= m, 1 <= j
// <= min(n, N) and i + j <= M + N (the plain version's last diagonal); the
// warp stops after step min(m, M + N - 1) + (lane of column min(n, N)). The
// plain version keeps the first strictly greater diagonal maximum and its
// smallest j: over counted cells with h > 0, the lexicographic best (largest
// h, smallest i + j, smallest j). Each lane finds its row's largest h and
// first column holding it, folds that into its own (score, i + j, j) by that
// order, and at the end the warp takes one __reduce_max_sync of the score
// and __reduce_min_sync of i + j and j among the lanes that hold it; (0, 0,
// 0) when no cell is positive.
//
// Rows wider than 32 x 32 cells (or codes too long for shared memory) take
// the wide kernels: the same recurrence, one warp per read, but the last
// three diagonals live in a per-warp ring in global scratch (the caller
// allocates nwarps rings, and the warps stride over the reads), lane L
// works cells L, L + 32, ... of a diagonal, a __syncwarp separates
// diagonals, and the codes are read from the packed words. They are slower
// per cell and serve inputs the register kernels cannot hold.
//
// Costs and scores are any int32 values. Every sum and product of a cell
// wraps modulo 2^32 (wadd, wmul: unsigned arithmetic cast back), as the
// plain versions' int32 tensors and the JAX package's int32 arrays do;
// signed overflow would be undefined in C++.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kPadA = 4;
constexpr int kPadB = 5;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxSmem = 227 * 1024;

// a + b and a * b modulo 2^32, as int32 tensors compute them.
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// Codes [0, 16 W) of one packed row into shared memory; `pad` at and past
// `len`.
__device__ __forceinline__ void unpack_row(const uint32_t* __restrict__ words,
                                           int W, int len, uint8_t pad,
                                           uint8_t* out, int lane) {
  for (int x = lane; x < 16 * W; x += 32) {
    const uint32_t w = __ldg(words + (x >> 4));
    out[x] = x < len ? (uint8_t)((w >> (2 * (x & 15))) & 3u) : pad;
  }
}

// Code of a at i - 1 and of b at j - 1 (the sentinels outside [0, M) and
// [0, N), as ops.align._rev_padded and _b_shifted give them).
__device__ __forceinline__ int code_a(const uint8_t* sa, int M, int x) {
  return (x >= 0 && x < M) ? sa[x] : kPadA;
}
__device__ __forceinline__ int code_b(const uint8_t* sb, int N, int y) {
  return (y >= 0 && y < N) ? sb[y] : kPadB;
}

// x[c + o] for a uniform offset o in {-1, 0, 1}: the lane's own register or
// the edge cell of the lane before (l) or after (r).
template <int C>
__device__ __forceinline__ int at_off(const int (&x)[C], int c, int o, int l, int r) {
  const int k = c + o;
  return k < 0 ? l : (k >= C ? r : x[k < 0 ? 0 : (k >= C ? C - 1 : k)]);
}

// The band slides of a diagonal against the two before it, (d1, d2) =
// (base(d) - base(d - 1), base(d) - base(d - 2)): (0, 0), (1, 1), (0, 1),
// or read at run time (the generic body).
enum Slide { kSlide00, kSlide11, kSlide01, kSlideAny };

// What every diagonal of one read shares. Cells c >= live of a lane have
// t >= K.
struct FitRead {
  const uint8_t* sa;
  const uint8_t* sb;
  int M, N, m, n, mm, gp, K, t0, live, lane;
};

// Diagonal d of fit_banded_kernel<C>: the lane's band cells from (p, ps) of
// d - 1 and (q, qs) of d - 2, written over (q, qs), then the extraction of
// the cell (i = m, j = d - m). SLIDE fixes d1 and d2 at compile time, so
// the body shuffles only the neighbours it reads; FIX applies the boundary
// fixes j == 0, j == d and j > d. kSlideAny reads d1 and d2 and applies
// every fix: the body of any diagonal. (ca, cb) hold each cell's codes of
// a at i - 1 and of b at j - 1, those of d - 1 on entry and of d on exit.
template <int C, Slide SLIDE, bool FIX>
__device__ __forceinline__ void fit_diagonal(const FitRead& f, int d, int bd, int d1,
                                             int d2, const int (&p)[C],
                                             const int (&ps)[C], int (&q)[C],
                                             int (&qs)[C], int (&ca)[C], int (&cb)[C],
                                             int& fit, int& ej, int& sj) {
  constexpr bool kAny = SLIDE == kSlideAny;
  // Codes in registers take 2 C of them; at C = 32 (K > 768) the state
  // fills the register file, and the cells read shared memory instead.
  constexpr bool kRegCodes = C < 32;
  // A diagonal with d1 = 1 moves every cell's j up by one and keeps i, so
  // b's codes slide down a cell; one with d1 = 0 moves every i up by one
  // and keeps j, so a's codes slide up a cell. Each lane reads the one code
  // that enters its cells; the generic body reads them all.
  if constexpr (kRegCodes && kAny) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      ca[c] = code_a(f.sa, f.M, d - bd - f.t0 - c - 1);
      cb[c] = code_b(f.sb, f.N, bd + f.t0 + c - 1);
    }
  } else if constexpr (kRegCodes && SLIDE == kSlide11) {
#pragma unroll
    for (int c = 0; c < C - 1; ++c) cb[c] = cb[c + 1];
    cb[C - 1] = code_b(f.sb, f.N, bd + f.t0 + C - 2);
  } else if constexpr (kRegCodes) {
#pragma unroll
    for (int c = C - 1; c > 0; --c) ca[c] = ca[c - 1];
    ca[0] = code_a(f.sa, f.M, d - bd - f.t0 - 1);
  }
  // the edge cells of the lanes before (l) and after (r): d - 1 at offset -1
  // (left, d1 = 0) and +1 (up, d1 = 1); d - 2 at -1 (diag, d2 = 0) and +1
  // (d2 = 2)
  int pl = kBig, pr = kBig, sl = kBig, sr = kBig;
  int ql = kBig, qr = kBig, ul = kBig, ur = kBig;
  if constexpr (SLIDE != kSlide11) {
    pl = __shfl_up_sync(kFull, p[C - 1], 1);
    sl = __shfl_up_sync(kFull, ps[C - 1], 1);
  }
  if constexpr (kAny || SLIDE == kSlide11) {
    pr = __shfl_down_sync(kFull, p[0], 1);
    sr = __shfl_down_sync(kFull, ps[0], 1);
  }
  if constexpr (kAny || SLIDE == kSlide00) {
    ql = __shfl_up_sync(kFull, q[C - 1], 1);
    ul = __shfl_up_sync(kFull, qs[C - 1], 1);
  }
  if constexpr (kAny) {
    qr = __shfl_down_sync(kFull, q[0], 1);
    ur = __shfl_down_sync(kFull, qs[0], 1);
  }
  if (f.lane == 0) pl = sl = ql = ul = kBig;
  if (f.lane == 31) pr = sr = qr = ur = kBig;
  int nd[C], ns[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = f.t0 + c;
    const int j = bd + t;
    const int i = d - j;
    // up reads band cell t + d1 of d-1, left t + d1 - 1, diag t + d2 - 1
    // of d-2 (ops.align._band_shift with lag 0, 1, 1)
    int up, s_up, left, s_left, dg, s_dg;
    if constexpr (kAny) {
      up = d1 ? at_off<C>(p, c, 1, pl, pr) : p[c];
      s_up = d1 ? at_off<C>(ps, c, 1, sl, sr) : ps[c];
      left = d1 ? p[c] : at_off<C>(p, c, -1, pl, pr);
      s_left = d1 ? ps[c] : at_off<C>(ps, c, -1, sl, sr);
      dg = d2 == 0 ? at_off<C>(q, c, -1, ql, qr)
                   : (d2 == 1 ? q[c] : at_off<C>(q, c, 1, ql, qr));
      s_dg = d2 == 0 ? at_off<C>(qs, c, -1, ul, ur)
                     : (d2 == 1 ? qs[c] : at_off<C>(qs, c, 1, ul, ur));
    } else {
      constexpr int o1 = SLIDE == kSlide11 ? 1 : 0;  // d1
      constexpr int o2 = SLIDE == kSlide00 ? 0 : 1;  // d2
      up = at_off<C>(p, c, o1, pl, pr);
      s_up = at_off<C>(ps, c, o1, sl, sr);
      left = at_off<C>(p, c, o1 - 1, pl, pr);
      s_left = at_off<C>(ps, c, o1 - 1, sl, sr);
      dg = at_off<C>(q, c, o2 - 1, ql, qr);
      s_dg = at_off<C>(qs, c, o2 - 1, ul, ur);
    }
    const bool same = kRegCodes ? ca[c] == cb[c]
                                : code_a(f.sa, f.M, i - 1) == code_b(f.sb, f.N, j - 1);
    const int sub = same ? 0 : f.mm;
    const int c_diag = wadd(dg, sub), c_up = wadd(up, f.gp), c_left = wadd(left, f.gp);
    int D = min(min(c_diag, c_up), c_left);
    int S = min(min(c_diag == D ? s_dg : kBig, c_up == D ? s_up : kBig),
                c_left == D ? s_left : kBig);
    if constexpr (kAny || FIX) {
      if (j == 0) {
        D = wmul(d, f.gp);
        S = 0;
      }
      if (j == d) {  // free b-prefix: D[0, j] = 0, the path enters at j
        D = 0;
        S = j;
      }
      if (j > d) D = kBig;  // i < 0: no such cell
    }
    if (c >= f.live) {  // t >= K
      D = kBig;
      S = kBig;
    }
    nd[c] = D;
    ns[c] = S;
  }
  // the cell (i = m, j = d - m), if the band holds it
  const int jm = d - f.m;
  const int th = jm - bd;
  if (jm >= 0 && jm <= f.n && th >= 0 && th < f.K) {
    int v = kBig, st = kBig;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (f.t0 + c == th) {
        v = nd[c];
        st = ns[c];
      }
    }
    v = __shfl_sync(kFull, v, th / C);
    st = __shfl_sync(kFull, st, th / C);
    if (v < fit) {  // strict: the earliest diagonal (smallest end) wins
      fit = v;
      ej = jm;
      sj = st;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    q[c] = nd[c];
    qs[c] = ns[c];
  }
}

// `pairs` pairs of diagonals from d on, the first of each with slide SA at
// base bd, the second with SB at the same base; bd grows by `step` a pair.
// The two diagonals swap the roles of (p, ps) and (q, qs), so the arrays
// hold d - 1 and d - 2 again after each pair and nothing is copied.
template <int C, Slide SA, Slide SB, bool FIX>
__device__ __forceinline__ void fit_pairs(const FitRead& f, int& d, int pairs, int bd,
                                          int step, int (&p)[C], int (&ps)[C],
                                          int (&q)[C], int (&qs)[C], int (&ca)[C],
                                          int (&cb)[C], int& fit, int& ej, int& sj) {
  for (int k = 0; k < pairs; ++k, d += 2, bd += step) {
    fit_diagonal<C, SA, FIX>(f, d, bd, 0, 0, p, ps, q, qs, ca, cb, fit, ej, sj);
    fit_diagonal<C, SB, FIX>(f, d + 1, bd, 0, 0, q, qs, p, ps, ca, cb, fit, ej, sj);
  }
}

template <int C>
__global__ void fit_banded_kernel(const uint32_t* __restrict__ wa,
                                  const int* __restrict__ la,
                                  const uint32_t* __restrict__ wb,
                                  const int* __restrict__ lb, int64_t B, int Wa,
                                  int Wb, int mm, int gp, int off_lo, int K,
                                  int smem_stride, int* __restrict__ cost,
                                  int* __restrict__ startj,
                                  int* __restrict__ endj) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= B) return;  // the whole warp leaves together
  const int M = 16 * Wa, N = 16 * Wb, T = M + N;
  uint8_t* sa = smem + warp * smem_stride;
  uint8_t* sb = sa + M;
  const int m = la[r], n = lb[r];
  unpack_row(wa + r * Wa, Wa, m, kPadA, sa, lane);
  unpack_row(wb + r * Wb, Wb, n, kPadB, sb, lane);
  __syncwarp();

  const int top = N + 1 - K > 0 ? N + 1 - K : 0;
  auto base = [&](int d) {
    const int v = (d + off_lo + 1) >> 1;  // floor division by 2
    return v < 0 ? 0 : (v > top ? top : v);
  };
  const int t0 = lane * C;
  const FitRead f{sa, sb, M, N, m, n, mm, gp, K, t0, K - t0, lane};
  int p[C], ps[C], q[C], qs[C];  // D and S of diagonals d-1, d-2
  int ca[C], cb[C];              // codes of a at i - 1, b at j - 1
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = t0 + c;
    p[c] = (t == 0) ? 0 : kBig;  // d = 0: D[0, 0] = 0
    ps[c] = t < K ? t : kBig;    // S[0, j] = j
    q[c] = kBig;
    qs[c] = t < K ? 0 : kBig;
    ca[c] = code_a(sa, M, -t - 1);  // d = 0, base 0: i = -t, j = t
    cb[c] = code_b(sb, N, t - 1);
  }
  int fit = (m == 0) ? 0 : kBig, ej = 0, sj = 0;
  const int d_end = min(T, m + n);
  // The runs (see the header): base(d) = 0 up to p1, alternating slides up
  // to p2, top after; boundary fixes up to fix_end.
  const int p1 = -off_lo, p2 = 2 * top - off_lo;
  int fix_end = max(p1, min(p2, 2 * K - 1 + off_lo));
  if (N > p2) fix_end = max(fix_end, N);
  int d = 1;
  while (d <= d_end) {
    const bool fix = d <= fix_end;
    const bool alt = d > p1 && d <= p2;
    int hi = fix ? min(d_end, fix_end) : d_end;
    if (d <= p1) {
      hi = min(hi, p1);
    } else if (alt) {
      hi = min(hi, p2);
    }
    int pairs = (hi - d + 1) >> 1;
    // a run of alternating slides pairs (1, 1) with (0, 1); the closed
    // forms need off_lo <= 0, as ops.align._band_geometry asserts
    if ((alt && ((d + off_lo) & 1) == 0) || off_lo > 0) pairs = 0;
    if (pairs == 0) {  // a seam: one diagonal of the generic body
      const int bd = base(d);
      fit_diagonal<C, kSlideAny, true>(f, d, bd, bd - base(d - 1), bd - base(d - 2), p,
                                       ps, q, qs, ca, cb, fit, ej, sj);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int x = p[c], y = ps[c];
        p[c] = q[c];
        ps[c] = qs[c];
        q[c] = x;
        qs[c] = y;
      }
      ++d;
    } else if (alt) {
      const int bd = (d + off_lo + 1) >> 1;
      if (fix) {
        fit_pairs<C, kSlide11, kSlide01, true>(f, d, pairs, bd, 1, p, ps, q, qs, ca, cb,
                                               fit, ej, sj);
      } else {
        fit_pairs<C, kSlide11, kSlide01, false>(f, d, pairs, bd, 1, p, ps, q, qs, ca, cb,
                                                fit, ej, sj);
      }
    } else {
      const int bd = d <= p1 ? 0 : top;
      if (fix) {
        fit_pairs<C, kSlide00, kSlide00, true>(f, d, pairs, bd, 0, p, ps, q, qs, ca, cb,
                                               fit, ej, sj);
      } else {
        fit_pairs<C, kSlide00, kSlide00, false>(f, d, pairs, bd, 0, p, ps, q, qs, ca, cb,
                                                fit, ej, sj);
      }
    }
  }
  if (lane == 0) {
    cost[r] = fit;
    endj[r] = ej;
    startj[r] = fit < kBig ? min(sj, ej) : 0;
  }
}

template <int C>
__global__ void sw_kernel(const uint32_t* __restrict__ wa,
                          const int* __restrict__ la,
                          const uint32_t* __restrict__ wb,
                          const int* __restrict__ lb, int64_t B, int Wa, int Wb,
                          int match, int mismatch, int go, int ge,
                          int smem_stride, int* __restrict__ score,
                          int* __restrict__ end_i, int* __restrict__ end_j) {
  extern __shared__ uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= B) return;
  const int M = 16 * Wa, N = 16 * Wb, T = M + N;
  uint8_t* sa = smem + warp * smem_stride;
  uint8_t* sb = sa + M;
  const int m = la[r], n = lb[r];
  unpack_row(wa + r * Wa, Wa, m, kPadA, sa, lane);
  unpack_row(wb + r * Wb, Wb, n, kPadB, sb, lane);
  __syncwarp();

  const int t0 = lane * C;  // lane L holds columns j = t0 .. t0 + C - 1
  int hp[C], fp[C], cb[C];  // H and F of the lane's last row, b's codes
#pragma unroll
  for (int c = 0; c < C; ++c) {
    hp[c] = 0;  // row 0: H = 0, no gap state
    fp[c] = -kBig;
    cb[c] = code_b(sb, N, t0 + c - 1);
  }
  // Every cell in range lies in rows 1 .. rows and columns 1 .. jn; lane L
  // works row s - L at step s, so the lane of column jn ends the pair.
  const int rows = min(m, T - 1), jn = min(n, N);
  const int steps = (rows > 0 && jn > 0) ? rows + jn / C : 0;
  int hlast = 0, elast = -kBig;  // H and E of column t0 + C - 1, last row
  int hdiag = 0;                 // H[i - 1][t0 - 1] for the next row i
  int best = 0, bd = 0, bj = 0;  // the lane's best: score, then i + j, j
  for (int s = 1; s <= steps; ++s) {
    // H[i][t0 - 1] and E[i][t0 - 1], which lane L - 1 made at step s - 1
    int hl = __shfl_up_sync(kFull, hlast, 1);
    int el = __shfl_up_sync(kFull, elast, 1);
    if (lane == 0) hl = el = -kBig;  // x[j - 1] at j = 0
    const int i = s - lane;
    if (i >= 1 && i <= rows) {
      const int ca = code_a(sa, M, i - 1);
      const int cl = min(jn, T - i) - t0;  // columns c <= cl are in range
      int h_left = hl, e_left = el, h_diag = hdiag, rbest = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int sc = ca == cb[c] ? match : mismatch;
        int e = max(wadd(h_left, go), wadd(e_left, ge));
        int f = max(wadd(hp[c], go), wadd(fp[c], ge));
        int h = max(max(wadd(h_diag, sc), 0), max(e, f));
        if (c == 0 && lane == 0) {  // column 0: H = 0, no gap state
          h = 0;
          e = -kBig;
          f = -kBig;
        }
        h_diag = hp[c];
        hp[c] = h;
        fp[c] = f;
        h_left = h;
        e_left = e;
        if (c <= cl) rbest = max(rbest, h);
      }
      hlast = h_left;
      elast = e_left;
      if (rbest > 0 && rbest >= best) {
        int rj = 0;  // the row's first column holding rbest
#pragma unroll
        for (int c = C - 1; c >= 0; --c) {
          if (c <= cl && hp[c] == rbest) rj = t0 + c;
        }
        const int rd = i + rj;
        if (rbest > best || rd < bd || (rd == bd && rj < bj)) {
          best = rbest;
          bd = rd;
          bj = rj;
        }
      }
    }
    hdiag = hl;
  }
  // the largest score, then the smallest i + j, then the smallest j; no
  // positive cell leaves every lane at (0, 0, 0)
  const int top = __reduce_max_sync(kFull, best);
  const int td = __reduce_min_sync(kFull, best == top ? bd : INT_MAX);
  const int tj = __reduce_min_sync(kFull, best == top && bd == td ? bj : INT_MAX);
  if (lane == 0) {
    score[r] = top;
    end_i[r] = td - tj;
    end_j[r] = tj;
  }
}

// Code x of a packed row of length len, `pad` outside [0, len).
__device__ __forceinline__ int code_at(const uint32_t* __restrict__ words,
                                       int len, int pad, int x) {
  return (x >= 0 && x < len)
             ? (int)((__ldg(words + (x >> 4)) >> (2 * (x & 15))) & 3u)
             : pad;
}

// x[k], or the sentinel for a band cell outside [0, K).
__device__ __forceinline__ int ring_at(const int* x, int k, int K) {
  return (k >= 0 && k < K) ? x[k] : kBig;
}

// fit_banded_kernel for any K: the ring holds D then S of three diagonals,
// 6 K ints per warp; diagonal d lives in slot d % 3.
__global__ void fit_banded_wide_kernel(const uint32_t* __restrict__ wa,
                                       const int* __restrict__ la,
                                       const uint32_t* __restrict__ wb,
                                       const int* __restrict__ lb, int64_t B,
                                       int Wa, int Wb, int mm, int gp,
                                       int off_lo, int K, int* __restrict__ scratch,
                                       int64_t nwarps, int* __restrict__ cost,
                                       int* __restrict__ startj,
                                       int* __restrict__ endj) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (gw >= nwarps) return;
  int* Dr = scratch + gw * 6 * (int64_t)K;
  int* Sr = Dr + 3 * (int64_t)K;
  const int M = 16 * Wa, N = 16 * Wb, T = M + N;
  const int top = N + 1 - K > 0 ? N + 1 - K : 0;
  auto base = [&](int d) {
    const int v = (d + off_lo + 1) >> 1;
    return v < 0 ? 0 : (v > top ? top : v);
  };
  for (int64_t r = gw; r < B; r += nwarps) {
    const uint32_t* ra = wa + r * Wa;
    const uint32_t* rb = wb + r * Wb;
    const int m = la[r], n = lb[r];
    const int ma = min(m, M), nb = min(n, N);
    for (int t = lane; t < K; t += 32) {
      Dr[t] = (t == 0) ? 0 : kBig;  // d = 0 in slot 0
      Sr[t] = t;
      Dr[2 * K + t] = kBig;  // d = -1 in slot 2
      Sr[2 * K + t] = 0;
    }
    __syncwarp();
    int fit = (m == 0) ? 0 : kBig, ej = 0, sj = 0;
    const int d_end = min(T, m + n);
    int b1 = base(0), b2 = base(-1);
    for (int d = 1; d <= d_end; ++d) {
      const int bd = base(d);
      const int d1 = bd - b1, d2 = bd - b2;
      const int cur = d % 3, p1 = (d + 2) % 3, p2 = (d + 1) % 3;
      const int* P = Dr + p1 * K;
      const int* Q = Dr + p2 * K;
      const int* SP = Sr + p1 * K;
      const int* SQ = Sr + p2 * K;
      int* ND = Dr + cur * K;
      int* NS = Sr + cur * K;
      for (int t = lane; t < K; t += 32) {
        const int j = bd + t;
        const int i = d - j;
        const int up = ring_at(P, t + d1, K), s_up = ring_at(SP, t + d1, K);
        const int left = ring_at(P, t + d1 - 1, K), s_left = ring_at(SP, t + d1 - 1, K);
        const int dg = ring_at(Q, t + d2 - 1, K), s_dg = ring_at(SQ, t + d2 - 1, K);
        const int sub = code_at(ra, ma, kPadA, i - 1) == code_at(rb, nb, kPadB, j - 1) ? 0 : mm;
        const int c_diag = wadd(dg, sub), c_up = wadd(up, gp), c_left = wadd(left, gp);
        int D = min(min(c_diag, c_up), c_left);
        int S = min(min(c_diag == D ? s_dg : kBig, c_up == D ? s_up : kBig),
                    c_left == D ? s_left : kBig);
        if (j == 0) {
          D = wmul(d, gp);
          S = 0;
        }
        if (j == d) {
          D = 0;
          S = j;
        }
        if (j > d) D = kBig;
        ND[t] = D;
        NS[t] = S;
      }
      __syncwarp();
      const int jm = d - m;
      const int th = jm - bd;
      if (jm >= 0 && jm <= n && th >= 0 && th < K) {
        const int v = ND[th];
        if (v < fit) {
          fit = v;
          ej = jm;
          sj = NS[th];
        }
      }
      b2 = b1;
      b1 = bd;
    }
    if (lane == 0) {
      cost[r] = fit;
      endj[r] = ej;
      startj[r] = fit < kBig ? min(sj, ej) : 0;
    }
    __syncwarp();  // every lane has read the ring before the next read fills it
  }
}

// sw_kernel for any N: the ring holds H of three diagonals, then E and F of
// two, 7 (N + 1) ints per warp.
__global__ void sw_wide_kernel(const uint32_t* __restrict__ wa,
                               const int* __restrict__ la,
                               const uint32_t* __restrict__ wb,
                               const int* __restrict__ lb, int64_t B, int Wa,
                               int Wb, int match, int mismatch, int go, int ge,
                               int* __restrict__ scratch, int64_t nwarps,
                               int* __restrict__ score, int* __restrict__ end_i,
                               int* __restrict__ end_j) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (gw >= nwarps) return;
  const int M = 16 * Wa, N = 16 * Wb, T = M + N, L = N + 1;
  int* H = scratch + gw * 7 * (int64_t)L;  // slot d % 3
  int* E = H + 3 * (int64_t)L;              // slot d % 2
  int* F = E + 2 * (int64_t)L;
  for (int64_t r = gw; r < B; r += nwarps) {
    const uint32_t* ra = wa + r * Wa;
    const uint32_t* rb = wb + r * Wb;
    const int m = la[r], n = lb[r];
    const int ma = min(m, M), nb = min(n, N);
    for (int j = lane; j < L; j += 32) {
      H[j] = 0;          // d = 0
      H[2 * L + j] = 0;  // d = -1
      E[j] = -kBig;
      F[j] = -kBig;
    }
    __syncwarp();
    int best = 0, bi = 0, bj = 0;
    const int d_end = min(T, m + n);
    for (int d = 1; d <= d_end; ++d) {
      const int* hp = H + ((d + 2) % 3) * L;
      const int* hp2 = H + ((d + 1) % 3) * L;
      const int* ep = E + ((d + 1) & 1) * L;
      const int* fp = F + ((d + 1) & 1) * L;
      int* nh = H + (d % 3) * L;
      int* ne = E + (d & 1) * L;
      int* nf = F + (d & 1) * L;
      int lbest = -1, lj = N + 1;
      for (int j = lane; j < L; j += 32) {
        const int i = d - j;
        const int h_left = j ? hp[j - 1] : -kBig;
        const int e_left = j ? ep[j - 1] : -kBig;
        const int h_diag = j ? hp2[j - 1] : -kBig;
        const int s = code_at(ra, ma, kPadA, i - 1) == code_at(rb, nb, kPadB, j - 1)
                          ? match : mismatch;
        int e = max(wadd(h_left, go), wadd(e_left, ge));
        int f = max(wadd(hp[j], go), wadd(fp[j], ge));
        int h = max(max(wadd(h_diag, s), 0), max(e, f));
        if (j == 0 || j == d) {
          h = 0;
          e = -kBig;
          f = -kBig;
        }
        nh[j] = h;
        ne[j] = e;
        nf[j] = f;
        const bool in_range = j >= 1 && j <= n && i >= 1 && i <= m;
        const int hm = in_range ? h : -1;
        if (hm > lbest) {  // columns ascend within a lane: keep the first
          lbest = hm;
          lj = j;
        }
      }
      const int row_best = __reduce_max_sync(kFull, lbest);
      const int row_j = __reduce_min_sync(kFull, lbest == row_best ? lj : N + 1);
      if (row_best > best) {
        best = row_best;
        bj = row_j;
        bi = d - row_j;
      }
      __syncwarp();  // diagonal d is whole before d + 1 reads it
    }
    if (lane == 0) {
      score[r] = best;
      end_i[r] = bi;
      end_j[r] = bj;
    }
    __syncwarp();
  }
}

// Warps per block and the dynamic shared memory of a launch: each warp
// holds its pair's M + N codes (rounded up to 4 bytes).
bool launch_shape(int Wa, int Wb, int* stride, int* warps, size_t* smem) {
  *stride = (16 * (Wa + Wb) + 3) & ~3;
  if (*stride > kMaxSmem) return false;
  *warps = kMaxWarpsPerBlock;
  while (*warps > 1 && *warps * *stride > 48 * 1024) --*warps;
  *smem = (size_t)*warps * *stride;
  return true;
}

template <typename Kern>
int run(Kern kernel, int64_t B, int warps, size_t smem, cudaStream_t s,
        const void* const* args) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const unsigned blocks = (unsigned)((B + warps - 1) / warps);
  return (int)cudaLaunchKernel((const void*)kernel, dim3(blocks),
                               dim3(32 * warps), const_cast<void**>(args), smem, s);
}

// The cells per lane a launch uses: the smallest instantiated C with
// 32 C >= lanes, or 0 when there is none.
int cells_per_lane(int lanes) {
  static const int kC[] = {1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32};
  for (int c : kC) {
    if (32 * c >= lanes) return c;
  }
  return 0;
}

#define BN_CELL_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(12) X(16) X(24) X(32)

}  // namespace

// words_a [B, Wa], words_b [B, Wb] uint32; lens_a, lens_b, the three
// outputs [B] int32; K band lanes, K < 16 Wb + 1. nwarps == 0 runs the
// register kernel (K <= 1024, codes within shared memory); nwarps > 0 runs
// the wide kernel with nwarps warps and scratch of nwarps * 6 K ints.
extern "C" int bn_fit_banded(const void* words_a, const void* lens_a,
                             const void* words_b, const void* lens_b, int64_t B,
                             int Wa, int Wb, int mismatch, int gap, int off_lo,
                             int K, void* scratch, int64_t nwarps, void* cost,
                             void* startj, void* endj, void* stream) {
  if (B < 0 || Wa < 0 || Wb < 1 || K < 2 || K >= 16 * Wb + 1 || nwarps < 0 ||
      (nwarps > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int code = (int)cudaErrorInvalidValue;
  if (nwarps > 0) {
    const void* args[] = {&words_a, &lens_a, &words_b, &lens_b, &B,   &Wa,
                          &Wb,      &mismatch, &gap,  &off_lo, &K,  &scratch,
                          &nwarps,  &cost,   &startj,  &endj};
    code = run(fit_banded_wide_kernel, nwarps, kMaxWarpsPerBlock, 0, s, args);
  } else {
    int stride = 0, warps = 0;
    size_t smem = 0;
    const int C = cells_per_lane(K);
    if (C == 0 || !launch_shape(Wa, Wb, &stride, &warps, &smem)) {
      return (int)cudaErrorInvalidValue;
    }
    const void* args[] = {&words_a, &lens_a, &words_b, &lens_b, &B,  &Wa,
                          &Wb,      &mismatch, &gap,  &off_lo, &K,  &stride,
                          &cost,    &startj,  &endj};
    switch (C) {
#define BN_FIT_CASE(c) \
  case c:              \
    code = run(fit_banded_kernel<c>, B, warps, smem, s, args); \
    break;
      BN_CELL_CASES(BN_FIT_CASE)
#undef BN_FIT_CASE
    }
  }
  const int last = (int)cudaGetLastError();  // also clears a failed launch
  return code != 0 ? code : last;
}

// words_a [B, Wa], words_b [B, Wb] uint32; lens_a, lens_b, the three
// outputs [B] int32; all 16 Wb + 1 lanes. nwarps == 0 runs the register
// kernel (16 Wb + 1 <= 1024, codes within shared memory); nwarps > 0 runs
// the wide kernel with nwarps warps and scratch of nwarps * 7 (16 Wb + 1)
// ints.
extern "C" int bn_sw_score(const void* words_a, const void* lens_a,
                           const void* words_b, const void* lens_b, int64_t B,
                           int Wa, int Wb, int match, int mismatch,
                           int gap_open, int gap_extend, void* scratch,
                           int64_t nwarps, void* score, void* end_i, void* end_j,
                           void* stream) {
  if (B < 0 || Wa < 0 || Wb < 0 || nwarps < 0 || (nwarps > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int code = (int)cudaErrorInvalidValue;
  if (nwarps > 0) {
    const void* args[] = {&words_a,  &lens_a,     &words_b, &lens_b, &B,
                          &Wa,       &Wb,         &match,   &mismatch,
                          &gap_open, &gap_extend, &scratch, &nwarps, &score,
                          &end_i,    &end_j};
    code = run(sw_wide_kernel, nwarps, kMaxWarpsPerBlock, 0, s, args);
  } else {
    int stride = 0, warps = 0;
    size_t smem = 0;
    const int C = cells_per_lane(16 * Wb + 1);
    if (C == 0 || !launch_shape(Wa, Wb, &stride, &warps, &smem)) {
      return (int)cudaErrorInvalidValue;
    }
    const void* args[] = {&words_a, &lens_a,   &words_b,  &lens_b, &B,
                          &Wa,      &Wb,       &match,    &mismatch,
                          &gap_open, &gap_extend, &stride, &score,
                          &end_i,   &end_j};
    switch (C) {
#define BN_SW_CASE(c) \
  case c:             \
    code = run(sw_kernel<c>, B, warps, smem, s, args); \
    break;
      BN_CELL_CASES(BN_SW_CASE)
#undef BN_SW_CASE
    }
  }
  const int last = (int)cudaGetLastError();  // also clears a failed launch
  return code != 0 ? code : last;
}
