// C2 traceback: the direction-recording wavefront of ops/align.py and its
// walk, the source of every CIGAR, on the card.
//
// Replaces no TPU kernel. bitnuc_tpu/ops/align.py::_wavefront_tb_codes
// (align.py:448) and _wavefront_tb_codes_banded (:585) are two lax.scans in
// one jit (a forward scan over the M + N diagonals that records a uint8
// candidate mask per cell, then a walk of M + N steps), which XLA compiles
// into device loops; eager PyTorch has no such loop. This kernel is both
// scans: (cost [B], end_j [B], ops [B, M + N] uint8 in forward order,
// OP_STOP-padded), equal bit for bit to the plain version
// (ops.align.align_ops_codes_torch / align_ops_codes_banded_torch) for
// lengths in [0, M] and [0, N].
//
// Bound on the card: integer ALU. A pair is a chain of m + n dependent
// diagonals of about 12 int32 operations a cell (the code compare and
// substitution select, three candidate sums, two mins, three tie compares
// and the mask), then a serial walk of at most m + n steps; the bytes are
// the codes, read once, and the ops, written once.
//
// Design (a simple first form): one block a pair (a grid-stride loop over
// the pairs where the plane lives in device memory). The threads stride
// over the lanes of a diagonal; the last three diagonals live in a ring in
// shared memory (slot d % 3), or in the block's slice of device scratch
// past what shared memory holds. One __syncthreads a diagonal. Each cell's
// 4-bit candidate mask (bit0 diag ties, bit1 up ties, bit2 left ties, bit3
// diag is a match) goes to a per-pair plane of bytes, in shared memory
// where the ring and plane fit in ops.align._TB_SMEM_BYTES, else in the
// block's scratch. Then thread 0 walks the plane with the op-continuation tie
// policy (continue an INS on bit 1 or a DEL on bit 2, else diag > up >
// left), writing the ops into the output row end first, and the block
// reverses the row in place and pads it with OP_STOP.
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
