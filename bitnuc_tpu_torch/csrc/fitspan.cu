// C3 fit_span: the unbanded anti-diagonal wavefront of ops/align.py on the
// card, in two forms chosen by a template flag.
//
// Replaces no TPU kernel. bitnuc_tpu/ops/align.py::fit_distance_span
// (align.py:218, the fit of map_reads_long's extend) and
// _distance_wavefront (:79, behind edit_distance, global_distance and
// fit_distance) are each one lax.scan over the M + N diagonals in a jit,
// which XLA compiles into one device loop; eager PyTorch has no such loop.
// The span form returns (cost [B], start_j [B], end_j [B]) as
// ops.align.fit_distance_span_torch does; the distance form (cost [B],
// end_j [B]) as ops.align._distance_wavefront_torch does, global or fitting
// with tie_late rows. Both equal their plain versions bit for bit for
// lengths in [0, 16 Wa] and [0, 16 Wb].
//
// Bound on the card: integer ALU. A pair is a chain of m + n dependent
// diagonals of about 15 int32 operations a cell in the span form (the code
// compare and substitution select, three candidate sums, two mins, three
// tie compares, three selects and two mins for the start column S), 7 in
// the distance form; the bytes are the packed words, read once, and three
// int32 outputs a pair.
//
// Design (a simple first form): one block a pair (a grid-stride loop over
// the pairs where the ring lives in device scratch). The block unpacks the
// pair's 2-bit codes a[0, m) and b[0, n) once into bytes in shared memory.
// The threads stride over the lanes j of a diagonal; the last three
// diagonals of the cost (and, in the span form, of S) live in a ring, slot
// d % 3, in shared memory, or in the block's slice of device scratch past
// ops.align._FIT_RING_SMEM_BYTES. One __syncthreads a diagonal.
//
// Live lanes only: a pair with lengths m, n computes the cells of the
// rectangle [0, m] x [0, n], diagonal d covering j in [max(0, d - m),
// min(n, d)], for d = 1 .. m + n. No cell of the rectangle depends on a cell
// outside it (up, left and diag stay inside), and every output is read off
// it: the fitting extraction at (m, d - m) with d - m <= n, the global
// answer at (m, n). So the codes past the lengths (the plain version's
// sentinels) are never read. The plain version's extraction is clamped
// (min over its lanes of where(at, D, 2^30)): the running fit starts at
// 2^30 or below, so a clamped candidate never changes it, and the kernel
// takes the cell's own D and S. The global answer is min(2^30, D(m, n)), 0
// when m + n = 0.
//
// Costs are any int32 values: every sum and product wraps modulo 2^32
// (wadd, wmul: unsigned arithmetic cast back), as the plain version's int32
// tensors and the JAX package's int32 arrays do, and the tie tests compare
// the wrapped values.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr int kMaxSmem = 227 * 1024 - 64;  // dynamic, beside the static words
constexpr int kMaxThreads = 512;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

struct Args {
  const int* wa;        // [B, Wa] packed words of a
  const int* la;        // [B] lengths of a
  const int* wb;        // [B, Wb] packed words of b
  const int* lb;        // [B] lengths of b
  const uint8_t* late;  // [B] tie_late, or null (the fitting distance form only)
  int64_t B;
  int Wa, Wb;
  int mm, gp;
  int efb;              // the distance form: 1 fitting, 0 global
  int ring_smem, codes_smem;
  int64_t ring_bytes;   // 12 (N + 1) a plane (span form: 2), rounded up to 16
  int64_t codes_a;      // bytes of a's codes: 16 Wa rounded up to 16
  uint8_t* scratch;     // per block: [ring unless ring_smem][codes unless codes_smem]
  int64_t stride;       // scratch bytes a block
  int* cost;
  int* startj;          // the span form only
  int* endj;
};

// 2-bit code k of a row of packed words (LSB first, 16 a word).
__device__ __forceinline__ uint8_t code_at(const int* row, int k) {
  return (uint8_t)((__ldg(row + (k >> 4)) >> (2 * (k & 15))) & 3);
}

// kSpan: the span form, with the start column S in a second ring plane;
// otherwise the distance form (p.efb: fitting, else global).
template <bool kSpan>
__global__ void __launch_bounds__(kMaxThreads) fit_span_kernel(const Args p) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_fit, s_start, s_end;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int M = 16 * p.Wa, N = 16 * p.Wb, lanes = N + 1;
  uint8_t* slice = p.scratch ? p.scratch + (int64_t)blockIdx.x * p.stride : nullptr;
  int* ring = reinterpret_cast<int*>(p.ring_smem ? smem : slice);
  uint8_t* ca = p.codes_smem ? smem + (p.ring_smem ? p.ring_bytes : 0)
                             : slice + (p.ring_smem ? 0 : p.ring_bytes);
  uint8_t* cb = ca + p.codes_a;
  for (int64_t r = blockIdx.x; r < p.B; r += gridDim.x) {
    // lengths outside [0, M] x [0, N] are refused by the wrapper; the clamps
    // only keep every access in bounds
    const int m = min(max(p.la[r], 0), M), n = min(max(p.lb[r], 0), N);
    const int* ra = p.wa + r * p.Wa;
    const int* rb = p.wb + r * p.Wb;
    const bool fits = kSpan || p.efb;
    const bool late = !kSpan && p.late != nullptr && p.late[r] != 0;
    for (int k = tid; k < m; k += nt) ca[k] = code_at(ra, k);
    for (int k = tid; k < n; k += nt) cb[k] = code_at(rb, k);
    if (tid == 0) {
      s_fit = fits ? (m == 0 ? 0 : kBig) : (m + n == 0 ? 0 : kBig);
      s_start = 0;
      s_end = fits ? 0 : n;
      ring[0] = 0;  // D[0, 0]; no other lane of d = 0 or d = -1 is read
      if (kSpan) ring[3 * lanes] = 0;  // S[0, 0]
    }
    __syncthreads();
    const int d_end = m + n;
    for (int d = 1; d <= d_end; ++d) {
      int* ND = ring + (d % 3) * lanes;
      const int* P = ring + ((d + 2) % 3) * lanes;  // diagonal d - 1
      const int* Q = ring + ((d + 1) % 3) * lanes;  // diagonal d - 2
      const int jlo = max(0, d - m), jhi = min(n, d);
      for (int j = jlo + tid; j <= jhi; j += nt) {
        const int i = d - j;
        int D, S = 0;
        if (j == 0) {
          D = wmul(d, p.gp);
        } else if (i == 0) {  // fits: a free b-prefix, D[0, j] = 0, a path entering at j
          D = fits ? 0 : wmul(d, p.gp);
          S = j;
        } else {  // codes in range: i <= m, j <= n
          const int c_diag = wadd(Q[j - 1], ca[i - 1] == cb[j - 1] ? 0 : p.mm);
          const int c_up = wadd(P[j], p.gp), c_left = wadd(P[j - 1], p.gp);
          D = min(min(c_diag, c_up), c_left);
          if (kSpan) {  // the smallest start over every candidate that attains D
            const int* SP = P + 3 * lanes;
            const int* SQ = Q + 3 * lanes;
            S = min(min(c_diag == D ? SQ[j - 1] : kBig, c_up == D ? SP[j] : kBig),
                    c_left == D ? SP[j - 1] : kBig);
          }
        }
        ND[j] = D;
        if (kSpan) ND[3 * lanes + j] = S;
        if (i == m) {  // (m, d - m): one lane a diagonal
          const int fit = s_fit;
          if (kSpan) {
            if (D < fit) {  // strict: the earliest end wins ties
              s_fit = D;
              s_end = j;
              s_start = S;
            }
          } else if (p.efb) {
            if (D < fit || (late && D == fit && D < kBig)) {  // tie_late: the latest
              s_fit = min(fit, D);
              s_end = j;
            }
          } else if (j == n) {  // d == m + n: the global answer, clamped
            s_fit = min(fit, D);
          }
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      const int fit = s_fit, end = s_end;
      p.cost[r] = fit;
      p.endj[r] = end;
      if (kSpan) p.startj[r] = fit < kBig ? min(s_start, end) : 0;
    }
    __syncthreads();  // the reads of s_* are done before the next pair
  }
}

}  // namespace

// words_a [B, Wa], words_b [B, Wb] int32 packed codes; lens_a, lens_b [B]
// int32 in [0, 16 Wa] and [0, 16 Wb]; span 1 for the span form, else the
// distance form, fitting where ends_free_b (late [B] bytes or null: the
// tie_late rows) and global otherwise (late null). The ring (12 (N + 1)
// bytes a plane, two planes in the span form, one in the distance form,
// rounded up to 16; N = 16 Wb) and the codes (16 Wa and 16 Wb bytes, each
// rounded up to 16) live in shared memory where ring_smem / codes_smem say
// so, else in the block's slice of scratch (stride bytes a block: the ring
// first when it is not in shared memory, then the codes); nblocks blocks
// stride over the pairs. Outputs cost and endj [B] int32 (n in the global
// form), and in the span form startj [B] int32 (null otherwise).
extern "C" int bn_fit_span(const void* words_a, const void* lens_a, const void* words_b,
                           const void* lens_b, const void* late, int64_t B, int Wa, int Wb,
                           int mismatch, int gap, int span, int ends_free_b, int ring_smem,
                           int codes_smem, void* scratch, int64_t stride, int64_t nblocks,
                           void* cost, void* startj, void* endj, void* stream) {
  const int64_t M = 16 * (int64_t)Wa, N = 16 * (int64_t)Wb;
  const int64_t ring_bytes = (12 * (span ? 2 : 1) * (N + 1) + 15) / 16 * 16;
  const int64_t codes_a = (M + 15) / 16 * 16;
  const int64_t codes_bytes = codes_a + (N + 15) / 16 * 16;
  const int64_t smem = (ring_smem ? ring_bytes : 0) + (codes_smem ? codes_bytes : 0);
  const int64_t need = (ring_smem ? 0 : ring_bytes) + (codes_smem ? 0 : codes_bytes);
  if (B < 0 || Wa < 0 || Wb < 0 || M + N > INT_MAX / 4 || smem > kMaxSmem || stride < need ||
      (need > 0 && scratch == nullptr) || nblocks < 1 || nblocks > INT_MAX ||
      (span && startj == nullptr) || (late != nullptr && (span || !ends_free_b))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return (int)cudaGetLastError();
  Args a;
  a.wa = static_cast<const int*>(words_a);
  a.la = static_cast<const int*>(lens_a);
  a.wb = static_cast<const int*>(words_b);
  a.lb = static_cast<const int*>(lens_b);
  a.late = static_cast<const uint8_t*>(late);
  a.B = B;
  a.Wa = Wa;
  a.Wb = Wb;
  a.mm = mismatch;
  a.gp = gap;
  a.efb = ends_free_b ? 1 : 0;
  a.ring_smem = ring_smem ? 1 : 0;
  a.codes_smem = codes_smem ? 1 : 0;
  a.ring_bytes = ring_bytes;
  a.codes_a = codes_a;
  a.scratch = need > 0 ? static_cast<uint8_t*>(scratch) : nullptr;
  a.stride = stride;
  a.cost = static_cast<int*>(cost);
  a.startj = static_cast<int*>(startj);
  a.endj = static_cast<int*>(endj);
  // lanes a diagonal: at most the rectangle's widest diagonal
  const int64_t widest = (M < N ? M : N) + 1;
  const int threads = (int)(widest < kMaxThreads ? (widest + 31) / 32 * 32 : kMaxThreads);
  cudaStream_t s = (cudaStream_t)stream;
  void (*kernel)(Args) = span ? &fit_span_kernel<true> : &fit_span_kernel<false>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  kernel<<<(unsigned)nblocks, threads, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}
