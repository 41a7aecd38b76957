// K7: merge of two sorted lists of rows, key words plus payloads.
//
// Replaces bitnuc_tpu/ops/pallas/merge.py::merge_sorted (the bitonic merge
// whose stages below one block run in _merge_tail's pallas_call). Same
// function: two lists, each sorted ascending by its first n_keys columns
// (1..3 key words, most significant first, compared as unsigned), merge into
// one sorted list; every column, keys and payloads, moves with its row. The
// result is the STABLE sort of concat(a, b): on equal keys the rows of a come
// first and each list keeps its own order. The wrapper (ops/merge.py) fills
// the padding rows [na + nb, next_pow2(na + nb)).
//
// Bound on the card: latency. Each row does a binary search of about
// log2(n) dependent loads over the other list, then one scattered write per
// column; the top levels of the searches hit L2, neighbouring threads probe
// neighbouring rows.
//
// Design: a rank merge, one thread per input row. Row i of a lands at
// i + (rows of b with a smaller key), row j of b at j + (rows of a with a key
// not greater): a lower bound and an upper bound, which together give each
// output position exactly one writer and the stable order. The bitonic
// network of the TPU kernel exists because Mosaic has rolls and powers of two
// and no gather; it is not kept. Columns are passed by value as a fixed-size
// struct of pointers, indexed only with unrolled constants so the struct
// stays in the parameter bank. Merge-path tiling in shared memory is later
// work.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 8;

struct Cols {
  const uint32_t* p[kMaxCols];
};

struct OutCols {
  uint32_t* p[kMaxCols];
};

// Rows of `other` (rows [0, n)) whose key is < x (strict) or <= x (!strict).
template <int NK>
__device__ __forceinline__ int64_t rank_in(const uint32_t (&x)[NK],
                                           const Cols& other, int64_t n,
                                           bool strict) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    int c = 0;  // sign of other[mid] - x, lexicographic over the key words
#pragma unroll
    for (int w = 0; w < NK; ++w) {
      if (c == 0) {
        const uint32_t y = other.p[w][mid];
        c = y < x[w] ? -1 : (y > x[w] ? 1 : 0);
      }
    }
    const bool before = strict ? (c < 0) : (c <= 0);
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void move_row(const Cols& src, int64_t i,
                                         const OutCols& out, int64_t pos,
                                         int n_cols) {
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    if (c < n_cols) out.p[c][pos] = src.p[c][i];
  }
}

template <int NK>
__global__ void merge_kernel(Cols a, Cols b, OutCols out, int n_cols,
                             int64_t na, int64_t nb) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= na + nb) return;
  uint32_t x[NK];
  if (t < na) {
#pragma unroll
    for (int w = 0; w < NK; ++w) x[w] = a.p[w][t];
    move_row(a, t, out, t + rank_in<NK>(x, b, nb, true), n_cols);
  } else {
    const int64_t j = t - na;
#pragma unroll
    for (int w = 0; w < NK; ++w) x[w] = b.p[w][j];
    move_row(b, j, out, j + rank_in<NK>(x, a, na, false), n_cols);
  }
}

}  // namespace

// a_cols, b_cols, out_cols: HOST arrays of kMaxCols device pointers, the
// first n_cols of which are used; columns [0, n_keys) are the key words.
extern "C" int bn_merge(const void* a_cols, const void* b_cols,
                        const void* out_cols, int n_cols, int n_keys,
                        int64_t na, int64_t nb, void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || n_keys < 1 || n_keys > 3 ||
      n_keys > n_cols) {
    return (int)cudaErrorInvalidValue;
  }
  Cols a{}, b{};
  OutCols out{};
  for (int c = 0; c < n_cols; ++c) {
    a.p[c] = static_cast<const uint32_t* const*>(a_cols)[c];
    b.p[c] = static_cast<const uint32_t* const*>(b_cols)[c];
    out.p[c] = static_cast<uint32_t* const*>(out_cols)[c];
  }
  const int64_t total = na + nb;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    cudaStream_t s = (cudaStream_t)stream;
    if (n_keys == 1) {
      merge_kernel<1><<<blocks, threads, 0, s>>>(a, b, out, n_cols, na, nb);
    } else if (n_keys == 2) {
      merge_kernel<2><<<blocks, threads, 0, s>>>(a, b, out, n_cols, na, nb);
    } else {
      merge_kernel<3><<<blocks, threads, 0, s>>>(a, b, out, n_cols, na, nb);
    }
  }
  return (int)cudaGetLastError();
}
