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
// Bound on the card: bytes. Every column is read once and written once: at
// combine_counts' main shape (2 x 8,388,608 rows of 3 key words and a count)
// 268 MB in and 268 MB out, 537 MB, 0.160 ms at 3.35 TB/s.
//
// Design: merge path (Odeh, Green, Mwassi, Shmueli and Birk, "Merge Path",
// 2012), in two passes.
//   1. partition_kernel: one thread per tile boundary finds, with one binary
//      search over the two global lists, how many rows of a the merge has
//      taken by output row t * kTile. The splits go to the caller's scratch
//      as int64: (na + nb) / kTile + 1 searches, where a rank merge needs
//      one per row.
//   2. merge_tile_kernel: block t owns output rows [t kTile, (t + 1) kTile).
//      It stages every column of its two input ranges a[i0, i1) and
//      b[j0, j1) in shared memory with coalesced loads; each thread finds
//      its split inside the tile at diagonal tid * kIpt by a binary search
//      in shared memory, merges its kIpt rows in sequence and records each
//      output row's source (its index in the staged tile); then the block
//      writes every column in output order, neighbouring threads on
//      neighbouring rows, so each store fills whole sectors.
// One tie rule everywhere: a row of a goes first when its key is not greater
// than b's (!(b < a)). The global split, the in-tile split and the
// sequential merge all use it, so a run of equal keys across a tile edge is
// cut at the same row by both neighbouring tiles, and the order is stable.
// The bitonic network of the TPU kernel exists because Mosaic has rolls and
// powers of two and no gather; it is not kept. Columns are passed by value as
// a fixed-size struct of pointers, indexed only with unrolled constants so
// the struct stays in the parameter bank.
//
// kTile = 256 threads x 8 rows = 2,048 rows: 8 KB of shared memory a staged
// column, 36 KB at the main shape's 4 columns, so six blocks share an SM.
// On the card it beat 256 x 15 and 256 x 16 (4,096-row tiles: fewer blocks
// in flight, longer serial merges) and 128 x 15, and tied 256 x 7 and
// 512 x 8, at every K7 shape of chip_smoke.py.
#include "common.cuh"

namespace {

constexpr int kMaxCols = 8;
constexpr int kThreads = 256;
constexpr int kIpt = 8;                   // output rows a thread merges
constexpr int kTile = kThreads * kIpt;    // output rows a block
constexpr int kPartitionThreads = 128;

static_assert(kTile <= 65535, "tile indices are uint16");

struct Cols {
  const uint32_t* p[kMaxCols];
};

struct OutCols {
  uint32_t* p[kMaxCols];
};

// x < y over NK key words, most significant first, unsigned.
template <int NK>
__device__ __forceinline__ bool key_less(const uint32_t (&x)[NK], const uint32_t (&y)[NK]) {
#pragma unroll
  for (int w = 0; w < NK; ++w) {
    if (x[w] != y[w]) return x[w] < y[w];
  }
  return false;
}

// Rows of a among the first d rows of the stable merge of a[0, na) and
// b[0, nb): the least i in [max(0, d - nb), min(d, na)] with
// b[d - 1 - i] < a[i], else the upper end. key_a(i, x) and key_b(j, y)
// load a row's key words.
template <int NK, typename I, typename KeyA, typename KeyB>
__device__ __forceinline__ I merge_split(KeyA key_a, KeyB key_b, I na, I nb, I d) {
  I lo = d > nb ? d - nb : 0;
  I hi = d < na ? d : na;
  while (lo < hi) {
    const I mid = lo + ((hi - lo) >> 1);
    uint32_t x[NK], y[NK];
    key_a(mid, x);
    key_b(d - 1 - mid, y);
    if (key_less<NK>(y, x)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

template <int NK>
__global__ void partition_kernel(Cols a, Cols b, int64_t na, int64_t nb, int64_t tiles,
                                 int64_t* __restrict__ splits) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > tiles) return;
  const int64_t d = t * kTile < na + nb ? t * kTile : na + nb;
  splits[t] = merge_split<NK>(
      [&](int64_t i, uint32_t (&x)[NK]) {
#pragma unroll
        for (int w = 0; w < NK; ++w) x[w] = a.p[w][i];
      },
      [&](int64_t j, uint32_t (&y)[NK]) {
#pragma unroll
        for (int w = 0; w < NK; ++w) y[w] = b.p[w][j];
      },
      na, nb, d);
}

template <int NK>
__global__ void __launch_bounds__(kThreads)
merge_tile_kernel(Cols a, Cols b, OutCols out, int n_cols, int64_t na, int64_t nb,
                  const int64_t* __restrict__ splits) {
  // column c of staged row x at tile[c * kTile + x]: a[i0, i1) at rows
  // [0, la), b[j0, j0 + lb) at rows [la, n); then each output row's source
  extern __shared__ uint32_t tile[];
  uint16_t* src = reinterpret_cast<uint16_t*>(tile + n_cols * kTile);
  const int64_t d0 = (int64_t)blockIdx.x * kTile;
  const int64_t i0 = splits[blockIdx.x];
  const int64_t j0 = d0 - i0;
  const int n = (int)(d0 + kTile < na + nb ? kTile : na + nb - d0);
  const int la = (int)(splits[blockIdx.x + 1] - i0);
  const int lb = n - la;
  const int tid = threadIdx.x;

#pragma unroll
  for (int r = 0; r < kIpt; ++r) {
    const int x = r * kThreads + tid;
    if (x < n) {
      const bool from_a = x < la;
      const int64_t row = from_a ? i0 + x : j0 + (x - la);
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < n_cols) tile[c * kTile + x] = (from_a ? a.p[c] : b.p[c])[row];
      }
    }
  }
  __syncthreads();

  auto key_at = [&](int x, uint32_t (&k)[NK]) {
#pragma unroll
    for (int w = 0; w < NK; ++w) k[w] = tile[w * kTile + x];
  };
  const int diag = min(tid * kIpt, n);
  int i = merge_split<NK, int>(key_at, [&](int j, uint32_t (&k)[NK]) { key_at(la + j, k); },
                               la, lb, diag);
  int j = diag - i;
  uint32_t ka[NK], kb[NK];
  if (i < la) key_at(i, ka);
  if (j < lb) key_at(la + j, kb);
#pragma unroll
  for (int r = 0; r < kIpt; ++r) {
    const int pos = diag + r;
    if (pos < n) {
      if (i < la && (j >= lb || !key_less<NK>(kb, ka))) {
        src[pos] = (uint16_t)i;
        if (++i < la) key_at(i, ka);
      } else {
        src[pos] = (uint16_t)(la + j);
        if (++j < lb) key_at(la + j, kb);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kIpt; ++r) {
    const int x = r * kThreads + tid;
    if (x < n) {
      const int s = src[x];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < n_cols) out.p[c][d0 + x] = tile[c * kTile + s];
      }
    }
  }
}

int64_t n_tiles(int64_t total) { return (total + kTile - 1) / kTile; }

template <int NK>
cudaError_t launch(const Cols& a, const Cols& b, const OutCols& out, int n_cols, int64_t na,
                   int64_t nb, int64_t* splits, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      merge_tile_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kMaxCols * kTile * sizeof(uint32_t) + kTile * sizeof(uint16_t)));
  if (attr != cudaSuccess) return attr;
  const int64_t tiles = n_tiles(na + nb);
  partition_kernel<NK><<<(unsigned)((tiles + kPartitionThreads) / kPartitionThreads),
                         kPartitionThreads, 0, s>>>(a, b, na, nb, tiles, splits);
  const size_t smem = n_cols * kTile * sizeof(uint32_t) + kTile * sizeof(uint16_t);
  merge_tile_kernel<NK><<<(unsigned)tiles, kThreads, smem, s>>>(a, b, out, n_cols, na, nb,
                                                                splits);
  return cudaGetLastError();
}

}  // namespace

// Output rows a merge_tile_kernel block owns.
extern "C" int bn_merge_tile(int64_t* rows) {
  *rows = kTile;
  return 0;
}

// Bytes of scratch bn_merge needs: the int64 split of every tile boundary.
extern "C" int bn_merge_scratch(int64_t na, int64_t nb, int64_t* bytes) {
  *bytes = (int64_t)sizeof(int64_t) * (n_tiles(na + nb) + 1);
  return 0;
}

// a_cols, b_cols, out_cols: HOST arrays of kMaxCols device pointers, the
// first n_cols of which are used; columns [0, n_keys) are the key words.
// scratch: bn_merge_scratch(na, nb) bytes of device memory.
extern "C" int bn_merge(const void* a_cols, const void* b_cols, const void* out_cols,
                        int n_cols, int n_keys, int64_t na, int64_t nb, void* scratch,
                        void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols || n_keys < 1 || n_keys > 3 || n_keys > n_cols) {
    return (int)cudaErrorInvalidValue;
  }
  Cols a{}, b{};
  OutCols out{};
  for (int c = 0; c < n_cols; ++c) {
    a.p[c] = static_cast<const uint32_t* const*>(a_cols)[c];
    b.p[c] = static_cast<const uint32_t* const*>(b_cols)[c];
    out.p[c] = static_cast<uint32_t* const*>(out_cols)[c];
  }
  if (na + nb == 0) return (int)cudaGetLastError();
  int64_t* splits = static_cast<int64_t*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_keys == 1) return (int)launch<1>(a, b, out, n_cols, na, nb, splits, s);
  if (n_keys == 2) return (int)launch<2>(a, b, out, n_cols, na, nb, splits, s);
  return (int)launch<3>(a, b, out, n_cols, na, nb, splits, s);
}
