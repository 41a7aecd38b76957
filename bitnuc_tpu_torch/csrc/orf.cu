// K10 orf_scan: the longest ATG..stop open reading frame of each packed
// read, (length, start, stopped), on the forward strand and, in the same
// launch, on its reverse complement, as ops.orf's best_orf_one_strand_torch
// and best_orf_two_strands_torch compute them.
//
// Replaces bitnuc_tpu/ops/pallas/orfscan.py::best_orf_one_strand_pallas
// (orfscan.py:93, its pallas_call at orfscan.py:117). The TPU kernel takes
// unpacked 2-bit codes [B, L] of one strand and finds each position's next
// stop in frame with a stride-3 doubling scan of lane rolls; its L <= 32767
// bound serves a multiply-shift division by 3. This kernel takes the packed
// words, so no [B, L] byte plane and no reverse complement are made on the
// device, and takes rows of any length.
//
// Rules (ops.orf): codon(p) = c[p] 16 + c[p+1] 4 + c[p+2], bases past 16 W
// read as A, and a codon counts only if p + 3 <= len. An ORF at an ATG at p
// runs to the next stop in frame at or after p (TAA, TAG, TGA; the stop is
// excluded), or, open, to p + 3 floor((len - p) / 3). The longest wins, then
// the smallest start; stopped is the winner's flag. A stop at p >= 2^30
// counts as none, as the plain version's 2^30 sentinel has it. The reverse
// strand is the scan of ops.revcomp.reverse_complement_reads(words, len),
// its words built here from the forward ones by the same formula (Reverse).
//
// Bound on the card: bytes at the main path's 150-bp rows, the words read
// once (a quarter byte a base) and three values a read and strand written;
// beside them the operations of a SWAR pass over each word a read covers
// (chip_smoke.py): 48 a word for one strand (ORF_OPS_PER_WORD: one-hot
// masks, funnel shifts, codon masks, first stops, carries) and 83 for six
// frames (ORF_TWO_STRAND_OPS_PER_WORD: the one-hots and shifts once, a C
// mask, each strand's codon masks, frames and carries), which bound both
// strands at 150 bp. Building the reverse strand's words is this design's
// own cost and is not counted.
//
// Design: SWAR on whole words. The two bit planes of a word and the next
// word's low bases (a funnel shift) give one-hot masks of A, G and T at bit
// 2t of base t; stop = T & (A1 & (A2 | G2) | G1 & A2) and start = A & T1 &
// G2 mark codons at t (1 and 2: the bases after). Base t of word j lies in
// frame (j + t) mod 3 because 16 = 1 (mod 3), so three constant masks (t
// mod 3 = 0, 1, 2) split a word's stops by frame, and the next stop of a
// frame past word j, carried as the walk goes from the row's end to its
// start, is relabelled for word j - 1 by a rotation. Only ATG bits are
// visited (__ffs): each takes the first stop of its frame at or after it in
// the word, or else the carry. The winner is one 64-bit key, (length << 32)
// | ((2^31 - 1 - start) << 1) | stopped, whose max keeps the longest ORF,
// then the smallest start, and carries its flag.
//
// Row-length split. Rows of W <= 128 words (reads up to 2,048 bp): one
// thread a row and both strands, the block's rows staged in shared memory
// with coalesced loads, as many rows a block (256, 128, 64 or 32) as fit
// 4,352 staged words at an odd stride; no shuffles. Longer rows: one
// block a row and strand, 16 words a lane, rounds of 512 words a warp taken
// from the row's end; a first pass finds each lane's first stop per frame,
// a suffix-min over the lanes and warps above (and the rounds above) gives
// each lane what follows its segment, and a second pass over the lane's
// masks, kept in registers, resolves its ATGs.
#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr unsigned kEven = 0x55555555u;  // bit 2t of a mask: base t of the word
constexpr int kShortW = 128;             // rows up to this many words: a thread a row
constexpr int kShortWords = 256 * 17;    // staged words a block of short rows: 256 of 16
constexpr int kSeg = 16;                 // words a lane of a long row
constexpr int kLongWarps = 8;            // most warps a long row's block

// bit 2t set where t mod 3 == r
__device__ __forceinline__ unsigned frame_mask(int r) {
  return r == 0 ? 0x41041041u : (r == 1 ? 0x04104104u : 0x10410410u);
}

__device__ __forceinline__ int pick3(int f, int a, int b, int c) {
  return f == 0 ? a : (f == 1 ? b : c);
}

// one-hot masks of A, G and T at bit 2t of base t (A = 0, G = 2, T = 3)
__device__ __forceinline__ unsigned is_a(unsigned w) { return ~(w | (w >> 1)) & kEven; }
__device__ __forceinline__ unsigned is_g(unsigned w) { return ~w & (w >> 1) & kEven; }
__device__ __forceinline__ unsigned is_t(unsigned w) { return w & (w >> 1) & kEven; }

struct Codons {
  unsigned stop, start;
};

// The stops and ATGs at the 16 positions of word w, whose next word is nx
// (0 past the row: bases there read as A), at bit 2t of position t; only
// positions below send (stops) and pend (starts) of the row, p0 = 16 j.
__device__ __forceinline__ Codons codons(unsigned w, unsigned nx, int p0, int pend, int send) {
  const unsigned w1 = __funnelshift_r(w, nx, 2), w2 = __funnelshift_r(w, nx, 4);
  const unsigned a1 = is_a(w1), g1 = is_g(w1), a2 = is_a(w2), g2 = is_g(w2);
  Codons c{is_t(w) & ((a1 & (a2 | g2)) | (g1 & a2)), is_a(w) & is_t(w1) & g2};
  if (p0 + 16 > send) {  // send <= pend: the row's last words only
    c.stop &= bn::base_mask(send - p0);
    c.start &= bn::base_mask(pend - p0);
  }
  return c;
}

__device__ __forceinline__ int first_pos(unsigned m, int p0) {
  return p0 + ((__ffs(m) - 1) >> 1);
}

// Folds word j's stops (p0 = 16 j) into the next stops (c0, c1, c2) of its
// frames t mod 3 = 0, 1, 2, then relabels them for word j - 1, where the
// frame of t mod 3 = r is this word's r - 1.
__device__ __forceinline__ void fold(unsigned stop, int p0, int& c0, int& c1, int& c2) {
  const unsigned s0 = stop & frame_mask(0), s1 = stop & frame_mask(1),
                 s2 = stop & frame_mask(2);
  const int n0 = s0 ? first_pos(s0, p0) : c0;
  const int n1 = s1 ? first_pos(s1, p0) : c1;
  const int n2 = s2 ? first_pos(s2, p0) : c2;
  c0 = n2;
  c1 = n0;
  c2 = n1;
}

// The ORFs of word j's ATGs into key, given (c0, c1, c2) the next stop past
// the word in each of its frames; then fold.
__device__ __forceinline__ void scan_word(Codons k, int p0, int n, int& c0, int& c1, int& c2,
                                          unsigned long long& key) {
  for (unsigned s = k.start; s; s &= s - 1) {
    const int b = __ffs(s) - 1;  // 2t
    const int r = (b >> 1) % 3;
    const unsigned later = k.stop & frame_mask(r) & (kFull << b);
    const int e = later ? first_pos(later, p0) : pick3(r, c0, c1, c2);
    const int p = p0 + (b >> 1);
    const bool st = e < kBig;
    const unsigned len = st ? (unsigned)(e - p) : 3u * (unsigned)((n - p) / 3);
    const unsigned long long cand = ((unsigned long long)len << 32) |
                                    ((unsigned long long)(0x7FFFFFFFu - (unsigned)p) << 1) |
                                    (st ? 1ull : 0ull);
    key = cand > key ? cand : key;
  }
  fold(k.stop, p0, c0, c1, c2);
}

// The forward strand's words: row[j], 0 past the row.
struct Forward {
  const uint32_t* row;
  int W;
  __device__ Forward(const uint32_t* row_, int W_, int, int) : row(row_), W(W_) {}
  __device__ __forceinline__ unsigned operator()(int j) { return j < W ? row[j] : 0u; }
};

// Reverse-complement all 16 bases of a word (ops.revcomp.revcomp_word): the
// bit reversal of ~w with each 2-bit pair swapped back.
__device__ __forceinline__ unsigned rc_word(unsigned w) {
  const unsigned r = __brev(~w);
  return ((r >> 1) & kEven) | ((r & kEven) << 1);
}

// The reverse strand's words, as ops.revcomp.reverse_complement_reads makes
// them from the forward row: the row's reverse-complement words R(s) =
// rc_word(row[W - 1 - s]), shifted down by 16 W - n bases (ws words and bs
// bits, floor) and masked past n. R(s) is 0 from s = W on; lengths past 16 W
// give s < 0, where the gather wraps (R(s + W)) and, below -W, fills all
// ones. Called for j, j - 1, ... in turn from jtop, it keeps R(j + ws + 1)
// from the last call.
struct Reverse {
  const uint32_t* row;
  int W, n, ws, bs;
  unsigned hi;
  __device__ Reverse(const uint32_t* row_, int W_, int n_, int jtop) : row(row_), W(W_), n(n_) {
    const int shift = 16 * W - n;
    ws = shift >> 4;
    bs = 2 * (shift & 15);
    hi = src(jtop + 1 + ws);
  }
  __device__ __forceinline__ unsigned src(int s) const {
    if (s >= W) return 0u;
    if (s < -W) return kFull;
    return rc_word(row[s < 0 ? -1 - s : W - 1 - s]);
  }
  __device__ __forceinline__ unsigned operator()(int j) {
    const unsigned lo = src(j + ws);
    const unsigned w = j < W ? __funnelshift_r(lo, hi, bs) & bn::base_mask(n - 16 * j) : 0u;
    hi = lo;
    return w;
  }
};

// Positions below pend hold codons of the read; stops count below send.
__device__ __forceinline__ void row_ends(int W, int n, int& pend, int& send) {
  const int64_t pe = min((int64_t)16 * W, (int64_t)n - 2);
  pend = pe > 0 ? (int)pe : 0;
  send = min(pend, kBig);
}

// One thread walks its row from its last word to its first.
template <class Strand>
__device__ unsigned long long scan_row(const uint32_t* row, int W, int n) {
  int pend, send;
  row_ends(W, n, pend, send);
  const int nw = (pend + 15) >> 4;
  Strand word(row, W, n, nw);
  unsigned nx = word(nw);
  int c0 = kBig, c1 = kBig, c2 = kBig;
  unsigned long long key = 0ull;
  for (int j = nw - 1; j >= 0; --j) {
    const unsigned w = word(j);
    scan_word(codons(w, nx, 16 * j, pend, send), 16 * j, n, c0, c1, c2, key);
    nx = w;
  }
  return key;
}

__device__ __forceinline__ void write_key(unsigned long long key, int64_t i, int* best_out,
                                          int* start_out, bool* stopped_out) {
  const int len = (int)(key >> 32);
  best_out[i] = len;
  start_out[i] = len > 0 ? (int)(0x7FFFFFFFu - (unsigned)((key >> 1) & 0x7FFFFFFFu)) : 0;
  stopped_out[i] = len > 0 && (key & 1ull);
}

// Rows of W <= kShortW words: a thread a row; the block's kRows rows,
// contiguous in memory, staged in shared memory at an odd stride (no bank
// conflicts), kRows (W | 1) <= kShortWords.
template <int kRows>
__global__ void __launch_bounds__(kRows)
    orf_short_kernel(const uint32_t* __restrict__ words, const int* __restrict__ lens,
                     int64_t B, int W, int strands, int* __restrict__ best_out,
                     int* __restrict__ start_out, bool* __restrict__ stopped_out) {
  __shared__ uint32_t sm[kShortWords];
  const int stride = W | 1;
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int rows = (int)min((int64_t)kRows, B - r0);
  if (W > 0) {  // thread i copies words i, i + kRows, ...: (row, column) stepped
    const uint32_t* src = words + r0 * W;
    const int dq = kRows / W, dm = kRows - dq * W;
    int rr = threadIdx.x / W, c = threadIdx.x - rr * W;
    for (int i = threadIdx.x; i < rows * W; i += kRows) {
      sm[rr * stride + c] = __ldg(src + i);
      rr += dq;
      c += dm;
      if (c >= W) {
        c -= W;
        ++rr;
      }
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const uint32_t* row = sm + r * stride;
  const int n = lens[r0 + r];
  write_key(scan_row<Forward>(row, W, n), r0 + r, best_out, start_out, stopped_out);
  if (strands == 2)
    write_key(scan_row<Reverse>(row, W, n), B + r0 + r, best_out, start_out, stopped_out);
}

// The first stop of each absolute frame (position mod 3) among a segment's
// words j0 .. j0 + kSeg - 1, from their stop masks.
__device__ __forceinline__ void segment_first(const unsigned (&stp)[kSeg], int j0, int& f0,
                                              int& f1, int& f2) {
  int c0 = kBig, c1 = kBig, c2 = kBig;
#pragma unroll
  for (int i = kSeg - 1; i >= 0; --i) fold(stp[i], 16 * (j0 + i), c0, c1, c2);
  // now labelled for word j0 - 1: its frame t mod 3 = r is absolute
  // (j0 - 1 + r) mod 3
  const int fm = (j0 + 2) % 3;
  f0 = pick3((3 - fm) % 3, c0, c1, c2);
  f1 = pick3((4 - fm) % 3, c0, c1, c2);
  f2 = pick3((5 - fm) % 3, c0, c1, c2);
}

// The warp's suffix-min of v over the lanes above this one (exclusive);
// the whole warp's min is left in total (lane 0's inclusive value).
__device__ __forceinline__ int lanes_above(int v, int lane, int& total) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v = min(v, o);
  }
  total = __shfl_sync(kFull, v, 0);
  const int ex = __shfl_down_sync(kFull, v, 1);
  return lane == 31 ? kBig : ex;
}

// Rows of W > kShortW words: a block a row, kSeg words a lane.
template <class Strand>
__device__ unsigned long long scan_long_row(const uint32_t* row, int W, int n) {
  __shared__ int warp_first[kLongWarps][3];
  __shared__ unsigned long long warp_key[kLongWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int pend, send;
  row_ends(W, n, pend, send);
  const int nw = (pend + 15) >> 4;
  const int round = 32 * kSeg * nwarps;
  int carry0 = kBig, carry1 = kBig, carry2 = kBig;  // absolute frames, past the round
  unsigned long long key = 0ull;
  for (int k = (nw + round - 1) / round - 1; k >= 0; --k) {
    const int j0 = k * round + (warp * 32 + lane) * kSeg;
    unsigned stp[kSeg], sta[kSeg];
    if (j0 < nw) {
      Strand word(row, W, n, j0 + kSeg);
      unsigned nx = word(j0 + kSeg);
#pragma unroll
      for (int i = kSeg - 1; i >= 0; --i) {
        const unsigned w = word(j0 + i);
        const Codons c = codons(w, nx, 16 * (j0 + i), pend, send);
        stp[i] = c.stop;
        sta[i] = c.start;
        nx = w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSeg; ++i) stp[i] = sta[i] = 0u;
    }
    // pass 1: what follows each segment, per absolute frame
    int f0, f1, f2, t0, t1, t2;
    segment_first(stp, j0, f0, f1, f2);
    int in0 = lanes_above(f0, lane, t0);
    int in1 = lanes_above(f1, lane, t1);
    int in2 = lanes_above(f2, lane, t2);
    if (lane == 0) {
      warp_first[warp][0] = t0;
      warp_first[warp][1] = t1;
      warp_first[warp][2] = t2;
    }
    __syncthreads();
    int a0 = carry0, a1 = carry1, a2 = carry2;
    for (int v = nwarps - 1; v >= 0; --v) {
      if (v == warp) {
        in0 = min(in0, a0);
        in1 = min(in1, a1);
        in2 = min(in2, a2);
      }
      a0 = min(a0, warp_first[v][0]);
      a1 = min(a1, warp_first[v][1]);
      a2 = min(a2, warp_first[v][2]);
    }
    carry0 = a0;
    carry1 = a1;
    carry2 = a2;
    __syncthreads();  // warp_first is written again next round
    // pass 2: the segment's ATGs, from its last word (kSeg - 1 = 0 mod 3,
    // so its frame t mod 3 = r is absolute (j0 + r) mod 3)
    const int fl = j0 % 3;
    int c0 = pick3(fl, in0, in1, in2), c1 = pick3((fl + 1) % 3, in0, in1, in2),
        c2 = pick3((fl + 2) % 3, in0, in1, in2);
#pragma unroll
    for (int i = kSeg - 1; i >= 0; --i)
      scan_word(Codons{stp[i], sta[i]}, 16 * (j0 + i), n, c0, c1, c2, key);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, key, off);
    key = o > key ? o : key;
  }
  if (lane == 0) warp_key[warp] = key;
  __syncthreads();
  for (int v = 0; v < nwarps; ++v) key = warp_key[v] > key ? warp_key[v] : key;
  return key;
}

__global__ void __launch_bounds__(32 * kLongWarps)
    orf_long_kernel(const uint32_t* __restrict__ words, const int* __restrict__ lens,
                    int64_t B, int W, int* __restrict__ best_out,
                    int* __restrict__ start_out, bool* __restrict__ stopped_out) {
  const int64_t r = blockIdx.x;
  const uint32_t* row = words + r * W;
  const unsigned long long key = blockIdx.y == 0 ? scan_long_row<Forward>(row, W, lens[r])
                                                 : scan_long_row<Reverse>(row, W, lens[r]);
  if (threadIdx.x == 0) write_key(key, blockIdx.y * B + r, best_out, start_out, stopped_out);
}

}  // namespace

// words [B, W] uint32, lens [B] int32 -> best [strands, B] int32, start
// [strands, B] int32, stopped [strands, B] bool: the forward strand, then
// (strands = 2) the reverse complement's.
extern "C" int bn_orf_scan(const void* words, const void* lens, int64_t B, int W, int strands,
                           void* best, void* start, void* stopped, void* stream) {
  if (B < 0 || W < 0 || strands < 1 || strands > 2) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const auto s = (cudaStream_t)stream;
  if (W <= kShortW) {  // as many rows a block as fit kShortWords, at least 32
    const int stride = W | 1;
    const int rows = 256 * stride <= kShortWords   ? 256
                     : 128 * stride <= kShortWords ? 128
                     : 64 * stride <= kShortWords  ? 64
                                                   : 32;
    const unsigned blocks = (unsigned)((B + rows - 1) / rows);
    auto kernel = rows == 256   ? &orf_short_kernel<256>
                  : rows == 128 ? &orf_short_kernel<128>
                  : rows == 64  ? &orf_short_kernel<64>
                                : &orf_short_kernel<32>;
    kernel<<<blocks, rows, 0, s>>>((const uint32_t*)words, (const int*)lens, B, W, strands,
                                   (int*)best, (int*)start, (bool*)stopped);
  } else {
    const int warps = min(kLongWarps, (W + 32 * kSeg - 1) / (32 * kSeg));
    orf_long_kernel<<<dim3((unsigned)B, strands), 32 * warps, 0, s>>>(
        (const uint32_t*)words, (const int*)lens, B, W, (int*)best, (int*)start,
        (bool*)stopped);
  }
  return (int)cudaGetLastError();
}
