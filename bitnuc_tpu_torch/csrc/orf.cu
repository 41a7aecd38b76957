// K10 orf_scan: the longest ATG..stop open reading frame on one strand of
// each packed read, (length, start, stopped), as ops.orf's
// best_orf_one_strand_torch computes it.
//
// Replaces bitnuc_tpu/ops/pallas/orfscan.py::best_orf_one_strand_pallas
// (its pallas_call at orfscan.py:117). The TPU kernel takes unpacked 2-bit
// codes [B, L] and finds each position's next stop in frame with a
// stride-3 doubling scan of lane rolls; its L <= 32767 bound serves a
// multiply-shift division by 3. This kernel takes the packed words, so no
// [B, L] byte plane is made, and takes rows of any length.
//
// Rules (ops.orf): codon(p) = c[p] 16 + c[p+1] 4 + c[p+2], bases past 16 W
// read as A, and a codon counts only if p + 3 <= len. An ORF at an ATG at p
// runs to the next stop in frame at or after p (TAA, TAG, TGA; the stop is
// excluded), or, open, to p + 3 floor((len - p) / 3). The longest wins, then
// the smallest start; stopped is the winner's flag. A stop at p >= 2^30
// counts as none, as the plain version's 2^30 sentinel has it.
//
// Bound on the card: integer ALU, about a dozen int32 operations a base;
// the words (a quarter byte a base) are read once and three values a read
// written.
//
// Design: one warp per read walks it from its end in chunks of 32 words
// (512 bases). Lane l holds word 32k + l and takes the next word's first
// two bases by one __shfl_down_sync (lane 31 loads it). Frames are absolute
// positions mod 3, so they agree across lanes: a lane finds its first stop
// in each frame, a warp suffix-min over the lanes above (five shuffles a
// frame) plus the carry from the chunks above gives each lane the next stop
// past its word, and a backward pass over the lane's 16 positions gives
// each ATG its ORF. The winner is one 64-bit key, (length << 32) |
// ((2^31 - 1 - start) << 1) | stopped, so a warp max keeps the longest ORF,
// then the smallest start, and carries its flag. Rows of 150 bp use 10 of
// the 32 lanes; several reads a warp is later work.
#include "common.cuh"

namespace {

constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarps = 8;
// codons as read from the words, LSB first: c[p] + 4 c[p+1] + 16 c[p+2]
constexpr unsigned kAtg = 0 + 4 * 3 + 16 * 2;
constexpr unsigned kTaa = 3 + 4 * 0 + 16 * 0;
constexpr unsigned kTag = 3 + 4 * 0 + 16 * 2;
constexpr unsigned kTga = 3 + 4 * 2 + 16 * 0;

__device__ __forceinline__ int pick3(int f, int a, int b, int c) {
  return f == 0 ? a : (f == 1 ? b : c);
}

// The next stop at or after the lanes above this one, per absolute frame:
// a warp suffix-min of each lane's first stop, then the carry of the chunks
// above. Updates the carry with this chunk's first stops.
__device__ __forceinline__ int incoming(int first, int& carry, int lane) {
  int v = first;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v = min(v, o);
  }
  int ex = __shfl_down_sync(kFull, v, 1);
  if (lane == 31) ex = kBig;
  const int in = min(ex, carry);
  carry = min(carry, __shfl_sync(kFull, v, 0));
  return in;
}

__global__ void orf_scan_kernel(const uint32_t* __restrict__ words,
                                const int* __restrict__ lens, int64_t B, int W,
                                int* __restrict__ best_out,
                                int* __restrict__ start_out,
                                bool* __restrict__ stopped_out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (r >= B) return;  // the whole warp leaves together
  const uint32_t* row = words + r * (int64_t)W;
  const int n = lens[r];
  // codons at p < pend lie inside the read; stops count below send
  const int64_t pe = min((int64_t)16 * W, (int64_t)n - 2);
  const int pend = pe > 0 ? (int)pe : 0;
  const int send = min(pend, kBig);
  unsigned long long key = 0ull;
  int carry0 = kBig, carry1 = kBig, carry2 = kBig;
  for (int k = (pend + 511) / 512 - 1; k >= 0; --k) {
    const int w = 32 * k + lane;
    const uint32_t word = w < W ? __ldg(row + w) : 0u;
    uint32_t next = __shfl_down_sync(kFull, word, 1);
    if (lane == 31) next = w + 1 < W ? __ldg(row + w + 1) : 0u;
    const unsigned long long ext = ((unsigned long long)next << 32) | word;
    const int p0 = 16 * w;
    const int f0 = p0 % 3;  // frame of the lane's first base
    // first stop of each frame relative to p0 (r = t % 3)
    int first[3] = {kBig, kBig, kBig};
#pragma unroll
    for (int t = 15; t >= 0; --t) {
      const unsigned c = (unsigned)(ext >> (2 * t)) & 63u;
      if (p0 + t < send && (c == kTaa || c == kTag || c == kTga)) first[t % 3] = p0 + t;
    }
    // relative frame r is absolute frame (f0 + r) % 3
    const int a0 = pick3((3 - f0) % 3, first[0], first[1], first[2]);
    const int a1 = pick3((4 - f0) % 3, first[0], first[1], first[2]);
    const int a2 = pick3((5 - f0) % 3, first[0], first[1], first[2]);
    const int in0 = incoming(a0, carry0, lane);
    const int in1 = incoming(a1, carry1, lane);
    const int in2 = incoming(a2, carry2, lane);
    int nxt[3] = {pick3(f0, in0, in1, in2), pick3((f0 + 1) % 3, in0, in1, in2),
                  pick3((f0 + 2) % 3, in0, in1, in2)};
    unsigned long long lkey = 0ull;
#pragma unroll
    for (int t = 15; t >= 0; --t) {
      const int p = p0 + t;
      const unsigned c = (unsigned)(ext >> (2 * t)) & 63u;
      if (p < send && (c == kTaa || c == kTag || c == kTga)) nxt[t % 3] = p;
      if (p < pend && c == kAtg) {
        const int e = nxt[t % 3];
        const bool st = e < kBig;
        const int len = st ? e - p : 3 * ((n - p) / 3);
        const unsigned long long cand =
            ((unsigned long long)(unsigned)len << 32) |
            ((unsigned long long)(0x7FFFFFFFu - (unsigned)p) << 1) | (st ? 1ull : 0ull);
        lkey = cand > lkey ? cand : lkey;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, lkey, off);
      lkey = o > lkey ? o : lkey;
    }
    key = lkey > key ? lkey : key;
  }
  if (lane == 0) {
    const int len = (int)(key >> 32);
    best_out[r] = len;
    start_out[r] = len > 0 ? (int)(0x7FFFFFFFu - (unsigned)((key >> 1) & 0x7FFFFFFFu)) : 0;
    stopped_out[r] = len > 0 && (key & 1ull);
  }
}

}  // namespace

// words [B, W] uint32, lens [B] int32 -> best [B] int32, start [B] int32,
// stopped [B] bool.
extern "C" int bn_orf_scan(const void* words, const void* lens, int64_t B, int W,
                           void* best, void* start, void* stopped, void* stream) {
  if (B < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((B + kWarps - 1) / kWarps);
  orf_scan_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)lens, B, W, (int*)best, (int*)start,
      (bool*)stopped);
  return (int)cudaGetLastError();
}
