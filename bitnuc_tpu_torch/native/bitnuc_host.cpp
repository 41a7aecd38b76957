// Host library of bitnuc_tpu_torch: the C++ passes that run on the CPU
// beside the card's kernels.
//
// Single-call pack/unpack/hdist/split for the host API tier and
// PackedSequence; FASTQ framing (a scan and a fill of whole buffers, no
// per-record Python); the record emitter of filter_fastq; the QC fold; the
// de Bruijn graph passes of the assembler (merge joins, list ranking, the
// edge structure, a radix argsort); a host k-mer spectrum; and a threaded
// host pack of ASCII rows.
//
// Codes follow the reference contract (A=00 C=01 G=10 T=11, LSB-first, 32
// bases per u64, zero-padded last word, the reference crate's
// src/utils/packing/naive.rs); the implementation is branch-free SWAR
// (shift-or bit compaction within u64 lanes).
//
// Built at first use by bitnuc_tpu_torch/native/__init__.py with the host
// compiler: c++ -O3 -march=native -std=c++17 -shared -fPIC -pthread.

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <cmath>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kOnes = 0x0101010101010101ULL;
constexpr uint64_t kHigh = 0x8080808080808080ULL;

inline uint64_t load_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// 0x80 in each byte of x equal to c, else 0 (classic zero-byte SWAR test).
inline uint64_t match_byte(uint64_t x, uint8_t c) {
  uint64_t t = x ^ (kOnes * c);
  return (t - kOnes) & ~t & kHigh;
}

// All 8 bytes in {A,C,G,T,a,c,g,t}?
inline uint64_t valid_mask8(uint64_t v) {
  uint64_t l = v | 0x2020202020202020ULL;  // lowercase
  return match_byte(l, 'a') | match_byte(l, 'c') | match_byte(l, 'g') |
         match_byte(l, 't');
}

// Pack 8 ASCII bases (one u64 load) into 16 bits, LSB-first.
// code = ((b>>1) ^ (b>>2)) & 3 per byte, then shift-or compaction 8->2 bit
// spacing in three rounds.
inline uint64_t pack8(uint64_t v) {
  uint64_t c = ((v >> 1) ^ (v >> 2)) & 0x0303030303030303ULL;
  c = (c | (c >> 6)) & 0x000F000F000F000FULL;
  c = (c | (c >> 12)) & 0x000000FF000000FFULL;
  c = (c | (c >> 24)) & 0x000000000000FFFFULL;
  return c;
}

// Inverse: expand 16 bits (8 bases) to 8 ASCII bytes in a u64.
inline uint64_t unpack8(uint64_t c) {
  c &= 0xFFFFULL;
  c = (c | (c << 24)) & 0x000000FF000000FFULL;
  c = (c | (c << 12)) & 0x000F000F000F000FULL;
  c = (c | (c << 6)) & 0x0303030303030303ULL;
  // per-byte code -> ASCII: 'A' + 2c + 2*bit1(c) + 11*(c==3); max byte 84, no
  // cross-byte carries.
  uint64_t bit1 = (c >> 1) & kOnes;
  uint64_t is3 = c & (c >> 1) & kOnes;
  return (kOnes * (uint64_t)'A') + (c << 1) + (bit1 << 1) +
         (is3 << 3) + (is3 << 1) + is3;
}

inline uint64_t pack_tail(const uint8_t* p, size_t n, bool* ok, uint8_t* bad) {
  uint64_t w = 0;
  for (size_t i = 0; i < n; ++i) {
    uint8_t b = p[i];
    uint8_t l = b | 0x20;
    if (l != 'a' && l != 'c' && l != 'g' && l != 't') {
      *ok = false;
      *bad = b;
      return 0;
    }
    w |= (uint64_t)(((b >> 1) ^ (b >> 2)) & 3) << (2 * i);
  }
  return w;
}

}  // namespace

extern "C" {

// status codes mirrored in bitnuc_tpu_torch/native/__init__.py
enum { BN_OK = 0, BN_INVALID_BASE = 1, BN_TOO_LONG = 2, BN_INVALID_LENGTH = 3,
       BN_OOB = 4 };

// ASCII -> u64 words. out must hold ceil(n/32) words. On invalid input,
// returns BN_INVALID_BASE and stores the offending byte in *bad_byte.
int bn_encode(const uint8_t* seq, size_t n, uint64_t* out, uint8_t* bad_byte) {
  size_t w = 0;
  size_t i = 0;
  for (; i + 32 <= n; i += 32, ++w) {
    uint64_t v0 = load_u64(seq + i);
    uint64_t v1 = load_u64(seq + i + 8);
    uint64_t v2 = load_u64(seq + i + 16);
    uint64_t v3 = load_u64(seq + i + 24);
    uint64_t m = valid_mask8(v0) & valid_mask8(v1) & valid_mask8(v2) &
                 valid_mask8(v3);
    if (m != kHigh) {
      // slow path pinpoints the first bad byte
      for (size_t j = i; j < i + 32; ++j) {
        uint8_t l = seq[j] | 0x20;
        if (l != 'a' && l != 'c' && l != 'g' && l != 't') {
          *bad_byte = seq[j];
          return BN_INVALID_BASE;
        }
      }
    }
    out[w] = pack8(v0) | (pack8(v1) << 16) | (pack8(v2) << 32) |
             (pack8(v3) << 48);
  }
  if (i < n) {
    bool ok = true;
    uint64_t tail = pack_tail(seq + i, n - i, &ok, bad_byte);
    if (!ok) return BN_INVALID_BASE;
    out[w] = tail;
  }
  return BN_OK;
}

// u64 words -> ASCII. out must hold n_bases bytes.
int bn_decode(const uint64_t* words, size_t n_words, size_t n_bases,
              uint8_t* out) {
  if (n_bases > 32 * n_words) return BN_INVALID_LENGTH;
  size_t i = 0;
  size_t w = 0;
  for (; i + 32 <= n_bases; i += 32, ++w) {
    uint64_t v = words[w];
    uint64_t a0 = unpack8(v);
    uint64_t a1 = unpack8(v >> 16);
    uint64_t a2 = unpack8(v >> 32);
    uint64_t a3 = unpack8(v >> 48);
    std::memcpy(out + i, &a0, 8);
    std::memcpy(out + i + 8, &a1, 8);
    std::memcpy(out + i + 16, &a2, 8);
    std::memcpy(out + i + 24, &a3, 8);
  }
  if (i < n_bases) {
    uint64_t v = words[w];
    for (size_t j = 0; i < n_bases; ++i, ++j) {
      static const char lut[4] = {'A', 'C', 'G', 'T'};
      out[i] = lut[(v >> (2 * j)) & 3];
    }
  }
  return BN_OK;
}

// Per-base Hamming distance over packed words (the reference crate's
// hamming/scalar.rs:40-47 semantics).
int bn_hdist(const uint64_t* e1, const uint64_t* e2, size_t n_words,
             size_t n_bases, uint64_t* out) {
  if (n_bases > 32 * n_words) return BN_INVALID_LENGTH;
  constexpr uint64_t kLow = 0x5555555555555555ULL;
  uint64_t total = 0;
  size_t full = n_bases / 32;
  for (size_t i = 0; i < full; ++i) {
    uint64_t d = e1[i] ^ e2[i];
    total += (uint64_t)__builtin_popcountll((d | (d >> 1)) & kLow);
  }
  size_t rem = n_bases % 32;
  if (rem) {
    uint64_t mask = (1ULL << (2 * rem)) - 1;
    uint64_t d = (e1[full] ^ e2[full]) & mask;
    total += (uint64_t)__builtin_popcountll((d | (d >> 1)) & kLow);
  }
  *out = total;
  return BN_OK;
}

// Split packed stream at base idx. lbuf holds idx/32+1 words, rbuf holds
// ceil((slen-idx)/32). Correct funnel shift (see oracle.split_packed note on
// the reference's carry bug). Caller handles idx==0 / idx==slen.
int bn_split(const uint64_t* words, size_t n_words, size_t slen, size_t idx,
             uint64_t* lbuf, uint64_t* rbuf) {
  if (idx > slen) return BN_OOB;
  size_t chunk = idx / 32;
  size_t bit = (idx % 32) * 2;
  for (size_t i = 0; i < chunk; ++i) lbuf[i] = words[i];
  lbuf[chunk] = bit ? (words[chunk] & ((1ULL << bit) - 1)) : 0;

  size_t n_right = (slen - idx + 31) / 32;
  for (size_t j = 0; j < n_right; ++j) {
    uint64_t lo = words[chunk + j] >> bit;
    uint64_t hi = 0;
    if (bit && chunk + j + 1 < n_words) hi = words[chunk + j + 1] << (64 - bit);
    rbuf[j] = lo | hi;
  }
  return BN_OK;
}

// Host staging: rectangular ASCII [B, L] -> u64 words [B, words_per_read]
// without validation (garbage in, garbage out). Each read packs its full L
// columns; callers mask by length on device.
int bn_encode_batch(const uint8_t* ascii, size_t batch, size_t len,
                    uint64_t* out, size_t words_per_read) {
  for (size_t b = 0; b < batch; ++b) {
    const uint8_t* row = ascii + b * len;
    uint64_t* orow = out + b * words_per_read;
    size_t i = 0, w = 0;
    for (; i + 32 <= len && w < words_per_read; i += 32, ++w) {
      orow[w] = pack8(load_u64(row + i)) | (pack8(load_u64(row + i + 8)) << 16) |
                (pack8(load_u64(row + i + 16)) << 32) |
                (pack8(load_u64(row + i + 24)) << 48);
    }
    if (i < len && w < words_per_read) {
      uint64_t word = 0;
      for (size_t j = 0; i < len; ++i, ++j) {
        uint8_t b8 = row[i];
        word |= (uint64_t)(((b8 >> 1) ^ (b8 >> 2)) & 3) << (2 * j);
      }
      orow[w] = word;
    }
  }
  return BN_OK;
}

// Threaded host staging: rows split across n_threads hardware threads.
// Same contract as bn_encode_batch.
int bn_encode_batch_mt(const uint8_t* ascii, size_t batch, size_t len,
                       uint64_t* out, size_t words_per_read, int n_threads) {
  if (n_threads <= 1 || batch < 2) {
    return bn_encode_batch(ascii, batch, len, out, words_per_read);
  }
  size_t nt = (size_t)n_threads;
  if (nt > batch) nt = batch;
  std::vector<std::thread> ts;
  ts.reserve(nt);
  size_t per = (batch + nt - 1) / nt;
  for (size_t t = 0; t < nt; ++t) {
    size_t b0 = t * per;
    size_t b1 = b0 + per < batch ? b0 + per : batch;
    if (b0 >= b1) break;
    ts.emplace_back([=] {
      bn_encode_batch(ascii + b0 * len, b1 - b0, len,
                      out + b0 * words_per_read, words_per_read);
    });
  }
  for (auto& th : ts) th.join();
  return BN_OK;
}

// Dense k-mer histogram over one packed sequence: counts[key] += 1 for every
// window of k bases, rolling O(n) over the packed words (the device analog
// lives in ops/kmer.py; this is the host single-call path replacing the
// reference crate's README HashMap loop, README.md:164-180). counts must hold 4^k
// zero-initialised uint64 bins; k <= 16.
int bn_count_kmers(const uint64_t* words, size_t n_words, size_t n_bases,
                   size_t k, uint64_t* counts) {
  if (k < 1 || k > 16 || n_bases > 32 * n_words) return BN_INVALID_LENGTH;
  if (n_bases < k) return BN_OK;
  uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  uint64_t key = 0;
  for (size_t p = 0; p < n_bases; ++p) {
    uint64_t code = (words[p >> 5] >> (2 * (p & 31))) & 3;
    key = ((key >> 2) | (code << (2 * (k - 1)))) & mask;
    if (p + 1 >= k) ++counts[key];
  }
  return BN_OK;
}

// FASTQ scanning: pass 1 counts records and the longest sequence line.
int bn_fastq_scan(const uint8_t* buf, size_t n, size_t* n_reads,
                  size_t* max_len) {
  size_t reads = 0, maxl = 0, i = 0;
  int line_in_record = 0;
  while (i < n) {
    const uint8_t* nl =
        (const uint8_t*)std::memchr(buf + i, '\n', n - i);
    size_t end = nl ? (size_t)(nl - buf) : n;
    size_t len = end - i;
    if (len && buf[end - 1] == '\r') --len;
    if (line_in_record == 0 && len == 0) { i = end + 1; continue; }
    if (line_in_record == 1) {
      ++reads;
      if (len > maxl) maxl = len;
    }
    line_in_record = (line_in_record + 1) & 3;
    i = end + 1;
  }
  *n_reads = reads;
  *max_len = maxl;
  return BN_OK;
}

// Pass 2: fill a rectangular ASCII buffer [B, L] (zero-padded) + lengths.
int bn_fastq_fill(const uint8_t* buf, size_t n, uint8_t* ascii, int32_t* lens,
                  size_t B, size_t L) {
  size_t r = 0, i = 0;
  int line_in_record = 0;
  while (i < n && r < B) {
    const uint8_t* nl =
        (const uint8_t*)std::memchr(buf + i, '\n', n - i);
    size_t end = nl ? (size_t)(nl - buf) : n;
    size_t len = end - i;
    if (len && buf[end - 1] == '\r') --len;
    if (line_in_record == 0 && len == 0) { i = end + 1; continue; }
    if (line_in_record == 1) {
      size_t c = len < L ? len : L;
      std::memcpy(ascii + r * L, buf + i, c);
      lens[r] = (int32_t)c;
      ++r;
    }
    line_in_record = (line_in_record + 1) & 3;
    i = end + 1;
  }
  return BN_OK;
}

// Pass 2, full-record variant: fill seq AND qual rectangles (zero-padded)
// plus per-record name byte spans into the input buffer (offset past the
// '@', length to end of header line) — the quality-aware loader for the
// preprocessing tier (filters/qc), where the per-record Python readline
// loop was the measured bottleneck.
int bn_fastq_fill_sq(const uint8_t* buf, size_t n, uint8_t* ascii,
                     uint8_t* quals, int32_t* lens, int64_t* name_off,
                     int64_t* name_len, size_t B, size_t L) {
  size_t r = 0, i = 0;
  int line_in_record = 0;
  while (i < n && r < B) {
    const uint8_t* nl =
        (const uint8_t*)std::memchr(buf + i, '\n', n - i);
    size_t end = nl ? (size_t)(nl - buf) : n;
    size_t len = end - i;
    if (len && buf[end - 1] == '\r') --len;
    if (line_in_record == 0 && len == 0) { i = end + 1; continue; }
    if (line_in_record == 0) {
      name_off[r] = (int64_t)(i + 1);  // past '@'
      name_len[r] = (int64_t)(len ? len - 1 : 0);
    } else if (line_in_record == 1) {
      size_t c = len < L ? len : L;
      std::memcpy(ascii + r * L, buf + i, c);
      lens[r] = (int32_t)c;
    } else if (line_in_record == 3) {
      size_t c = len < L ? len : L;
      std::memcpy(quals + r * L, buf + i, c);
      ++r;
    }
    line_in_record = (line_in_record + 1) & 3;
    i = end + 1;
  }
  return BN_OK;
}

// FASTQ record emitter: assemble "@name\nseq[s:e]\n+\nqual[s:e]\n" for every
// kept read into one output buffer. The per-read Python formatting loop was
// the measured bottleneck of filter_fastq once parsing (bn_fastq_fill_sq)
// and the filter math (jitted kernel) were fast — this is the write-side
// twin of the native parse, completing the zero-Python record path.
// `out` must hold bn_filter_emit_size() bytes; returns bytes written.
int64_t bn_filter_emit(const uint8_t* raw, const uint8_t* ascii,
                       const uint8_t* quals, size_t B, size_t L,
                       const int64_t* name_off, const int64_t* name_len,
                       const uint8_t* keep, const int64_t* start,
                       const int64_t* end, uint8_t* out) {
  uint8_t* p = out;
  for (size_t r = 0; r < B; ++r) {
    if (!keep[r]) continue;
    int64_t s = start[r], e = end[r];
    if (s < 0) s = 0;
    if (e > (int64_t)L) e = (int64_t)L;
    if (e < s) e = s;
    size_t span = (size_t)(e - s);
    *p++ = '@';
    std::memcpy(p, raw + name_off[r], (size_t)name_len[r]);
    p += name_len[r];
    *p++ = '\n';
    std::memcpy(p, ascii + r * L + s, span);
    p += span;
    *p++ = '\n';
    *p++ = '+';
    *p++ = '\n';
    std::memcpy(p, quals + r * L + s, span);
    p += span;
    *p++ = '\n';
  }
  return (int64_t)(p - out);
}

// Sorted-set membership as a LINEAR MERGE: queries q[] are sorted (the
// assembler's successor candidates suf|b preserve key order), so one
// two-pointer pass replaces n binary searches (each ~22 random cache
// misses — the measured joins stage of the de Bruijn graph build).
// ok[i] = 1 iff q[i] is in keys; idx[i] = lower-bound index (clamped).
int bn_merge_join(const uint64_t* keys, size_t n, const uint64_t* q,
                  size_t m, uint8_t* ok, int32_t* idx) {
  size_t j = 0;
  for (size_t i = 0; i < m; ++i) {
    while (j < n && keys[j] < q[i]) ++j;
    size_t p = j < n ? j : n - 1;
    idx[i] = (int32_t)p;
    ok[i] = (uint8_t)(j < n && keys[j] == q[i]);
  }
  return BN_OK;
}

// List ranking over a predecessor forest by pointer doubling (the Wyllie
// stage of the unitig compaction — docstring semantics of
// assemble._wyllie_rank). rank/jump are packed into one u64 per node so
// each round costs ONE random gather instead of two, and rounds run
// threaded (random gathers overlap across cores). Cycle nodes keep
// doubling and exceed n — the caller's cycle detector.
int bn_list_rank(const int32_t* prev, size_t n, int32_t* rank_out,
                 int32_t* jump_out, int n_threads) {
  if (n == 0) return BN_OK;
  // packed[i] = (rank << 32) | jump  (jump as unsigned 32)
  std::vector<uint64_t> cur(n), nxt(n);
  for (size_t i = 0; i < n; ++i) {
    uint32_t j = prev[i] >= 0 ? (uint32_t)prev[i] : (uint32_t)i;
    uint64_t r = prev[i] >= 0 ? 1ull : 0ull;
    cur[i] = (r << 32) | j;
  }
  if (n_threads <= 0) n_threads = 1;
  size_t nt = (size_t)n_threads;
  if (nt > n) nt = 1;
  int rounds = 1;
  while ((size_t(1) << rounds) < n) ++rounds;  // ceil(log2 n)
  ++rounds;
  std::vector<uint8_t> changed(nt);
  for (int rd = 0; rd < rounds; ++rd) {
    auto work = [&](size_t ti) {
      size_t lo = n * ti / nt, hi = n * (ti + 1) / nt;
      uint8_t ch = 0;
      for (size_t i = lo; i < hi; ++i) {
        uint64_t me = cur[i];
        uint64_t tgt = cur[(uint32_t)me];
        uint64_t r = (me >> 32) + (tgt >> 32);
        // Saturate: on a cycle the rank doubles every round (up to ~4n);
        // for n > 2^30 an unsaturated r<<32 would wrap and corrupt the
        // packed value, defeating the rank >= n cycle detector. Once every
        // cycle node saturates, nv == me and the early exit fires with
        // rank == 2^32-1 >= n — still a detected cycle for any n < 2^31.
        if (r > 0xFFFFFFFFull) r = 0xFFFFFFFFull;
        uint32_t j = (uint32_t)tgt;
        uint64_t nv = (r << 32) | j;
        nxt[i] = nv;
        ch |= nv != me;
      }
      changed[ti] = ch;
    };
    if (nt == 1) {
      work(0);
    } else {
      std::vector<std::thread> ts;
      for (size_t ti = 0; ti < nt; ++ti) ts.emplace_back(work, ti);
      for (auto& t : ts) t.join();
    }
    cur.swap(nxt);
    uint8_t any = 0;
    for (size_t ti = 0; ti < nt; ++ti) any |= changed[ti];
    // Early exit compares the FULL packed (rank, jump) value: a cycle
    // whose length divides 2^round fixes its jump pointers, but its ranks
    // keep growing every round (rank[jump] > 0 on a cycle), so only true
    // chain convergence stops the loop — the rank >= n cycle detector
    // stays exact (the numpy twin needs a separate prev[jump] < 0 check
    // precisely because it compares jumps alone).
    if (!any) break;
  }
  for (size_t i = 0; i < n; ++i) {
    uint64_t v = cur[i];
    uint64_t r = v >> 32;
    rank_out[i] = (int32_t)(r > 0x7FFFFFFFull ? 0x7FFFFFFF : r);
    jump_out[i] = (int32_t)(uint32_t)v;
  }
  return BN_OK;
}

// Full de Bruijn edge structure in one native pass per base: for each of
// the 4 successor candidates y_b = (key >> 2) | b << 2(k-1) (sorted in
// key order), a two-pointer merge against the key set fills the
// membership planes, degrees, unique-successor/predecessor candidates,
// and the simple-edge function nxt and its inverse prev — the numpy
// version materialized per-b ok/idx/bincount temporaries and a fancy-
// index post stage that together dominated the graph build
// build. Semantics bit-match _Graph's numpy edge pass: succ1 = FIRST
// ok base's index (b=0's clamped lower bound when none), pred1 = LAST
// writing base, nxt/prev only where outdeg==1 && indeg[succ]==1.
int bn_graph_edges(const uint64_t* keys, size_t n, int k,
                   uint8_t* succ_ok, int32_t* succ_idx,
                   int32_t* outdeg, int32_t* indeg,
                   int32_t* succ1, int32_t* pred1,
                   int32_t* nxt, int32_t* prev) {
  if (n == 0) return BN_OK;
  int sh = 2 * (k - 1);
  std::memset(outdeg, 0, n * sizeof(int32_t));
  std::memset(indeg, 0, n * sizeof(int32_t));
  std::memset(pred1, 0, n * sizeof(int32_t));
  for (int b = 0; b < 4; ++b) {
    uint64_t hi = (uint64_t)b << sh;
    uint8_t* okp = succ_ok + (size_t)b * n;
    int32_t* idxp = succ_idx + (size_t)b * n;
    size_t j = 0;
    for (size_t i = 0; i < n; ++i) {
      uint64_t q = (keys[i] >> 2) | hi;
      while (j < n && keys[j] < q) ++j;
      size_t p = j < n ? j : n - 1;
      idxp[i] = (int32_t)p;
      bool ok = j < n && keys[j] == q;
      okp[i] = (uint8_t)ok;
      if (ok) {
        if (outdeg[i] == 0) succ1[i] = (int32_t)j;
        ++outdeg[i];
        ++indeg[j];
        pred1[j] = (int32_t)i;
      }
    }
  }
  for (size_t i = 0; i < n; ++i) {
    if (outdeg[i] == 0) succ1[i] = succ_idx[i];  // b=0 plane fallback
    prev[i] = -1;
    nxt[i] = -1;
  }
  for (size_t i = 0; i < n; ++i) {
    if (outdeg[i] == 1) {
      int32_t y = succ1[i];
      if (indeg[y] == 1) {
        nxt[i] = y;
        prev[y] = (int32_t)i;
      }
    }
  }
  return BN_OK;
}

// Stable u64 argsort: LSD radix (8-bit digits, constant-digit passes
// skipped). The assembler's strand-union and unitig-emit orderings are
// both u64 argsorts of multi-million-key arrays where numpy's comparison
// sort was the measured wall. order must hold n int32
// (n < 2^31).
int bn_argsort_u64(const uint64_t* keys, size_t n, int32_t* order) {
  std::vector<uint64_t> ka(keys, keys + n), kb(n);
  std::vector<int32_t> ia(n), ib(n);
  for (size_t i = 0; i < n; ++i) ia[i] = (int32_t)i;
  uint64_t *src = ka.data(), *dst = kb.data();
  int32_t *isrc = ia.data(), *idst = ib.data();
  for (int pass = 0; pass < 8; ++pass) {
    int sh = 8 * pass;
    size_t count[256] = {0};
    for (size_t i = 0; i < n; ++i) ++count[(src[i] >> sh) & 0xFF];
    size_t nonzero = 0, last = 0;
    for (int d = 0; d < 256; ++d)
      if (count[d]) { ++nonzero; last = count[d]; }
    if (nonzero <= 1 && last == n) continue;  // constant digit: skip
    size_t pos = 0;
    size_t offs[256];
    for (int d = 0; d < 256; ++d) { offs[d] = pos; pos += count[d]; }
    for (size_t i = 0; i < n; ++i) {
      size_t p = offs[(src[i] >> sh) & 0xFF]++;
      dst[p] = src[i];
      idst[p] = isrc[i];
    }
    std::swap(src, dst);
    std::swap(isrc, idst);
  }
  std::memcpy(order, isrc, n * sizeof(int32_t));
  return BN_OK;
}

// One-pass QC fold over a rectangular read batch: per-cycle base counts
// [L, 5], per-cycle quality histogram [L, qmax], mean-quality histogram
// [qmax], GC%% histogram [101]. The numpy fold pays two full bincount
// passes over L*R int32 key temporaries (qc.py::_Acc.fold); this walks
// the bytes once, multithreaded over row slabs with per-thread
// accumulators merged at the end. Symbol map matches qc._SYM
// (A/C/G/T -> 0..3 case-insensitive, everything else 4); phred clipped
// to [0, qmax); mean-q/GC rounding matches numpy's rint (half-to-even).
int bn_qc_fold(const uint8_t* ascii, const uint8_t* quals,
               const int32_t* lens, size_t R, size_t L, int qmax,
               int64_t* base_by_cycle, int64_t* qual_by_cycle,
               int64_t* mean_q_hist, int64_t* gc_hist, int n_threads) {
  uint8_t sym[256];
  for (int i = 0; i < 256; ++i) sym[i] = 4;
  const char* b = "ACGT";
  for (int i = 0; i < 4; ++i) {
    sym[(uint8_t)b[i]] = (uint8_t)i;
    sym[(uint8_t)(b[i] | 0x20)] = (uint8_t)i;
  }
  if (n_threads <= 0) n_threads = 1;
  size_t nt = (size_t)n_threads;
  if (nt > R) nt = R ? R : 1;
  std::vector<std::vector<int64_t>> tb(nt), tq(nt), tm(nt), tg(nt);
  std::vector<std::thread> threads;
  auto work = [&](size_t ti) {
    std::vector<int64_t>& bb = tb[ti];
    std::vector<int64_t>& qq = tq[ti];
    std::vector<int64_t>& mm = tm[ti];
    std::vector<int64_t>& gg = tg[ti];
    bb.assign(L * 5, 0);
    qq.assign(L * (size_t)qmax, 0);
    mm.assign((size_t)qmax, 0);
    gg.assign(101, 0);
    size_t lo = R * ti / nt, hi = R * (ti + 1) / nt;
    for (size_t r = lo; r < hi; ++r) {
      size_t n = (size_t)(lens[r] < 0 ? 0 : lens[r]);
      if (n > L) n = L;
      const uint8_t* a = ascii + r * L;
      const uint8_t* q = quals + r * L;
      int64_t qsum = 0;
      size_t gc = 0;
      for (size_t c = 0; c < n; ++c) {
        uint8_t s = sym[a[c]];
        ++bb[c * 5 + s];
        int ph = (int)q[c] - 33;
        if (ph < 0) ph = 0;
        if (ph >= qmax) ph = qmax - 1;
        ++qq[c * (size_t)qmax + (size_t)ph];
        qsum += ph;
        gc += (s == 1) | (s == 2);
      }
      size_t span = n ? n : 1;
      // numpy rint: round half to even
      double mq = (double)qsum / (double)span;
      long long mqi = llrint(mq);
      if (mqi < 0) mqi = 0;
      if (mqi >= qmax) mqi = qmax - 1;
      ++mm[(size_t)mqi];
      long long gci = llrint(100.0 * (double)gc / (double)span);
      if (gci < 0) gci = 0;
      if (gci > 100) gci = 100;
      ++gg[(size_t)gci];
    }
  };
  if (nt == 1) {
    work(0);
  } else {
    for (size_t ti = 0; ti < nt; ++ti) threads.emplace_back(work, ti);
    for (auto& t : threads) t.join();
  }
  for (size_t ti = 0; ti < nt; ++ti) {
    for (size_t i = 0; i < L * 5; ++i) base_by_cycle[i] += tb[ti][i];
    for (size_t i = 0; i < L * (size_t)qmax; ++i) qual_by_cycle[i] += tq[ti][i];
    for (int i = 0; i < qmax; ++i) mean_q_hist[i] += tm[ti][i];
    for (int i = 0; i <= 100; ++i) gc_hist[i] += tg[ti][i];
  }
  return BN_OK;
}

// Host k-mer spectrum over a packed read batch: the assembler's spectrum
// without a device pass. Semantics are those of ops.kmer.count_kmers_runs
// compacted: canonical = count min(kmer, revcomp(kmer)); windows touching
// an invalid base (valid[r*L + j] == 0) are dropped; output is ascending
// distinct u64 keys (the 2k-bit LSB-first window) with int32 counts,
// saturated at BN_SPECTRUM_COUNT_MAX (2^31 - 1). Two passes: threaded
// window emission into per-read offsets, a threaded LSD radix sort
// (per-pass per-thread counts, disjoint scatter regions), then one
// run-length pass.
//
// words: u32 row-major [B, W] (16 LSB-first bases per word, the reference
// crate's src/utils/packing/naive.rs:17 layout in u32 lanes); lens int32
// [B]; valid: NULL or u8 [B, L] with L == 16*W; out arrays hold at least
// min(total windows, 4^k) entries (the distinct keys' bound).
#ifndef BN_SPECTRUM_COUNT_MAX  // a test build lowers the clamp to reach it
#define BN_SPECTRUM_COUNT_MAX 0x7FFFFFFFull
#endif

int bn_spectrum(const uint32_t* words, size_t B, size_t W,
                const int32_t* lens, int k, int canonical,
                const uint8_t* valid, uint64_t* out_keys,
                int32_t* out_counts, int64_t* n_out, int n_threads) {
  if (k < 1 || k > 32) return BN_INVALID_LENGTH;
  size_t L = W * 16;
  // per-read emission offsets (upper bound: skipped invalid windows leave
  // gaps that compact away before the sort)
  std::vector<size_t> off(B + 1, 0);
  for (size_t r = 0; r < B; ++r) {
    int32_t len = lens[r];
    size_t nw = (len >= k) ? (size_t)(len - k + 1) : 0;
    off[r + 1] = off[r] + nw;
  }
  size_t total = off[B];
  *n_out = 0;
  if (total == 0) return BN_OK;
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  if (n_threads <= 0) n_threads = 1;
  size_t nt = (size_t)n_threads;
  if (nt > B) nt = B;
  auto run_threads = [&](size_t n, auto&& fn) {
    if (n == 1) {
      fn((size_t)0);
      return;
    }
    std::vector<std::thread> ts;
    for (size_t ti = 0; ti < n; ++ti) ts.emplace_back(fn, ti);
    for (auto& t : ts) t.join();
  };
  std::vector<uint64_t> keys(total);
  std::vector<size_t> emitted(B, 0);
  run_threads(nt, [&](size_t ti) {
    for (size_t r = B * ti / nt; r < B * (ti + 1) / nt; ++r) {
      int32_t len = lens[r];
      if (len < k) continue;
      const uint32_t* w = words + r * W;
      const uint8_t* v = valid ? valid + r * L : nullptr;
      uint64_t key = 0, rck = 0;
      int run = 0;  // consecutive valid bases ending at j
      size_t out = off[r];
      for (int32_t j = 0; j < len; ++j) {
        uint64_t b = (w[j >> 4] >> (2 * (j & 15))) & 3u;
        key = ((key >> 2) | (b << (2 * (k - 1)))) & mask;
        rck = ((rck << 2) | (3 - b)) & mask;
        run = (!v || v[j]) ? run + 1 : 0;
        if (j >= k - 1 && run >= k) keys[out++] = canonical && rck < key ? rck : key;
      }
      emitted[r] = out - off[r];
    }
  });
  // compact the invalid-window gaps (no-op when every window was valid)
  size_t n = 0;
  for (size_t r = 0; r < B; ++r) {
    if (n != off[r] && emitted[r])
      std::memmove(keys.data() + n, keys.data() + off[r],
                   emitted[r] * sizeof(uint64_t));
    n += emitted[r];
  }
  if (n == 0) return BN_OK;
  // threaded LSD radix over the 2k key bits
  int passes = (2 * k + 7) / 8;
  std::vector<uint64_t> alt(n);
  uint64_t* src = keys.data();
  uint64_t* dst = alt.data();
  size_t ntr = (size_t)n_threads;
  if (ntr < 1) ntr = 1;
  if (ntr > n) ntr = 1;
  std::vector<size_t> counts_t(ntr * 256);
  for (int pass = 0; pass < passes; ++pass) {
    int sh = 8 * pass;
    std::fill(counts_t.begin(), counts_t.end(), 0);
    run_threads(ntr, [&](size_t ti) {
      size_t lo = n * ti / ntr, hi = n * (ti + 1) / ntr;
      size_t* c = counts_t.data() + ti * 256;
      for (size_t i = lo; i < hi; ++i) ++c[(src[i] >> sh) & 0xFF];
    });
    // digit-major exclusive scan so each (digit, thread) slab is disjoint
    size_t pos = 0;
    bool constant = false;
    for (int d = 0; d < 256 && !constant; ++d) {
      size_t tot = 0;
      for (size_t ti = 0; ti < ntr; ++ti) tot += counts_t[ti * 256 + d];
      if (tot == n) constant = true;
    }
    if (constant) continue;
    for (int d = 0; d < 256; ++d)
      for (size_t ti = 0; ti < ntr; ++ti) {
        size_t c = counts_t[ti * 256 + d];
        counts_t[ti * 256 + d] = pos;
        pos += c;
      }
    run_threads(ntr, [&](size_t ti) {
      size_t lo = n * ti / ntr, hi = n * (ti + 1) / ntr;
      size_t* o = counts_t.data() + ti * 256;
      for (size_t i = lo; i < hi; ++i) dst[o[(src[i] >> sh) & 0xFF]++] = src[i];
    });
    std::swap(src, dst);
  }
  // run-length: distinct keys + counts
  size_t m = 0;
  for (size_t i = 0; i < n;) {
    size_t j = i + 1;
    while (j < n && src[j] == src[i]) ++j;
    out_keys[m] = src[i];
    size_t c = j - i;
    out_counts[m] = (int32_t)(c > BN_SPECTRUM_COUNT_MAX ? BN_SPECTRUM_COUNT_MAX : c);
    ++m;
    i = j;
  }
  *n_out = (int64_t)m;
  return BN_OK;
}

}  // extern "C"
