// K6 tc_scan: per-base Hamming distances of Q packed queries against a
// word-major database, [Q, W] x [W, D] -> [Q, D] int32, on the int8 tensor
// cores; and tc_search, the same main loop with a per-query top-k epilogue.
//
// Replaces bitnuc_tpu/ops/pallas/hamming.py::hdist_scan_batch_mxu (its
// pallas_call at hamming.py:268). With x0, x1 the +-1 codes of a base's two
// bits and x01 = x0 x1, S = sum over the first nb bases of x0q x0d + x1q x1d
// + x01q x01d is 4 matches - nb, so the distance is (3 nb - S) / 4, exactly
// (3 nb - S) >> 2. S is one int8 product [D, 48W] x [48W, Q] with int32
// sums. The distances equal K4/K5 and ops.hamming.hdist_many_to_many for any
// n_bases (clamped to 16 W; the TPU kernel counts 3 n_bases past the words),
// any W (the TPU's 48 W <= 4096 gate is a VMEM limit) and any Q.
//
// Bound on the card: the tensor cores (2 Q D 48 W int8 operations); tc_scan
// also writes the [Q, D] int32 matrix (4.3 GB at Q = 256, D = 4,194,304).
// The database is read once for every tile of N queries (a quarter byte a
// base); the query planes are streamed from L2 once a block tile.
//
// Plane order (both sides, ops.hamming): word pair p, then group g (x0, x1,
// x01), then the pair's 32 bases, so a k-step of 32 is one group of one word
// pair and a pair is three k-steps; an odd W gets a zero word, which the
// query planes (zero past nb) cancel.
//
// Design: wgmma.mma_async.m64nNk32.s32.s8.s8 with the database entries as M
// and the queries as N, N = 8, 32, 64, 128 or 256 (the smallest that covers
// Q; above 256, tiles of 256 queries). A, the database planes, comes from
// registers: lane 4 r + c of warp w holds rows 16 w + r and 16 w + r + 8 and
// k bytes 4c..4c+3 and 16 + 4c..; for the pair's three k-steps these are
// the +-1 bytes of byte c of word 2p and of word 2p + 1 of its two entries.
// So a thread reads four words a pair and expands them straight into the
// twelve A registers of the pair (twelve int32 operations a byte: a
// multiply spreads the byte's four bits of one kind to the four bytes), and
// the database planes touch neither device nor shared memory. B, the query
// planes, is read by the tensor cores from shared memory: the wrapper lays
// them out in PyTorch (ops.hamming._b_stages) as the shared-memory image of
// one pair, three k-steps of [N / 8][2 k halves][8 rows][16 bytes], core
// matrices of 8 rows x 16 bytes with no swizzle (descriptor LBO = 128 bytes
// between the k halves, SBO = 256 between groups of 8 rows), so a pair's
// operand is one contiguous cp.async.bulk completing on an mbarrier; no
// tensor map is needed. The same stage carries the pair's two words of the
// tile's 128 entries (1 KB), copied by the producer's 32 lanes with 4-byte
// cp.async (any D, no 16-byte alignment) completing on the same mbarrier,
// so no consumer waits on a load from device memory.
//
// A block is two consumer warpgroups (64 entries each, 128 a block tile)
// and a producer warp, which keeps a ring of up to eight pair stages in
// flight (full/empty mbarriers; every consumer warp releases a stage once
// its wgmma group on it is complete). At N = 256 the 128 accumulators a
// thread do not fit the 168 registers that 384 threads get at launch, so
// the producer warp's warpgroup gives its registers to the consumers
// (setmaxnreg: 56 for the producer, 224 for each consumer). A consumer
// issues pair p's three wgmma and commits them, waits for pair p - 1's
// group, and then expands pair p + 1's stage into the second of two A
// register sets while the tensor cores work on pair p. Blocks are
// persistent: the grid is about one wave (the occupancy the card reports,
// bn_tc_blocks_per_sm) for each tile of queries, and block g walks a
// contiguous range of 128-entry tiles. tc_scan writes (3 nb - S) >> 2
// straight from the accumulators with a streaming hint (a register's lanes
// cover 8 neighbouring entries of 4 queries, whole 32-byte sectors); its
// two warpgroups share no barrier, so one's stores overlap the other's
// products.
//
// tc_search keeps, for each query of the block's tile of N, the k smallest
// keys dist << 32 | index seen so far in shared memory, so the [Q, D]
// matrix is never written nor read back as int64 keys; its output is [Q, G,
// k] int64, merged by one torch.topk. Per query: a sorted list of up to
// k <= kSearchMax keys, a limit (a sum, derived from the k-th key's
// distance; INT_MIN until the list is full, INT_MAX past Q) and a buffer of
// candidates. After a tile's sums the two warpgroups offer in turn (a query
// then gets at most 64 candidates a round): a sum above its query's limit is
// appended to the query's buffer through an atomicAdd on its count, as
// dist << 8 | entry in the tile. If any sum was offered (a barrier of the
// consumers with an OR), one thread a query inserts the candidates whose
// key is below the list's k-th key into the sorted list, dropping the
// largest key of a full list, and sets the limit; keys are unique, so the
// order is exact whatever order the lanes offered them in. Random entries
// sit near 3/4 of n_bases, so after a query's first tiles few sums pass:
// most tiles' epilogue is one int32 compare a sum and a barrier a round.
// Entries past D never enter a list.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kConsumers = 256;            // two warpgroups of four warps
// and the producer: one warp, or at N = 256 a warpgroup whose other three
// warps only hand their registers to the consumers (setmaxnreg)
constexpr int threads_for(int N) { return N == 256 ? kConsumers + 128 : kConsumers + 32; }
constexpr int kConsumerRegs = 224;  // at N = 256: 2 x 128 x 224 + 128 x 56 = 168 x 384
constexpr int kProducerRegs = 56;
constexpr int kTileM = 128;                // entries of a block tile, 64 a warpgroup
constexpr int kSteps = 3;                  // k-steps of one word pair
constexpr int kLBO = 128;                  // bytes between the two k halves of a row group
constexpr int kSBO = 256;                  // bytes between groups of 8 rows
// the ring is as deep as shared memory allows, up to kMaxStages
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 2 * kMaxStages * 8;  // the ring's mbarriers, before the ring
constexpr size_t kSmemMax = 232448;        // shared memory a block may use
constexpr int kSearchMax = 32;             // ops.hamming.SEARCH_TOPK_MAX
constexpr int kCandSlots = 64;             // a query's candidates in one round

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one contiguous global -> shared copy that completes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// keeps the compiler from moving accesses of the accumulators across this point
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the consumers' named barrier (id 1; the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ bool consumers_or(bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, %2, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)v), "n"(kConsumers)
      : "memory");
  return r != 0;
}

// shared-memory descriptor of one k-step of B: no swizzle, K-major core
// matrices of 8 rows x 16 bytes
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);
}

// The four bases of the low byte of e as +-1 int8 bytes of the three
// planes: x0 = 2 b0 - 1, x1 = 2 b1 - 1, x01 = 1 - 2 (b0 ^ b1). Multiplying
// by 1 + 2^6 + 2^12 + 2^18 moves bit 2i (2i + 1) to bit 8i (8i + 1); the
// other products fall between the kept bits and carry no further.
__device__ __forceinline__ void expand(uint32_t e, uint32_t& x0, uint32_t& x1, uint32_t& x01) {
  const uint32_t n0 = ((~e & 0x55u) * 0x41041u) & 0x01010101u;  // 1 - b0 a byte
  const uint32_t n1 = ((~e & 0xAAu) * 0x41041u) & 0x02020202u;  // 2 (1 - b1)
  x0 = n0 * 0xFEu + 0x01010101u;                                // 0 -> 0x01, 1 -> 0xFF
  x1 = n1 * 0x7Fu + 0x01010101u;
  x01 = (n0 ^ (n1 >> 1)) * 0xFEu + 0x01010101u;
}

// wgmma.mma_async m64nNk32 s32 += s8 x s8, A from registers, B from the
// shared-memory descriptor; N / 2 int32 accumulators a thread.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(int (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
          "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
          "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// A stage: the pair's B operand (3 k-steps of N x 32 bytes), then the
// pair's two database words of the tile's 128 entries (word 2p, word 2p + 1).
template <int N>
struct Stage {
  static constexpr uint32_t kStepBytes = N * 32;
  static constexpr uint32_t kBBytes = kSteps * kStepBytes;
  static constexpr uint32_t kBytes = kBBytes + 2 * kTileM * 4;
};

// 4 bytes global -> shared, completion tracked by the mbarrier below
__device__ __forceinline__ void copy_word(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The ring's position: the same sequence of (tile, pair) for the producer
// and every consumer.
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  int n;      // stages
  int slot;
  int phase;
};

__device__ __forceinline__ void ring_next(Ring& ring) {
  if (++ring.slot == ring.n) {
    ring.slot = 0;
    ring.phase ^= 1;
  }
}

// the stage before the ring's current one
__device__ __forceinline__ int ring_prev(const Ring& ring) {
  return ring.slot == 0 ? ring.n - 1 : ring.slot - 1;
}

// Wait for the ring's current stage and expand its database words into A
// set S: rows row and row + 8 of the tile, byte c (shift sh) of each word.
template <int N, int S>
__device__ __forceinline__ void expand_stage(uint32_t (&A)[2][kSteps][4], const Ring& ring,
                                             int row, int sh) {
  mbar_wait(&ring.full[ring.slot], ring.phase);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(
      ring.stages + ring.slot * Stage<N>::kBytes + Stage<N>::kBBytes);
  const uint32_t v[4] = {w[row], w[row + 8], w[kTileM + row], w[kTileM + row + 8]};
#pragma unroll
  for (int i = 0; i < 4; ++i) expand(v[i] >> sh, A[S][0][i], A[S][1][i], A[S][2][i]);
}

// One word pair p of a consumer, its stage waited for and expanded into A
// set S: issue its three k-steps and commit, wait for pair p - 1's group and
// release its stage, then expand pair p + 1 into the set p - 1 used.
template <int N, int S>
__device__ __forceinline__ void pair_step(int (&acc)[N / 2], uint32_t (&A)[2][kSteps][4],
                                          Ring& ring, int p, int P, int row, int sh, int lane) {
  const uint32_t base = smem_u32(ring.stages + ring.slot * Stage<N>::kBytes);
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    Wgmma<N>::mma(acc, A[S][ks], b_desc(base + ks * Stage<N>::kStepBytes));
  }
  wg_commit();
  wg_wait<1>();
  if (p > 0 && lane == 0) mbar_arrive(&ring.empty[ring_prev(ring)]);
  ring_next(ring);
  if (p + 1 < P) expand_stage<N, S ^ 1>(A, ring, row, sh);
}

__device__ __forceinline__ long long cand_key(uint32_t c, int64_t d0) {
  return ((long long)(c >> 8) << 32) | (long long)(d0 + (c & 0xFFu));
}

// Shared memory past the ring in tc_search: lists [N][k | 1] keys (an odd
// stride: the merge's threads, one a query, then hit distinct banks), then
// lim, cnt, ncand [N] and cand [N][kCandSlots + 1].
__host__ __device__ inline size_t search_bytes(int N, int k) {
  return (size_t)N * (k | 1) * 8 + (size_t)3 * N * 4 + (size_t)N * (kCandSlots + 1) * 4;
}

// Block blockIdx.x = g n_qt + qt computes queries [qt N, qt N + N) against
// entry tiles [g per_block, min((g + 1) per_block, n_mt)) of 128.
template <int N, bool kSearch>
__global__ void __launch_bounds__(threads_for(N), 1)
k6_kernel(const int8_t* __restrict__ bplanes, const uint32_t* __restrict__ db, int64_t Q, int W,
          int64_t D, int nb, int k, int64_t n_qt, int64_t G, int64_t per_block, int n_stages,
          int32_t* __restrict__ out_scan, long long* __restrict__ out_search) {
  constexpr int kR = N / 2;
  constexpr uint32_t kStageBytes = Stage<N>::kBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* stages = smem + kBarBytes;
  unsigned char* extra = stages + (size_t)n_stages * kStageBytes;
  const int ks = k | 1;
  long long* lists = reinterpret_cast<long long*>(extra);
  int* lim = reinterpret_cast<int*>(extra + (size_t)N * ks * 8);
  int* cnt = lim + N;
  int* ncand = cnt + N;
  uint32_t* cand = reinterpret_cast<uint32_t*>(ncand + N);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t qt = blockIdx.x % n_qt, g = blockIdx.x / n_qt;
  const int64_t n_mt = (D + kTileM - 1) / kTileM;
  const int64_t t_begin = g * per_block;
  const int64_t t_end = t_begin + per_block < n_mt ? t_begin + per_block : n_mt;
  const int P = (W + 1) / 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the bulk copy's expect_tx and the words' 32 lanes
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kSearch) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      lim[i] = qt * N + i < Q ? INT_MIN : INT_MAX;
      cnt[i] = 0;
      ncand[i] = 0;
    }
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer: one pair's query planes a stage
    if constexpr (N == 256) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    }
    if (warp == kConsumers / 32) {
      const int8_t* src = bplanes + qt * (int64_t)P * Stage<N>::kBBytes;
      int slot = 0, phase = 0;
      for (int64_t t = t_begin; t < t_end; ++t) {
        for (int p = 0; p < P; ++p) {
          unsigned char* st = stages + slot * kStageBytes;
          mbar_wait(&empty[slot], phase ^ 1);
          if (lane == 0) {
            mbar_expect_tx(&full[slot], Stage<N>::kBBytes);
            bulk_copy(st, src + (int64_t)p * Stage<N>::kBBytes, Stage<N>::kBBytes, &full[slot]);
          }
          // the pair's words of the tile's entries; rows past D and a word
          // past W (odd W) are left as they are: their sums are never read,
          // and the query planes are zero there
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int i = lane + 32 * m, word = 2 * p + i / kTileM;
            const int64_t e = t * kTileM + i % kTileM;
            if (e < D && word < W) {
              copy_word(st + Stage<N>::kBBytes + 4 * i, db + (int64_t)word * D + e);
            }
          }
          copies_arrive(&full[slot]);
          if (++slot == n_stages) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg, its warp wr holds entry rows 16 wr + r (+ 8)
  if constexpr (N == 256) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  }
  const int wg = warp >> 2, wr = warp & 3;
  const int r = lane >> 2, c = lane & 3;
  const int row = 64 * wg + 16 * wr + r;  // entry in the block tile; row + 8 the other
  const int sh = 8 * c;
  const int three_nb = 3 * nb;
  Ring ring{stages, full, empty, n_stages, 0, 0};
  uint32_t A[2][kSteps][4];
  int acc[kR];
  for (int64_t t = t_begin; t < t_end; ++t) {
#pragma unroll
    for (int i = 0; i < kR; ++i) acc[i] = 0;
    if (P > 0) expand_stage<N, 0>(A, ring, row, sh);
    for (int p = 0; p < P; p += 2) {
      pair_step<N, 0>(acc, A, ring, p, P, row, sh, lane);
      if (p + 1 < P) pair_step<N, 1>(acc, A, ring, p + 1, P, row, sh, lane);
    }
    wg_wait<0>();
    if (P > 0 && lane == 0) mbar_arrive(&ring.empty[ring_prev(ring)]);  // the last pair's stage
    fence_regs(acc);

    const int64_t e0 = t * kTileM + row, e1 = e0 + 8;
    if constexpr (!kSearch) {
      // register 4 j + 2 h + i: entry row (+ 8 h), query 8 j + 2 c + i. The
      // row stride is opaque to the compiler, so it does not keep N / 2 row
      // pointers live across the main loop.
      int64_t ld = D;
      asm volatile("" : "+l"(ld));
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int64_t q = qt * N + 8 * j + 2 * c + i;
          if (q >= Q) continue;
          int32_t* o = out_scan + q * ld;
          if (e0 < D) __stcs(o + e0, (three_nb - acc[4 * j + i]) >> 2);
          if (e1 < D) __stcs(o + e1, (three_nb - acc[4 * j + 2 + i]) >> 2);
        }
      }
      continue;
    }

    // tc_search: warpgroup 0 offers (64 entries a query), the consumers
    // merge; then warpgroup 1. A full list's limit is 3 nb - 4 (dist_k + 1), dist_k the distance of
    // its k-th key: a sum above it is a distance <= dist_k, which may tie
    // dist_k at a lower index. The merge tests the exact key.
    const int64_t d0 = t * kTileM;
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      bool offered = false;
      if (wg == round) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = 8 * j + 2 * c + i;
            const int l = lim[q];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int sum = acc[4 * j + 2 * h + i];
              if (sum > l && (h ? e1 : e0) < D) {
                const int at = atomicAdd(&ncand[q], 1);
                cand[q * (kCandSlots + 1) + at] =
                    ((uint32_t)((three_nb - sum) >> 2) << 8) | (uint32_t)(row + 8 * h);
                offered = true;
              }
            }
          }
        }
      }
      // merge, only where a sum was offered: one thread a query inserts its
      // candidates whose key is below the list's k-th into the sorted list
      if (consumers_or(offered)) {
        const int q = threadIdx.x;
        if (q < N && ncand[q] > 0) {
          const int n = ncand[q];
          long long* L = lists + q * ks;
          int m = cnt[q];
          long long th = m == k ? L[k - 1] : LLONG_MAX;
          for (int ci = 0; ci < n; ++ci) {
            const long long key = cand_key(cand[q * (kCandSlots + 1) + ci], d0);
            if (key >= th) continue;
            int pos = m < k ? m : k - 1;  // a full list drops its largest key
            while (pos > 0 && L[pos - 1] > key) {
              L[pos] = L[pos - 1];
              --pos;
            }
            L[pos] = key;
            if (m < k) ++m;
            if (m == k) th = L[k - 1];
          }
          cnt[q] = m;
          lim[q] = m == k ? three_nb - 4 * ((int)(th >> 32) + 1) : INT_MIN;
          ncand[q] = 0;
        }
        consumers_sync();
      }
    }
  }

  if constexpr (kSearch) {
    // each query's list, padded with INT64_MAX, at out[q][g][0..k)
    consumers_sync();
    for (int qi = warp; qi < N; qi += kConsumers / 32) {
      const int64_t q = qt * N + qi;
      if (q >= Q) continue;
      long long* o = out_search + (q * G + g) * k;
      const int m = cnt[qi];
      for (int s = lane; s < k; s += 32) o[s] = s < m ? lists[qi * ks + s] : LLONG_MAX;
    }
  }
}

// Shared memory of one block and the ring's stage count (up to kMaxStages):
// the deepest ring that leaves room for two blocks an SM below N = 128.
size_t k6_smem(int N, bool search, int k, int* n_stages) {
  const size_t stage = (size_t)kSteps * N * 32 + 2 * kTileM * 4;  // Stage<N>::kBytes
  const size_t fixed = kBarBytes + (search ? search_bytes(N, k) : 0);
  const size_t budget = kSmemMax / (N < 128 ? 2 : 1) - 1024;  // less the 1 KB CUDA reserves a block
  size_t s = fixed < budget ? (budget - fixed) / stage : 0;
  if (s > kMaxStages) s = kMaxStages;
  *n_stages = (int)s;
  return fixed + s * stage;
}

struct Args {
  const int8_t* bplanes;
  const uint32_t* db;
  int64_t Q;
  int W;
  int64_t D;
  int nb;
  int k;
  int64_t n_qt;
  int64_t G;
  int64_t per_block;
  int32_t* out_scan;
  long long* out_search;
};

// occupancy (blocks an SM) when blocks_per_sm is set; else the launch
template <int N, bool kSearch>
cudaError_t run(const Args& a, cudaStream_t stream, int* blocks_per_sm) {
  int n_stages = 0;
  const size_t smem = k6_smem(N, kSearch, a.k, &n_stages);
  // a consumer holds two stages (one in flight, one expanded); a third lets
  // the producer run ahead
  if (n_stages < 3) return cudaErrorInvalidValue;
  auto fn = k6_kernel<N, kSearch>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_per_sm) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads_for(N), smem);
  }
  const int64_t blocks = a.n_qt * a.G;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  fn<<<(unsigned)blocks, threads_for(N), smem, stream>>>(a.bplanes, a.db, a.Q, a.W, a.D, a.nb, a.k,
                                                   a.n_qt, a.G, a.per_block, n_stages,
                                                   a.out_scan, a.out_search);
  return cudaGetLastError();
}

template <bool kSearch>
cudaError_t dispatch(int N, const Args& a, cudaStream_t stream, int* blocks_per_sm) {
  switch (N) {
    case 8: return run<8, kSearch>(a, stream, blocks_per_sm);
    case 32: return run<32, kSearch>(a, stream, blocks_per_sm);
    case 64: return run<64, kSearch>(a, stream, blocks_per_sm);
    case 128: return run<128, kSearch>(a, stream, blocks_per_sm);
    case 256: return run<256, kSearch>(a, stream, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// The arguments both entry points share; n_qt from Q and N.
cudaError_t check_args(int64_t Q, int64_t W, int64_t D, int nb, int N, int64_t G,
                       int64_t per_block, Args* a) {
  if (Q < 0 || W < 0 || D < 0 || D > 0x7FFFFFFF || nb < 0 || nb > 16 * W || W >= (1 << 19)) {
    return cudaErrorInvalidValue;
  }
  if (Q == 0 || D == 0) return cudaSuccess;
  const int64_t n_mt = (D + kTileM - 1) / kTileM;
  if (G < 1 || per_block < 1 || G * per_block < n_mt) return cudaErrorInvalidValue;
  a->Q = Q;
  a->W = (int)W;
  a->D = D;
  a->nb = nb;
  a->n_qt = (Q + N - 1) / N;
  a->G = G;
  a->per_block = per_block;
  return cudaSuccess;
}

}  // namespace

// Blocks of K6 that fit an SM at tile width N (8, 32, 64, 128, 256), for
// tc_scan (search = 0) or tc_search with k keys a query; into *out (int).
extern "C" int bn_tc_blocks_per_sm(int N, int search, int k, void* out) {
  if (search && (k < 1 || k > kSearchMax)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.k = search ? k : 1;
  int* n = (int*)out;
  return (int)(search ? dispatch<true>(N, a, nullptr, n) : dispatch<false>(N, a, nullptr, n));
}

// bplanes: the query planes in B-stage layout (ops.hamming._b_stages),
// ceil(Q / N) tiles x ceil(W / 2) pairs x 3 k-steps x N x 32 bytes; db
// [W, D] uint32 word-major; out [Q, D] int32; nb in [0, 16 W]. Block g of
// each query tile walks entry tiles [g per_block, (g + 1) per_block) of
// 128; G per_block must cover D.
extern "C" int bn_tc_scan(const void* bplanes, const void* db, int64_t Q, int64_t W, int64_t D,
                          int nb, int N, int64_t G, int64_t per_block, void* out, void* stream) {
  Args a{};
  cudaError_t err = check_args(Q, W, D, nb, N, G, per_block, &a);
  if (err != cudaSuccess) return (int)err;
  if (Q == 0 || D == 0) return (int)cudaGetLastError();
  a.bplanes = (const int8_t*)bplanes;
  a.db = (const uint32_t*)db;
  a.k = 1;
  a.out_scan = (int32_t*)out;
  return (int)dispatch<false>(N, a, (cudaStream_t)stream, nullptr);
}

// As bn_tc_scan; out [Q, G, k] int64: block g's k smallest keys
// dist << 32 | index of each query, ascending, padded with INT64_MAX.
// 1 <= k <= 32.
extern "C" int bn_tc_search(const void* bplanes, const void* db, int64_t Q, int64_t W,
                            int64_t D, int nb, int k, int N, int64_t G, int64_t per_block,
                            void* out, void* stream) {
  if (k < 1 || k > kSearchMax) return (int)cudaErrorInvalidValue;
  Args a{};
  cudaError_t err = check_args(Q, W, D, nb, N, G, per_block, &a);
  if (err != cudaSuccess) return (int)err;
  if (Q == 0 || D == 0) return (int)cudaGetLastError();
  a.bplanes = (const int8_t*)bplanes;
  a.db = (const uint32_t*)db;
  a.k = k;
  a.out_search = (long long*)out;
  return (int)dispatch<true>(N, a, (cudaStream_t)stream, nullptr);
}
