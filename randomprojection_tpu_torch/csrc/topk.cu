// Exact Hamming top-m of packed codes for Hopper (sm_90a).
//
// Replaces the TPU kernel of randomprojection_tpu/ops/topk_kernels.py:
//   _topk_kernel (291-399), launched by _fused_impl (406) at pallas_call 449,
//   whose public entry is fused_topk (479).
//
// What it computes.  For each query row q and each code row r < n_real of a
// chunk, dist = popcount(q XOR code) over all n_bytes*8 bits (pad bits are
// zero on both sides and cancel).  Rows with r >= n_real and rows with
// dead[r] == 1 never enter a selection, which is what the TPU kernel's
// sentinel masking before selection achieves.  The output is the m smallest
// by (dist, lower chunk-local id), ascending; a slot no live row fills is
// exactly (n_bytes*8 + 1, 2^31 - 1), as the TPU kernel forces at 383-390 and
// the host cross-chunk merge relies on.
//
// What bounds it.  At the serving shape (2048 queries x 2^24 codes of 32
// bytes, m = 16) the function must read 512 MiB (0.16 ms at 3.35 TB/s) and
// do 2*nq*rows*n_bits = 1.76e13 +-1 products, 8.9 ms at the 1,979 TOPS int8
// tensor-core rate: it is bound by operations.  The 1-bit tensor-core
// product used here takes a 256-bit step in the time of a 32-value int8
// step (measured: torch_experiments/k4_product.py), so a pair needs at
// least an eighth of that, 1.1 ms; this kernel spends two steps a pair
// (2.3 ms).  Beside it stand the selection's register compares on the
// CUDA cores (3.4e10 of them, 2.4 ms at the integer rate), the shared
// memory the products and the staging read and write (about 64 KB a tile,
// 2.4 ms) and the survivors' inserts, a list's warm-up in every row split.
// Measured on an H100 (PERF.md; torch_experiments/k4_parts.py takes the
// parts out one at a time): about half the time is products, staging and
// compares, which overlap only in part, and half the survivors' path, in
// which one warp's insert holds its whole warpgroup at the next product.
//
// What the design does about it.  The TPU grid walks query tiles and loops
// over every row block inside one program, carrying the running top-m in
// VMEM.  Here blocks run in parallel, so the grid is (query tile x row
// split), and a second small launch merges each query's splits.  There are
// two scan routes, chosen by the planner from the shape alone
// (ops/topk_kernels.py::plan_fused):
//   route "wgmma" (topk_mma_kernel), every shape whose lists fit beside the
//     ring: a block holds 64 or 128 queries (one or two consumer
//     warpgroups) and scans its split's rows in tiles of 256.
//     * The product on the tensor cores.  wgmma m64n256k256 .b1 .and.popc
//       gives popc(a & b); with A = [q, ~q] and B = [~c, c] two steps sum to
//       popc(q & ~c) + popc(~q & c) = popc(q ^ c), the distance itself, in
//       the s32 accumulator: exact, and no identity is left for the
//       epilogue.  A row is cut into 32-byte k-steps, zero past its end (a
//       zero on the plain side cancels the one on the complemented side),
//       so any width streams through the same stage.
//     * Staging.  The producer warps take the (row tile, k-step) items in
//       turn; a warp copies its item with cp.async straight into a ring of
//       up to 8 stages, in the 32-byte-swizzled K-major layout wgmma reads,
//       zero-filled past the matrix, so four copies (eight with a ring of
//       8) are in flight.  When a lane's own pieces have landed it writes
//       their complements beside them, and one lane arrives on the stage's
//       full mbarrier; the consumers' empty mbarrier hands the stage back.
//       Copies are 16 bytes where rows allow, else 4-byte words, else byte
//       loads.
//     * Selection from the accumulator registers.  Each consumer thread
//       owns two query rows of the 64 x 256 distances and keeps each row's
//       threshold (the distance of its m-th best) in a register; the test
//       is one compare a pair (a running minimum, then one test a row).
//       Ids only ascend inside a block's scan, so a later row at the
//       threshold's distance never displaces a listed one: the strict
//       compare on 32 bits is enough.  Only survivors touch shared memory:
//       a warp votes, and for each survivor looks the code row up in the
//       tile's liveness bits and inserts (dist << 32 | id) into the
//       query's sorted list, which the warp owns; thresholds are read
//       again after each insert.  The lists (TQ x m keys) go to a scratch
//       buffer.
//     * Rows that never enter.  The producer reads the tile's 256
//       tombstone bytes with its copies and leaves, beside the stage, a
//       bit a row (live: below n_real and not tombstoned) and a flag; a
//       tile with no live row is passed over without a product; the
//       consumers take the bits into registers with the products, so the
//       survivors' path never reads the dead mask from global memory.
//   route "popc" (topk_scan_kernel), the rest (m past what the tensor-core
//     route's lists fit, up to 1024): the scan on the CUDA cores, TQ =
//     16/32/64 queries against tiles of 128 rows, a 32-bit XOR and __popc
//     a word, the tile's distances through shared memory, one warp a query
//     testing them against its list.
//   pass 2 (topk_merge_kernel): one warp per query merges its <= 32 sorted
//     split lists, one lane per list, into the final m (dist, idx).
// Row splits exist because a TopKServer batch of 128-640 queries gives too
// few query tiles to fill 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // popc route: 16 query groups x 16 row lanes
constexpr int kRows = 128;                 // popc route: code rows per tile
constexpr int kRowsPerThread = kRows / 16;
constexpr int kChunkWords = 32;            // popc route: words of a row staged per step
constexpr int kStride = kChunkWords + 1;   // odd: 16 rows in 16 banks
constexpr int kMaxSplits = 32;             // one merge lane per split
constexpr long long kMaxKey = 0x7FFFFFFFFFFFFFFFLL;

constexpr int kTileN = 256;                // wgmma route: code rows per tile
constexpr int kStepBytes = 32;             // bytes of a row per k-step
constexpr int kMaxStages = 8;
constexpr int kProducerThreads = 128;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block can use
constexpr int kLiveBytes = 64;             // a stage's row-liveness bits (32) and flag
constexpr int kSmemSlack =                 // 1024-byte alignment, barriers, liveness
    1024 + 128 + kMaxStages * kLiveBytes;

struct ScanArgs {
  const uint8_t* q;
  const uint8_t* codes;
  const uint8_t* dead;  // nullptr: no tombstones in this chunk
  long long* part;      // (nq, splits, m) keys, each split's list ascending
  int64_t nq;
  int64_t rows;
  int64_t n_real;
  int64_t n_bytes;
  int m;
  int splits;
  int tiles_per_split;
  int aligned;          // n_bytes % 4 == 0 and both bases 4-aligned
  uint32_t sentinel;    // n_bytes * 8 + 1
};

__device__ __forceinline__ uint32_t load_word(const uint8_t* base, int64_t row,
                                              int64_t n_bytes, int64_t w,
                                              int aligned) {
  const uint8_t* p = base + row * n_bytes + w * 4;
  if (aligned) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
  for (int b = 0; b < 4; ++b)
    if (w * 4 + b < n_bytes) v |= static_cast<uint32_t>(p[b]) << (8 * b);
  return v;
}

// Insert key into the ascending list of m keys (key < list[m-1]); the whole
// warp calls it with the same key.
__device__ __noinline__ void insert_key(long long* list, int m, long long key,
                                        int lane) {
  int lo = 0, hi = m - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < key) lo = mid + 1; else hi = mid;
  }
  __syncwarp();
  // shift [lo, m-2] up by one, from the top down, 32 entries a step
  for (int base = m - 2; base >= lo; base -= 32) {
    const int j = base - lane;
    const bool act = j >= lo;
    long long v = 0;
    if (act) v = list[j];
    __syncwarp();
    if (act) list[j + 1] = v;
    __syncwarp();
  }
  if (lane == 0) list[lo] = key;
  __syncwarp();
}

template <int QPT>
__global__ void __launch_bounds__(kThreads) topk_scan_kernel(ScanArgs a) {
  constexpr int kTQ = 16 * QPT;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* lists = reinterpret_cast<long long*>(smem);          // kTQ x m
  uint32_t* qs = reinterpret_cast<uint32_t*>(lists + kTQ * a.m);  // kTQ x kStride
  uint32_t* cs = qs + kTQ * kStride;                              // kRows x kStride
  int* dt = reinterpret_cast<int*>(cs + kRows * kStride);        // kTQ x kRows

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;  // rows tx + 16 i of the tile
  const int ty = tid >> 4;  // queries ty*QPT .. ty*QPT + QPT-1 of the block
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kTQ;
  const int split = blockIdx.y;
  const int64_t n_words = (a.n_bytes + 3) / 4;
  const int64_t n_tiles = (a.rows + kRows - 1) / kRows;
  const int64_t tile0 = static_cast<int64_t>(split) * a.tiles_per_split;
  const int64_t tile_end =
      tile0 + a.tiles_per_split < n_tiles ? tile0 + a.tiles_per_split : n_tiles;
  const long long empty =
      (static_cast<long long>(a.sentinel) << 32) | 0x7FFFFFFFLL;

  for (int e = tid; e < kTQ * a.m; e += kThreads) lists[e] = empty;

  for (int64_t t = tile0; t < tile_end; ++t) {
    const int64_t r0 = t * kRows;
    int acc[QPT][kRowsPerThread];
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[i][j] = 0;

    for (int64_t w0 = 0; w0 < n_words; w0 += kChunkWords) {
      const int cw = static_cast<int>(
          n_words - w0 < kChunkWords ? n_words - w0 : kChunkWords);
      // the previous chunk's reads and the previous tile's selection are
      // done before the buffers are overwritten
      __syncthreads();
      for (int e = tid; e < kTQ * cw; e += kThreads) {
        const int qi = e / cw;
        const int w = e - qi * cw;
        const int64_t gq = q0 + qi;
        qs[qi * kStride + w] =
            gq < a.nq ? load_word(a.q, gq, a.n_bytes, w0 + w, a.aligned) : 0u;
      }
      for (int e = tid; e < kRows * cw; e += kThreads) {
        const int r = e / cw;
        const int w = e - r * cw;
        const int64_t gr = r0 + r;
        cs[r * kStride + w] =
            gr < a.rows ? load_word(a.codes, gr, a.n_bytes, w0 + w, a.aligned)
                        : 0u;
      }
      __syncthreads();
      for (int w = 0; w < cw; ++w) {
        uint32_t qv[QPT];
        uint32_t cv[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < QPT; ++i) qv[i] = qs[(ty * QPT + i) * kStride + w];
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
          cv[j] = cs[(tx + 16 * j) * kStride + w];
#pragma unroll
        for (int i = 0; i < QPT; ++i)
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            acc[i][j] += __popc(qv[i] ^ cv[j]);
      }
    }

    // distances of live rows; -1 keeps a pad or tombstoned row out
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = tx + 16 * j;
      const int64_t gr = r0 + r;
      const bool live =
          gr < a.n_real && (a.dead == nullptr || a.dead[gr] == 0);
#pragma unroll
      for (int i = 0; i < QPT; ++i)
        dt[(ty * QPT + i) * kRows + r] = live ? acc[i][j] : -1;
    }
    __syncthreads();

    // one warp per query: keys that beat the m-th best go into its list
    for (int qi = warp; qi < kTQ && q0 + qi < a.nq; qi += kThreads / 32) {
      long long* list = lists + static_cast<int64_t>(qi) * a.m;
      long long thr = list[a.m - 1];
      for (int j = 0; j < kRows; j += 32) {
        const int d = dt[qi * kRows + j + lane];
        const long long key =
            d >= 0 ? (static_cast<long long>(d) << 32) | (r0 + j + lane)
                   : kMaxKey;
        unsigned cand = __ballot_sync(0xFFFFFFFFu, key < thr);
        while (cand) {
          const int src = __ffs(cand) - 1;
          cand &= cand - 1;
          const long long k = __shfl_sync(0xFFFFFFFFu, key, src);
          if (k < thr) {
            insert_key(list, a.m, k, lane);
            thr = list[a.m - 1];
          }
        }
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < kTQ * a.m; e += kThreads) {
    const int qi = e / a.m;
    const int j = e - qi * a.m;
    const int64_t gq = q0 + qi;
    if (gq < a.nq) a.part[(gq * a.splits + split) * a.m + j] = lists[e];
  }
}

__global__ void topk_merge_kernel(const long long* __restrict__ part,
                                  int64_t nq, int splits, int m,
                                  uint32_t sentinel, int* __restrict__ dist,
                                  int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const int64_t q =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (q >= nq) return;  // the whole warp leaves together
  const long long* mine = part + (q * splits + lane) * m;
  int p = 0;
  long long head = lane < splits ? mine[0] : kMaxKey;
  for (int t = 0; t < m; ++t) {
    long long best = head;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long other = __shfl_xor_sync(0xFFFFFFFFu, best, o);
      best = other < best ? other : best;
    }
    // empty slots carry equal keys in several lists: the lowest lane wins
    const int src = __ffs(__ballot_sync(0xFFFFFFFFu, head == best)) - 1;
    if (lane == 0) {
      int d = static_cast<int>(best >> 32);
      int id = static_cast<int>(best & 0xFFFFFFFFLL);
      if (d >= static_cast<int>(sentinel)) {
        d = static_cast<int>(sentinel);
        id = 0x7FFFFFFF;
      }
      dist[q * m + t] = d;
      idx[q * m + t] = id;
    }
    if (lane == src) {
      ++p;
      head = p < m ? mine[p] : kMaxKey;
    }
  }
}


// -- the tensor-core route ----------------------------------------------------------

#define RP_REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127"

#define RP_OUTS128 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), \
  "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), \
  "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), \
  "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), \
  "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), \
  "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), \
  "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), \
  "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), \
  "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), \
  "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), \
  "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), \
  "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), \
  "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), \
  "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), \
  "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), \
  "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), \
  "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), \
  "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), \
  "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), \
  "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), \
  "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), \
  "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), \
  "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), \
  "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), \
  "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), \
  "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), \
  "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), \
  "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), \
  "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), \
  "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), \
  "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])

// d (64 x 256, s32) = popc(A & B) (+ d when accumulate): A 64 rows, B 256
// rows, 256 bits each, from shared memory through descriptors
__device__ __forceinline__ void wgmma_and_popc(int (&d)[128], uint64_t desc_a,
                                               uint64_t desc_b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc "
      "{" RP_REGS128 "}, %128, %129, p;\n}\n"
      : RP_OUTS128
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// A wait that never ends is a fault of the pipeline: trap (a launch error
// the wrapper raises) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity); ++spins) {
    if (spins == (1u << 26)) __trap();
  }
}

// wgmma descriptor of a K-major tile of 32-byte rows in the 32-byte
// swizzle (8-row atoms 256 bytes apart)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (16ull << 32) | (3ull << 62);
}

// byte offset of the 16-byte half `half` of row r in that layout
__device__ __forceinline__ uint32_t swz32(int r, int half) {
  return (r >> 3) * 256 + (r & 7) * 32 + (((half ^ (r >> 2)) & 1) << 4);
}

struct MmaArgs {
  const uint8_t* q;
  const uint8_t* codes;
  const uint8_t* dead;  // nullptr: no tombstones in this chunk
  long long* part;      // (nq, splits, m) keys, each split's list ascending
  int64_t nq;
  int64_t rows;
  int64_t n_real;
  int64_t n_bytes;
  int m;
  int splits;
  int tiles_per_split;
  int stages;
  uint32_t sentinel;    // n_bytes * 8 + 1
};

constexpr int kCodeStage = 2 * kTileN * kStepBytes;  // a tile's k-step, and its complement

// One k-step of the block's queries and its complement.  With one step a
// row the queries never change and one slot serves every stage; wider rows
// ring their steps beside the code stages.
__host__ __device__ constexpr int mma_q_slots(int64_t n_bytes, int stages) {
  return n_bytes > kStepBytes ? stages : 1;
}

__host__ __device__ constexpr int64_t mma_smem_bytes(int tq, int m, int stages,
                                                     int64_t n_bytes) {
  return kSmemSlack + static_cast<int64_t>(stages) * kCodeStage +
         static_cast<int64_t>(mma_q_slots(n_bytes, stages)) * 2 * tq * kStepBytes +
         static_cast<int64_t>(tq) * m * 8;
}

// 16 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// wait until at most n (0 or 1) of this thread's newest cp.async groups are
// pending
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n == 0) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  }
}

// Copy 16 bytes of row `row` at byte k0 of a (n_rows x n_bytes) matrix to
// dst in shared memory, zero past either end.  LD 0: one 16-byte cp.async
// (n_bytes % 16 == 0, base 16-aligned); 1: four 4-byte cp.async (n_bytes %
// 4 == 0, base 4-aligned); 2: byte loads and a plain store.
template <int LD>
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* base,
                                       int64_t row, int64_t n_rows,
                                       int64_t n_bytes, int64_t k0) {
  const bool in = row < n_rows && k0 < n_bytes;
  const uint8_t* p = in ? base + row * n_bytes + k0 : base;
  if constexpr (LD == 0) {
    cp_async_16(smem_u32(dst), p, in ? 16u : 0u);
  } else if constexpr (LD == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = in && k0 + 4 * i < n_bytes;
      cp_async_4(smem_u32(dst) + 4 * i, ok ? p + 4 * i : base, ok ? 4u : 0u);
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (in) {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (k0 + b < n_bytes) w[b >> 2] |= static_cast<uint32_t>(p[b]) << (8 * (b & 3));
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// dst = ~src, 16 bytes of shared memory
__device__ __forceinline__ void complement16(uint8_t* dst, const uint8_t* src) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(dst) = make_uint4(~v.x, ~v.y, ~v.z, ~v.w);
}

// Insert key into the ascending list of m <= 32 keys unless it is past the
// last: lane j holds list[j], a vote finds the place, the tail moves up by
// one.  The whole warp calls it with the same key.
__device__ __forceinline__ void insert_small(long long* list, int m,
                                             long long key, int lane) {
  const long long v = lane < m ? list[lane] : kMaxKey;
  const int at = __popc(__ballot_sync(0xFFFFFFFFu, v < key));
  if (at >= m) return;
  __syncwarp();
  if (lane >= at && lane < m - 1) list[lane + 1] = v;
  if (lane == at) list[at] = key;
  __syncwarp();
}

// The survivors of one accumulator register across the warp.  `hit`: this
// lane's distance d beat its row's threshold and its code row is live; lane
// 4g + t holds query row row_w + g and chunk row r0 + col + 2t.  The whole
// warp inserts them into their queries' lists.
__device__ __forceinline__ void take_survivors(long long* lists, int m,
                                               int64_t r0, bool hit, int d,
                                               int col, int row_w, int lane) {
  unsigned mask = __ballot_sync(0xFFFFFFFFu, hit);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const int dd = __shfl_sync(0xFFFFFFFFu, d, src);
    const long long key = (static_cast<long long>(dd) << 32) |
                          (r0 + col + 2 * (src & 3));
    long long* list = lists + static_cast<int64_t>(row_w + (src >> 2)) * m;
    if (m <= 32) {
      insert_small(list, m, key, lane);
    } else if (key < list[m - 1]) {
      insert_key(list, m, key, lane);
    }
  }
}

// acc[BASE + i] for a run-time i in [0, 32): a tree of selects, so the
// accumulators stay in registers
template <int BASE>
__device__ __forceinline__ int pick32(const int (&acc)[128], int i) {
  int v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = (i & 16) ? acc[BASE + 16 + j] : acc[BASE + j];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = (i & 8) ? v[8 + j] : v[j];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = (i & 4) ? v[4 + j] : v[j];
#pragma unroll
  for (int j = 0; j < 2; ++j) v[j] = (i & 2) ? v[2 + j] : v[j];
  return (i & 1) ? v[1] : v[0];
}

// What a consumer thread carries from tile to tile: the thresholds of its
// two query rows (the distance of each row's m-th best) with where to read
// them again after an insert, and the current tile's liveness bits (bit c
// of the 256: code row c of the tile is below n_real and not tombstoned).
struct Selection {
  int thr0, thr1;
  const long long* last0;  // the m-th key of row's list, or nullptr past nq
  const long long* last1;
  uint4 live_lo, live_hi;
  __device__ __forceinline__ void refresh() {
    if (last0 != nullptr) thr0 = static_cast<int>(*last0 >> 32);
    if (last1 != nullptr) thr1 = static_cast<int>(*last1 >> 32);
  }
  __device__ __forceinline__ bool live(int c) const {
    const int w = c >> 5;
    const uint32_t a0 = (w & 4) ? live_hi.x : live_lo.x;
    const uint32_t a1 = (w & 4) ? live_hi.y : live_lo.y;
    const uint32_t a2 = (w & 4) ? live_hi.z : live_lo.z;
    const uint32_t a3 = (w & 4) ? live_hi.w : live_lo.w;
    const uint32_t b0 = (w & 2) ? a2 : a0, b1 = (w & 2) ? a3 : a1;
    return (((w & 1) ? b1 : b0) >> (c & 31)) & 1u;
  }
};

// One group of 32 accumulator registers of a tile in which some lane's
// distance beat its row's threshold: the registers any lane hit, as a bit
// mask, then each such register's survivors, tested again against the
// thresholds as they stand after the inserts before it (ties let through),
// and against the liveness bits.
template <int BASE>
__device__ __forceinline__ void take_group(const int (&acc)[128], Selection& t,
                                           long long* lists, int m, int64_t r0,
                                           int row_w, int lane) {
  unsigned part[4] = {0u, 0u, 0u, 0u};  // four short chains, not one long
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (acc[BASE + i] < ((i & 2) ? t.thr1 : t.thr0)) part[i >> 3] |= 1u << i;
  unsigned todo = __reduce_or_sync(
      0xFFFFFFFFu, (part[0] | part[1]) | (part[2] | part[3]));
  while (todo) {
    const int i = __ffs(todo) - 1;
    todo &= todo - 1;
    const int idx = BASE + i;
    const int col = 8 * (idx >> 2) + (idx & 1);
    const int d = pick32<BASE>(acc, i);
    // the thresholds may by now come from this tile's own rows, of higher
    // ids than this register's: a tie must reach the list's full compare
    const bool hit =
        d <= ((idx & 2) ? t.thr1 : t.thr0) && t.live(col + 2 * (lane & 3));
    if (__any_sync(0xFFFFFFFFu, hit)) {
      take_survivors(lists, m, r0, hit, d, col, row_w + ((idx & 2) ? 8 : 0),
                     lane);
      t.refresh();
    }
  }
}

// An item of a block's scan, k-step ks of row tile `tile`, and where the
// ring holds it: stage st, in the stage's phase ph.  Stepped without a
// division (the scan's loops are a few hundred instructions an item).
struct Cursor {
  int64_t tile;
  int ks;
  int st;
  uint32_t ph;
  __device__ __forceinline__ void advance(int by, int n_steps, int stages) {
    ks += by;
    while (ks >= n_steps) {
      ks -= n_steps;
      ++tile;
    }
    st += by;
    while (st >= stages) {
      st -= stages;
      ph ^= 1;
    }
  }
};

template <int LD>
__global__ void __launch_bounds__(384, 1) topk_mma_kernel(MmaArgs a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int cons = (blockDim.x - kProducerThreads) >> 7;  // consumer warpgroups
  const int tq = 64 * cons;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  uint8_t* smem = smem_raw + (base - raw);
  const int q_bytes = 2 * tq * kStepBytes;  // a k-step of q, then of ~q
  const bool wide = a.n_bytes > kStepBytes;
  const uint32_t q_off = a.stages * kCodeStage;
  const uint32_t bar_off = q_off + mma_q_slots(a.n_bytes, a.stages) * q_bytes;
  uint8_t* live_bits = smem + bar_off + 128;  // kLiveBytes a stage
  long long* lists = reinterpret_cast<long long*>(
      smem + bar_off + 128 + kMaxStages * kLiveBytes);
  auto full = [&](int s) { return base + bar_off + 8u * s; };
  auto empty = [&](int s) { return base + bar_off + 8u * (kMaxStages + s); };

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * tq;
  const int split = blockIdx.y;
  const int n_steps = static_cast<int>((a.n_bytes + kStepBytes - 1) / kStepBytes);
  // rows past n_real never enter: the scan ends at n_real's tile
  const int64_t n_tiles = (a.n_real + kTileN - 1) / kTileN;
  const int64_t tile0 = static_cast<int64_t>(split) * a.tiles_per_split;
  const int64_t tile_end =
      tile0 + a.tiles_per_split < n_tiles ? tile0 + a.tiles_per_split : n_tiles;
  const int64_t total = tile_end > tile0 ? (tile_end - tile0) * n_steps : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full(s), 1);         // the lane that arrives for the item's warp
      mbar_init(empty(s), 4 * cons);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (static_cast<int>(threadIdx.x) >= 128 * cons) {
    // -- producer warpgroup ------------------------------------------------------------
    // registers: a block of 384 threads is given 384 x 168; two consumer
    // warpgroups at 216 and this one at 64 fit in that (63,488 of 64,512)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 64;");
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    // Item `it` is k-step it % n_steps of tile it / n_steps.  The producer
    // warps take the items in turn (warp w the items w, w + P, ...), so P
    // chains of copies run side by side.  A warp copies its item with
    // cp.async, one commit group an item, and `ahead` of its items later,
    // when a lane's own pieces have landed, the lane writes their
    // complements; then one lane arrives on the stage's full barrier.
    // A lane's pieces of a code tile are e = lane, lane + 32, ...: row
    // e / 2, half e % 2, which the swizzle puts 512 bytes apart.
    constexpr int kPieces = 2 * kTileN / 32;
    const uint32_t lane_off = swz32(lane >> 1, lane & 1);
    const int P = a.stages < 4 ? a.stages : 4;
    const int ahead = a.stages / P - 1;  // 1 with a ring of 8, else 0
    if (warp >= P) return;
    const bool dead8 = (reinterpret_cast<uintptr_t>(a.dead) & 7) == 0;
    uint2 tomb = make_uint2(0u, 0u), tomb_prev = tomb;
    const int64_t end_it = total + static_cast<int64_t>(ahead) * P;
    Cursor at = {tile0, 0, 0, 0u};  // the item being copied
    at.advance(warp, n_steps, a.stages);
    Cursor fin = at;                // the item being finished, `ahead` behind
    for (int64_t it = warp; it < end_it; it += P) {
      tomb_prev = tomb;
      if (it < total) {
        const int st = at.st;
        mbar_wait(empty(st), at.ph ^ 1);
        const int64_t r0 = at.tile * kTileN;
        const int64_t k0 = static_cast<int64_t>(at.ks) * kStepBytes;
        at.advance(P, n_steps, a.stages);
        uint8_t* sc = smem + st * kCodeStage;
        if (LD == 0 && r0 + kTileN <= a.rows && k0 + kStepBytes <= a.n_bytes) {
          // a whole tile: piece i of this lane is 16 rows and 512 bytes of
          // the swizzled stage on from piece i - 1
          const uint8_t* src =
              a.codes + (r0 + (lane >> 1)) * a.n_bytes + k0 + 16 * (lane & 1);
          const uint32_t dst = smem_u32(sc) + lane_off;
#pragma unroll
          for (int i = 0; i < kPieces; ++i)
            cp_async_16(dst + 512 * i, src + i * 16 * a.n_bytes, 16u);
        } else {
          for (int e = lane; e < 2 * kTileN; e += 32)
            copy16<LD>(sc + swz32(e >> 1, e & 1), a.codes, r0 + (e >> 1),
                       a.rows, a.n_bytes, k0 + 16 * (e & 1));
        }
        if (wide || it == 0) {
          uint8_t* sq = smem + q_off + (wide ? st : 0) * q_bytes;
          for (int e = lane; e < 2 * tq; e += 32)
            copy16<LD>(sq + swz32(e >> 1, e & 1), a.q, q0 + (e >> 1), a.nq,
                       a.n_bytes, k0 + 16 * (e & 1));
        }
        // the tombstones of this lane's 8 rows of the tile, used when the
        // item is finished
        tomb = make_uint2(0u, 0u);
        if (a.dead != nullptr) {
          const int64_t rb = r0 + 8 * lane;
          if (dead8 && rb + 8 <= a.rows) {
            tomb = *reinterpret_cast<const uint2*>(a.dead + rb);
          } else {
            for (int b = 0; b < 8; ++b)
              if (rb + b < a.rows && a.dead[rb + b] != 0)
                (b < 4 ? tomb.x : tomb.y) |= 1u << (8 * (b & 3));
          }
        }
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      const int64_t done = it - static_cast<int64_t>(ahead) * P;
      if (done >= 0) {
        cp_async_wait(ahead);
        const int st = fin.st;
        const int64_t rb = fin.tile * kTileN + 8 * lane;
        fin.advance(P, n_steps, a.stages);
        uint8_t* sc = smem + st * kCodeStage + lane_off;
#pragma unroll
        for (int i = 0; i < kPieces; ++i)
          complement16(sc + kTileN * kStepBytes + 512 * i, sc + 512 * i);
        if (wide || done == 0) {
          uint8_t* sq = smem + q_off + (wide ? st : 0) * q_bytes;
          for (int e = lane; e < 2 * tq; e += 32) {
            const uint32_t off = swz32(e >> 1, e & 1);
            complement16(sq + tq * kStepBytes + off, sq + off);
          }
        }
        // the tile's liveness: bit b of byte `lane` is row 8 lane + b, live
        // when below n_real and not tombstoned; a tile with no live row is
        // flagged, and the consumers pass over it
        const uint2 tv = ahead ? tomb_prev : tomb;
        uint32_t alive = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t byte = ((b < 4 ? tv.x : tv.y) >> (8 * (b & 3))) & 0xFFu;
          if (rb + b < a.n_real && byte == 0) alive |= 1u << b;
        }
        uint8_t* lv = live_bits + st * kLiveBytes;
        lv[lane] = static_cast<uint8_t>(alive);
        const bool any = __any_sync(0xFFFFFFFFu, alive != 0);
        if (lane == 0) *reinterpret_cast<uint32_t*>(lv + 32) = any;
        // the stage is read by wgmma (the async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(full(st));
      }
    }
  } else {
    // -- consumer warpgroups: 64 queries each ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int row_w = wg * 64 + warp * 16;  // the warp's 16 query rows
    const int row = row_w + g;              // this thread's rows: row, row + 8
    const long long empty_key =
        (static_cast<long long>(a.sentinel) << 32) | 0x7FFFFFFFLL;
    for (int e = lane; e < 16 * a.m; e += 32)
      lists[static_cast<int64_t>(row_w) * a.m + e] = empty_key;
    __syncwarp();
    // a distance passes when it is below the row's threshold; rows past nq
    // pass nothing
    Selection t;
    t.last0 = q0 + row < a.nq
                  ? lists + static_cast<int64_t>(row) * a.m + a.m - 1 : nullptr;
    t.last1 = q0 + row + 8 < a.nq
                  ? lists + static_cast<int64_t>(row + 8) * a.m + a.m - 1 : nullptr;
    t.thr0 = t.thr1 = 0;
    t.refresh();  // the empty lists' threshold, n_bits + 1: every distance passes
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;

    int st = 0;       // the ring stage of the next item,
    uint32_t ph = 0;  // and its phase
    for (int64_t tile = tile0; tile < tile_end; ++tile) {
      bool any_live = true;
      for (int ks = 0; ks < n_steps; ++ks) {
        mbar_wait(full(st), ph);
        // a tile with no live row (the same flag on each of its k-steps)
        // is passed over
        any_live = *reinterpret_cast<const volatile uint32_t*>(
                       live_bits + st * kLiveBytes + 32) != 0;
        if (any_live && ks + 1 == n_steps) {
          t.live_lo = *reinterpret_cast<const uint4*>(live_bits + st * kLiveBytes);
          t.live_hi =
              *reinterpret_cast<const uint4*>(live_bits + st * kLiveBytes + 16);
        }
        __syncwarp();  // every lane has read them before the stage is let go
        if (any_live) {
          const uint32_t sq = base + q_off + (wide ? st : 0) * q_bytes +
                              wg * 64 * kStepBytes;
          const uint32_t sc = base + st * kCodeStage;
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
          // popc(q & ~c) + popc(~q & c) = popc(q ^ c)
          wgmma_and_popc(acc, smem_desc(sq),
                         smem_desc(sc + kTileN * kStepBytes), ks > 0);
          wgmma_and_popc(acc, smem_desc(sq + tq * kStepBytes), smem_desc(sc), 1);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        }
        if (lane == 0) mbar_arrive(empty(st));
        if (++st == a.stages) {
          st = 0;
          ph ^= 1;
        }
      }
      if (any_live) {  // selection
#pragma unroll
        for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(acc[i])::"memory");
        // register 4j + {0, 1}: row, code rows 8j + 2 (lane & 3) + {0, 1} of
        // the tile; 4j + {2, 3}: row + 8, the same code rows.  The least
        // distance of each row in each group of 32 registers, by two
        // independent chains a row, tells whether anything can pass.
        int least[4][2][2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          least[k][0][0] = least[k][0][1] = 0x7FFFFFFF;
          least[k][1][0] = least[k][1][1] = 0x7FFFFFFF;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int v = acc[32 * k + i];
            int& slot = least[k][(i >> 1) & 1][(i >> 2) & 1];
            slot = v < slot ? v : slot;
          }
        }
        bool hit[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int m0 = least[k][0][0] < least[k][0][1] ? least[k][0][0] : least[k][0][1];
          const int m1 = least[k][1][0] < least[k][1][1] ? least[k][1][0] : least[k][1][1];
          hit[k] = m0 < t.thr0 || m1 < t.thr1;
        }
        if (__any_sync(0xFFFFFFFFu, hit[0] | hit[1] | hit[2] | hit[3])) {
          const int64_t r0 = tile * kTileN;
          const unsigned groups = __reduce_or_sync(
              0xFFFFFFFFu, (hit[0] ? 1u : 0u) | (hit[1] ? 2u : 0u) |
                               (hit[2] ? 4u : 0u) | (hit[3] ? 8u : 0u));
          if (groups & 1u) take_group<0>(acc, t, lists, a.m, r0, row_w, lane);
          if (groups & 2u) take_group<32>(acc, t, lists, a.m, r0, row_w, lane);
          if (groups & 4u) take_group<64>(acc, t, lists, a.m, r0, row_w, lane);
          if (groups & 8u) take_group<96>(acc, t, lists, a.m, r0, row_w, lane);
          __syncwarp();
        }
      }
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int64_t gq = q0 + row_w + r;
      if (gq >= a.nq) break;
      for (int j = lane; j < a.m; j += 32)
        a.part[(gq * a.splits + split) * a.m + j] =
            lists[static_cast<int64_t>(row_w + r) * a.m + j];
    }
  }
}

template <int LD>
int launch_mma(const MmaArgs& a, int tq, cudaStream_t s) {
  const int smem =
      static_cast<int>(mma_smem_bytes(tq, a.m, a.stages, a.n_bytes));
  cudaError_t err = cudaFuncSetAttribute(
      topk_mma_kernel<LD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.nq + tq - 1) / tq),
                  static_cast<unsigned>(a.splits));
  topk_mma_kernel<LD><<<grid, kProducerThreads + 2 * tq, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

size_t scan_smem_bytes(int tq, int m) {
  return static_cast<size_t>(tq) * m * sizeof(long long) +
         static_cast<size_t>(tq + kRows) * kStride * sizeof(uint32_t) +
         static_cast<size_t>(tq) * kRows * sizeof(int);
}

template <int QPT>
int launch_scan(const ScanArgs& a, cudaStream_t s) {
  const size_t smem = scan_smem_bytes(16 * QPT, a.m);
  cudaError_t err = cudaFuncSetAttribute(
      topk_scan_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.nq + 16 * QPT - 1) / (16 * QPT)),
                  static_cast<unsigned>(a.splits));
  topk_scan_kernel<QPT><<<grid, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pass 1: per (query, split) ascending lists of m keys (dist << 32 | id)
// into part (nq x splits x m int64).  q (nq x n_bytes), codes (rows x
// n_bytes) and dead (rows, or null) are contiguous uint8 on the card.
// route 1 is the tensor-core scan (tq 64 or 128, `stages` ring stages,
// tiles of 256 rows), route 0 the CUDA-core scan (tq 16, 32 or 64, tiles of
// 128 rows; `stages` unused); the plan comes from the wrapper's planner and
// one the kernel cannot run is refused with cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
int rp_topk_scan(const void* q, const void* codes, const void* dead,
                 int64_t nq, int64_t rows, int64_t n_real, int64_t n_bytes,
                 int m, int route, int tq, int stages, int splits,
                 int tiles_per_split, void* part, void* stream) {
  const int tile_rows = route == 1 ? kTileN : kRows;
  if (splits < 1 || splits > kMaxSplits || m < 1 || nq < 1 ||
      static_cast<int64_t>(splits) * tiles_per_split * tile_rows < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t both =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if ((tq != 64 && tq != 128) || stages < 2 || stages > kMaxStages ||
        mma_smem_bytes(tq, m, stages, n_bytes) > kSmemLimit)
      return static_cast<int>(cudaErrorInvalidValue);
    MmaArgs a;
    a.q = static_cast<const uint8_t*>(q);
    a.codes = static_cast<const uint8_t*>(codes);
    a.dead = static_cast<const uint8_t*>(dead);
    a.part = static_cast<long long*>(part);
    a.nq = nq;
    a.rows = rows;
    a.n_real = n_real;
    a.n_bytes = n_bytes;
    a.m = m;
    a.splits = splits;
    a.tiles_per_split = tiles_per_split;
    a.stages = stages;
    a.sentinel = static_cast<uint32_t>(n_bytes * 8 + 1);
    if (n_bytes % 16 == 0 && both % 16 == 0) return launch_mma<0>(a, tq, s);
    if (n_bytes % 4 == 0 && both % 4 == 0) return launch_mma<1>(a, tq, s);
    return launch_mma<2>(a, tq, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a;
  a.q = static_cast<const uint8_t*>(q);
  a.codes = static_cast<const uint8_t*>(codes);
  a.dead = static_cast<const uint8_t*>(dead);
  a.part = static_cast<long long*>(part);
  a.nq = nq;
  a.rows = rows;
  a.n_real = n_real;
  a.n_bytes = n_bytes;
  a.m = m;
  a.splits = splits;
  a.tiles_per_split = tiles_per_split;
  a.aligned = n_bytes % 4 == 0 && both % 4 == 0;
  a.sentinel = static_cast<uint32_t>(n_bytes * 8 + 1);
  switch (tq) {
    case 16: return launch_scan<1>(a, s);
    case 32: return launch_scan<2>(a, s);
    case 64: return launch_scan<4>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Pass 2: merge each query's split lists into dist and idx (nq x m int32).
// Returns cudaGetLastError() after the launch.
int rp_topk_merge(const void* part, int64_t nq, int splits, int m,
                  int64_t n_bytes, void* dist, void* idx, void* stream) {
  if (splits < 1 || splits > kMaxSplits || m < 1 || nq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((nq + warps - 1) / warps);
  topk_merge_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(part), nq, splits, m,
      static_cast<uint32_t>(n_bytes * 8 + 1), static_cast<int*>(dist),
      static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one pass-1 block (the planner checks the same
// formulas against the card's 227 KB).
int64_t rp_topk_smem_bytes(int route, int tq, int m, int stages,
                           int64_t n_bytes) {
  return route == 1 ? mma_smem_bytes(tq, m, stages, n_bytes)
                    : static_cast<int64_t>(scan_smem_bytes(tq, m));
}

const char* rp_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
