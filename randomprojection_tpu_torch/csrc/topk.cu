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
// tensor-core rate: it is bound by operations.  This first kernel issues a
// 32-bit XOR and __popc per word per (query, code) pair on the CUDA cores,
// 2.7e11 popcounts, which at 16 per clock per SM needs about 65 ms.  The
// tensor-core (+-1 mma/wgmma) form is later work.
//
// What the design does about it.  The TPU grid walks query tiles and loops
// over every row block inside one program, carrying the running top-m in
// VMEM.  Here blocks run in parallel, so the grid is (query tile x row
// split), and a second small launch merges each query's splits:
//   pass 1 (topk_scan_kernel): a block holds TQ = 16/32/64 queries and scans
//     its split's rows in tiles of 128.  Each tile is staged in shared
//     memory 32 words (128 bytes) of every row at a time, the queries'
//     matching words beside it, and each thread accumulates the distances
//     of QPT queries x 8 rows in registers, so any width, from 3-byte codes
//     to 2 MiB rows, streams through the same buffers.  The tile's
//     distances go to shared memory; then one warp per query tests them
//     against the query's m-th best key (dist << 32 | id) and inserts the
//     few that beat it into the query's sorted list in shared memory.  The
//     lists (TQ x m keys) are written to a scratch buffer.
//   pass 2 (topk_merge_kernel): one warp per query merges its <= 32 sorted
//     split lists, one lane per list, into the final m (dist, idx).
// Row splits exist because a TopKServer batch of 128-640 queries gives too
// few query tiles to fill 132 SMs.  Loads of 32-bit words need
// n_bytes % 4 == 0 and 4-aligned rows; other widths (20 bits in 3 bytes)
// assemble each word from bytes, zero past the row's end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // 16 query groups x 16 row lanes
constexpr int kRows = 128;                 // code rows per tile
constexpr int kRowsPerThread = kRows / 16;
constexpr int kChunkWords = 32;            // words of a row staged per step
constexpr int kStride = kChunkWords + 1;   // odd: 16 rows in 16 banks
constexpr int kMaxSplits = 32;             // one merge lane per split
constexpr long long kMaxKey = 0x7FFFFFFFFFFFFFFFLL;

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
__device__ void insert_key(long long* list, int m, long long key, int lane) {
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
// Returns cudaGetLastError() after the launch.
int rp_topk_scan(const void* q, const void* codes, const void* dead,
                 int64_t nq, int64_t rows, int64_t n_real, int64_t n_bytes,
                 int m, int tq, int splits, int tiles_per_split, int aligned,
                 void* part, void* stream) {
  if (splits < 1 || splits > kMaxSplits || m < 1 || nq < 1 ||
      static_cast<int64_t>(splits) * tiles_per_split * kRows < rows)
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.aligned = aligned;
  a.sentinel = static_cast<uint32_t>(n_bytes * 8 + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
// formula against the card's 227 KB).
int64_t rp_topk_smem_bytes(int tq, int m) {
  return static_cast<int64_t>(scan_smem_bytes(tq, m));
}

const char* rp_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
