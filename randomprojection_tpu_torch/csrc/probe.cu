// CSR multi-probe gather of the LSH candidate tier for Hopper (sm_90a).
//
// Replaces the TPU kernel of randomprojection_tpu/ops/probe_kernels.py:
//   _probe_kernel (183-254), launched by _probe_pallas (257) at pallas_call 262,
//   whose public entry is probe_gather (307).
//
// What it computes.  For every run t = (query q, band j, probe p), in
// query-major order t = (q * bands + j) * P + p:
//   key = qkeys[j, q] ^ masks[p]            (read modulo 2^b)
//   len = active[q] ? indptr[j, key + 1] - indptr[j, key] : 0
//   counts[q] = sum of q's lengths          (the attempted yield, int32)
// and the runs ids[j, indptr[j, key] : + len] are packed in run order into
// slots[0, total), the rest of the cap slots holding the sentinel 2^31 - 1;
// stats = [total, 0, 0, ...].  When total > cap no run is written: every
// slot is the sentinel and stats = [0, 1, 0, ...]; counts stay exact.  The
// TPU kernel instead skips each run that would pass cap and packs later
// runs that fit, so after an overflow its slots and stats[0] differ; the
// tier reads neither then (ops/probe_kernels.py documents the divergence).
// When total <= cap the prefix sum puts every run where the TPU kernel's
// sequential loop puts it, and slots, counts and stats are bit-identical.
//
// What bounds it.  Bytes: two indptr words a run, the gathered ids read
// once and written once, and the sentinel fill of the rest of the cap
// slots; the operations are a few integer ops a run.  At the bench tile
// (64 queries x 8 bands x 16 probes = 8,192 runs over a 2^20-row CSR,
// 137,832 ids gathered, cap 2^19) that is 2.72 MB, 0.81 us at 3.35 TB/s.
// So little work is bound by latency: two dependent loads a run before its
// length is known, a scan across the runs, then a dependent chain a slot
// (its run, the run's start, the id).  The earlier design (three launches:
// count, scan, copy) gave each copy block 1,024 runs, so the bench tile's
// 137,832 ids went through 8 of 132 SMs, a warp walking 128 runs one after
// another with half its lanes idle on a 17-id run.
//
// What the design does about it.  Two launches, no atomics, no fill:
//   launch 1 (probe_runs_kernel): a thread takes rpt consecutive runs (1 at
//     serving shapes; a power of two past 2^19 runs, so that the grid stays
//     at most kMaxRunBlocks blocks).  For each run it writes where the run's
//     ids start in the flat ids array (band row + bucket start) and the
//     run's exclusive offset within its block (an int64 block scan), and
//     the block writes its total.
//   launch 2 (probe_copy_kernel): every block scans the block totals in
//     shared memory itself (at most kMaxRunBlocks of them), so no block
//     waits for another; that gives each block the grand total, hence the
//     overflow verdict, stats, and counts (a query's runs are consecutive,
//     so its count is the difference of the run offsets around them: no
//     atomics, and no zeroed buffer).  The copy is balanced over output
//     slots, not runs: a lane owns 4 consecutive slots of [0, cap) and a
//     warp 128.  The warp finds the run of its first slot once (the block
//     totals in shared memory, then a 32-way search of the run offsets
//     inside that block, one probe a lane: two dependent loads for 256
//     runs), loads the offsets and id starts of the 32 runs from there,
//     one a lane, and each lane finds each of its slots' runs in that
//     window by shuffles (merge-path style); a slot past the window
//     searches on its own.  A lane then loads its ids (neighbouring lanes
//     read neighbouring ids of a run) and writes its 4 slots with one
//     16-byte store: ids below the total, the sentinel past it, the
//     sentinel everywhere after an overflow.  Every SM takes an equal share
//     of the cap slots, gathered or sentinel, and a slot's chain is four
//     dependent loads from device memory.
//
// Why two launches and not one.  The overflow verdict and the first
// sentinel slot need the grand total before any slot is written.  One
// launch could get it only through a grid-wide barrier, which is safe only
// when every block of the grid is resident at once; only a cooperative
// launch guarantees that, and it would cap the copy's grid at what is
// resident.  The tier replays the whole tile as one CUDA graph
// (ops/probe_kernels.py, TileGraphs), where the second launch is a kernel
// boundary inside the graph, not a host launch.
//
// The scans are written here (no cub or thrust).  The wrapper allocates the
// int64 scratch (rp_probe_scratch_words words) with torch.empty: every word
// of it that is read was written by launch 1 of the same call, so a graph
// can replay the pair with no reset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxRunBlocks = 2048;  // block totals a copy block scans
constexpr int kSlotsPerThread = 4;       // one 16-byte store
constexpr int64_t kMaxCopyBlocks = 1024;
constexpr int kSentinel = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct ProbeArgs {
  const int* qkeys;   // (bands, tq)
  const int* masks;   // (n_probes,)
  const int* active;  // (tq,)
  const int* indptr;  // (bands, nb + 1)
  const int* ids;     // (bands, ids_stride)
  int tq;
  int bands;
  int n_probes;
  int nb;             // 2^band_bits
  int64_t ids_stride;
  int64_t cap;
  int64_t n_runs;     // tq * bands * n_probes
  int64_t rpt;        // runs a thread of launch 1 (a power of two)
  int block_shift;    // log2(runs a block of launch 1) = log2(kThreads * rpt)
  int64_t n_blocks;   // blocks of launch 1 (0 when there is no run)
};

struct Run {
  int len;    // 0 for an inactive query
  int start;  // the bucket's start in the band's id row
  int band;
};

// Run t's bucket.
__device__ __forceinline__ Run run_of(const ProbeArgs& a, int64_t t) {
  int p, j, q;
  if (a.n_runs <= 0xFFFFFFFFll) {  // 32-bit divisions where the runs fit
    const unsigned tt = static_cast<unsigned>(t);
    const unsigned qj = tt / static_cast<unsigned>(a.n_probes);
    p = static_cast<int>(tt - qj * static_cast<unsigned>(a.n_probes));
    j = static_cast<int>(qj % static_cast<unsigned>(a.bands));
    q = static_cast<int>(qj / static_cast<unsigned>(a.bands));
  } else {
    const int64_t qj = t / a.n_probes;
    p = static_cast<int>(t - qj * a.n_probes);
    j = static_cast<int>(qj % a.bands);
    q = static_cast<int>(qj / a.bands);
  }
  const unsigned key =
      static_cast<unsigned>(a.qkeys[static_cast<int64_t>(j) * a.tq + q] ^
                            a.masks[p]) &
      static_cast<unsigned>(a.nb - 1);
  const int* ip = a.indptr + static_cast<int64_t>(j) * (a.nb + 1) + key;
  const int s = ip[0];
  return Run{a.active[q] != 0 ? ip[1] - s : 0, s, j};
}

// Exclusive prefix of v over the block's threads; *total (shared) gets the
// block's sum.  Every thread of the block calls it.  warp_sums holds one
// entry a warp (at most 32 warps).
__device__ long long block_exclusive_scan(long long v, long long* warp_sums,
                                          long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < n_warps ? warp_sums[lane] : 0;
    long long wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += up;
    }
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == n_warps - 1) *total = wi;
  }
  __syncthreads();
  return warp_sums[warp] + incl - v;
}

// Launch 1: loc[t] = run t's exclusive offset within its block, src[t] =
// where its ids start in the flat ids array, bsum[b] = block b's total.
__global__ void __launch_bounds__(kThreads)
    probe_runs_kernel(ProbeArgs a, long long* loc, long long* src,
                      long long* bsum) {
  __shared__ long long warp_sums[kWarps];
  __shared__ long long block_total;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.x) << a.block_shift) +
                     static_cast<int64_t>(threadIdx.x) * a.rpt;
  if (a.rpt == 1) {  // serving shapes: the run stays in registers
    const Run r = t0 < a.n_runs ? run_of(a, t0) : Run{0, 0, 0};
    const long long off = block_exclusive_scan(r.len, warp_sums, &block_total);
    if (t0 < a.n_runs) {
      loc[t0] = off;
      src[t0] = static_cast<long long>(r.band) * a.ids_stride + r.start;
    }
  } else {
    const int64_t t1 = t0 + a.rpt < a.n_runs ? t0 + a.rpt : a.n_runs;
    long long sum = 0;
    for (int64_t t = t0; t < t1; ++t) sum += run_of(a, t).len;
    long long off = block_exclusive_scan(sum, warp_sums, &block_total);
    for (int64_t t = t0; t < t1; ++t) {
      const Run r = run_of(a, t);
      loc[t] = off;
      src[t] = static_cast<long long>(r.band) * a.ids_stride + r.start;
      off += r.len;
    }
  }
  if (threadIdx.x == 0) bsum[blockIdx.x] = block_total;
}

// Run r's offset in the packed slots (the total for r == n_runs).
__device__ __forceinline__ long long off_at(const ProbeArgs& a,
                                            const long long* bpre,
                                            const long long* loc,
                                            long long total, int64_t r) {
  return r >= a.n_runs ? total : bpre[r >> a.block_shift] + loc[r];
}

// The last run block whose prefix (shared memory) is at most s; bpre[0] = 0.
__device__ __forceinline__ int64_t find_block(const ProbeArgs& a,
                                              const long long* bpre,
                                              long long s) {
  int64_t lo = 0, hi = a.n_blocks - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (bpre[mid] <= s) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The run holding slot s (s below the total): the last run whose offset is
// at most s.  Every later run starts past s, so this one holds s and is not
// empty.  The last block whose prefix is at most s, then the last run of
// that block whose in-block offset is at most s (one thread's binary
// search: the fallback of a slot past its warp's window).
__device__ int64_t find_run(const ProbeArgs& a, const long long* bpre,
                            const long long* loc, long long s) {
  const int64_t b = find_block(a, bpre, s);
  const long long in = s - bpre[b];
  int64_t rlo = b << a.block_shift;  // loc[rlo] = 0 <= in
  const int64_t end = rlo + (int64_t{1} << a.block_shift);
  int64_t rhi = (end < a.n_runs ? end : a.n_runs) - 1;
  while (rlo < rhi) {
    const int64_t mid = (rlo + rhi + 1) >> 1;
    if (loc[mid] <= in) rlo = mid; else rhi = mid - 1;
  }
  return rlo;
}

// find_run for the slot s that every lane of the warp holds: a 32-way
// search, one probe a lane a step (two steps for a block of 256 runs).
__device__ int64_t warp_find_run(const ProbeArgs& a, const long long* bpre,
                                 const long long* loc, long long s, int lane) {
  const int64_t b = find_block(a, bpre, s);
  const long long in = s - bpre[b];
  int64_t lo = b << a.block_shift;  // loc[lo] = 0 <= in
  const int64_t end = lo + (int64_t{1} << a.block_shift);
  int64_t n = (end < a.n_runs ? end : a.n_runs) - lo;  // the answer is in [lo, lo + n)
  while (n > 1) {
    const int64_t step = (n + 31) >> 5;
    const int64_t p = lo + lane * step;
    const bool ok = lane * step < n && loc[p] <= in;  // lane 0 always
    const int last = 31 - __clz(__ballot_sync(kFull, ok));
    const int64_t rest = n - last * step;
    lo += last * step;
    n = rest < step ? rest : step;
  }
  return lo;
}

// Launch 2: the block totals scanned in every block, then stats, counts and
// every slot of [0, cap), kSlotsPerThread consecutive slots a lane.  A
// warp takes 32 lanes' slots at a time; it finds the run of its first slot
// once, loads the offsets and id starts of the 32 runs from there (one a
// lane: the window), and each lane finds each of its slots' runs in the
// window by shuffles; a slot past the window (runs shorter than 4 ids on
// average, or many empty runs) searches on its own.
__global__ void __launch_bounds__(kThreads)
    probe_copy_kernel(ProbeArgs a, const long long* loc, const long long* src,
                      const long long* bsum, int* slots, int* counts,
                      int* stats, int vec) {
  extern __shared__ long long bpre[];  // n_blocks exclusive block prefixes
  __shared__ long long warp_sums[kWarps];
  __shared__ long long tile_total;
  long long total = 0;
  for (int64_t base = 0; base < a.n_blocks; base += kThreads) {
    const int64_t i = base + threadIdx.x;
    const long long v = i < a.n_blocks ? bsum[i] : 0;
    const long long ex = block_exclusive_scan(v, warp_sums, &tile_total);
    if (i < a.n_blocks) bpre[i] = total + ex;
    total += tile_total;
    __syncthreads();  // the next tile rewrites warp_sums and tile_total
  }
  const bool over = total > a.cap;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  if (tid < 8)
    stats[tid] = tid == 0 ? (over ? 0 : static_cast<int>(total))
                          : (tid == 1 ? static_cast<int>(over) : 0);
  // int32 counts wrap as the TPU kernel's int32 sums do
  const int64_t per_query = static_cast<int64_t>(a.bands) * a.n_probes;
  for (int64_t q = tid; q < a.tq; q += stride)
    counts[q] = static_cast<int>(static_cast<unsigned>(
        off_at(a, bpre, loc, total, (q + 1) * per_query) -
        off_at(a, bpre, loc, total, q * per_query)));
  const long long filled = over ? 0 : total;  // slots [0, filled) get ids
  const int64_t groups = (a.cap + kSlotsPerThread - 1) / kSlotsPerThread;
  const int lane = threadIdx.x & 31;
  // warp-uniform loop: every lane of a warp takes the same trips
  for (int64_t wg = tid - lane; wg < groups; wg += stride) {
    const long long s0 = (wg + lane) * kSlotsPerThread;
    int v[kSlotsPerThread];
#pragma unroll
    for (int k = 0; k < kSlotsPerThread; ++k) v[k] = kSentinel;
    if (wg * kSlotsPerThread < filled) {  // warp-uniform
      const int64_t r_w = warp_find_run(a, bpre, loc, wg * kSlotsPerThread, lane);
      const int64_t r = r_w + lane;
      const long long w_off = off_at(a, bpre, loc, total, r);
      const long long w_src = r < a.n_runs ? src[r] : 0;
      // runs r_w .. r_w + 30 end inside the window
      const long long w_end = __shfl_sync(kFull, w_off, 31);
#pragma unroll
      for (int k = 0; k < kSlotsPerThread; ++k) {
        const long long s = s0 + k;
        // the last window run starting at or before s (all lanes shuffle)
        int i = 0;
#pragma unroll
        for (int b = 16; b >= 1; b >>= 1) {
          const int c = i + b;
          const long long o = __shfl_sync(kFull, w_off, c < 31 ? c : 31);
          if (c <= 30 && o <= s) i = c;
        }
        const long long o = __shfl_sync(kFull, w_off, i);
        const long long sr = __shfl_sync(kFull, w_src, i);
        if (s < filled) {
          if (s < w_end) {
            v[k] = a.ids[sr + (s - o)];
          } else {
            const int64_t rr = find_run(a, bpre, loc, s);
            v[k] = a.ids[src[rr] + (s - off_at(a, bpre, loc, total, rr))];
          }
        }
      }
    }
    if (s0 < a.cap) {
      if (vec && s0 + kSlotsPerThread <= a.cap) {
        *reinterpret_cast<int4*>(slots + s0) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kSlotsPerThread; ++k)
          if (s0 + k < a.cap) slots[s0 + k] = v[k];
      }
    }
  }
}

int fill_args(ProbeArgs* a, const void* qkeys, const void* masks,
              const void* active, const void* indptr, const void* ids, int tq,
              int bands, int n_probes, int nb, int64_t ids_stride, int64_t cap) {
  if (tq < 0 || bands < 1 || n_probes < 0 || nb < 1 || (nb & (nb - 1)) ||
      cap < 0 || ids_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  a->qkeys = static_cast<const int*>(qkeys);
  a->masks = static_cast<const int*>(masks);
  a->active = static_cast<const int*>(active);
  a->indptr = static_cast<const int*>(indptr);
  a->ids = static_cast<const int*>(ids);
  a->tq = tq;
  a->bands = bands;
  a->n_probes = n_probes;
  a->nb = nb;
  a->ids_stride = ids_stride;
  a->cap = cap;
  a->n_runs = static_cast<int64_t>(tq) * bands * n_probes;
  // the fewest runs a thread (a power of two) that keeps launch 1's grid
  // within kMaxRunBlocks blocks
  const int64_t need = (a->n_runs + kThreads * kMaxRunBlocks - 1) /
                       (kThreads * kMaxRunBlocks);
  a->rpt = 1;
  int shift = 8;  // log2(kThreads)
  while (a->rpt < need) {
    a->rpt <<= 1;
    ++shift;
  }
  a->block_shift = shift;
  a->n_blocks = (a->n_runs + (int64_t{1} << shift) - 1) >> shift;
  return 0;
}

}  // namespace

extern "C" {

// int64 words of scratch rp_probe_gather takes for this tile: each run's
// in-block offset and id start, and each block's total.  -1 for bad
// arguments.
int64_t rp_probe_scratch_words(int tq, int bands, int n_probes, int nb) {
  ProbeArgs a;
  if (fill_args(&a, nullptr, nullptr, nullptr, nullptr, nullptr, tq, bands,
                n_probes, nb, 0, 0))
    return -1;
  return 2 * a.n_runs + a.n_blocks;
}

// The probe gather of one tile: slots (cap int32), counts (tq int32) and
// stats (8 int32), every word written here.  The planes are contiguous
// int32 on the card; scratch holds rp_probe_scratch_words int64 words.
// *launches gets the kernels launched (launch 1 is skipped when there is no
// run).  Returns cudaGetLastError() of the first launch that failed, or 0.
int rp_probe_gather(const void* qkeys, const void* masks, const void* active,
                    const void* indptr, const void* ids, int tq, int bands,
                    int n_probes, int nb, int64_t ids_stride, int64_t cap,
                    void* scratch, void* slots, void* counts, void* stats,
                    void* stream, int* launches) {
  *launches = 0;
  ProbeArgs a;
  const int rc = fill_args(&a, qkeys, masks, active, indptr, ids, tq, bands,
                           n_probes, nb, ids_stride, cap);
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* loc = static_cast<long long*>(scratch);
  long long* src = loc + a.n_runs;
  long long* bsum = src + a.n_runs;
  if (a.n_blocks > 0) {
    probe_runs_kernel<<<static_cast<unsigned>(a.n_blocks), kThreads, 0, s>>>(
        a, loc, src, bsum);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    *launches = 1;
  }
  const int64_t groups = (cap + kSlotsPerThread - 1) / kSlotsPerThread;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxCopyBlocks) blocks = kMaxCopyBlocks;
  if (blocks < 1) blocks = 1;  // stats and counts are written even at cap 0
  const int vec = (reinterpret_cast<uintptr_t>(slots) & 15) == 0;
  probe_copy_kernel<<<static_cast<unsigned>(blocks), kThreads,
                      static_cast<size_t>(a.n_blocks) * sizeof(long long), s>>>(
      a, loc, src, bsum, static_cast<int*>(slots), static_cast<int*>(counts),
      static_cast<int*>(stats), vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launches += 1;
  return 0;
}

const char* rp_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
