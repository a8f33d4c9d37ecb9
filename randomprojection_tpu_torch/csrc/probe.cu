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
//   counts[q] += len                        (the attempted yield)
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
// slots; the operations are a few integer ops a run.  At serving shapes
// (64 queries x 8 bands x 16 probes = 8,192 runs over a 2^20-row CSR) that
// is a few MB, about a microsecond at 3.35 TB/s, while three launches take
// several microseconds each: the kernel is launch-latency-bound there.
//
// What the design does about it.  The TPU kernel is one grid step that
// walks the runs with a sequential fori_loop, streaming each run's ids
// through two revolving DMA slots behind a running write cursor.  Blocks on
// the card run in parallel, so the write cursor becomes a prefix sum:
//   pass 1 (probe_count_kernel): a thread takes 4 consecutive runs, adds
//     their lengths to counts[q] with an int32 atomic (integer atomics are
//     exact in any order) and to its block's int64 sum;
//   pass 2 (probe_scan_kernel): one block scans the block sums in place
//     (exclusive, int64, a warp-shuffle block scan with a running carry)
//     and writes the total and stats;
//   pass 3 (probe_copy_kernel): each block recomputes its runs, scans their
//     lengths on top of its block prefix, and one warp per run copies the
//     run's ids, 32 consecutive ids a step (coalesced); every block then
//     fills its share of [total, cap) with the sentinel.
// The scans are written here (no cub or thrust).  Making it fast (one
// launch, or a CUDA graph around the tile) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunsPerThread = 4;
constexpr int kRunsPerBlock = kThreads * kRunsPerThread;  // 1024
constexpr int kScanThreads = 1024;
constexpr int kFillPerThread = 8;   // sentinel slots a pass-3 thread fills
constexpr int kMaxFillBlocks = 1024;
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
};

// Run t's bucket: its start in the band's id row, its length (0 for an
// inactive query), its query and its band.
__device__ __forceinline__ int run_of(const ProbeArgs& a, int64_t t, int* start,
                                      int* query, int* band) {
  const int p = static_cast<int>(t % a.n_probes);
  const int64_t qj = t / a.n_probes;
  const int j = static_cast<int>(qj % a.bands);
  const int q = static_cast<int>(qj / a.bands);
  const unsigned key =
      static_cast<unsigned>(a.qkeys[static_cast<int64_t>(j) * a.tq + q] ^
                            a.masks[p]) &
      static_cast<unsigned>(a.nb - 1);
  const int* ip = a.indptr + static_cast<int64_t>(j) * (a.nb + 1) + key;
  const int s = ip[0];
  *start = s;
  *query = q;
  *band = j;
  return a.active[q] != 0 ? ip[1] - s : 0;
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

__global__ void __launch_bounds__(kThreads)
    probe_count_kernel(ProbeArgs a, unsigned* counts, long long* bsum) {
  __shared__ long long warp_sums[kWarps];
  __shared__ long long block_total;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kRunsPerBlock +
                     static_cast<int64_t>(threadIdx.x) * kRunsPerThread;
  long long sum = 0;
  int cur_q = -1;
  unsigned acc = 0;  // int32 sums wrap like the TPU kernel's
  for (int k = 0; k < kRunsPerThread; ++k) {
    const int64_t t = t0 + k;
    if (t >= a.n_runs) break;
    int start, q, band;
    const int len = run_of(a, t, &start, &q, &band);
    if (q != cur_q) {
      if (acc) atomicAdd(counts + cur_q, acc);
      cur_q = q;
      acc = 0;
    }
    acc += static_cast<unsigned>(len);
    sum += len;
  }
  if (acc) atomicAdd(counts + cur_q, acc);
  block_exclusive_scan(sum, warp_sums, &block_total);
  if (threadIdx.x == 0) bsum[blockIdx.x] = block_total;
}

__global__ void __launch_bounds__(kScanThreads)
    probe_scan_kernel(long long* bsum, int64_t n_blocks, int64_t cap,
                      long long* total, int* stats) {
  __shared__ long long warp_sums[32];
  __shared__ long long tile_total;
  long long carry = 0;
  for (int64_t base = 0; base < n_blocks; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const long long v = i < n_blocks ? bsum[i] : 0;
    const long long ex = block_exclusive_scan(v, warp_sums, &tile_total);
    if (i < n_blocks) bsum[i] = carry + ex;
    carry += tile_total;
    __syncthreads();  // the next tile rewrites warp_sums and tile_total
  }
  if (threadIdx.x == 0) {
    const bool over = carry > cap;
    *total = carry;
    stats[0] = over ? 0 : static_cast<int>(carry);
    stats[1] = over ? 1 : 0;
    for (int k = 2; k < 8; ++k) stats[k] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    probe_copy_kernel(ProbeArgs a, const long long* bprefix,
                      const long long* total_p, int* slots, int64_t run_blocks) {
  __shared__ long long warp_sums[kWarps];
  __shared__ long long block_total;
  __shared__ long long off_s[kRunsPerBlock];
  __shared__ int start_s[kRunsPerBlock];
  __shared__ int len_s[kRunsPerBlock];
  __shared__ int band_s[kRunsPerBlock];
  const long long total = *total_p;
  const bool over = total > a.cap;
  // block-uniform condition: every thread of a block takes the same branch
  if (!over && blockIdx.x < run_blocks) {
    const int r0 = threadIdx.x * kRunsPerThread;
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kRunsPerBlock + r0;
    int lens[kRunsPerThread];
    long long sum = 0;
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      int start = 0, q = 0, band = 0, len = 0;
      if (t0 + k < a.n_runs) len = run_of(a, t0 + k, &start, &q, &band);
      lens[k] = len;
      start_s[r0 + k] = start;
      band_s[r0 + k] = band;
      len_s[r0 + k] = len;
      sum += len;
    }
    long long off =
        bprefix[blockIdx.x] + block_exclusive_scan(sum, warp_sums, &block_total);
#pragma unroll
    for (int k = 0; k < kRunsPerThread; ++k) {
      off_s[r0 + k] = off;
      off += lens[k];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int r = warp; r < kRunsPerBlock; r += kWarps) {
      const int len = len_s[r];
      if (len == 0) continue;  // the whole warp skips together
      const int* src =
          a.ids + static_cast<int64_t>(band_s[r]) * a.ids_stride + start_s[r];
      int* dst = slots + off_s[r];
      for (int i = lane; i < len; i += 32) dst[i] = src[i];
    }
  }
  // the sentinel past the last run (every slot after an overflow)
  const int64_t from = over ? 0 : total;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = from + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < a.cap; i += step)
    slots[i] = kSentinel;
}

int fill_args(ProbeArgs* a, const void* qkeys, const void* masks,
              const void* active, const void* indptr, const void* ids, int tq,
              int bands, int n_probes, int nb, int64_t ids_stride, int64_t cap) {
  if (tq < 1 || bands < 1 || n_probes < 1 || nb < 1 || (nb & (nb - 1)) ||
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
  return 0;
}

int64_t run_blocks_of(const ProbeArgs& a) {
  return (a.n_runs + kRunsPerBlock - 1) / kRunsPerBlock;
}

}  // namespace

extern "C" {

// Pass 1: counts (tq int32, zeroed by the caller) += each query's run
// lengths; bsum (one int64 a block of 1024 runs) = each block's total.
// The planes are contiguous int32 on the card.  Returns cudaGetLastError().
int rp_probe_count(const void* qkeys, const void* masks, const void* active,
                   const void* indptr, const void* ids, int tq, int bands,
                   int n_probes, int nb, int64_t ids_stride, int64_t cap,
                   void* counts, void* bsum, void* stream) {
  ProbeArgs a;
  const int rc = fill_args(&a, qkeys, masks, active, indptr, ids, tq, bands,
                           n_probes, nb, ids_stride, cap);
  if (rc) return rc;
  probe_count_kernel<<<static_cast<unsigned>(run_blocks_of(a)), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<unsigned*>(counts), static_cast<long long*>(bsum));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: bsum (n_blocks int64) becomes its exclusive prefix in place;
// total (one int64) = the runs' total, stats (8 int32) = [total, 0, ...],
// or [0, 1, 0, ...] past cap.  Returns cudaGetLastError().
int rp_probe_scan(void* bsum, int64_t n_blocks, int64_t cap, void* total,
                  void* stats, void* stream) {
  if (n_blocks < 1 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  probe_scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(bsum), n_blocks, cap,
      static_cast<long long*>(total), static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// Pass 3: the runs into slots (cap int32) at their prefix offsets, the
// sentinel past them; no run when total > cap.  bprefix and total are pass
// 2's outputs.  Returns cudaGetLastError().
int rp_probe_copy(const void* qkeys, const void* masks, const void* active,
                  const void* indptr, const void* ids, int tq, int bands,
                  int n_probes, int nb, int64_t ids_stride, int64_t cap,
                  const void* bprefix, const void* total, void* slots,
                  void* stream) {
  ProbeArgs a;
  const int rc = fill_args(&a, qkeys, masks, active, indptr, ids, tq, bands,
                           n_probes, nb, ids_stride, cap);
  if (rc) return rc;
  const int64_t run_blocks = run_blocks_of(a);
  int64_t fill_blocks = (cap + kThreads * kFillPerThread - 1) /
                        (kThreads * kFillPerThread);
  if (fill_blocks > kMaxFillBlocks) fill_blocks = kMaxFillBlocks;
  const int64_t blocks = run_blocks > fill_blocks ? run_blocks : fill_blocks;
  probe_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const long long*>(bprefix),
      static_cast<const long long*>(total), static_cast<int*>(slots),
      run_blocks);
  return static_cast<int>(cudaGetLastError());
}

const char* rp_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
