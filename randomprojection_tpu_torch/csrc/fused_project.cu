// Fused lazy-mask projection, its mask cache and the mask writer, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of randomprojection_tpu/ops/pallas_kernels.py:
//   rp_fused_project  <- _project_kernel_dma (347) and _project_kernel (321),
//                        launched by _fused_raw (664) at pallas_call 752/777;
//                        with rp_mask_cache, the counterpart of the TPU
//                        kernel's mask cache (_fetch_mask_block, 256-287);
//   rp_lazy_matrix    <- _matrix_kernel (397), pallas_sparse_matrix (940).
//
// What it computes.  Y[n,k] = scale * sum_j X[:, block j] . M_j^T, where
// M_j is the (k x 512) {+1,-1,0} mask of column block j, a pure function of
// (seed, j + block_offset); scale = 1/sqrt(density*k) is applied once at the
// end.  The mask stream is the integer hash of the JAX package's interpreter
// stream (_interp_mask_block, 205-230), bit for bit: all arithmetic is
// uint32, a ragged last block keeps its position within the full 512-wide
// block, and the two thresholds arrive as integer limits on h >> 8 that the
// host derived from float32(density/2) and float32(density), so
// "u < t" with u = (h >> 8) * 2^-24 is the same test as "(h >> 8) < lim".
// mask_entry below is the one definition: the mask cache, the mask writer
// and so the fused product and lazy_matrix() read the same bits.
//
// What bounds it.  At config 2 (a 65,536 x 4096 -> 256 batch, f32 in and
// out) the function must move 4nd + 4nk bytes (1.14 GB, 0.341 ms at
// 3.35 TB/s).  Its products run on the bf16 tensor cores: x is cut into
// bf16 parts whose products with +-1/0 are exact (split2: hi = x & 0xFFFF0000
// and lo = bf16_rn(x - hi), two products; f32: hi, mid and lo by successive
// & 0xFFFF0000 truncations, three products; bf16: x itself, one product),
// 2ndk operations each, 0.139 ms per product at 989 TFLOP/s.  So split2 and
// bf16 are bound by bytes and f32 (0.417 ms) by operations.  Measured on an
// H100 (PERF.md), the tensor cores' attainable rate is what holds it: with
// every load after the ring's first fill removed, split2 still takes the
// same time (0.44 ms, 63% of the bf16 peak, the share torch's own bf16
// matmul reaches); multicasting the mask tile across a 2-CTA cluster and
// deeper wgmma pipelines moved nothing, so neither is in the source.
//
// What the design does about it.
//  * Tensor cores: wgmma m64nNk16 (bf16 x bf16 -> f32) with A, the x parts,
//    in registers and B, the mask tile, in shared memory.  The consumer
//    warps load their x fragments from shared memory as float32 and cut
//    them into bf16 parts in registers, so the parts never touch memory
//    (the TPU kernel's in-VMEM split, _contract_block 290-318).
//  * x read from HBM once (k <= 256): a CTA owns 64 rows and all k columns,
//    one 64 x k/2 half per consumer warpgroup; k > 256 runs in 256-wide
//    slices (a tile per (row tile, slice), slices of a row tile adjacent so
//    the re-read hits L2).
//  * Asynchronous copies: one producer thread keeps TMA loads of x (128B
//    swizzle, boxes of 64 rows x 128 bytes) and of the mask tile in flight
//    into a ring of stages, each guarded by a full and an empty mbarrier.
//    Rows whose stride is not a multiple of 16 bytes (TMA's rule) take a
//    masked cp.async path in the same kernel: the producer warpgroup copies
//    x in 4-byte pieces (zero-filled past n and d) into the same swizzled
//    layout and arrives with cp.async.mbarrier.arrive.
//  * Persistent grid: one CTA per SM walks the tiles, so the producer loads
//    the next tile while the consumers store the last one.
//  * The mask: the TPU kernel's answer (generate once, reuse).  rp_mask_cache
//    writes the launch's unscaled mask as bf16 (k x d padded to 64 columns,
//    2 MiB at config 2, L2-resident), hashed once per entry instead of once
//    per row tile; the fused kernel loads its tiles by TMA.  The mask cache
//    and rp_lazy_matrix are one templated writer (mask_writer_kernel).
//  * Accuracy: the tensor cores may round their float32 sums toward zero,
//    a bias that over 256 k16 steps (x2 or x3 parts) would come near the
//    1e-5 * max|Y| tolerance.  The accumulator is restarted at every 512-
//    column block and added into a second float32 accumulator in registers
//    (round to nearest), the plain version's per-block order.  That second
//    accumulator is why a CTA owns 64 rows and not 128: 128 x 256 outputs
//    in two registers each would take 256 registers a consumer thread, past
//    the 232 setmaxnreg gives it.
//  * Row independence: no split over d, no atomics; a row's sums depend
//    only on d, never on n or its place in a tile.
//
// Modes: 0 = f32, 1 = split2, 2 = bf16 (x arrives as bf16).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockD = 512;        // column block of the matrix definition
constexpr int kTileM = 64;          // rows of Y per tile
constexpr int kStepD = 64;          // contraction columns per ring stage
constexpr int kSliceN = 256;        // widest column slice of a tile
constexpr int kThreads = 384;       // 2 consumer warpgroups + 1 producer
constexpr int kProducer = 256;      // first thread of the producer warpgroup
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block can use
constexpr int kSmemSlack = 1024 + 128;  // 1024-byte alignment + barriers

struct MaskParams {
  uint32_t seed_mix;      // uint32(seed) * 0xC2B2AE3D
  uint32_t block_offset;  // global index of column block 0
  uint32_t lim_plus;      // (h >> 8) <  lim_plus              -> +1
  uint32_t lim_nonzero;   // lim_plus <= (h >> 8) < lim_nonzero -> -1, else 0
};

constexpr uint32_t kColMul = 0x85EBCA77u;  // the hash's column constant

// The hash's row and block terms, the part of an entry's hash that a run of
// columns of one row in one block shares.
__device__ __forceinline__ uint32_t mask_row_block(uint32_t ri, uint32_t blk,
                                                   const MaskParams& p) {
  return (ri * 0x9E3779B1u) ^ p.seed_mix ^ (blk * 0x27D4EB2Fu);
}

// The entry of hash h = mask_row_block(ri, blk) ^ ci * kColMul.
__device__ __forceinline__ float mask_finish(uint32_t h, const MaskParams& p) {
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h ^= h >> 13;
  const uint32_t m = h >> 8;
  return m < p.lim_plus ? 1.0f : (m < p.lim_nonzero ? -1.0f : 0.0f);
}

// Entry (ri, ci) of block blk: the one definition of the mask's bits.
__device__ __forceinline__ float mask_entry(uint32_t ri, uint32_t ci,
                                            uint32_t blk,
                                            const MaskParams& p) {
  return mask_finish(mask_row_block(ri, blk, p) ^ (ci * kColMul), p);
}

// bytes of one stage's x tile: 64 rows x 64 columns
__host__ __device__ constexpr int x_stage_bytes(int mode) {
  return kTileM * kStepD * (mode == 2 ? 2 : 4);
}

// bytes of one stage's mask tile: cta_n rows x 64 bf16 columns
__host__ __device__ constexpr int mask_stage_bytes(int cta_n) {
  return cta_n * kStepD * 2;
}

__host__ __device__ constexpr int smem_bytes(int cta_n, int mode, int stages) {
  return kSmemSlack + stages * (x_stage_bytes(mode) + mask_stage_bytes(cta_n));
}

// -- PTX wrappers ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
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
// the wrapper raises) instead of hanging the card.  Each try_wait sleeps up
// to a system-dependent limit; 2^26 of them is far past any real wait.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity); ++spins) {
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 4 bytes global -> shared, zero-filled when src_bytes is 0
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep a register's value where it is until here (wgmma reads its A
// registers and writes its accumulators asynchronously)
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// wgmma descriptor of a K-major bf16 tile in shared memory with the 128B
// swizzle (rows of 128 bytes, 8-row atoms 1024 bytes apart)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// byte offset of (row, byte) in a 128B-swizzled panel of 128-byte rows
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int WN>
__device__ __forceinline__ void mma(float (&d)[WN / 2], const uint32_t (&a)[4],
                                    uint64_t desc_b, int accumulate) {
  if constexpr (WN == 32) {
    wgmma_m64n32(d, a, desc_b, accumulate);
  } else if constexpr (WN == 64) {
    wgmma_m64n64(d, a, desc_b, accumulate);
  } else {
    wgmma_m64n128(d, a, desc_b, accumulate);
  }
}

__device__ __forceinline__ uint32_t bf16x2_rn(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ float hi_part(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
}

// the top 16 bits of two floats whose low 16 bits are zero, as bf16x2
__device__ __forceinline__ uint32_t pack_hi(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// One register of an A fragment from two neighbouring float32 columns: the
// bf16 parts whose sum is the pair (the wgmma A layout of m16n8k16: lane
// g*4 + q holds rows g and g + 8, columns 2q, 2q + 1 and 2q + 8, 2q + 9).
template <int MODE, int PARTS>
__device__ __forceinline__ void split_pair(float2 v, uint32_t (&a)[PARTS][4],
                                           int reg) {
  const float h0 = hi_part(v.x), h1 = hi_part(v.y);
  a[0][reg] = pack_hi(h0, h1);
  const float r0 = v.x - h0, r1 = v.y - h1;  // exact
  if constexpr (MODE == 1) {
    a[1][reg] = bf16x2_rn(r0, r1);
  } else {
    const float m0 = hi_part(r0), m1 = hi_part(r1);
    a[1][reg] = pack_hi(m0, m1);
    a[2][reg] = bf16x2_rn(r0 - m0, r1 - m1);  // exact for |x| >= 2^-110
  }
}

// The A fragments of one k16 step (columns c .. c + 9 used by this lane,
// c = 16 s + 2q) for rows row and row + 8 of the stage's x tile.
template <int MODE, int PARTS>
__device__ __forceinline__ void load_parts(const uint8_t* xs, int row, int c,
                                           uint32_t (&a)[PARTS][4]) {
  if constexpr (MODE == 2) {
    a[0][0] = *reinterpret_cast<const uint32_t*>(xs + swz(row, c * 2));
    a[0][1] = *reinterpret_cast<const uint32_t*>(xs + swz(row + 8, c * 2));
    a[0][2] = *reinterpret_cast<const uint32_t*>(xs + swz(row, c * 2 + 16));
    a[0][3] = *reinterpret_cast<const uint32_t*>(xs + swz(row + 8, c * 2 + 16));
  } else {
    // float32 columns live in two panels of 32; c and c + 8 share one
    const uint8_t* panel = xs + (c >> 5) * (kTileM * 128);
    const int b = (c & 31) * 4;
    split_pair<MODE, PARTS>(
        *reinterpret_cast<const float2*>(panel + swz(row, b)), a, 0);
    split_pair<MODE, PARTS>(
        *reinterpret_cast<const float2*>(panel + swz(row + 8, b)), a, 1);
    split_pair<MODE, PARTS>(
        *reinterpret_cast<const float2*>(panel + swz(row, b + 32)), a, 2);
    split_pair<MODE, PARTS>(
        *reinterpret_cast<const float2*>(panel + swz(row + 8, b + 32)), a, 3);
  }
}

// The cp.async route: the producer warpgroup's 128 threads copy one stage
// of x (64 rows x 64 columns, rows ldx elements apart) in 4-byte pieces
// into the swizzled layout a TMA load gives, zero past n and d.  float32:
// one element a piece; bf16 (d and ldx even): a pair.
template <int MODE>
__device__ __forceinline__ void copy_x_stage(uint32_t xs, const void* x,
                                             int64_t n, int64_t d,
                                             int64_t ldx, int64_t row0,
                                             int64_t col0, int pt) {
  if constexpr (MODE == 2) {
    const uint16_t* xb = static_cast<const uint16_t*>(x);
#pragma unroll 4
    for (int i = 0; i < kTileM * kStepD / 2 / 128; ++i) {
      const int e = pt + i * 128;
      const int r = e >> 5, c = (e & 31) * 2;
      const int64_t gr = row0 + r, gc = col0 + c;
      const bool ok = gr < n && gc < d;
      cp_async_4(xs + swz(r, c * 2), ok ? xb + gr * ldx + gc : xb, ok ? 4 : 0);
    }
  } else {
    const float* xf = static_cast<const float*>(x);
#pragma unroll 4
    for (int i = 0; i < kTileM * kStepD / 128; ++i) {
      const int e = pt + i * 128;
      const int r = e >> 6, c = e & 63;
      const int64_t gr = row0 + r, gc = col0 + c;
      const bool ok = gr < n && gc < d;
      cp_async_4(xs + (c >> 5) * (kTileM * 128) + swz(r, (c & 31) * 4),
                 ok ? xf + gr * ldx + gc : xf, ok ? 4 : 0);
    }
  }
}

template <int MODE, int WN>
__global__ void __launch_bounds__(kThreads, 1)
    fused_project_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap m_map,
                         const void* __restrict__ x, float* __restrict__ y,
                         int64_t n, int64_t d, int64_t ldx, int k,
                         int slices, int tiles, int stages, int use_tma,
                         float scale) {
  constexpr int kParts = MODE == 0 ? 3 : (MODE == 1 ? 2 : 1);
  constexpr int kCtaN = 2 * WN;
  constexpr int kXBytes = x_stage_bytes(MODE);
  constexpr int kMBytes = mask_stage_bytes(kCtaN);
  constexpr int kStageBytes = kXBytes + kMBytes;
  constexpr int kStepsPerBlock = kBlockD / kStepD;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's alignment
  const uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + stages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const int nkb = static_cast<int>((d + kStepD - 1) / kStepD);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      // TMA: the producer's expect_tx; cp.async: that and 128 copiers
      mbar_init(full(s), use_tma ? 1 : 129);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    // -- producer warpgroup ----------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = threadIdx.x - kProducer;
    if (use_tma && pt != 0) return;
    int st = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / slices) * kTileM;
      const int col0 = (tile % slices) * kCtaN;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(empty(st), ph ^ 1);
        const uint32_t xs = base + st * kStageBytes;
        if (pt == 0) {
          mbar_expect_tx(full(st), use_tma ? kStageBytes : kMBytes);
          if (use_tma) {
            tma_load_2d(xs, &x_map, full(st), kb * kStepD, row0);
            if constexpr (MODE != 2) {  // float32: a second 32-column panel
              tma_load_2d(xs + kTileM * 128, &x_map, full(st),
                          kb * kStepD + 32, row0);
            }
          }
          tma_load_2d(xs + kXBytes, &m_map, full(st), kb * kStepD, col0);
        }
        if (!use_tma) {
          copy_x_stage<MODE>(xs, x, n, d, ldx, row0,
                             static_cast<int64_t>(kb) * kStepD, pt);
          cp_async_arrive(full(st));
        }
        if (++st == stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // -- consumer warpgroups: 64 rows x WN columns each ---------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int row = warp * 16 + g;  // and row + 8
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.0f;
    uint32_t frag[2][kParts][4] = {};
    int st = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t row0 = static_cast<int64_t>(tile / slices) * kTileM;
      const int col0 = (tile % slices) * kCtaN + wg * WN;
      float prom[WN / 2];  // the round-to-nearest sum of the blocks
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) prom[i] = 0.0f;
      int fresh = 1;     // the next product starts a 512-column block
      int pending = -1;  // a stage whose last product may still be running
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(full(st), ph);
        const uint8_t* xs = smem + st * kStageBytes;
        const uint64_t desc =
            smem_desc(base + st * kStageBytes + kXBytes + wg * WN * 128);
        const int first = fresh ? 0 : 1;
        fresh = 0;
#pragma unroll
        for (int s = 0; s < kStepD / 16; ++s) {
          load_parts<MODE, kParts>(xs, row, s * 16 + 2 * q, frag[s & 1]);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < kParts; ++p) {
            // +32 bytes a k16 step inside the 128-byte swizzled rows
            mma<WN>(acc, frag[s & 1][p], desc + 2 * s,
                    (s == 0 && p == 0) ? first : 1);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous step's products are done
#pragma unroll
          for (int p = 0; p < kParts; ++p)
#pragma unroll
            for (int i = 0; i < 4; ++i) fence_reg(frag[(s + 1) & 1][p][i]);
          if (s == 0 && pending >= 0) {
            if (lane == 0) mbar_arrive(empty(pending));
            pending = -1;
          }
        }
        if ((kb + 1) % kStepsPerBlock == 0 || kb == nkb - 1) {
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < WN / 2; ++i) {
            fence_reg(acc[i]);
            prom[i] += acc[i];
          }
          fresh = 1;
          if (lane == 0) mbar_arrive(empty(st));
        } else {
          pending = st;
        }
        if (++st == stages) {
          st = 0;
          ph ^= 1;
        }
      }
      // the wgmma D layout: register 4j + {0, 1} is row g, columns
      // 8j + 2q + {0, 1}; 4j + {2, 3} the same columns of row g + 8
      const int64_t ra = row0 + row, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = col0 + 8 * j + 2 * q;
        if (col < k) {  // k is a multiple of 8: col + 1 < k too
          if (ra < n) {
            *reinterpret_cast<float2*>(y + ra * k + col) =
                make_float2(prom[4 * j] * scale, prom[4 * j + 1] * scale);
          }
          if (rb < n) {
            *reinterpret_cast<float2*>(y + rb * k + col) =
                make_float2(prom[4 * j + 2] * scale, prom[4 * j + 3] * scale);
          }
        }
      }
    }
  }
}

// -- the mask writer -----------------------------------------------------------
//
// One kernel, two instantiations: float32 M * scale, k x d (rp_lazy_matrix,
// the counterpart of _matrix_kernel), and the launch's unscaled bf16 mask,
// k x cols with the columns past d zero (rp_mask_cache).  Column c lies in
// block c / 512 at position c % 512, so a ragged last block is the leading
// slice of the full 512-wide block, as pallas_sparse_matrix slices it.
//
// What bounds it: the store stream (4kd bytes, 1.25 us at 256 x 4096 and
// 3.35 TB/s); the hash is ~13 integer operations an entry.  The design:
//  * a 2-D grid, so no thread divides: x runs over the columns, VEC a
//    thread (16 bytes of output), y over the rows, and a thread steps on by
//    the grid's rows where k exceeds the y limit.  VEC divides 512, so a
//    thread's run lies in one block, and its block and position are shifts;
//  * the hash's row and block terms are computed once a row, the column
//    term once a thread, stepped by adding the constant along the run;
//  * one 16-byte store a run where rows are 16-byte aligned (float32 with
//    d % 4 == 0, and every bf16 row: cols is a multiple of 64); float32
//    rows of other widths store float2 pairs or single values, and a row's
//    ragged tail only the entries inside it.
// The launch geometry is the wrapper's plan (plan_mask_writer).

constexpr int kWriterThreads = 256;

template <int STORE>
__device__ __forceinline__ void store_run(float* dst, const float (&v)[4],
                                          int n) {
  if (STORE == 4 && n >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (STORE == 2 && n >= 4) {
    reinterpret_cast<float2*>(dst)[0] = make_float2(v[0], v[1]);
    reinterpret_cast<float2*>(dst)[1] = make_float2(v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) dst[i] = v[i];
    }
  }
}

// bf16 rows are whole runs of 8 (cols % 64 == 0): one 16-byte store
template <int STORE>
__device__ __forceinline__ void store_run(__nv_bfloat16* dst,
                                          const float (&v)[8], int) {
  uint4 w;
  w.x = bf16x2_rn(v[0], v[1]);
  w.y = bf16x2_rn(v[2], v[3]);
  w.z = bf16x2_rn(v[4], v[5]);
  w.w = bf16x2_rn(v[6], v[7]);
  *reinterpret_cast<uint4*>(dst) = w;
}

template <typename T, int VEC, int STORE>
__global__ void __launch_bounds__(kWriterThreads)
    mask_writer_kernel(T* __restrict__ out, int k, int d, int cols,
                       MaskParams p, float scale) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= cols) return;
  const uint32_t blk = static_cast<uint32_t>(c0 >> 9) + p.block_offset;
  uint32_t col[VEC];  // ci * kColMul along the run
  col[0] = static_cast<uint32_t>(c0 & (kBlockD - 1)) * kColMul;
#pragma unroll
  for (int i = 1; i < VEC; ++i) col[i] = col[i - 1] + kColMul;
  const int live = d - c0;  // the run's entries inside d (none when <= 0)
  for (int r = blockIdx.y * blockDim.y + threadIdx.y; r < k;
       r += gridDim.y * blockDim.y) {
    const uint32_t rb = mask_row_block(static_cast<uint32_t>(r), blk, p);
    float v[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float e = i < live ? mask_finish(rb ^ col[i], p) : 0.0f;
      if constexpr (sizeof(T) == 4) {
        v[i] = e * scale;
      } else {
        v[i] = e;
      }
    }
    store_run<STORE>(out + static_cast<int64_t>(r) * cols + c0, v, cols - c0);
  }
}

// The plan's geometry: threads to run, every column covered, the y limit.
bool writer_geometry_ok(int cols, int vec, int block_x, int block_y,
                        int grid_x, int grid_y) {
  return block_x > 0 && block_y > 0 && block_x * block_y <= kWriterThreads &&
         grid_x > 0 && grid_y > 0 && grid_y <= 65535 &&
         static_cast<int64_t>(grid_x) * block_x * vec >= cols;
}

template <typename T, int VEC, int STORE>
cudaError_t launch_writer(T* out, int k, int d, int cols, const MaskParams& p,
                          float scale, int block_x, int block_y, int grid_x,
                          int grid_y, cudaStream_t s) {
  mask_writer_kernel<T, VEC, STORE>
      <<<dim3(grid_x, grid_y), dim3(block_x, block_y), 0, s>>>(
          out, k, d, cols, p, scale);
  return cudaGetLastError();
}

MaskParams make_params(uint32_t seed, uint32_t block_offset,
                       uint32_t lim_plus, uint32_t lim_nonzero) {
  MaskParams p;
  p.seed_mix = seed * 0xC2B2AE3Du;
  p.block_offset = block_offset;
  p.lim_plus = lim_plus;
  p.lim_nonzero = lim_nonzero;
  return p;
}

// cuTensorMapEncodeTiled from libcuda, found at run time so the library
// links against the CUDA runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 2-D map (inner x outer elements, rows row_bytes apart) read in boxes of
// box_inner x box_outer with the 128B swizzle; out-of-range elements read 0.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
            uint64_t inner, uint64_t outer, uint64_t row_bytes,
            uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, int WN>
cudaError_t launch(const CUtensorMap& xm, const CUtensorMap& mm, const void* x,
                   float* y, int64_t n, int64_t d, int64_t ldx, int k,
                   int slices, int tiles, int stages, int use_tma, float scale,
                   int grid, cudaStream_t s) {
  const int smem = smem_bytes(2 * WN, MODE, stages);
  cudaError_t e = cudaFuncSetAttribute(
      fused_project_kernel<MODE, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  fused_project_kernel<MODE, WN><<<grid, kThreads, smem, s>>>(
      xm, mm, x, y, n, d, ldx, k, slices, tiles, stages, use_tma, scale);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(int cta_n, const CUtensorMap& xm,
                        const CUtensorMap& mm, const void* x, float* y,
                        int64_t n, int64_t d, int64_t ldx, int k, int slices,
                        int tiles, int stages, int use_tma, float scale,
                        int grid, cudaStream_t s) {
  switch (cta_n) {
    case 64:
      return launch<MODE, 32>(xm, mm, x, y, n, d, ldx, k, slices, tiles,
                              stages, use_tma, scale, grid, s);
    case 128:
      return launch<MODE, 64>(xm, mm, x, y, n, d, ldx, k, slices, tiles,
                              stages, use_tma, scale, grid, s);
    case 256:
      return launch<MODE, 128>(xm, mm, x, y, n, d, ldx, k, slices, tiles,
                               stages, use_tma, scale, grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of one fused launch (the planner's formula).
int rp_fused_smem_bytes(int cta_n, int mode, int stages) {
  return smem_bytes(cta_n, mode, stages);
}

// out (k x dp, bf16) = the unscaled mask of the launch, columns past d zero,
// written by the mask writer on the wrapper's geometry (8 columns a thread).
// Returns cudaGetLastError(); a geometry or shape the writer cannot run is
// refused with cudaErrorInvalidValue.
int rp_mask_cache(void* out, int k, int d, int dp, uint32_t seed,
                  uint32_t block_offset, uint32_t lim_plus,
                  uint32_t lim_nonzero, int block_x, int block_y, int grid_x,
                  int grid_y, void* stream) {
  if (k <= 0 || d <= 0 || dp < d || dp % kStepD ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      !writer_geometry_ok(dp, 8, block_x, block_y, grid_x, grid_y)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MaskParams p = make_params(seed, block_offset, lim_plus, lim_nonzero);
  return static_cast<int>(launch_writer<__nv_bfloat16, 8, 8>(
      static_cast<__nv_bfloat16*>(out), k, d, dp, p, 1.0f, block_x, block_y,
      grid_x, grid_y, static_cast<cudaStream_t>(stream)));
}

// Y (n x k, float32) = scale * X (n x d) . M^T, M read from the mask cache
// (k x dp bf16).  x is float32 for modes 0 and 1 and bfloat16 for mode 2,
// its rows ldx >= d elements apart (ldx = d: contiguous; a column shard of
// a wider batch passes the batch's row length, so it is read in place).
// The plan (cta_n, stages, the TMA or cp.async route, the grid) comes from
// the wrapper's planner; a plan the kernel cannot run is refused with
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
int rp_fused_project(const void* x, const void* mask, void* y, int64_t n,
                     int64_t d, int64_t ldx, int64_t dp, int k, float scale,
                     int mode, int cta_n, int stages, int use_tma, int grid,
                     void* stream) {
  const int item = mode == 2 ? 2 : 4;
  if (mode < 0 || mode > 2 || stages < 2 || stages > kMaxStages ||
      (cta_n != 64 && cta_n != 128 && cta_n != kSliceN) || n <= 0 ||
      d <= 0 || ldx < d || k <= 0 || k % 8 || grid <= 0 || dp % kStepD ||
      dp < d || smem_bytes(cta_n, mode, stages) > kSmemLimit ||
      (use_tma && ((d * item) % 16 || (ldx * item) % 16 ||
                   reinterpret_cast<uintptr_t>(x) % 16)) ||
      (!use_tma && mode == 2 &&
       (d % 2 || ldx % 2 || reinterpret_cast<uintptr_t>(x) % 4)) ||
      reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xm = {}, mm = {};
  if (use_tma &&
      !encode(&xm,
              mode == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              x, d, n, ldx * item, 128 / item, kTileM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!encode(&mm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, mask, dp, k, dp * 2,
              kStepD, cta_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int slices = (k + cta_n - 1) / cta_n;
  const int tiles = static_cast<int>((n + kTileM - 1) / kTileM) * slices;
  grid = grid < tiles ? grid : tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  cudaError_t e;
  switch (mode) {
    case 0:
      e = launch_mode<0>(cta_n, xm, mm, x, out, n, d, ldx, k, slices, tiles,
                         stages, use_tma, scale, grid, s);
      break;
    case 1:
      e = launch_mode<1>(cta_n, xm, mm, x, out, n, d, ldx, k, slices, tiles,
                         stages, use_tma, scale, grid, s);
      break;
    default:
      e = launch_mode<2>(cta_n, xm, mm, x, out, n, d, ldx, k, slices, tiles,
                         stages, use_tma, scale, grid, s);
      break;
  }
  return static_cast<int>(e);
}

// out (k x d, float32) = M * scale, written by the mask writer on the
// wrapper's geometry (4 columns a thread) with stores of `store` values:
// 4 (d % 4 == 0, out 16-byte aligned), 2 (d even, out 8-byte aligned) or 1.
// Returns cudaGetLastError(); a geometry, store width or shape the writer
// cannot run is refused with cudaErrorInvalidValue.
int rp_lazy_matrix(void* out, int k, int d, uint32_t seed,
                   uint32_t block_offset, uint32_t lim_plus,
                   uint32_t lim_nonzero, float scale, int store, int block_x,
                   int block_y, int grid_x, int grid_y, void* stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(out);
  if (k <= 0 || d <= 0 ||
      !writer_geometry_ok(d, 4, block_x, block_y, grid_x, grid_y) ||
      (store == 4 && (d % 4 || at % 16)) || (store == 2 && (d % 2 || at % 8)) ||
      (store != 1 && store != 2 && store != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MaskParams p = make_params(seed, block_offset, lim_plus, lim_nonzero);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (store) {
    case 4:
      e = launch_writer<float, 4, 4>(o, k, d, d, p, scale, block_x, block_y,
                                     grid_x, grid_y, s);
      break;
    case 2:
      e = launch_writer<float, 4, 2>(o, k, d, d, p, scale, block_x, block_y,
                                     grid_x, grid_y, s);
      break;
    default:
      e = launch_writer<float, 4, 1>(o, k, d, d, p, scale, block_x, block_y,
                                     grid_x, grid_y, s);
      break;
  }
  return static_cast<int>(e);
}

const char* rp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
