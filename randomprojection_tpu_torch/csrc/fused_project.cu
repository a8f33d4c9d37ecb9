// Fused lazy-mask projection and mask writer for Hopper (sm_90a).
//
// Replaces the TPU kernels of randomprojection_tpu/ops/pallas_kernels.py:
//   rp_fused_project  <- _project_kernel_dma (347) and _project_kernel (321),
//                        launched by _fused_raw (664) at pallas_call 752/777;
//   rp_lazy_matrix    <- _matrix_kernel (397), pallas_sparse_matrix (940).
//
// What it computes.  Y[n,k] = scale * sum_j X[:, block j] . M_j^T, where
// M_j is the (k x 512) {+1,-1,0} mask of column block j, a pure function of
// (seed, j + block_offset), regenerated in the kernel and never written to
// device memory; scale = 1/sqrt(density*k) is applied once at the end.
// The mask stream is the integer hash of the JAX package's interpreter
// stream (_interp_mask_block, 205-230), bit for bit: all arithmetic is
// uint32, a ragged last block keeps its position within the full 512-wide
// block, and the two thresholds arrive as integer limits on h >> 8 that
// the host derived from float32(density/2) and float32(density), so
// "u < t" with u = (h >> 8) * 2^-24 is the same test as "(h >> 8) < lim".
//
// What bounds it.  At config 2 (1M x 4096 -> 256, f32 in and out) the
// function must move 4nd + 4nk bytes (17.4 GB, 5.2 ms at 3.35 TB/s) and do
// 2ndk multiply-adds per product (2.1 TFLOP), so the memory bounds it when
// the products run on tensor cores.  This first kernel runs them on the
// CUDA cores in float32 FMA, where 2.1 TFLOP at 67 TFLOP/s is already
// 31 ms: it is bound by operations, far from the memory bound.
//
// What the design does about it.  One block owns a (128-row x 64-column)
// tile of Y and loops over the contraction in 32-column steps: it stages
// the x tile in shared memory (split into its hi/lo bf16 halves in
// registers on the way for split2), regenerates its 64 x 32 slice of the
// mask into shared memory (one hash per entry, reused by all 128 rows),
// and accumulates 8 x 4 outputs per thread in float32 registers.  The
// TPU kernel's mask cache, x double buffering, TMA and wgmma are later
// work.  Modes: 0 = f32 (fp32 FMA, the interpreter's arithmetic),
// 1 = split2 (x split by the 0xFFFF0000 bit mask into hi/lo bf16, both
// products accumulated in float32; products with +-1/0 are exact),
// 2 = bf16 (x arrives as bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockD = 512;   // column block of the matrix definition
constexpr int kTileN = 128;    // rows of Y per thread block
constexpr int kTileK = 64;     // columns of Y (rows of M) per thread block
constexpr int kTileD = 32;     // contraction columns staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, each 8 rows x 4 columns

struct MaskParams {
  uint32_t seed_mix;      // uint32(seed) * 0xC2B2AE3D
  uint32_t block_offset;  // global index of column block 0
  uint32_t lim_plus;      // (h >> 8) <  lim_plus              -> +1
  uint32_t lim_nonzero;   // lim_plus <= (h >> 8) < lim_nonzero -> -1, else 0
};

__device__ __forceinline__ float mask_entry(uint32_t ri, uint32_t ci,
                                            uint32_t blk,
                                            const MaskParams& p) {
  uint32_t h = (ri * 0x9E3779B1u) ^ (ci * 0x85EBCA77u) ^ p.seed_mix ^
               (blk * 0x27D4EB2Fu);
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h ^= h >> 13;
  const uint32_t m = h >> 8;
  return m < p.lim_plus ? 1.0f : (m < p.lim_nonzero ? -1.0f : 0.0f);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    fused_project_kernel(const void* __restrict__ x_, float* __restrict__ y,
                         int64_t n, int64_t d, int k, MaskParams p,
                         float scale) {
  constexpr int kHalves = MODE == 1 ? 2 : 1;
  // x tile row-major, one column of padding: the writes (a warp stores 32
  // consecutive columns of one row) and the reads (a warp reads two rows
  // 8 apart) both fall in distinct banks
  __shared__ float xs[kHalves][kTileN][kTileD + 1];
  __shared__ __align__(16) float ms[kTileD][kTileK];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows ty*8 .. ty*8+7
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  const int col0 = blockIdx.y * kTileK;

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int64_t d0 = 0; d0 < d; d0 += kTileD) {
    // stage x: a warp reads 32 consecutive columns of one row; columns past
    // d and rows past n are zero, as the TPU kernel's zero padding
#pragma unroll
    for (int i = 0; i < kTileN * kTileD / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kTileD;
      const int c = e % kTileD;
      const int64_t gr = row0 + r;
      const int64_t gc = d0 + c;
      float v = 0.0f;
      if (gr < n && gc < d) {
        if (MODE == 2) {
          v = __bfloat162float(
              static_cast<const __nv_bfloat16*>(x_)[gr * d + gc]);
        } else {
          v = static_cast<const float*>(x_)[gr * d + gc];
        }
      }
      if (MODE == 1) {
        const float hi = __uint_as_float(__float_as_uint(v) & 0xFFFF0000u);
        xs[0][r][c] = hi;
        xs[kHalves - 1][r][c] = __bfloat162float(__float2bfloat16_rn(v - hi));
      } else {
        xs[0][r][c] = v;
      }
    }
    // regenerate this step's 64 x 32 slice of the mask; a 32-column step
    // never straddles a 512-column block
    const uint32_t blk = static_cast<uint32_t>(d0 / kBlockD) + p.block_offset;
    const uint32_t ci0 = static_cast<uint32_t>(d0 % kBlockD);
#pragma unroll
    for (int i = 0; i < kTileK * kTileD / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e % kTileK;
      const int c = e / kTileK;
      const int gk = col0 + kk;
      ms[c][kk] = gk < k ? mask_entry(static_cast<uint32_t>(gk), ci0 + c,
                                      blk, p)
                         : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTileD; ++c) {
      const float4 m4 = *reinterpret_cast<const float4*>(&ms[c][tx * 4]);
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = xs[h][ty * 8 + r][c];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a, mv[q], acc[r][q]);
        }
      }
    }
    __syncthreads();
  }

  // k is a multiple of 8 and col0 of 64, so a column group that starts
  // inside k ends inside it: one 16-byte store per row
  const int gk = col0 + tx * 4;
  if (gk >= k) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t gr = row0 + ty * 8 + r;
    if (gr < n) {
      *reinterpret_cast<float4*>(&y[gr * k + gk]) =
          make_float4(acc[r][0] * scale, acc[r][1] * scale, acc[r][2] * scale,
                      acc[r][3] * scale);
    }
  }
}

// One thread per entry of the (k x d) output M * scale.  Column c lies in
// block c / 512 at position c % 512, so a ragged last block is the leading
// slice of the full 512-wide block, as pallas_sparse_matrix slices it.
__global__ void lazy_matrix_kernel(float* __restrict__ out, int k, int64_t d,
                                   MaskParams p, float scale) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(k) * d) return;
  const int64_t r = idx / d;
  const int64_t c = idx % d;
  out[idx] = mask_entry(static_cast<uint32_t>(r),
                        static_cast<uint32_t>(c % kBlockD),
                        static_cast<uint32_t>(c / kBlockD) + p.block_offset,
                        p) *
             scale;
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

}  // namespace

extern "C" {

// Y (n x k, float32) = scale * X (n x d) . M^T.  x is float32 for modes 0
// and 1 and bfloat16 for mode 2; both tensors contiguous.  Returns
// cudaGetLastError() after the launch.
int rp_fused_project(const void* x, void* y, int64_t n, int64_t d, int k,
                     uint32_t seed, uint32_t block_offset, uint32_t lim_plus,
                     uint32_t lim_nonzero, float scale, int mode,
                     void* stream) {
  const MaskParams p = make_params(seed, block_offset, lim_plus, lim_nonzero);
  const dim3 grid(static_cast<unsigned>((n + kTileN - 1) / kTileN),
                  static_cast<unsigned>((k + kTileK - 1) / kTileK));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  switch (mode) {
    case 0:
      fused_project_kernel<0><<<grid, kThreads, 0, s>>>(x, out, n, d, k, p,
                                                        scale);
      break;
    case 1:
      fused_project_kernel<1><<<grid, kThreads, 0, s>>>(x, out, n, d, k, p,
                                                        scale);
      break;
    case 2:
      fused_project_kernel<2><<<grid, kThreads, 0, s>>>(x, out, n, d, k, p,
                                                        scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (k x d, float32) = M * scale.  Returns cudaGetLastError().
int rp_lazy_matrix(void* out, int k, int64_t d, uint32_t seed,
                   uint32_t block_offset, uint32_t lim_plus,
                   uint32_t lim_nonzero, float scale, void* stream) {
  const MaskParams p = make_params(seed, block_offset, lim_plus, lim_nonzero);
  const int64_t total = static_cast<int64_t>(k) * d;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  lazy_matrix_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), k, d, p, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* rp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
