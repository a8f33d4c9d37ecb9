// The mask writers as they stood before their redesign (one thread an
// entry, a 64-bit division and remainder a thread, one 2- or 4-byte store),
// kept as the yardstick of the redesigned writer in
// randomprojection_tpu_torch/csrc/fused_project.cu.  chip_smoke.py builds
// this file beside the port's sources and times both writers in one run,
// and holds this one to the same plain versions bit for bit.
//
// Plain C interface, loaded with ctypes:
//   rp_mask_cache_per_entry(out, k, d, dp, seed, block_offset, lim_plus,
//                           lim_nonzero, stream)
//   rp_lazy_matrix_per_entry(out, k, d, seed, block_offset, lim_plus,
//                            lim_nonzero, scale, stream)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockD = 512;

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

__global__ void mask_cache_kernel(__nv_bfloat16* __restrict__ out, int k,
                                  int64_t d, int64_t dp, MaskParams p) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(k) * dp) return;
  const int64_t r = idx / dp;
  const int64_t c = idx % dp;
  out[idx] = __float2bfloat16(
      c < d ? mask_entry(static_cast<uint32_t>(r),
                         static_cast<uint32_t>(c % kBlockD),
                         static_cast<uint32_t>(c / kBlockD) + p.block_offset, p)
            : 0.0f);
}

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

int rp_mask_cache_per_entry(void* out, int k, int64_t d, int64_t dp,
                            uint32_t seed, uint32_t block_offset,
                            uint32_t lim_plus, uint32_t lim_nonzero,
                            void* stream) {
  const MaskParams p = make_params(seed, block_offset, lim_plus, lim_nonzero);
  const int64_t total = static_cast<int64_t>(k) * dp;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  mask_cache_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(out), k, d, dp, p);
  return static_cast<int>(cudaGetLastError());
}

int rp_lazy_matrix_per_entry(void* out, int k, int64_t d, uint32_t seed,
                             uint32_t block_offset, uint32_t lim_plus,
                             uint32_t lim_nonzero, float scale,
                             void* stream) {
  const MaskParams p = make_params(seed, block_offset, lim_plus, lim_nonzero);
  const int64_t total = static_cast<int64_t>(k) * d;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  lazy_matrix_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), k, d, p, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
