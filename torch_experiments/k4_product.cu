// Bare 64 x 256 tensor-core products for the Hamming top-k kernel (K4):
// the two exact forms of the distance product, timed alone.
//   form 0: wgmma m64n256k256 .b1 .and.popc  (32 bytes of packed bits a row)
//   form 1: wgmma m64n256k32  .s8            (32 int8 values a row)
// Both read A (64 rows x 32 bytes) and B (256 rows x 32 bytes) from shared
// memory through descriptors, K-major, in one of two layouts:
//   layout 0: the 32-byte swizzle (rows 32 bytes apart, 8-row atoms of 256
//             bytes, the 16-byte half of a row XORed with bit 2 of the row);
//   layout 1: no swizzle (8 x 16-byte core matrices of 128 bytes, the second
//             K half 128 bytes on, 8-row groups 256 bytes apart).
// Driven by torch_experiments/k4_product.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

#define RP_WGMMA(NAME, INSTR)                                                  \
  __device__ __forceinline__ void NAME(int (&d)[128], uint64_t da,             \
                                       uint64_t db, int accumulate) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" INSTR          \
                 " {" RP_REGS128 "}, %128, %129, p;\n}\n"                       \
                 : RP_OUTS128                                                  \
                 : "l"(da), "l"(db), "r"(accumulate));                         \
  }

RP_WGMMA(wgmma_b1, "wgmma.mma_async.sync.aligned.m64n256k256.s32.b1.b1.and.popc")
RP_WGMMA(wgmma_s8, "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8")

__device__ __forceinline__ uint32_t place(int r, int b, int layout) {
  if (layout == 0)
    return (r >> 3) * 256 + (r & 7) * 32 + ((((b >> 4) ^ (r >> 2)) & 1) << 4) +
           (b & 15);
  return (r >> 3) * 256 + (b >> 4) * 128 + (r & 7) * 16 + (b & 15);
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, int layout) {
  const uint64_t start = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  if (layout == 0) return start | (1ull << 16) | (16ull << 32) | (3ull << 62);
  return start | (8ull << 16) | (16ull << 32);
}

template <int FORM>
__global__ void __launch_bounds__(384, 1)
    product_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                   int* __restrict__ out, int iters, int layout) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sa = smem_raw + (base - raw);
  uint8_t* sb = sa + 64 * 32;
  for (int e = threadIdx.x; e < 64 * 32; e += blockDim.x)
    sa[place(e >> 5, e & 31, layout)] = a[e];
  for (int e = threadIdx.x; e < 256 * 32; e += blockDim.x)
    sb[place(e >> 5, e & 31, layout)] = b[e];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  const uint64_t da = descriptor(base, layout);
  const uint64_t db = descriptor(base + 64 * 32, layout);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  if constexpr (FORM == 0) wgmma_b1(d, da, db, 0); else wgmma_s8(d, da, db, 0);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if constexpr (FORM == 0) wgmma_b1(d, da, db, 1); else wgmma_s8(d, da, db, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
  if (blockIdx.x == 0 && threadIdx.x < 128) {
    // the D layout: register 4j + {0, 1} is row 16 warp + g, columns
    // 8j + 2q + {0, 1}; 4j + {2, 3} the same columns of row + 8
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      out[row * 256 + 8 * j + col] = d[4 * j];
      out[row * 256 + 8 * j + col + 1] = d[4 * j + 1];
      out[(row + 8) * 256 + 8 * j + col] = d[4 * j + 2];
      out[(row + 8) * 256 + 8 * j + col + 1] = d[4 * j + 3];
    }
  }
}

}  // namespace

extern "C" {

// out (64 x 256 int32) = the first product (plus 8 * iters accumulated
// repeats) of block 0's first warpgroup; `wgs` warpgroups a block, `blocks`
// blocks.  Returns cudaGetLastError() after the launch.
int k4_product(int form, const void* a, const void* b, void* out, int iters,
               int layout, int wgs, int blocks, void* stream) {
  const int smem = 1024 + (64 + 256) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0)
    product_kernel<0><<<blocks, 128 * wgs, smem, s>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
        static_cast<int*>(out), iters, layout);
  else
    product_kernel<1><<<blocks, 128 * wgs, smem, s>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
        static_cast<int*>(out), iters, layout);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
