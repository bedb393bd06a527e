// Shared numerics and small helpers of the port's attention kernels: the
// finite NEG_INF and the log constants, bf16 packing, 32- and 128-bit
// loads, mma.sync.m16n8k16 (the paged few-rows kernel's 16-row tiles,
// paged_attention.cu) and the launch with a raised shared-memory limit.
// The wgmma building blocks are in hopper.cuh, which includes this file.
//
// Numerics shared by every kernel:
//   * scores are scaled in f32 after the bf16 product (never by scaling q in
//     bf16) and exponentiated with exp2 in the log2 domain;
//   * masked scores take the finite NEG_INF = -1e30 of the JAX package, and
//     masked p is 0, so a row that sees no key ends with l = 0 and writes
//     0 (not NaN; not the JAX reference's uniform average either);
//   * the ragged edge (rows or keys past the end) is masked in the kernels,
//     so callers pad nothing;
//   * p is rounded to bf16 for P@V while l sums the f32 p, as the TPU
//     kernels do.
//
// Every row pointer must be 16-byte aligned with the head dim contiguous
// (the wrappers check): rows are loaded 8 bf16 at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace merlin {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 acc.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ld128(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Raise the dynamic shared-memory limit and launch `kernel` on `stream`.
template <typename Kernel, typename Args>
cudaError_t launch_grid(Kernel kernel, dim3 grid, int threads, int smem,
                        const Args& args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace merlin
