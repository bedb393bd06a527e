// Hopper (sm_90a) building blocks shared by the dense attention forward
// (attention_fwd.cu: B1, B2, B12), the fused backward
// (flash_attention_bwd.cu: B10, B11, B13) and the paged window kernel
// (paged_attention.cu: B6, B8):
//   * the 128-byte swizzled tile layout that wgmma's descriptors read, and
//     a cp.async loader that fills it from a strided (b, s, h, d) tensor;
//   * 16- and 4-byte cp.async with zero fill, commit and wait;
//   * wgmma descriptors (K-major and MN-major), fences, commit and wait;
//   * wgmma.mma_async m64nNk16 bf16 -> f32 with A and B in shared memory
//     (SS, N = 64 or 128) or A from registers (RS, N = 64 or 128);
//   * pin(), which keeps the compiler from moving a use of a register that
//     an asynchronous wgmma reads or writes across its wait;
//   * fast_exp2 (ex2.approx on the SFU).
//
// Tile layout: a ROWS-row bf16 tile of DP columns is kept as DP / 64
// blocks of [ROWS][64], block after block; in each block row r is 128 bytes
// and its 16-byte chunk c / 8 sits at chunk (c / 8) ^ (r % 8). Read K-major
// (rows = M or N, the 64 columns = K) a descriptor steps 8-row groups 1024
// bytes apart; read MN-major (rows = K, columns = N) it also steps 64-column
// blocks ROWS * 128 bytes apart. Block bases must be 1024-aligned.

#pragma once

#include "attention_core.cuh"

namespace merlin {

// 2^x by the SFU, flushing results below 2^-126 to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row r, column c) in a ROWS-row swizzled tile.
template <int ROWS = 64>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 6) * (ROWS * 128) + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for this thread's copies; fence_async_smem then makes every
// thread's writes to shared memory visible to wgmma (the async proxy) once
// the caller syncs
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ROWS rows x DP columns of a strided (b, s, h, d) tensor (rows
// `row_stride` apart, from `src`) into the swizzled tile at `dst`, by
// NTHREADS threads (this one is `tid`); rows past `rows` and columns past d
// are zero-filled and never read.
template <int DP, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int rows, int d,
                                          int tid) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < rows && c < d;
    cp_async16(dst + sw128<ROWS>(r, c), ok ? src + r * row_stride + c : src,
               ok);
  }
}

// wgmma descriptor of a swizzled tile at shared address `addr`: strides in
// bytes (lbo: between 64-column blocks along M/N for an MN-major operand,
// unused for a K-major one; sbo: between 8-row groups), 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return wgmma_desc(addr, 16, 1024);
}

// an MN-major operand in a ROWS-row tile (64-column blocks ROWS * 128
// bytes apart)
template <int ROWS = 64>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return wgmma_desc(addr, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed wgmma groups are
// still in flight (they complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma writes (or reads) at this point
// of the program, so the compiler moves no use of them across a wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A B, A (64 x 16) and B (16 x 64) both read from shared memory
// through descriptors; TA / TB mark A / B as MN-major (transposed). With
// scale_d 0 the old d is ignored (d = A B).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// As wgmma_ss_n64 with B (16 x 128).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d += A B, A (64 x 16) from registers (each warp's 16 rows in the
// mma.sync A fragment layout) and B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// As wgmma_rs_n64 with B (16 x 128).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A from registers and B (16 x N) MN-major, N = 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

}  // namespace merlin
