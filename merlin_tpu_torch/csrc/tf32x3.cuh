// 3xTF32 building blocks of the port's dense float32 attention kernels
// (attention_f32.cu: B1, B2, B12; flash_attention_bwd_f32.cu: B10, B11,
// B13): every product on the tensor cores by mma.sync m16n8k8 with tf32
// operands, at f32 accuracy.
//
// The split: an f32 operand x is taken as big = x with its low 13 mantissa
// bits cleared (tf32 rounded toward zero) and small = x - big (exact in
// f32), and a product a b as small_a big_b + big_a small_b + big_a big_b,
// summed in f32 by the tensor core, which reads the top 19 bits of each
// operand register (so small enters rounded toward zero to tf32 too). What
// is lost a product (small_a small_b and small's cut bits) is of order
// 2^-20 |a b|. One tf32 pass (big_a big_b alone) keeps ~3 decimal digits.
// Each operand is split when its fragment is loaded from shared memory
// (a LOP3 and an FADD), so tiles stay plain f32. cvt.rna.tf32.f32 would
// round big to nearest, but costs more instructions an operand (ptxas
// adds its NaN handling) for an error that stays of the same order.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32): lane = 4 g + t. A (16 x 8, row):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// col): b0 (k = t, n = g), b1 (k = t + 4, n = g); C (16 x 8): c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
//
// A contraction does not care about the order of its terms, and the
// tensor core reads an operand's fragment from consecutive registers, so
// the products are laid out for loads that land in those registers:
//   * dots (S = A B^T, both operands with the contracted dim contiguous:
//     Q K^T, dO V^T, K Q^T, V dO^T): ldmatrix.x4 (8 rows of 16 bytes a
//     matrix; lane i receives word i % 4 of row i / 4) reads A's 16 x 8
//     fragment and B's two 8 x 8 fragments of a 16-column step straight
//     into their register quads and pairs.
//   * pv (O += P V, P in registers as dots left it: P V, dS K, P^T dO,
//     dS^T Q) is computed transposed, O^T += V^T P^T: P's accumulator
//     pairs (c0, c1) and (c2, c3), keys 2t and 2t + 1 of rows g and g + 8,
//     are its B fragments (k = t taken as key 2t, k = t + 4 as key 2t + 1),
//     so P never leaves the registers; V^T's A fragment of 16 columns
//     (m = g taken as column 2g, m = g + 8 as 2g + 1) is two 8-byte loads,
//     rows 2t and 2t + 1 at columns 2g, 2g + 1. A lane then holds O's
//     rows 2t, 2t + 1, 8 + 2t and 9 + 2t at columns 2g, 2g + 1 of each
//     16-column group (pv's layout); the softmax, which owns rows g and g
//     + 8 in dots' layout, passes its row factors over by shuffles.
// Tiles are f32 in shared memory with the row stride LD = DMAX + 4 (a
// compile-time constant, so every fragment address is an immediate
// offset), columns d .. dp zero-filled, dp = d rounded up to 32: rows are
// 16 bytes apart modulo 128, so each ldmatrix phase (8 rows) and each
// half-warp of pv's 8-byte loads hits distinct banks.
//
// The tensor core adds into its accumulator without rounding to nearest
// (an ulp can go, in one direction, at every mma), so a chain of a
// thousand keys' mma into one accumulator drifts by ~1e-5 of max |out|:
// each product's chains start from 0 over one 32-column chunk (dots) or
// one key tile (pv) and are added to the running sums by an f32 add.

#pragma once

#include "hopper.cuh"

namespace merlin {
namespace tf32x3 {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // tile rows of a CTA, 16 a warp

__host__ __device__ constexpr int dpad(int d) { return (d + 31) & ~31; }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1,
                                        float a2, float a3) {
  split(a0, f.big[0], f.small[0]);
  split(a1, f.big[1], f.small[1]);
  split(a2, f.big[2], f.small[2]);
  split(a3, f.big[3], f.small[3]);
}

__device__ __forceinline__ void split_b(FragB& f, float b0, float b1) {
  split(b0, f.big[0], f.small[0]);
  split(b1, f.big[1], f.small[1]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// four 8 x 8 matrices of 32-bit words (8 rows of 16 bytes each, row
// addresses from lanes 8m .. 8m + 7 for matrix m) into r[m]: lane i gets
// word i % 4 of row i / 4
__device__ __forceinline__ void ldsm4(float (&r)[4], uint32_t addr) {
  uint32_t x0, x1, x2, x3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3)
               : "r"(addr));
  r[0] = __uint_as_float(x0);
  r[1] = __uint_as_float(x1);
  r[2] = __uint_as_float(x2);
  r[3] = __uint_as_float(x3);
}

// c[j] = A (16 rows from A) . B^T (rows 8j .. 8j + 7 from B), over the dp
// columns (dp % 32 == 0): dots' layout above, a chain a 32-column chunk,
// the NJ chains issued in turn so their mma overlap.
template <int NJ, int LD>
__device__ __forceinline__ void dots(const float* A, const float* B, int dp,
                                     int lane, float (&c)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  // A: matrices (rows 0-7, col 0), (8-15, 0), (0-7, 4), (8-15, 4) of a
  // k-step; B: rows 0-7 at cols 0, 4, 8, 12 (two k-steps)
  const uint32_t pa = smem_addr(A) +
      (((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4)) * 4;
  const uint32_t pb = smem_addr(B) + ((lane & 7) * LD + 4 * (lane >> 3)) * 4;
#pragma unroll 1
  for (int k0 = 0; k0 < dp; k0 += 32) {
    FragA fa[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float x[4];
      ldsm4(x, pa + (k0 + 8 * s) * 4);
      split_a(fa[s], x[0], x[1], x[2], x[3]);
    }
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float y[4];
        ldsm4(y, pb + (8 * j * LD + k0 + 16 * h) * 4);
        FragB fb;
        split_b(fb, y[0], y[1]);
        mma3(part[j], fa[2 * h], fb);
        split_b(fb, y[2], y[3]);
        mma3(part[j], fa[2 * h + 1], fb);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += part[j][e];
  }
}

// o += P (p[j]: 16 x 8 NJ in dots' layout) . V (rows 8j .. 8j + 7 from
// V), for the 16-column groups m < nm of V (nm even): pv's layout above
// (o[m][rb]: rows 8 rb + 2t (elements 0, 2) and 8 rb + 2t + 1 (1, 3) at
// columns 16m + 2g (0, 1) and 16m + 2g + 1 (2, 3)), a chain a group and
// row block, two groups' four chains in turn so their mma overlap.
template <int NJ, int NM, int LD>
__device__ __forceinline__ void pv(const float (&p)[NJ][4], const float* V,
                                   int nm, int lane, float (&o)[NM][2][4]) {
  const int g = lane >> 2, t = lane & 3;
  FragB fb[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split_b(fb[j][0], p[j][0], p[j][1]);
    split_b(fb[j][1], p[j][2], p[j][3]);
  }
  const float* v0 = V + 2 * t * LD + 2 * g;
  constexpr int MB = 2;                // groups in flight: 4 chains
  static_assert(NM % MB == 0, "pv's groups");
#pragma unroll
  for (int m0 = 0; m0 < NM; m0 += MB) {
    if (m0 < nm) {
      float part[MB][2][4];
#pragma unroll
      for (int mm = 0; mm < MB; ++mm)
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mm][rb][i] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int mm = 0; mm < MB; ++mm) {
          const float* vj = v0 + 8 * j * LD + 16 * (m0 + mm);
          const float2 x = lds2(vj), y = lds2(vj + LD);
          FragA fa;
          split_a(fa, x.x, x.y, y.x, y.y);
          mma3(part[mm][0], fa, fb[j][0]);
          mma3(part[mm][1], fa, fb[j][1]);
        }
#pragma unroll
      for (int mm = 0; mm < MB; ++mm)
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[m0 + mm][rb][i] += part[mm][rb][i];
    }
  }
}

// A factor of each row of pv's layout, from the lanes that own the row in
// dots' layout (quad q holds rows q and q + 8 as v[0], v[1]): f[rb][u] for
// row 8 rb + 2t + u
__device__ __forceinline__ void to_pv_rows(const float (&v)[2], int lane,
                                           float (&f)[2][2]) {
  const int t = lane & 3;
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      f[rb][u] = __shfl_sync(0xffffffffu, v[rb], 4 * (2 * t + u));
}

template <int NM>
__device__ __forceinline__ void zero(float (&o)[NM][2][4]) {
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[m][rb][i] = 0.f;
}

// Row 8 rb + 2t + u of pv's accumulators times mul to dst[0, d) (f32,
// dst the row's column 0)
template <int NM>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&o)[NM][2][4], int rb,
                                          int u, float mul, int d, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    const int col = 16 * m + 2 * g;
    if (col < d)
      *reinterpret_cast<float2*>(dst + col) =
          make_float2(o[m][rb][u] * mul, o[m][rb][u + 2] * mul);
  }
}

// Rows [r0, r0 + ROWS) of a strided f32 (s, d) matrix (d contiguous, rows
// `row_stride` floats apart, 16-byte aligned) into T (row stride DMAX +
// 4) by cp.async, this CTA's kThreads threads each taking one 16-byte
// column slot of every kThreads / (DMAX / 4)-th row; rows at or past
// `valid` and columns d .. dp are zero-filled.
template <int DMAX, int ROWS>
__device__ __forceinline__ void load_tile(float* T, const float* base,
                                          int64_t row_stride, int r0,
                                          int valid, int d, int dp,
                                          int tid) {
  constexpr int kPer = DMAX / 4, kStep = kThreads / kPer, kLd = DMAX + 4;
  static_assert(kThreads % kPer == 0 && ROWS % kStep == 0, "tile shape");
  const int c = (tid % kPer) * 4, r1 = tid / kPer;
  if (c >= dp) return;
  const uint32_t t0 = smem_addr(T) + (r1 * kLd + c) * 4;
  const float* src = base + static_cast<int64_t>(r0 + r1) * row_stride + c;
#pragma unroll
  for (int r = 0; r < ROWS; r += kStep) {
    const bool ok = c < d && r0 + r1 + r < valid;
    cp_async16(t0 + r * kLd * 4, ok ? src + r * row_stride : base, ok);
  }
}

// n 4-byte values src[i0 + i] (i < n, those at or past `valid` zero) into
// T[i] by cp.async; src NULL leaves T alone.
__device__ __forceinline__ void load_vec(void* T, const void* src, int i0,
                                         int n, int valid, int tid) {
  if (!src) return;
  const uint32_t t0 = smem_addr(T);
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = i0 + i < valid;
    cp_async4(t0 + 4 * i,
              ok ? static_cast<const char*>(src) + 4 * (i0 + i) : src, ok);
  }
}

// max / sum over the 4 lanes of a quad (the lanes that hold one row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace tf32x3
}  // namespace merlin
