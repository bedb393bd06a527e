// The tile engine of the port's f32 paged attention kernel
// (paged_attention_f32.cu): products on the CUDA cores (FFMA), f32 tiles
// in shared memory. The dense f32 kernels (attention_f32.cu,
// flash_attention_bwd_f32.cu) left it for 3xTF32 on the tensor cores
// (tf32x3.cuh).
//
// Why FFMA here: the JAX package's tests hold the port to Pallas interpret
// mode, which does every f32 product in f32, so an f32 kernel must be as
// accurate as f32, and one TF32 pass keeps ~3 decimal digits. The paged
// kernel rounds p to the page dtype on its own 64-key tiles (C48); at
// decode one CTA walks a sequence's keys alone, and that, not the FFMA
// peak (67 TFLOP/s), holds it back. A key split over CTAs (the bf16
// few-rows kernel's) and a 3xTF32 form are later work.
//
// The tile engine: 256 threads as a 16 x 16 grid, ty = tid / 16 owning the
// tile rows ty + 16 i (i < RI) and tx = tid % 16 owning the score columns
// tx + 16 j (j < CJ) and the output columns 64 j + 4 tx + e (e < 4). A row's
// 16 threads are one half-warp, so a row reduction is 4 shuffles. Tiles are
// f32 in shared memory with the row stride d + 4: 16-byte aligned rows, and
// the 8 rows a quarter-warp reads with one float4 load fall on 8 distinct
// 4-bank groups for every d % 8 == 0.

#pragma once

#include "attention_core.cuh"

namespace merlin {
namespace f32 {

constexpr int kThreads = 256;
constexpr int kKeys = 64;            // keys (score columns) of a tile
constexpr int kCJ = kKeys / 16;      // score columns a thread owns
constexpr int kLdP = kKeys + 4;      // row stride of a P or dS tile

__host__ __device__ constexpr int ld_of(int d) { return d + 4; }

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// s[i][j] = sum_{c < d} A[(ty + 16 i) * ld + c] * B[(tx + 16 j) * ld + c]
// (d % 4 == 0), summed in c order by FFMA.
template <int RI, int CJ>
__device__ __forceinline__ void tile_dots(const float* A, const float* B,
                                          int ld, int d, int ty, int tx,
                                          float (&s)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
  for (int c = 0; c < d; c += 4) {
    float4 a[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + c);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ld + c);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(a[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, bv[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// o[i][j][e] += sum_{k < nk} P[(ty + 16 i) * ldp + k] * V[k * ld + c],
// c = 64 j + 4 tx + e < d (nk % 4 == 0, d % 4 == 0): P V, or dS K, P^T dO,
// dS^T Q with the left operand's rows laid out as the tile's rows.
template <int RI, int DJ>
__device__ __forceinline__ void tile_pv(const float* P, int ldp,
                                        const float* V, int ld, int nk, int d,
                                        int ty, int tx,
                                        float (&o)[RI][DJ][4]) {
  for (int k = 0; k < nk; k += 4) {
    float4 p[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * ldp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = 64 * j + 4 * tx;
        if (c < d) {
          const float4 v =
              *reinterpret_cast<const float4*>(V + (k + kk) * ld + c);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            const float pk = lane_of(p[i], kk);
            o[i][j][0] = fmaf(pk, v.x, o[i][j][0]);
            o[i][j][1] = fmaf(pk, v.y, o[i][j][1]);
            o[i][j][2] = fmaf(pk, v.z, o[i][j][2]);
            o[i][j][3] = fmaf(pk, v.w, o[i][j][3]);
          }
        }
      }
    }
  }
}

template <int RI, int DJ>
__device__ __forceinline__ void zero(float (&o)[RI][DJ][4]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
}

// Row `row` of the tile's accumulators times `mul`, to dst[c] (f32, c < d).
template <int RI, int DJ>
__device__ __forceinline__ void store_row(float* dst, const float (&o)[RI][DJ][4],
                                          int i, float mul, int d, int tx) {
#pragma unroll
  for (int j = 0; j < DJ; ++j) {
    const int c = 64 * j + 4 * tx;
    if (c < d)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(o[i][j][0] * mul, o[i][j][1] * mul, o[i][j][2] * mul,
                      o[i][j][3] * mul);
  }
}

}  // namespace f32
}  // namespace merlin
