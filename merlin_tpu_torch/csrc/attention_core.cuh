// Shared tile machinery of the port's two attention kernels
// (onepass_attention.cu = B1, flash_attention.cu = B2).
//
// One thread block owns 64 query rows of one (batch, head): four warps of
// 16 rows each. The block stages its Q tile in shared memory once, then
// walks the KV sequence in 64-row tiles staged through shared memory.
// Scores and P@V run on the tensor cores as mma.sync.m16n8k16 (bf16 in,
// f32 accumulate); the softmax is online (running max m and sum l per
// row, kept in registers of the quad of threads that owns the row).
//
// Numerics shared by both kernels:
//   * scores are scaled in f32 after the bf16 matmul (never by scaling q in
//     bf16) and exponentiated with exp2 in the log2 domain;
//   * masked scores take the finite NEG_INF = -1e30 of the JAX package, and
//     masked p is 0, so a row that sees no key ends with l = 0 and writes
//     0 (not NaN; not the JAX reference's uniform average either);
//   * the ragged sequence edge (rows or keys past sq/skv) is masked here,
//     so callers pad nothing;
//   * p is rounded to bf16 for P@V while l sums the f32 p, as the TPU
//     kernels do.
//
// q/k/v are read through their (b, s, h, d) strides: the head dim must be
// contiguous, every other stride and the base pointers 16-byte aligned
// (the wrappers check). The output is contiguous (b, sq, h, d).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace merlin {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockM = 64;   // query rows per block (4 warps x 16)
constexpr int kBlockN = 64;   // key rows per KV tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 per smem row, staggers banks

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;   // (b, sq, h, d) contiguous
  float* lse;           // (b, h, sq) natural log, or nullptr
  const int* qseg;      // (b, sq) or nullptr
  const int* kseg;      // (b, skv) or nullptr
  const float* slopes;  // (h,) ALiBi slopes, or nullptr
  int b, sq, skv, h, hkv, d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

template <int DP>
constexpr int smem_bytes() {
  return 3 * kBlockM * (DP + kPad) * (int)sizeof(__nv_bfloat16);
}

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

// Stage a 64-row tile of one head into smem [64][DP + kPad], 16 bytes per
// thread per step; rows past `rows` and columns past d are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          int64_t row_stride, int rows, int d) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < kBlockM * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < d) {
      val = *reinterpret_cast<const uint4*>(base + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * (DP + kPad) + c) = val;
  }
}

// The whole forward for the block's 64 query rows. DP is the head dim
// rounded up to a supported width (zero columns cost MMA work, not
// results).
template <int DP, bool CAUSAL>
__device__ __forceinline__ void attention_block(const AttnArgs& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + kPad;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockM * LD;
  __nv_bfloat16* Vs = Ks + kBlockN * LD;
  const uint16_t* Vbits = reinterpret_cast<const uint16_t*>(Vs);

  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int hk = hi / (a.h / a.hkv);  // GQA: kv head of this query head
  const int q0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row within the warp's 16
  const int t = lane & 3;   // thread within the quad that shares a row
  const int r_lo = warp * 16 + g;
  const int qi[2] = {q0 + r_lo, q0 + r_lo + 8};

  load_tile<DP>(Qs, a.q + bi * a.q_sb + (int64_t)q0 * a.q_ss + hi * a.q_sh,
                a.q_ss, min(kBlockM, a.sq - q0), a.d);

  const bool alibi = a.slopes != nullptr;
  const float slope = alibi ? a.slopes[hi] : 0.f;
  const float log2_scale = a.scale * kLog2e;
  int qs[2] = {0, 0};
  if (a.qseg != nullptr) {
    for (int r = 0; r < 2; ++r) {
      qs[r] = qi[r] < a.sq ? a.qseg[(int64_t)bi * a.sq + qi[r]] : 0;
    }
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }

  int n_tiles = (a.skv + kBlockN - 1) / kBlockN;
  if (CAUSAL) {
    // tiles wholly above the diagonal hold no visible key for any row
    n_tiles = min(n_tiles, (q0 + kBlockM - 1) / kBlockN + 1);
  }
  const int dk = (a.d + 15) / 16 * 16;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockN;
    const int rows = min(kBlockN, a.skv - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP>(Ks, a.k + bi * a.k_sb + (int64_t)k0 * a.k_ss + hk * a.k_sh,
                  a.k_ss, rows, a.d);
    load_tile<DP>(Vs, a.v + bi * a.v_sb + (int64_t)k0 * a.v_ss + hk * a.v_sh,
                  a.v_ss, rows, a.d);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      if (kk < dk) {
        const __nv_bfloat16* qr = Qs + r_lo * LD + kk + t * 2;
        const uint32_t af[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8),
                                ld32(qr + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kk + t * 2;
          mma_16816(s[j], af, ld32(kr), ld32(kr + 8));
        }
      }
    }

    // scale (+ ALiBi), mask, and the tile's row max, in the log2 domain
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ki = k0 + j * 8 + t * 2 + (e & 1);
        float x = alibi ? (s[j][e] * a.scale + slope * (float)(ki - qi[r])) * kLog2e
                        : s[j][e] * log2_scale;
        bool ok = ki < a.skv;
        if (CAUSAL) ok = ok && ki <= qi[r];
        if (a.qseg != nullptr) {
          ok = ok && qs[r] == a.kseg[(int64_t)bi * a.skv + ki];
        }
        x = ok ? x : kNegInf;
        s[j][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float alpha[2];
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - m[r]);
        s[j][e] = p;
        lsum[r] += p;
      }
    }
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two adjacent n-tiles are exactly
    // the A fragment of one k=16 step
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pf[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const uint16_t* vr = Vbits + (ks * 16 + t * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        if (dn * 8 < a.d) {
          const uint16_t* vc = vr + dn * 8;
          const uint32_t b0 = (uint32_t)vc[0] | ((uint32_t)vc[LD] << 16);
          const uint32_t b1 =
              (uint32_t)vc[8 * LD] | ((uint32_t)vc[9 * LD] << 16);
          mma_16816(o[dn], pf, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow =
        a.out + (((int64_t)bi * a.sq + qi[r]) * a.h + hi) * a.d;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + t * 2;
      if (col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[dn][2 * r] / l_safe, o[dn][2 * r + 1] / l_safe);
      }
    }
    if (a.lse != nullptr && t == 0) {
      a.lse[((int64_t)bi * a.h + hi) * a.sq + qi[r]] =
          l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]);
    }
  }
}

// Raise the dynamic shared-memory limit and launch `kernel` over
// (q blocks, heads, batch) on `stream`.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const AttnArgs& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.h, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace merlin
