// B10 + B11 - flash-attention backward, for Hopper (sm_90a); B13 runs the
// same two kernels, non-causal and unmasked.
//
// Replaces merlin_tpu/ops/flash_attention.py: _bwd_dq_kernel (B10) and
// _bwd_dkv_gqa_kernel (B11), reached through _flash_bwd_pallas and its two
// pallas_calls; and merlin_tpu/ops/onepass_attention.py: _make_dq_kernel and
// _make_dkv_kernel (B13), reached through _onepass_bwd_rule. With
// p = exp(s - lse) (masked p = 0), dp = do v^T and ds = p (dp - di) scale,
// where di = sum(o * do) per row is computed beforehand in plain torch:
//   B10  dq = ds k                       one block per (64 q rows, head)
//   B11  dk = ds^T q, dv = p^T do        one block per (64 keys, kv head);
//        the query heads of a GQA group are summed inside the block
// Both recompute s tile by tile from the saved natural-log LSE with B2's mask
// semantics: top-left causal, qseg == kseg, ALiBi slope * (k - q), the
// ragged edge (rows past sq, keys past skv) masked here, so callers pad
// nothing. A row that saw no key in the forward (LSE = NEG_INF, trap C2) has
// every p masked to 0 and contributes 0, never NaN.
//
// What bounds it on the H100: at the Vicuna-7B training shape (1, 2048, 32,
// 128) causal, the two kernels do 5 matmuls of 2 sq skv d per head, halved
// by the causal mask: ~89 GFLOP against ~84 MB of q/k/v/do/dq/dk/dv/lse/di,
// ~1000 FLOP per byte, far above the ~295 FLOP/byte ridge: the tensor cores
// bound it (~0.09 ms at 989 TFLOP/s). B13 at the tower's (8, 1025, 16, 64):
// ~43 GFLOP, also operations-bound.
//
// Design: two kernels with independent iteration orders, as on the TPU (the
// TPU carries the dq or dk/dv sum across sequential grid steps in VMEM; here
// that sequential dimension is the loop inside the block, and no sum crosses
// blocks, so no atomics and no second pass). The tiles ride the B2 tile
// engine's mma.sync m16n8k16 fragments (attention_core.cuh): a warp owns 16
// rows (queries in B10, keys in B11); the f32 accumulators of a product whose
// result feeds the next matmul (ds, p) are repacked as bf16 A fragments in
// registers, as P@V does in the forward. p and ds are rounded to bf16 for
// their matmuls, as the TPU kernels round them. Key tiles wholly above the
// diagonal (B10) and query tiles wholly before it (B11) are never loaded, as
// the TPU's `live` predicate skips them. Simple first: no cp.async/TMA
// pipelining and no wgmma yet.

#include "attention_core.cuh"

namespace merlin {

constexpr int kBlockQ = 32;  // query rows per step of the dk/dv kernel

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;     // (b, h, sq) natural log
  const float* di;      // (b, h, sq) sum(o * do)
  __nv_bfloat16* dq;    // (b, sq, h, d) contiguous
  __nv_bfloat16* dk;    // (b, skv, hkv, d) contiguous
  __nv_bfloat16* dv;    // (b, skv, hkv, d) contiguous
  const int* qseg;      // (b, sq) or nullptr
  const int* kseg;      // (b, skv) or nullptr
  const float* slopes;  // (h,) or nullptr
  int b, sq, skv, h, hkv, d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // do's strides
  float scale;
};

// The raw dot s of (query qi, key ki) -> its log2-domain score, or kNegInf
// where the key is not visible to the query (B2's DenseProblem::logit, with
// the query's own edge masked too).
template <bool CAUSAL>
__device__ __forceinline__ float bwd_logit(const BwdArgs& a, int bi,
                                           float slope, int qi, int qseg,
                                           int ki, float s) {
  const float x = a.slopes != nullptr
                      ? (s * a.scale + slope * (float)(ki - qi)) * kLog2e
                      : s * (a.scale * kLog2e);
  bool ok = ki < a.skv && qi < a.sq;
  if (CAUSAL) ok = ok && ki <= qi;
  if (a.qseg != nullptr) {
    ok = ok && qseg == a.kseg[(int64_t)bi * a.skv + ki];
  }
  return ok ? x : kNegInf;
}

// B column fragment of rows kr0 + t*2 (+1, +8, +9), column c of a
// [rows][LD] bf16 tile: the second operand of X @ T where T is row-major
// (keys or queries by d), as V is read in the forward's P@V.
template <int LD>
__device__ __forceinline__ void col_frag(const uint16_t* base, uint32_t& b0,
                                         uint32_t& b1) {
  b0 = (uint32_t)base[0] | ((uint32_t)base[LD] << 16);
  b1 = (uint32_t)base[8 * LD] | ((uint32_t)base[9 * LD] << 16);
}

// A fragment of rows r, r + 8 and columns kk + t*2 (+1, +8, +9) of a
// [rows][LD] bf16 tile (the pointer is already at row r, column kk + t*2).
template <int LD>
__device__ __forceinline__ void row_frag(const __nv_bfloat16* p,
                                         uint32_t (&f)[4]) {
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * LD);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * LD + 8);
}

// B10: dq for 64 query rows of one (batch, head); grid (q tiles, h, b).
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + kPad;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ds = Qs + kBlockM * LD;
  __nv_bfloat16* Ks = Ds + kBlockM * LD;
  __nv_bfloat16* Vs = Ks + kBlockN * LD;
  const uint16_t* Kbits = reinterpret_cast<const uint16_t*>(Ks);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bi = blockIdx.z;
  const int hi = blockIdx.y;
  const int hk = hi / (a.h / a.hkv);
  const int q0 = blockIdx.x * kBlockM;
  const float slope = a.slopes != nullptr ? a.slopes[hi] : 0.f;
  const int n_rows = min(kBlockM, a.sq - q0);

  load_rows<DP, kThreads, kBlockM>(
      Qs, [&](int r, int c) {
        return ld128(a.q + bi * a.q_sb + (int64_t)(q0 + r) * a.q_ss +
                     hi * a.q_sh + c);
      }, n_rows, a.d, threadIdx.x);
  load_rows<DP, kThreads, kBlockM>(
      Ds, [&](int r, int c) {
        return ld128(a.dout + bi * a.o_sb + (int64_t)(q0 + r) * a.o_ss +
                     hi * a.o_sh + c);
      }, n_rows, a.d, threadIdx.x);

  const int r_lo = warp * 16 + g;
  int qi[2], qseg[2];
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + r_lo + 8 * r;
    const bool live = qi[r] < a.sq;
    const int64_t at = ((int64_t)bi * a.h + hi) * a.sq + qi[r];
    lse2[r] = live ? a.lse[at] * kLog2e : 0.f;
    di[r] = live ? a.di[at] : 0.f;
    qseg[r] = (a.qseg != nullptr && live) ? a.qseg[(int64_t)bi * a.sq + qi[r]]
                                          : 0;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  const int key_end = CAUSAL ? min(a.skv, q0 + kBlockM) : a.skv;
  const int n_tiles = (key_end + kBlockN - 1) / kBlockN;
  const int dk16 = (a.d + 15) / 16 * 16;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockN;
    const int rows = min(kBlockN, a.skv - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<DP, kThreads, kBlockN>(
        Ks, [&](int r, int c) {
          return ld128(a.k + bi * a.k_sb + (int64_t)(k0 + r) * a.k_ss +
                       hk * a.k_sh + c);
        }, rows, a.d, threadIdx.x);
    load_rows<DP, kThreads, kBlockN>(
        Vs, [&](int r, int c) {
          return ld128(a.v + bi * a.v_sb + (int64_t)(k0 + r) * a.v_ss +
                       hk * a.v_sh + c);
        }, rows, a.d, threadIdx.x);
    __syncthreads();

    // s = q k^T and dp = do v^T for this warp's 16 rows x 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      if (kk < dk16) {
        uint32_t qf[4], df[4];
        row_frag<LD>(Qs + r_lo * LD + kk + t * 2, qf);
        row_frag<LD>(Ds + r_lo * LD + kk + t * 2, df);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kk + t * 2;
          const __nv_bfloat16* vr = Vs + (j * 8 + g) * LD + kk + t * 2;
          mma_16816(s[j], qf, ld32(kr), ld32(kr + 8));
          mma_16816(dp[j], df, ld32(vr), ld32(vr + 8));
        }
      }
    }

    // ds = p (dp - di) scale, p recomputed from the saved LSE
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ki = k0 + j * 8 + t * 2 + (e & 1);
        const float x = bwd_logit<CAUSAL>(a, bi, slope, qi[r], qseg[r], ki,
                                          s[j][e]);
        const float p = x == kNegInf ? 0.f : exp2f(x - lse2[r]);
        s[j][e] = p * (dp[j][e] - di[r]) * a.scale;
      }
    }

    // dq += ds k: ds's accumulators are the A fragments of the k=16 steps
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t sf[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const uint16_t* kb = Kbits + (ks * 16 + t * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        if (dn * 8 < a.d) {
          uint32_t b0, b1;
          col_frag<LD>(kb + dn * 8, b0, b1);
          mma_16816(acc[dn], sf, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.sq) continue;
    __nv_bfloat16* row = a.dq + (((int64_t)bi * a.sq + qi[r]) * a.h + hi) * a.d;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + t * 2;
      if (col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[dn][2 * r], acc[dn][2 * r + 1]);
      }
    }
  }
}

// B11: dk and dv for 64 keys of one (batch, kv head), summed over the query
// heads of its group; grid (key tiles, hkv, b).
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + kPad;
  constexpr int NJ = kBlockQ / 8;  // 8-query n-tiles per q step
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBlockN * LD;
  __nv_bfloat16* Qs = Vs + kBlockN * LD;
  __nv_bfloat16* Ds = Qs + kBlockQ * LD;
  float* lse_s = reinterpret_cast<float*>(Ds + kBlockQ * LD);
  float* di_s = lse_s + kBlockQ;
  int* qseg_s = reinterpret_cast<int*>(di_s + kBlockQ);
  const uint16_t* Qbits = reinterpret_cast<const uint16_t*>(Qs);
  const uint16_t* Dbits = reinterpret_cast<const uint16_t*>(Ds);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bi = blockIdx.z;
  const int hk = blockIdx.y;
  const int group = a.h / a.hkv;
  const int k0 = blockIdx.x * kBlockN;
  const int n_keys = min(kBlockN, a.skv - k0);

  load_rows<DP, kThreads, kBlockN>(
      Ks, [&](int r, int c) {
        return ld128(a.k + bi * a.k_sb + (int64_t)(k0 + r) * a.k_ss +
                     hk * a.k_sh + c);
      }, n_keys, a.d, threadIdx.x);
  load_rows<DP, kThreads, kBlockN>(
      Vs, [&](int r, int c) {
        return ld128(a.v + bi * a.v_sb + (int64_t)(k0 + r) * a.v_ss +
                     hk * a.v_sh + c);
      }, n_keys, a.d, threadIdx.x);

  const int r_lo = warp * 16 + g;
  int ki[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) ki[r] = k0 + r_lo + 8 * r;

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }
  const int dk16 = (a.d + 15) / 16 * 16;
  // queries before the tile's first key see none of its keys
  const int q_begin = CAUSAL ? (k0 / kBlockQ) * kBlockQ : 0;

  for (int gq = 0; gq < group; ++gq) {
    const int hq = hk * group + gq;
    const float slope = a.slopes != nullptr ? a.slopes[hq] : 0.f;
    for (int q0 = q_begin; q0 < a.sq; q0 += kBlockQ) {
      const int nq = min(kBlockQ, a.sq - q0);
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_rows<DP, kThreads, kBlockQ>(
          Qs, [&](int r, int c) {
            return ld128(a.q + bi * a.q_sb + (int64_t)(q0 + r) * a.q_ss +
                         hq * a.q_sh + c);
          }, nq, a.d, threadIdx.x);
      load_rows<DP, kThreads, kBlockQ>(
          Ds, [&](int r, int c) {
            return ld128(a.dout + bi * a.o_sb + (int64_t)(q0 + r) * a.o_ss +
                         hq * a.o_sh + c);
          }, nq, a.d, threadIdx.x);
      for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
        const int qi = q0 + i;
        const bool live = qi < a.sq;
        const int64_t at = ((int64_t)bi * a.h + hq) * a.sq + qi;
        lse_s[i] = live ? a.lse[at] * kLog2e : 0.f;
        di_s[i] = live ? a.di[at] : 0.f;
        qseg_s[i] = (a.qseg != nullptr && live)
                        ? a.qseg[(int64_t)bi * a.sq + qi] : 0;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T: this warp's 16 keys x 32 queries
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        if (kk < dk16) {
          uint32_t kf[4], vf[4];
          row_frag<LD>(Ks + r_lo * LD + kk + t * 2, kf);
          row_frag<LD>(Vs + r_lo * LD + kk + t * 2, vf);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const __nv_bfloat16* qr = Qs + (j * 8 + g) * LD + kk + t * 2;
            const __nv_bfloat16* dr = Ds + (j * 8 + g) * LD + kk + t * 2;
            mma_16816(s[j], kf, ld32(qr), ld32(qr + 8));
            mma_16816(dp[j], vf, ld32(dr), ld32(dr + 8));
          }
        }
      }

      // p^T and ds^T; element (key ki[r], query q0 + j*8 + t*2 + (e&1))
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int ql = j * 8 + t * 2 + (e & 1);
          const float x = bwd_logit<CAUSAL>(a, bi, slope, q0 + ql,
                                            qseg_s[ql], ki[r], s[j][e]);
          const float p = x == kNegInf ? 0.f : exp2f(x - lse_s[ql]);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - di_s[ql]) * a.scale;
        }
      }

      // dv += p^T do and dk += ds^T q over the step's 32 queries
#pragma unroll
      for (int ks = 0; ks < kBlockQ / 16; ++ks) {
        const uint32_t pf[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                                pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                                pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const uint32_t sf[4] = {
            pack_bf16(dp[2 * ks][0], dp[2 * ks][1]),
            pack_bf16(dp[2 * ks][2], dp[2 * ks][3]),
            pack_bf16(dp[2 * ks + 1][0], dp[2 * ks + 1][1]),
            pack_bf16(dp[2 * ks + 1][2], dp[2 * ks + 1][3])};
        const uint16_t* db = Dbits + (ks * 16 + t * 2) * LD + g;
        const uint16_t* qb = Qbits + (ks * 16 + t * 2) * LD + g;
#pragma unroll
        for (int dn = 0; dn < DP / 8; ++dn) {
          if (dn * 8 < a.d) {
            uint32_t b0, b1;
            col_frag<LD>(db + dn * 8, b0, b1);
            mma_16816(dv[dn], pf, b0, b1);
            col_frag<LD>(qb + dn * 8, b0, b1);
            mma_16816(dk[dn], sf, b0, b1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ki[r] >= a.skv) continue;
    const int64_t at = (((int64_t)bi * a.skv + ki[r]) * a.hkv + hk) * a.d;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + t * 2;
      if (col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + at + col) =
            __floats2bfloat162_rn(dk[dn][2 * r], dk[dn][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + at + col) =
            __floats2bfloat162_rn(dv[dn][2 * r], dv[dn][2 * r + 1]);
      }
    }
  }
}

template <int DP>
constexpr int dq_smem_bytes() {
  return (2 * kBlockM + 2 * kBlockN) * (DP + kPad) *
         (int)sizeof(__nv_bfloat16);
}

template <int DP>
constexpr int dkv_smem_bytes() {
  return (2 * kBlockN + 2 * kBlockQ) * (DP + kPad) *
             (int)sizeof(__nv_bfloat16) +
         3 * kBlockQ * 4;
}

template <int DP>
cudaError_t launch_dq(const BwdArgs& a, bool causal, cudaStream_t s) {
  const dim3 grid((a.sq + kBlockM - 1) / kBlockM, a.h, a.b);
  return causal ? launch_grid(flash_bwd_dq_kernel<DP, true>, grid, kThreads,
                              dq_smem_bytes<DP>(), a, s)
                : launch_grid(flash_bwd_dq_kernel<DP, false>, grid, kThreads,
                              dq_smem_bytes<DP>(), a, s);
}

template <int DP>
cudaError_t launch_dkv(const BwdArgs& a, bool causal, cudaStream_t s) {
  const dim3 grid((a.skv + kBlockN - 1) / kBlockN, a.hkv, a.b);
  return causal ? launch_grid(flash_bwd_dkv_kernel<DP, true>, grid, kThreads,
                              dkv_smem_bytes<DP>(), a, s)
                : launch_grid(flash_bwd_dkv_kernel<DP, false>, grid, kThreads,
                              dkv_smem_bytes<DP>(), a, s);
}

BwdArgs bwd_args(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* di,
                 const void* qseg, const void* kseg, const void* slopes,
                 int b, int sq, int skv, int h, int hkv, int d,
                 const int64_t* strides, float scale) {
  BwdArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.slopes = static_cast<const float*>(slopes);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.q_sb = strides[0]; a.q_ss = strides[1]; a.q_sh = strides[2];
  a.k_sb = strides[3]; a.k_ss = strides[4]; a.k_sh = strides[5];
  a.v_sb = strides[6]; a.v_ss = strides[7]; a.v_sh = strides[8];
  a.o_sb = strides[9]; a.o_ss = strides[10]; a.o_sh = strides[11];
  a.scale = scale;
  return a;
}

}  // namespace merlin

// q, k, v, do strided (b, s, h, d) with d contiguous; lse, di (b, h, sq) f32;
// dq written (b, sq, h, d) contiguous. strides: q, k, v, do, each (b, s, h).
extern "C" int merlin_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, const void* qseg,
    const void* kseg, const void* slopes, int b, int sq, int skv, int h,
    int hkv, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale, int causal,
    void* stream) {
  using namespace merlin;
  const int64_t strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  BwdArgs a = bwd_args(q, k, v, dout, lse, di, qseg, kseg, slopes, b, sq, skv,
                       h, hkv, d, strides, scale);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch_dq<64>(a, causal != 0, s);
  if (d <= 128) return (int)launch_dq<128>(a, causal != 0, s);
  return (int)cudaErrorInvalidValue;
}

// As above; dk, dv written (b, skv, hkv, d) contiguous.
extern "C" int merlin_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, const void* qseg,
    const void* kseg, const void* slopes, int b, int sq, int skv, int h,
    int hkv, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale, int causal,
    void* stream) {
  using namespace merlin;
  const int64_t strides[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  BwdArgs a = bwd_args(q, k, v, dout, lse, di, qseg, kseg, slopes, b, sq, skv,
                       h, hkv, d, strides, scale);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch_dkv<64>(a, causal != 0, s);
  if (d <= 128) return (int)launch_dkv<128>(a, causal != 0, s);
  return (int)cudaErrorInvalidValue;
}
