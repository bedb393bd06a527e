// B10, B11 and B13 at float32 - the attention backward for f32 models
// (sm_90a, FFMA; the tile engine of attention_f32.cuh).
//
// Replaces, for f32 operands, merlin_tpu/ops/flash_attention.py:
// _bwd_dq_kernel (B10, :209, pallas_call :365) and _bwd_dkv_gqa_kernel (B11,
// :256, pallas_call :398), and merlin_tpu/ops/onepass_attention.py:
// _make_dq_kernel (:312, pallas_call :407) and _make_dkv_kernel (:346,
// pallas_call :432) (B13, run non-causal and unmasked). The bf16 kernel
// (flash_attention_bwd.cu) stays for bf16 operands.
//
// Contract: q/do (b, sq, h, d), k/v (b, skv, hkv, d), out (b, sq, h, d) or
// di (b, h, sq) given, lse (b, h, sq) natural log, all f32 and strided with
// d contiguous; the forward's masks (causal top-left, segment ids, ALiBi,
// GQA); d % 8 == 0, d <= 256. p = exp(s - lse) recomputed with the mask
// (masked p = 0, so a row that saw no key contributes 0: trap C2), ds =
// p (do v^T - di) scale; dq = ds k, dk = ds^T q, dv = p^T do, every product
// and sum in f32 (at f32 operands the TPU kernels round nothing), each kv
// head's dk/dv summed over its query group in f32. Outputs dq (b, sq, h, d),
// dk/dv (b, skv, hkv, d), contiguous f32.
//
// Two kernels, launched in order on one stream: flash_bwd_dq_f32_kernel (a
// CTA per query tile of a head) computes di = sum(out * do) for its rows
// when given out (flash_attention.py:333, onepass_attention.py:393) and
// writes it, then walks the key tiles for dq; flash_bwd_dkv_f32_kernel (a
// CTA per key tile of a kv head) walks the group's heads and their query
// tiles for dk and dv, reading di. No atomics: dq's sum order is fixed, so
// two runs agree bit for bit (the bf16 kernel's f32 atomics do not, C17).
//
// What bounds it on the H100: the FFMA rate, 7 products a visible (query,
// key) pair (S and dP twice) against the 5 the TPU computes: at (1, 2048,
// 32, 128) causal ~84 GFLOP, 1.25 ms at 67 TFLOP/s, against ~100 MB of
// operands. Simple first: no overlap of copies with products.

#include "attention_f32.cuh"

namespace merlin {
namespace f32 {

struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* out;   // NULL when di is given
  const float* dout;
  const float* lse;
  float* di;
  float* dq;
  float* dk;
  float* dv;
  const int* qseg;
  const int* kseg;
  const float* slopes;
  int b, sq, skv, h, hkv, d, causal;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh, o_sb, o_ss, o_sh;
  float scale;
};

// Whether query qp sees key kp (both in range), and p / ds from the score
// dot (q . k) and dp (do . v): p = exp2(s2 - lse log2 e) on the mask.
__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp,
                                        int qs, int ks) {
  return qp < a.sq && kp < a.skv && (!a.causal || kp <= qp) &&
         (!a.qseg || qs == ks);
}

__device__ __forceinline__ float prob(const BwdArgs& a, float dot, int qp,
                                      int kp, float slope2, float lse) {
  float x = dot * (a.scale * kLog2e);
  if (a.slopes) x += slope2 * static_cast<float>(kp - qp);
  return exp2f(x - lse * kLog2e);
}

template <int RI, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const BwdArgs a) {
  constexpr int BQ = 16 * RI, DJ = DMAX / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  const int d = a.d, ld = ld_of(d);
  float* dOs = Qs + BQ * ld;
  float* Ks = dOs + BQ * ld;
  float* Vs = Ks + kKeys * ld;
  float* dSs = Vs + kKeys * ld;
  float* lse_s = dSs + BQ * kLdP;
  float* di_s = lse_s + BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (a.h / a.hkv);
  const int64_t stat = (static_cast<int64_t>(bb) * a.h + hh) * a.sq;

  // di for the tile's rows (4 threads a row), or the given di
  for (int r = tid / 4; r < BQ; r += kThreads / 4) {
    const int qp = q0 + r;
    float acc = 0.f;
    if (a.out && qp < a.sq) {
      const float* op = a.out + bb * a.o_sb + qp * a.o_ss + hh * a.o_sh;
      const float* gp = a.dout + bb * a.do_sb + qp * a.do_ss + hh * a.do_sh;
      for (int c = (tid % 4) * 4; c < d; c += 16) {
        const float4 x = *reinterpret_cast<const float4*>(op + c);
        const float4 y = *reinterpret_cast<const float4*>(gp + c);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (tid % 4 == 0) {
      float di = 0.f, lse = 0.f;
      if (qp < a.sq) {
        if (a.out) {
          di = acc;
          a.di[stat + qp] = acc;
        } else {
          di = a.di[stat + qp];
        }
        lse = a.lse[stat + qp];
      }
      di_s[r] = di;
      lse_s[r] = lse;
    }
  }
  load_rows(Qs, ld, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0, BQ, a.sq, d,
            tid);
  load_rows(dOs, ld, a.dout + bb * a.do_sb + hh * a.do_sh, a.do_ss, q0, BQ,
            a.sq, d, tid);
  const float* kb = a.k + bb * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + bb * a.v_sb + hk * a.v_sh;
  const float slope2 = a.slopes ? a.slopes[hh] * kLog2e : 0.f;
  int qseg[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    qseg[i] = (a.qseg && qp < a.sq) ? a.qseg[bb * a.sq + qp] : 0;
  }
  float dq[RI][DJ][4];
  zero(dq);
  const int kend = a.causal ? min(a.skv, min(q0 + BQ, a.sq)) : a.skv;
  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    __syncthreads();
    load_rows(Ks, ld, kb, a.k_ss, k0, kKeys, a.skv, d, tid);
    load_rows(Vs, ld, vb, a.v_ss, k0, kKeys, a.skv, d, tid);
    __syncthreads();
    float s[RI][kCJ], dp[RI][kCJ];
    tile_dots<RI, kCJ>(Qs, Ks, ld, d, ty, tx, s);
    tile_dots<RI, kCJ>(dOs, Vs, ld, d, ty, tx, dp);
#pragma unroll
    for (int j = 0; j < kCJ; ++j) {
      const int kp = k0 + tx + 16 * j;
      const int ks = (a.kseg && kp < a.skv) ? a.kseg[bb * a.skv + kp] : 0;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i, qp = q0 + r;
        float ds = 0.f;
        if (visible(a, qp, kp, qseg[i], ks)) {
          const float p = prob(a, s[i][j], qp, kp, slope2, lse_s[r]);
          ds = p * (dp[i][j] - di_s[r]) * a.scale;
        }
        dSs[r * kLdP + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_pv<RI, DJ>(dSs, kLdP, Ks, ld, kKeys, d, ty, tx, dq);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp < a.sq)
      store_row(a.dq + ((static_cast<int64_t>(bb) * a.sq + qp) * a.h + hh) * d,
                dq, i, 1.f, d, tx);
  }
}

constexpr int kQRows = 64;   // queries of the dk/dv kernel's score tile

template <int RI, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32_kernel(const BwdArgs a) {
  constexpr int BK = 16 * RI, DJ = DMAX / 64, CJ = kQRows / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  const int d = a.d, ld = ld_of(d);
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* dOs = Qs + kQRows * ld;
  float* Pt = dOs + kQRows * ld;       // p^T: (keys, queries)
  float* dSt = Pt + BK * kLdP;         // ds^T
  float* lse_s = dSt + BK * kLdP;
  float* di_s = lse_s + kQRows;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, bb = blockIdx.z;
  const int group = a.h / a.hkv;
  load_rows(Ks, ld, a.k + bb * a.k_sb + hk * a.k_sh, a.k_ss, k0, BK, a.skv,
            d, tid);
  load_rows(Vs, ld, a.v + bb * a.v_sb + hk * a.v_sh, a.v_ss, k0, BK, a.skv,
            d, tid);
  int kseg[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty + 16 * i;
    kseg[i] = (a.kseg && kp < a.skv) ? a.kseg[bb * a.skv + kp] : 0;
  }
  float dk[RI][DJ][4], dv[RI][DJ][4];
  zero(dk);
  zero(dv);
  // causal: only queries >= k0 see a key of this tile
  const int qstart = a.causal ? (k0 / kQRows) * kQRows : 0;
  for (int g = 0; g < group; ++g) {
    const int hh = hk * group + g;
    const int64_t stat = (static_cast<int64_t>(bb) * a.h + hh) * a.sq;
    const float slope2 = a.slopes ? a.slopes[hh] * kLog2e : 0.f;
    for (int q0 = qstart; q0 < a.sq; q0 += kQRows) {
      __syncthreads();
      load_rows(Qs, ld, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0, kQRows,
                a.sq, d, tid);
      load_rows(dOs, ld, a.dout + bb * a.do_sb + hh * a.do_sh, a.do_ss, q0,
                kQRows, a.sq, d, tid);
      if (tid < kQRows) {
        const bool in = q0 + tid < a.sq;
        lse_s[tid] = in ? a.lse[stat + q0 + tid] : 0.f;
        di_s[tid] = in ? a.di[stat + q0 + tid] : 0.f;
      }
      __syncthreads();
      float st[RI][CJ], dpt[RI][CJ];
      tile_dots<RI, CJ>(Ks, Qs, ld, d, ty, tx, st);
      tile_dots<RI, CJ>(Vs, dOs, ld, d, ty, tx, dpt);
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j, qp = q0 + c;
        const int qs = (a.qseg && qp < a.sq) ? a.qseg[bb * a.sq + qp] : 0;
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int r = ty + 16 * i, kp = k0 + r;
          float p = 0.f, ds = 0.f;
          if (visible(a, qp, kp, qs, kseg[i])) {
            p = prob(a, st[i][j], qp, kp, slope2, lse_s[c]);
            ds = p * (dpt[i][j] - di_s[c]) * a.scale;
          }
          Pt[r * kLdP + c] = p;
          dSt[r * kLdP + c] = ds;
        }
      }
      __syncthreads();
      tile_pv<RI, DJ>(Pt, kLdP, dOs, ld, kQRows, d, ty, tx, dv);
      tile_pv<RI, DJ>(dSt, kLdP, Qs, ld, kQRows, d, ty, tx, dk);
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= a.skv) continue;
    const int64_t at = ((static_cast<int64_t>(bb) * a.skv + kp) * a.hkv + hk) * d;
    store_row(a.dk + at, dk, i, 1.f, d, tx);
    store_row(a.dv + at, dv, i, 1.f, d, tx);
  }
}

template <int RI, int DMAX>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr int B = 16 * RI;
  const int ld = ld_of(a.d);
  // dq: Q, dO (B rows), K, V (64 keys), dS, lse, di
  const int smem_dq = ((2 * B + 2 * kKeys) * ld + B * kLdP + 2 * B) * 4;
  dim3 grid_dq((a.sq + B - 1) / B, a.h, a.b);
  cudaError_t err = launch_grid(flash_bwd_dq_f32_kernel<RI, DMAX>, grid_dq,
                                kThreads, smem_dq, a, stream);
  if (err != cudaSuccess) return err;
  // dk/dv: K, V (B keys), Q, dO (64 queries), p^T, ds^T, lse, di
  const int smem_dkv =
      ((2 * B + 2 * kQRows) * ld + 2 * B * kLdP + 2 * kQRows) * 4;
  dim3 grid_dkv((a.skv + B - 1) / B, a.hkv, a.b);
  return launch_grid(flash_bwd_dkv_f32_kernel<RI, DMAX>, grid_dkv, kThreads,
                     smem_dkv, a, stream);
}

}  // namespace f32
}  // namespace merlin

// B10 + B11 (and B13: causal 0, no masks) at f32: dq, dk, dv from the
// forward's out (di computed and written to `di`) or from di (out NULL).
// Returns cudaGetLastError() after the second launch.
extern "C" int merlin_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* di, void* dq, void* dk,
    void* dv, const void* qseg, const void* kseg, const void* slopes, int b,
    int sq, int skv, int h, int hkv, int d, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss, int64_t do_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, float scale, int causal,
    void* stream) {
  using namespace merlin::f32;
  if (d % 8 || d > 256 || h % hkv || b < 1 || sq < 1 || skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<float*>(di);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.slopes = static_cast<const float*>(slopes);
  a.b = b; a.sq = sq; a.skv = skv; a.h = h; a.hkv = hkv; a.d = d;
  a.causal = causal;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return static_cast<int>(launch<4, 64>(a, s));
  if (d <= 128) return static_cast<int>(launch<4, 128>(a, s));
  return static_cast<int>(launch<2, 256>(a, s));
}
