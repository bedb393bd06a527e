// B1, B2 and B12 at float32 - the dense attention forward for f32 models
// (sm_90a; every product 3xTF32 on mma.sync m16n8k8, tf32x3.cuh).
//
// Replaces, for f32 operands, merlin_tpu/ops/flash_attention.py: _fwd_kernel
// (B2, :83, pallas_call :161) and merlin_tpu/ops/onepass_attention.py:
// _make_kernel (emit_lse=False, :54), _make_kernel_bd (:132) (B1) and
// _make_kernel with emit_lse=True (B12), pallas_call :254. The bf16 kernels
// (attention_fwd.cu) stay for bf16 q/k/v.
//
// Contract (the TPU kernels' at f32 operands): q (b, sq, h, d), k/v (b, skv,
// hkv, d), f32, strided with d contiguous; causal (top-left: key k visible to
// query q iff k <= q) or not; packed-sequence segment ids (qseg == kseg);
// ALiBi slope * (k - q); GQA (kv head = h / (h / hkv)); d % 8 == 0, d <= 256.
// Scores and every sum in f32; P stays f32 (V's dtype); out (b, sq, h, d) in
// f32 from the f32 accumulator, and the natural-log LSE (b, h, sq) when asked
// for (B2, B12). Masked scores take the finite NEG_INF and masked p is 0, so
// a row that sees no key writes 0 and LSE = NEG_INF (trap C2). The ragged
// edge is masked here: callers pad nothing.
//
// What bounds it on the H100: the tensor cores' TF32 rate, three passes an
// f32 product (495 / 3 = 165 TFLOP/s). At the decoder's (1, 2048, 32, 128)
// causal it does 34.4 GFLOP (0.21 ms at 165 TFLOP/s) against 67 MB of
// q/k/v/out (0.02 ms); at the tower's (1, 1025, 16, 64) 4.3 GFLOP (0.026
// ms) against 16.8 MB. On the H100 it runs at ~44 TFLOP/s of f32 work,
// 27% of that bound (0.777 ms there unpadded, SDPA's f32 0.900; 0.146 ms
// at the tower's, SDPA 0.211): legacy mma.sync, not wgmma, every fragment
// split as it is loaded (a LOP3 and an FADD an operand), and the mma
// latency of short accumulator chains. Design: one CTA of 4 warps per
// (64 query rows, head, batch), the longest causal walk first; a warp
// owns 16 rows; Q loaded once, K and V by key tiles (64 keys at 64 < d <=
// 128, else 32) through cp.async into one buffer each: K of the next tile
// loads while this tile's softmax and P V run, V of the next while its
// scores run. S and P stay in registers (tf32x3.cuh's layouts); online
// softmax in the log2 domain by ex2.approx. ~101 KB of shared memory at d
// = 128: two CTAs an SM.

#include "tf32x3.cuh"

namespace merlin {
namespace tf32x3 {

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;
  const int* qseg;
  const int* kseg;
  const float* slopes;
  int b, sq, skv, h, hkv, d, causal;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

template <int DMAX>
struct Fwd {
  static constexpr int BK = DMAX == 128 ? 64 : 32;   // keys of a tile
  static constexpr int NJ = BK / 8, NM = DMAX / 16, LD = DMAX + 4;
  static constexpr int kSmem = ((kRows + 2 * BK) * LD + BK) * 4;
};

// at d <= 64 three blocks an SM asked for: ptxas's own pick (128
// registers) spilled
template <int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX == 64 ? 3 : 1)
    attention_f32_kernel(const FwdArgs a) {
  using Cfg = Fwd<DMAX>;
  constexpr int BK = Cfg::BK, NJ = Cfg::NJ, NM = Cfg::NM, LD = Cfg::LD;
  extern __shared__ float4 smem4[];
  const int d = a.d, dp = dpad(d), nm = dp / 16;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * LD;
  float* Vs = Ks + BK * LD;
  int* ksegs = reinterpret_cast<int*>(Vs + BK * LD);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (a.h / a.hkv);
  const float* kb = a.k + bb * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + bb * a.v_sb + hk * a.v_sh;
  const int* kseg = a.kseg ? a.kseg + bb * a.skv : nullptr;
  const int kend = a.causal ? min(a.skv, min(q0 + kRows, a.sq)) : a.skv;
  const int ntiles = (kend + BK - 1) / BK;

  // groups in flight: [Q, K0, kseg0], [V0], then K and V of each next tile
  load_tile<DMAX, kRows>(Qs, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0,
                         a.sq, d, dp, tid);
  load_tile<DMAX, BK>(Ks, kb, a.k_ss, 0, a.skv, d, dp, tid);
  load_vec(ksegs, kseg, 0, BK, a.skv, tid);
  cp_async_commit();
  load_tile<DMAX, BK>(Vs, vb, a.v_ss, 0, a.skv, d, dp, tid);
  cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  const float slope2 = a.slopes ? a.slopes[hh] * kLog2e : 0.f;
  int qpos[2], qseg[2];
  float m[2], l[2], o[NM][2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + 16 * warp + g + 8 * r;
    qseg[r] = (a.qseg && qpos[r] < a.sq) ? a.qseg[bb * a.sq + qpos[r]] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  zero(o);
  const int row_lo = q0 + 16 * warp;

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    cp_async_wait<1>();
    __syncthreads();
    float s[NJ][4];
    dots<NJ, LD>(Qs + 16 * warp * LD, Ks, dp, lane, s);
    // the mask, only where a key or a row of this warp may be cut
    const bool edge = a.qseg || k0 + BK > a.skv || row_lo + 16 > a.sq ||
                      (a.causal && k0 + BK - 1 > row_lo);
    int ks[NJ][2] = {};
    if (a.qseg) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int2 v2 = *reinterpret_cast<const int2*>(ksegs + 8 * jj + 2 * t);
        ks[jj][0] = v2.x;
        ks[jj][1] = v2.y;
      }
    }
    __syncthreads();                  // every warp is done with K and kseg
    if (j + 1 < ntiles) {
      load_tile<DMAX, BK>(Ks, kb, a.k_ss, k0 + BK, a.skv, d, dp, tid);
      load_vec(ksegs, kseg, k0 + BK, BK, a.skv, tid);
    }
    cp_async_commit();
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * jj + 2 * t + e;
          float x = s[jj][2 * r + e] * sl2;
          if (a.slopes) x += slope2 * static_cast<float>(kpos - qpos[r]);
          if (edge) {
            const bool ok = kpos < a.skv && qpos[r] < a.sq &&
                            (!a.causal || kpos <= qpos[r]) &&
                            (!a.qseg || qseg[r] == ks[jj][e]);
            x = ok ? x : kNegInf;
          }
          s[jj][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
      const float mn = fmaxf(m[r], mx);
      alpha[r] = fast_exp2(m[r] - mn);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[jj][2 * r + e];
          const float p = x > 0.5f * kNegInf ? fast_exp2(x - mn) : 0.f;
          s[jj][2 * r + e] = p;
          sum += p;
        }
      l[r] = l[r] * alpha[r] + sum;   // this lane's share; summed at the end
      m[r] = mn;
    }
    float f[2][2];
    to_pv_rows(alpha, lane, f);
#pragma unroll
    for (int mm = 0; mm < NM; ++mm)
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          o[mm][rb][u] *= f[rb][u];
          o[mm][rb][u + 2] *= f[rb][u];
        }
    cp_async_wait<1>();
    __syncthreads();
    pv<NJ, NM, LD>(s, Vs, nm, lane, o);
    __syncthreads();                  // every warp is done with V
    if (j + 1 < ntiles)
      load_tile<DMAX, BK>(Vs, vb, a.v_ss, k0 + BK, a.skv, d, dp, tid);
    cp_async_commit();
  }
  cp_async_wait<0>();
  float lsum[2], lrow[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = quad_sum(l[r]);
    if (a.lse && t == 0 && qpos[r] < a.sq)
      a.lse[(static_cast<int64_t>(bb) * a.h + hh) * a.sq + qpos[r]] =
          lsum[r] > 0.f ? m[r] * kLn2 + logf(lsum[r]) : kNegInf;
  }
  to_pv_rows(lsum, lane, lrow);
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = row_lo + 8 * rb + 2 * t + u;
      if (row < a.sq)
        store_row(a.out + ((static_cast<int64_t>(bb) * a.sq + row) * a.h +
                           hh) * d,
                  o, rb, u, lrow[rb][u] > 0.f ? 1.f / lrow[rb][u] : 0.f, d,
                  lane);
    }
}

template <int DMAX>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  dim3 grid((a.sq + kRows - 1) / kRows, a.h, a.b);
  return launch_grid(attention_f32_kernel<DMAX>, grid, kThreads,
                     Fwd<DMAX>::kSmem, a, stream);
}

}  // namespace tf32x3
}  // namespace merlin

// B2 (lse given), B1 (lse NULL, causal 0, no masks) and B12 at f32. Returns
// cudaGetLastError() after the launch.
extern "C" int merlin_attention_f32(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* qseg, const void* kseg, const void* slopes, int b, int sq,
    int skv, int h, int hkv, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale, int causal, void* stream) {
  using namespace merlin::tf32x3;
  if (d % 8 || d > 256 || h % hkv || b < 1 || sq < 1 || skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.slopes = static_cast<const float*>(slopes);
  a.b = b; a.sq = sq; a.skv = skv; a.h = h; a.hkv = hkv; a.d = d;
  a.causal = causal;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return static_cast<int>(launch<64>(a, s));
  if (d <= 128) return static_cast<int>(launch<128>(a, s));
  return static_cast<int>(launch<256>(a, s));
}
