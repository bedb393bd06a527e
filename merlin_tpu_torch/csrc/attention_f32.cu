// B1, B2 and B12 at float32 - the dense attention forward for f32 models
// (sm_90a, FFMA; the tile engine of attention_f32.cuh).
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
// What bounds it on the H100: the FFMA rate. At the decoder's (1, 2048, 32,
// 128) causal it does 34.4 GFLOP (0.51 ms at 67 TFLOP/s) against 67 MB of
// q/k/v/out (0.02 ms); at the tower's (1, 1025, 16, 64) 4.3 GFLOP (0.064 ms)
// against 16.8 MB. Each thread's 4 x 4 score tile reads its operands as
// float4 from shared memory (conflict-free by the d + 4 stride), two FFMA per
// shared load: the loads, not the FMA pipes, set the pace. Design: one CTA
// per (64 query rows, head, batch), the longest causal walk first; Q loaded
// once, K and V by 64-key tiles, online softmax in the log2 domain; no
// overlap of copies with products (a later perf_opt PR's work).

#include "attention_f32.cuh"

namespace merlin {
namespace f32 {

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

constexpr int kRows = 64;   // query rows of a CTA (RI = 4)

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    attention_f32_kernel(const FwdArgs a) {
  constexpr int RI = kRows / 16, DJ = DMAX / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  const int d = a.d, ld = ld_of(d);
  float* Ks = Qs + kRows * ld;
  float* Vs = Ks + kKeys * ld;
  float* Ps = Vs + kKeys * ld;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (a.h / a.hkv);
  load_rows(Qs, ld, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0, kRows,
            a.sq, d, tid);
  const float* kb = a.k + bb * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + bb * a.v_sb + hk * a.v_sh;
  const float sl2 = a.scale * kLog2e;
  const float slope2 = a.slopes ? a.slopes[hh] * kLog2e : 0.f;

  int qpos[RI], qseg[RI];
  float m[RI], l[RI], o[RI][DJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    qpos[i] = q0 + ty + 16 * i;
    qseg[i] = (a.qseg && qpos[i] < a.sq) ? a.qseg[bb * a.sq + qpos[i]] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero(o);
  const int kend = a.causal ? min(a.skv, min(q0 + kRows, a.sq)) : a.skv;
  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    __syncthreads();
    load_rows(Ks, ld, kb, a.k_ss, k0, kKeys, a.skv, d, tid);
    load_rows(Vs, ld, vb, a.v_ss, k0, kKeys, a.skv, d, tid);
    __syncthreads();
    float s[RI][kCJ];
    tile_dots<RI, kCJ>(Qs, Ks, ld, d, ty, tx, s);
    int kseg[kCJ];
#pragma unroll
    for (int j = 0; j < kCJ; ++j) {
      const int kpos = k0 + tx + 16 * j;
      kseg[j] = (a.kseg && kpos < a.skv) ? a.kseg[bb * a.skv + kpos] : 0;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      bool ok[kCJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < a.skv && qpos[i] < a.sq &&
                (!a.causal || kpos <= qpos[i]) &&
                (!a.qseg || qseg[i] == kseg[j]);
        float x = s[i][j] * sl2;
        if (a.slopes) x += slope2 * static_cast<float>(kpos - qpos[i]);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float p = ok[j] ? exp2f(s[i][j] - mn) : 0.f;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][j][e] *= alpha;
    }
    __syncthreads();
    tile_pv<RI, DJ>(Ps, kLdP, Vs, ld, kKeys, d, ty, tx, o);
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    if (qpos[i] >= a.sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    store_row(a.out + ((static_cast<int64_t>(bb) * a.sq + qpos[i]) * a.h + hh) *
                          d,
              o, i, inv, d, tx);
    if (a.lse && tx == 0)
      a.lse[(static_cast<int64_t>(bb) * a.h + hh) * a.sq + qpos[i]] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : kNegInf;
  }
}

template <int DMAX>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  const int ld = ld_of(a.d);
  const int smem = ((kRows + 2 * kKeys) * ld + kRows * kLdP) * 4;
  dim3 grid((a.sq + kRows - 1) / kRows, a.h, a.b);
  return launch_grid(attention_f32_kernel<DMAX>, grid, kThreads, smem, a,
                     stream);
}

}  // namespace f32
}  // namespace merlin

// B2 (lse given), B1 (lse NULL, causal 0, no masks) and B12 at f32. Returns
// cudaGetLastError() after the launch.
extern "C" int merlin_attention_f32(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* qseg, const void* kseg, const void* slopes, int b, int sq,
    int skv, int h, int hkv, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale, int causal, void* stream) {
  using namespace merlin::f32;
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
