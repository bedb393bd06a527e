// B10, B11 and B13 at float32 - the attention backward for f32 models
// (sm_90a; every product 3xTF32 on mma.sync m16n8k8, tf32x3.cuh).
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
// CTA per 64 query rows of a head) computes di = sum(out * do) for its rows
// when given out (flash_attention.py:333, onepass_attention.py:393) and
// writes it, then walks the key tiles for dq; flash_bwd_dkv_f32_kernel (a
// CTA per 64 keys of a kv head, and at d > 128 per 128-column half of dk
// and dv) walks the group's heads and their query tiles for dk and dv,
// reading di. No atomics: dq's sum order is fixed, so two runs agree bit
// for bit (the bf16 kernel's f32 atomics do not, C17).
//
// What bounds it on the H100: the tensor cores' TF32 rate, three passes an
// f32 product (165 TFLOP/s), 7 products a visible (query, key) pair (S and
// dP in both kernels) against the 5 the TPU computes: at (1, 2048, 32,
// 128) causal, 300 padded, 64 GFLOP of the 5, 0.39 ms at 165 TFLOP/s,
// against ~100 MB of operands. It keeps the tensor cores about as busy as
// the forward does, and the 2 recomputed products are its cost: 2.59 ms
// there unpadded on the H100 (SDPA's f32 2.85). Design: a warp owns
// 16 rows (queries in the dq kernel, keys in the dk/dv kernel) and keeps
// its scores, dP, P and dS in registers (tf32x3.cuh's layouts: the dk/dv
// kernel computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are in
// the layout pv takes its left operand in). The walked tiles (K, V for
// dq; Q, dO for dk/dv) load through cp.async into one buffer each, each
// reloaded as soon as its last product is done: V (dO) of the next tile
// loads while this one's S and dq (dk) run, K (Q) while the next dP runs.

#include "tf32x3.cuh"

namespace merlin {
namespace tf32x3 {

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

// p = exp2(s2 - lse log2 e) for the score dot s (q . k) of a visible pair,
// else 0; ds = p (dp - di) scale
__device__ __forceinline__ void p_ds(const BwdArgs& a, bool visible, float s,
                                     float dp, int qp, int kp, float slope2,
                                     float lse2, float di, float& p,
                                     float& ds) {
  float x = s * (a.scale * kLog2e);
  if (a.slopes) x += slope2 * static_cast<float>(kp - qp);
  p = visible ? fast_exp2(x - lse2) : 0.f;
  ds = p * (dp - di) * a.scale;
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int qp, int kp,
                                        int qs, int ks) {
  return qp < a.sq && kp < a.skv && (!a.causal || kp <= qp) &&
         (!a.qseg || qs == ks);
}

template <int DMAX>
struct Dq {
  static constexpr int BK = DMAX > 128 ? 16 : 32;   // keys of a tile
  static constexpr int NJ = BK / 8, NM = DMAX / 16, LD = DMAX + 4;
  static constexpr int kSmem =
      ((2 * kRows + 2 * BK) * LD + 2 * kRows + BK) * 4;
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const BwdArgs a) {
  using Cfg = Dq<DMAX>;
  constexpr int BK = Cfg::BK, NJ = Cfg::NJ, NM = Cfg::NM, LD = Cfg::LD;
  extern __shared__ float4 smem4[];
  const int d = a.d, dp = dpad(d), nm = dp / 16;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kRows * LD;
  float* Ks = dOs + kRows * LD;
  float* Vs = Ks + BK * LD;
  float* lse_s = Vs + BK * LD;
  float* di_s = lse_s + kRows;
  int* ksegs = reinterpret_cast<int*>(di_s + kRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (a.h / a.hkv);
  const int64_t stat = (static_cast<int64_t>(bb) * a.h + hh) * a.sq;
  const float* kb = a.k + bb * a.k_sb + hk * a.k_sh;
  const float* vb = a.v + bb * a.v_sb + hk * a.v_sh;
  const int* kseg = a.kseg ? a.kseg + bb * a.skv : nullptr;
  const int kend = a.causal ? min(a.skv, min(q0 + kRows, a.sq)) : a.skv;
  const int ntiles = (kend + BK - 1) / BK;

  // groups in flight: [Q, dO, V0], [K0, kseg0], then V and K of each next
  // tile
  load_tile<DMAX, kRows>(Qs, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0,
                         a.sq, d, dp, tid);
  load_tile<DMAX, kRows>(dOs, a.dout + bb * a.do_sb + hh * a.do_sh, a.do_ss,
                         q0, a.sq, d, dp, tid);
  load_tile<DMAX, BK>(Vs, vb, a.v_ss, 0, a.skv, d, dp, tid);
  cp_async_commit();
  load_tile<DMAX, BK>(Ks, kb, a.k_ss, 0, a.skv, d, dp, tid);
  load_vec(ksegs, kseg, 0, BK, a.skv, tid);
  cp_async_commit();

  // di for the tile's rows (4 threads a row), or the given di
  for (int r = tid / 4; r < kRows; r += kThreads / 4) {
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
      lse_s[r] = lse * kLog2e;
    }
  }
  const float slope2 = a.slopes ? a.slopes[hh] * kLog2e : 0.f;
  int qpos[2], qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + 16 * warp + g + 8 * r;
    qseg[r] = (a.qseg && qpos[r] < a.sq) ? a.qseg[bb * a.sq + qpos[r]] : 0;
  }
  float dq[NM][2][4];
  zero(dq);

  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * BK;
    cp_async_wait<1>();
    __syncthreads();
    float dpt[NJ][4];
    dots<NJ, LD>(dOs + 16 * warp * LD, Vs, dp, lane, dpt);
    __syncthreads();                  // every warp is done with V
    if (j + 1 < ntiles)
      load_tile<DMAX, BK>(Vs, vb, a.v_ss, k0 + BK, a.skv, d, dp, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[NJ][4];
    dots<NJ, LD>(Qs + 16 * warp * LD, Ks, dp, lane, s);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kp = k0 + 8 * jj + 2 * t + (e & 1);
        const int row = 16 * warp + g + 8 * r;
        const int ks = a.qseg ? ksegs[8 * jj + 2 * t + (e & 1)] : 0;
        float p, ds;
        p_ds(a, visible(a, qpos[r], kp, qseg[r], ks), s[jj][e], dpt[jj][e],
             qpos[r], kp, slope2, lse_s[row], di_s[row], p, ds);
        s[jj][e] = ds;
      }
    pv<NJ, NM, LD>(s, Ks, nm, lane, dq);
    __syncthreads();                  // every warp is done with K and kseg
    if (j + 1 < ntiles) {
      load_tile<DMAX, BK>(Ks, kb, a.k_ss, k0 + BK, a.skv, d, dp, tid);
      load_vec(ksegs, kseg, k0 + BK, BK, a.skv, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = q0 + 16 * warp + 8 * rb + 2 * t + u;
      if (row < a.sq)
        store_row(a.dq + ((static_cast<int64_t>(bb) * a.sq + row) * a.h +
                          hh) * d,
                  dq, rb, u, 1.f, d, lane);
    }
}

template <int DMAX>
struct Dkv {
  static constexpr int BQ = DMAX > 128 ? 16 : 32;   // queries of a tile
  static constexpr int DC = DMAX > 128 ? 128 : DMAX;  // dk/dv columns a CTA
  static constexpr int NJ = BQ / 8, NM = DC / 16, HALVES = DMAX / DC;
  static constexpr int LD = DMAX + 4;
  static constexpr int kSmem = ((2 * kRows + 2 * BQ) * LD + 3 * BQ) * 4;
};

// at d <= 64 two blocks an SM asked for: ptxas's own pick (168
// registers) spilled
template <int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX == 64 ? 2 : 1)
    flash_bwd_dkv_f32_kernel(const BwdArgs a) {
  using Cfg = Dkv<DMAX>;
  constexpr int BQ = Cfg::BQ, NJ = Cfg::NJ, NM = Cfg::NM, LD = Cfg::LD;
  extern __shared__ float4 smem4[];
  const int d = a.d, dp = dpad(d);
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kRows * LD;
  float* Qs = Vs + kRows * LD;
  float* dOs = Qs + BQ * LD;
  float* lse_s = dOs + BQ * LD;
  float* di_s = lse_s + BQ;
  int* qsegs = reinterpret_cast<int*>(di_s + BQ);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = (blockIdx.x / Cfg::HALVES) * kRows;
  const int col0 = (blockIdx.x % Cfg::HALVES) * Cfg::DC;
  const int nm = min(NM, (dp - col0) / 16);
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int group = a.h / a.hkv;
  // causal: only queries >= k0 see a key of this tile
  const int qstart = a.causal ? (k0 / BQ) * BQ : 0;
  const int nq = (a.sq - qstart + BQ - 1) / BQ;   // query tiles a head
  const int nsteps = group * max(nq, 0);
  const int* qseg = a.qseg ? a.qseg + bb * a.sq : nullptr;

  // step i: head hk * group + i / nq, queries qstart + (i % nq) BQ
  auto head_of = [&](int i) { return hk * group + i / nq; };
  auto q0_of = [&](int i) { return qstart + (i % nq) * BQ; };
  auto stat_of = [&](int hh) {
    return (static_cast<int64_t>(bb) * a.h + hh) * a.sq;
  };
  auto load_do = [&](int i) {
    const int hh = head_of(i), q0 = q0_of(i);
    load_tile<DMAX, BQ>(dOs, a.dout + bb * a.do_sb + hh * a.do_sh, a.do_ss,
                        q0, a.sq, d, dp, tid);
    load_vec(di_s, a.di + stat_of(hh), q0, BQ, a.sq, tid);
  };
  auto load_q = [&](int i) {
    const int hh = head_of(i), q0 = q0_of(i);
    load_tile<DMAX, BQ>(Qs, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0,
                        a.sq, d, dp, tid);
    load_vec(lse_s, a.lse + stat_of(hh), q0, BQ, a.sq, tid);
    load_vec(qsegs, qseg, q0, BQ, a.sq, tid);
  };

  // groups in flight: [K, V, dO 0, di 0], [Q 0, lse 0, qseg 0], then dO
  // and Q of each next step
  load_tile<DMAX, kRows>(Ks, a.k + bb * a.k_sb + hk * a.k_sh, a.k_ss, k0,
                         a.skv, d, dp, tid);
  load_tile<DMAX, kRows>(Vs, a.v + bb * a.v_sb + hk * a.v_sh, a.v_ss, k0,
                         a.skv, d, dp, tid);
  if (nsteps > 0) load_do(0);
  cp_async_commit();
  if (nsteps > 0) load_q(0);
  cp_async_commit();

  int kpos[2], kseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = k0 + 16 * warp + g + 8 * r;
    kseg[r] = (a.kseg && kpos[r] < a.skv) ? a.kseg[bb * a.skv + kpos[r]] : 0;
  }
  float dk[NM][2][4], dv[NM][2][4];
  zero(dk);
  zero(dv);

  for (int i = 0; i < nsteps; ++i) {
    const int hh = head_of(i), q0 = q0_of(i);
    const float slope2 = a.slopes ? a.slopes[hh] * kLog2e : 0.f;
    cp_async_wait<1>();
    __syncthreads();
    float dpt[NJ][4];                 // dP^T: (keys, queries)
    dots<NJ, LD>(Vs + 16 * warp * LD, dOs, dp, lane, dpt);
    cp_async_wait<0>();
    __syncthreads();
    float st[NJ][4];                  // S^T, then P^T
    dots<NJ, LD>(Ks + 16 * warp * LD, Qs, dp, lane, st);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, c = 8 * jj + 2 * t + (e & 1), qp = q0 + c;
        const int qs = qseg ? qsegs[c] : 0;
        float p, ds;
        p_ds(a, visible(a, qp, kpos[r], qs, kseg[r]), st[jj][e],
             dpt[jj][e], qp, kpos[r], slope2, lse_s[c] * kLog2e, di_s[c], p,
             ds);
        st[jj][e] = p;
        dpt[jj][e] = ds;
      }
    pv<NJ, NM, LD>(st, dOs + col0, nm, lane, dv);
    __syncthreads();                  // every warp is done with dO and di
    if (i + 1 < nsteps) load_do(i + 1);
    cp_async_commit();
    pv<NJ, NM, LD>(dpt, Qs + col0, nm, lane, dk);
    __syncthreads();                  // every warp is done with Q, lse, qseg
    if (i + 1 < nsteps) load_q(i + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int kp = k0 + 16 * warp + 8 * rb + 2 * t + u;
      if (kp >= a.skv) continue;
      const int64_t at =
          ((static_cast<int64_t>(bb) * a.skv + kp) * a.hkv + hk) * d + col0;
      store_row(a.dk + at, dk, rb, u, 1.f, d - col0, lane);
      store_row(a.dv + at, dv, rb, u, 1.f, d - col0, lane);
    }
}

template <int DMAX>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  dim3 grid_dq((a.sq + kRows - 1) / kRows, a.h, a.b);
  cudaError_t err = launch_grid(flash_bwd_dq_f32_kernel<DMAX>, grid_dq,
                                kThreads, Dq<DMAX>::kSmem, a, stream);
  if (err != cudaSuccess) return err;
  dim3 grid_dkv((a.skv + kRows - 1) / kRows * Dkv<DMAX>::HALVES, a.hkv, a.b);
  return launch_grid(flash_bwd_dkv_f32_kernel<DMAX>, grid_dkv, kThreads,
                     Dkv<DMAX>::kSmem, a, stream);
}

}  // namespace tf32x3
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
  using namespace merlin::tf32x3;
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
  if (d <= 64) return static_cast<int>(launch<64>(a, s));
  if (d <= 128) return static_cast<int>(launch<128>(a, s));
  return static_cast<int>(launch<256>(a, s));
}
