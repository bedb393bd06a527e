// B2 - flash-attention forward of the decoder, for Hopper (sm_90a).
//
// Replaces merlin_tpu/ops/flash_attention.py: _fwd_kernel, reached through
// _flash_fwd_pallas and its pallas_call. Online-softmax attention, causal or
// bidirectional, with packed-sequence segment ids (qseg == kseg), in-kernel
// ALiBi (slope * (k - q)) and GQA (kv head = h // group). Writes the output
// in the input dtype and the natural-log LSE in f32 as (b, h, sq); the TPU's
// (b, h, 8, sq) sublane broadcast is a layout, not part of the contract.
//
// What bounds it on the H100: at the Vicuna-7B prompt shape (1, 512, 32, 128)
// causal, the work is ~2.15 GFLOP (half the square) against 16.8 MB of
// q/k/v/out: ~128 FLOP per byte, below the card's ~295 FLOP/byte ridge, so
// device memory bounds it (~5.0 us at 3.35 TB/s).
//
// Design: one block per (64 query rows, head, batch); the KV is walked in
// 64-key tiles through shared memory with the online max/sum kept in
// registers (attention_core.cuh), both matmuls on the tensor cores
// (mma.sync m16n8k16). The TPU grid carries (m, l, acc) across sequential
// grid steps in VMEM scratch; on the GPU that sequential dimension is the
// loop inside the block. Tiles wholly above the diagonal are never loaded.
// The ragged sequence edge is masked in the kernel, so callers do not pad
// to block multiples with shifted segment ids. Masked scores take the finite
// NEG_INF and masked p is zeroed, so a row with no visible key writes 0 and
// LSE = NEG_INF instead of NaN (trap C2). Each q/k/v row is read once per
// tile from device memory; reuse across the heads of a GQA group is left to
// the L2 cache. Simple first: no cp.async/TMA pipelining yet.

#include "attention_core.cuh"

namespace merlin {

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const AttnArgs a) {
  attention_tile<DP, kBlockM / 16>(DenseProblem<CAUSAL>(a), a.d);
}

template <int DP>
cudaError_t launch_flash(const AttnArgs& a, bool causal, cudaStream_t s) {
  return causal ? launch(flash_attention_fwd_kernel<DP, true>, smem_bytes<DP>(), a, s)
                : launch(flash_attention_fwd_kernel<DP, false>, smem_bytes<DP>(), a, s);
}

}  // namespace merlin

extern "C" int merlin_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* qseg, const void* kseg, const void* slopes, int b, int sq,
    int skv, int h, int hkv, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale, int causal, void* stream) {
  using namespace merlin;
  AttnArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.slopes = static_cast<const float*>(slopes);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch_flash<64>(a, causal != 0, s);
  if (d <= 128) return (int)launch_flash<128>(a, causal != 0, s);
  if (d <= 256) return (int)launch_flash<256>(a, causal != 0, s);
  return (int)cudaErrorInvalidValue;
}
