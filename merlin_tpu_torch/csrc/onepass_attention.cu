// B1 and B12 - bidirectional attention of the ViT tower, for Hopper (sm_90a).
//
// Replaces merlin_tpu/ops/onepass_attention.py: _make_kernel (emit_lse=False)
// and _make_kernel_bd (B1), and _make_kernel with emit_lse=True (B12, the
// forward of the trained path, _onepass_fwd_rule), all reached through
// _onepass_fwd and its pallas_call.
// out = softmax(q k^T * scale) v over the whole KV of each (batch, head);
// scores in f32, scaled by scale*log2(e) and exp2'd; keys past kv_len masked.
// With an lse pointer (B12) the kernel also writes the natural-log LSE,
// m * ln 2 + log l from the exp2 domain, as (b, h, sq) f32: the residual the
// backward (B13, flash_attention_bwd.cu) recomputes p from. The max is
// subtracted on both paths, as the TPU's trained path does
// (assume_bounded=False).
//
// What bounds it on the H100: at the CLIP ViT-L/14-448 shape (s=1025, h=16,
// d=64) one image-layer is 4*16*1025^2*64 = 4.3 GFLOP against 8.4 MB of
// q/k/v/out, about 510 FLOP per byte: above the card's ~295 FLOP/byte ridge,
// so the tensor cores bound it (4.35 us at 989 TFLOP/s dense bf16).
//
// Design: the TPU kernel keeps one head's whole K and V in VMEM and needs no
// running statistics. Here K+V of one head are 262 KB in bf16, more than the
// 227 KB of shared memory a block may use, so the KV is tiled (64 keys per
// tile) with an online max (attention_core.cuh), and both matmuls run on the
// tensor cores (mma.sync m16n8k16). The TPU inference path does not subtract
// the max and clamps the log2 scores at 120 instead (assume_bounded, trap
// C5); subtracting it is exact everywhere, and the two agree wherever natural
// logits stay below ~88, as they do after the tower's LayerNorms.
// Simple first: no cp.async/TMA pipelining and no warp specialisation yet.

#include "attention_core.cuh"

namespace merlin {

template <int DP>
__global__ void __launch_bounds__(kThreads)
    onepass_attention_kernel(const AttnArgs a) {
  attention_tile<DP, kBlockM / 16>(DenseProblem<false>(a), a.d);
}

}  // namespace merlin

extern "C" int merlin_onepass_attention_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int b, int sq,
    int skv, int h, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale, void* stream) {
  using namespace merlin;
  AttnArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.h = h;
  a.hkv = h;
  a.d = d;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) {
    return (int)launch(onepass_attention_kernel<64>, smem_bytes<64>(), a, s);
  }
  if (d <= 128) {
    return (int)launch(onepass_attention_kernel<128>, smem_bytes<128>(), a, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* merlin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
