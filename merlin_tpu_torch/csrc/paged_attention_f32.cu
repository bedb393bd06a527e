// B3-B9 for f32 models and f32 pages - paged attention whenever q or the
// pages are not both bf16 (sm_90a, FFMA; the tile engine of
// attention_f32.cuh). The bf16 kernels (paged_attention.cu) stay for bf16 q
// over bf16 or int8 pages.
//
// Replaces, at these operand dtypes, merlin_tpu/ops/paged_attention.py:
// _paged_dma_kernel (B3, pallas_call :365), _paged_kernel (B4, :143),
// _paged_dma_multi_kernel (B5, :631), _paged_multi_blocked_kernel (B6,
// :772), _paged_dma_multi_q8_kernel (B7, :1172, s_q = 1 and windows),
// _paged_multi_blocked_q8_kernel (B8, :916) and _paged_q8_kernel (B9,
// :1353). One kernel covers decode (s_q = 1) and windows: s_q queries per
// sequence, lengths INCLUDE the window, query row t at length - s_q + t
// sees the keys at positions <= its own; optional ALiBi slope * (k - q_pos);
// any query group (query head hk * group + g reads kv head hk); ragged
// lengths over permuted page tables. q / out (b, s_q, h, d) contiguous, bf16
// or f32; pages (P, page_size, hkv * d) bf16, f32 or int8 with f32 scale
// pages (P, page_size, S), head hk's scale at lane hk * max(S / hkv, 1)
// (trap C11); d % 8 == 0, d <= 128. No table entry, length or page past a
// sequence's own keys is read (trap C8), and a row that sees no key writes
// 0 (trap C2).
//
// Numerics: what the TPU kernel computes at these operand dtypes.
//   * float pages (B3-B6): q . k at the promoted dtype (a bf16 operand
//     widened to f32, exactly), f32 sums; p rounded to the page dtype before
//     P V (bf16 pages: to bf16; f32 pages: not), l summed from the f32 p;
//     out in q's dtype from the f32 accumulator (trap C48: JAX's reference,
//     the CPU route, keeps p in f32).
//   * int8 pages, q's-dtype mode (B8, B9): K and V dequantized to q's dtype
//     (int8 * scale in f32, then rounded), p rounded to q's dtype.
//   * int8 pages, bf16 mode (B7, trap C49): bf16 operands whatever q's
//     dtype: q rounded to bf16, s = (q . k_int8) * k_scale * scale, and
//     p * v_scale rounded to bf16 for the product with the int8 V.
// Keys go through the online softmax in 64-key tiles from key 0, the
// block on which p is rounded (the plain versions take the same block).
//
// What bounds it on the H100: the K/V bytes at decode (4 FLOP per key per
// head dim per row against 8 bytes of f32 K + V), the FFMA rate for 128-row
// prefill windows. At Vicuna-7B decode over f32 pages, 4 slots of ~1k tokens
// read ~134 MB (40 us at 3.35 TB/s). Design: one CTA per (16 or 64 rows of a
// kv head, kv head, sequence), walking its sequence's keys in 64-key tiles
// (each row of a tile addressed through the table), converted to f32 into
// shared memory; no key split over CTAs (the bf16 kernels' split is a later
// perf_opt PR's work here).

#include "attention_f32.cuh"

namespace merlin {
namespace f32 {

struct PagedArgs {
  const void* q;
  const void* k_pages;
  const float* k_scales;
  const void* v_pages;
  const float* v_scales;
  const int* lengths;
  const int* tables;
  const float* slopes;
  void* out;
  int b, s_q, h, hkv, d, page_size, pps, scale_lanes;
  int q_bf16;     // q and out are bf16 (else f32)
  int page_kind;  // 0 bf16, 1 f32, 2 int8
  int bf16_ops;   // int8 pages: B7's bf16 operands (else q's dtype)
  float scale;
};

enum { kPagesBf16 = 0, kPagesF32 = 1, kPagesInt8 = 2 };

// Keys [k0, k0 + kKeys) of kv head hk of sequence bb into T (f32, stride
// ld), keys at or past kend zero; for int8 pages in bf16 mode the raw
// integers, their scales into sc[key], else dequantized and rounded to q's
// dtype.
__device__ __forceinline__ void load_keys(float* T, float* sc, int ld,
                                          const PagedArgs& a,
                                          const void* pages,
                                          const float* scales, int bb, int hk,
                                          int k0, int kend, int tid) {
  const int d = a.d, per_row = d / 8;
  const int64_t packed = static_cast<int64_t>(a.hkv) * d;
  const int lane = hk * max(a.scale_lanes / a.hkv, 1);
  for (int idx = tid; idx < kKeys * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx - r * per_row) * 8;
    const int key = k0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float scl = 0.f;
    if (key < kend) {
      const int page = a.tables[static_cast<int64_t>(bb) * a.pps +
                                key / a.page_size];
      const int64_t slot =
          static_cast<int64_t>(page) * a.page_size + key % a.page_size;
      const int64_t at = slot * packed + static_cast<int64_t>(hk) * d + c;
      if (a.page_kind == kPagesBf16) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(pages) + at);
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = __bfloat162float(e[u]);
      } else if (a.page_kind == kPagesF32) {
        const float4* src =
            reinterpret_cast<const float4*>(static_cast<const float*>(pages) +
                                            at);
        const float4 lo = src[0], hi = src[1];
        x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
        x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            static_cast<const int8_t*>(pages) + at);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        scl = scales[slot * a.scale_lanes + lane];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          x[u] = static_cast<float>(e[u]);
          if (!a.bf16_ops) {
            x[u] *= scl;
            if (a.q_bf16) x[u] = round_bf16(x[u]);
          }
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(T + r * ld + c);
    dst[0] = make_float4(x[0], x[1], x[2], x[3]);
    dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    if (c == 0) sc[r] = scl;
  }
}

template <int RI, int DMAX>
__global__ void __launch_bounds__(kThreads)
    paged_attention_f32_kernel(const PagedArgs a) {
  constexpr int BQ = 16 * RI, DJ = DMAX / 64;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  const int d = a.d, ld = ld_of(d);
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + kKeys * ld;
  float* Ps = Vs + kKeys * ld;
  float* ksc = Ps + BQ * kLdP;
  float* vsc = ksc + kKeys;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int group = a.h / a.hkv, rows = group * a.s_q;
  const int r0 = blockIdx.x * BQ;
  const int len = a.lengths[bb];
  const bool b7 = a.page_kind == kPagesInt8 && a.bf16_ops;

  // query rows r = g * s_q + t of kv head hk: query head hk * group + g at
  // window slot t
  for (int idx = tid; idx < BQ * (d / 4); idx += kThreads) {
    const int r = idx / (d / 4), c = (idx - r * (d / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < rows) {
      const int g = (r0 + r) / a.s_q, t = (r0 + r) % a.s_q;
      const int64_t at =
          ((static_cast<int64_t>(bb) * a.s_q + t) * a.h + hk * group + g) *
              d + c;
      if (a.q_bf16) {
        const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + at;
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = __bfloat162float(qp[u]);
      } else {
        const float4 v =
            *reinterpret_cast<const float4*>(static_cast<const float*>(a.q) +
                                             at);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
        if (b7)
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = round_bf16(x[u]);
      }
    }
    *reinterpret_cast<float4*>(Qs + r * ld + c) =
        make_float4(x[0], x[1], x[2], x[3]);
  }

  int qpos[RI], qh[RI];
  float slope[RI], m[RI], l[RI], o[RI][DJ][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + ty + 16 * i;
    const bool live = r < rows;
    qpos[i] = live ? len - a.s_q + r % a.s_q : -1;
    qh[i] = hk * group + (live ? r / a.s_q : 0);
    slope[i] = a.slopes ? a.slopes[qh[i]] : 0.f;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero(o);
  for (int k0 = 0; k0 < len; k0 += kKeys) {
    __syncthreads();
    load_keys(Ks, ksc, ld, a, a.k_pages, a.k_scales, bb, hk, k0, len, tid);
    load_keys(Vs, vsc, ld, a, a.v_pages, a.v_scales, bb, hk, k0, len, tid);
    __syncthreads();
    float s[RI][kCJ];
    tile_dots<RI, kCJ>(Qs, Ks, ld, d, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      bool ok[kCJ];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos <= qpos[i];
        float x = b7 ? s[i][j] * ksc[tx + 16 * j] * a.scale
                     : s[i][j] * a.scale;
        if (a.slopes) x += slope[i] * static_cast<float>(kpos - qpos[i]);
        s[i][j] = ok[j] ? x * kLog2e : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float p = ok[j] ? exp2f(s[i][j] - mn) : 0.f;
        sum += p;
        // p as the TPU kernel multiplies it with V
        float pv = p;
        if (b7)
          pv = round_bf16(p * vsc[tx + 16 * j]);
        else if (a.page_kind == kPagesBf16 ||
                 (a.page_kind == kPagesInt8 && a.q_bf16))
          pv = round_bf16(p);
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = pv;
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
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    const int64_t at =
        ((static_cast<int64_t>(bb) * a.s_q + r % a.s_q) * a.h + qh[i]) * d;
    if (a.q_bf16) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + at;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = 64 * j + 4 * tx;
        if (c < d) {
          uint2 w;
          w.x = pack_bf16(o[i][j][0] * inv, o[i][j][1] * inv);
          w.y = pack_bf16(o[i][j][2] * inv, o[i][j][3] * inv);
          *reinterpret_cast<uint2*>(dst + c) = w;
        }
      }
    } else {
      store_row(static_cast<float*>(a.out) + at, o, i, inv, d, tx);
    }
  }
}

template <int RI, int DMAX>
cudaError_t launch(const PagedArgs& a, cudaStream_t stream) {
  constexpr int BQ = 16 * RI;
  const int ld = ld_of(a.d);
  const int smem = ((BQ + 2 * kKeys) * ld + BQ * kLdP + 2 * kKeys) * 4;
  const int rows = a.h / a.hkv * a.s_q;
  dim3 grid((rows + BQ - 1) / BQ, a.hkv, a.b);
  return launch_grid(paged_attention_f32_kernel<RI, DMAX>, grid, kThreads,
                     smem, a, stream);
}

}  // namespace f32
}  // namespace merlin

// Paged attention at every (q, pages) pair but (bf16, bf16|int8): q_bf16
// says q / out are bf16, page_kind 0/1/2 bf16/f32/int8 pages (int8 with
// their scale pages), bf16_ops B7's rule over int8 pages. Returns
// cudaGetLastError() after the launch.
extern "C" int merlin_paged_attention_f32(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* tables, const void* slopes, void* out, int b, int s_q, int h,
    int hkv, int d, int page_size, int pps, int scale_lanes, int q_bf16,
    int page_kind, int bf16_ops, float scale, void* stream) {
  using namespace merlin::f32;
  if (d % 8 || d > 128 || h % hkv || page_kind < 0 || page_kind > 2 ||
      b < 1 || s_q < 1 || page_size < 1 || pps < 1 ||
      (page_kind == kPagesInt8 && scale_lanes < hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a;
  a.q = q;
  a.k_pages = k_pages;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_pages = v_pages;
  a.v_scales = static_cast<const float*>(v_scales);
  a.lengths = static_cast<const int*>(lengths);
  a.tables = static_cast<const int*>(tables);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
  a.b = b; a.s_q = s_q; a.h = h; a.hkv = hkv; a.d = d;
  a.page_size = page_size; a.pps = pps; a.scale_lanes = scale_lanes;
  a.q_bf16 = q_bf16; a.page_kind = page_kind; a.bf16_ops = bf16_ops;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool few = h / hkv * s_q <= 16;
  if (d <= 64)
    return static_cast<int>(few ? launch<1, 64>(a, s) : launch<4, 64>(a, s));
  return static_cast<int>(few ? launch<1, 128>(a, s) : launch<4, 128>(a, s));
}
