// Paged attention over a head-packed KV pool, for Hopper (sm_90a).
//
// Replaces merlin_tpu/ops/paged_attention.py:
//   * paged decode (merlin_paged_decode_bf16) for B3 _paged_dma_kernel
//     (paged_attention_dma, pallas_call :365) and B4 _paged_kernel
//     (paged_attention, pallas_call :143): one query token per sequence,
//     keys at positions < lengths[b], optional per-query-head ALiBi
//     slope * (k - (len - 1)), GQA by group = h / hkv;
//   * paged window (merlin_paged_window_bf16) for B5 _paged_dma_multi_kernel
//     (paged_attention_dma_multi, pallas_call :631) and B6
//     _paged_multi_blocked_kernel (paged_attention_multi_blocked, pallas_call
//     :772): s_q queries per sequence, lengths INCLUDE the window, row t sits
//     at length - s_q + t and sees keys <= that position, optional ALiBi
//     slope * (k - q_pos), GQA.
// and the same two kernels over int8 pages:
//   * int8 paged decode (merlin_paged_decode_q8) for B7 at s_q = 1
//     (paged_attention_dma_q8, the s_q == 1 case of _paged_dma_multi_q8_kernel,
//     pallas_call :1172) and B9 _paged_q8_kernel (paged_attention_quantized,
//     pallas_call :1353);
//   * int8 paged window (merlin_paged_window_q8) for B7 windows
//     (paged_attention_dma_multi_q8, pallas_call :1172) and B8
//     _paged_multi_blocked_q8_kernel (paged_attention_multi_blocked_q8,
//     pallas_call :916).
// Pages are (P, page_size, hkv * d) bf16 or int8, tables (b, pps) int32,
// lengths (b,) int32, q/out contiguous (b, [s_q,] h, d) bf16. int8 pages
// come with f32 scales (P, page_size, S), one per (token, kv head): head hk's
// at lane hk * max(S / hkv, 1) (the strided layout of _scale_row, stride 4
// at hkv = 32, 3 at hkv = 40; reading lane hk instead passes any test with
// hkv = 1).
//
// What bounds them on the H100: the K/V bytes. Decode does 4 FLOP per key
// per head dim for every query head of a group against 4 bytes of K+V per
// key per head dim: at most 8 FLOP per byte for group 8, far below the ~295
// FLOP/byte ridge. At Vicuna-7B (hkv = 32, d = 128), 4 slots of ~2k tokens
// read ~134 MB: ~40 us at 3.35 TB/s. A 128-token prefill window does ~128 x
// that work per byte: still below the ridge, so bytes again, with the
// matmuls on the tensor cores. int8 pages halve the K/V bytes and add 8
// bytes of scales per (key, kv head): 264 bytes per key per head at d = 128
// instead of 512.
//
// Design. The TPU kernels walk a sequential grid with scalar-prefetched page
// ids, double-buffered DMAs of whole multi-head pages and a block-diagonal
// packed q (all TPU layout). Here every block loads its own page ids from
// the table, per key, so a block never reads a table entry, a length or a
// page past its sequence's own (the TPU kernels' prefetch predicate reads
// lengths[b] one past the end on their last grid step: trap C8), and the
// ragged last page is masked by position, not by padding.
//   * Decode: one block of 128 threads per (sequence, kv head) owns the
//     group's query rows. It walks the keys below min(length, pps * page) in
//     tiles of 64: each key's d-wide slice of its head (256 bytes at d = 128)
//     is read by 16 threads with 16-byte loads, neighbours on neighbouring
//     addresses; scores are CUDA-core dot products reduced by warp shuffles,
//     the online max and sum are f32 in shared memory, and P@V accumulates in
//     f32 registers (8 columns x up to 8 group rows per thread), summed over
//     the key lanes once at the end. p stays f32 (no bf16 rounding).
//   * Window: the mma.sync tile engine of attention_core.cuh with a problem
//     whose K/V rows go through the page table. A block of 4 warps owns one
//     (sequence, kv head, tile of the group * s_q rows, row = g * s_q + t).
//     B6 (prefill windows): 64-row tiles, each warp 16 rows, the block
//     walking every key once. B5 (verify windows, <= 16 rows per kv head):
//     one 16-row tile whose 4 warps split the key tiles and merge at the
//     end, so a 5-row window over a 2k-token history is walked 4 warps
//     wide instead of by one warp, and no warp computes rows that do not
//     exist.
// Both give 0 for a row that sees no key, as the JAX finalize (l == 0 -> 1)
// does. Simple first: no cp.async/TMA pipelining, no wgmma.
//
// int8 pages change only how a key's or value's 8 columns are fetched
// (kv_chunk): 8 bytes and that row's (token, head) scale, dequantized to
// bf16 on the way (int8 -> f32, times the scale, rounded once), as B8's and
// B9's TPU kernels and the plain version (dequantize_pages, then the bf16
// plain attention) do; the dots, the softmax and the masking are the bf16
// kernels'. B7's TPU kernel instead multiplies the f32 scores by the k scale
// and p by the v scale before P@V: the two orders differ by at most a bf16
// ulp of K or of p * scale, and this one is the plain version's.

#include "attention_core.cuh"

namespace merlin {

struct PagedArgs {
  const __nv_bfloat16* q;
  const void* k;          // bf16 or int8 pages
  const void* v;
  const float* k_scales;  // int8 pages: (P, page_size, s_lanes); else null
  const float* v_scales;
  const int* lengths;
  const int* tables;
  const float* slopes;  // (h,) or nullptr
  __nv_bfloat16* out;
  int b, s_q, h, hkv, d, page_size, pps, s_lanes, s_stride;
  float scale;
};

// Pool row (physical page * page_size + offset) of key `key` of sequence bi.
__device__ __forceinline__ int64_t page_slot(const PagedArgs& a, int bi,
                                             int key) {
  const int page = a.tables[(int64_t)bi * a.pps + key / a.page_size];
  return (int64_t)page * a.page_size + key % a.page_size;
}

// Columns c..c+7 of kv head hk's slice of the K (or V) pool row `slot`, as
// 8 bf16. int8 pages: 8 bytes and the row's scale at lane hk * s_stride,
// each value (float)x * scale rounded to bf16 once, as dequantize_pages.
template <bool Q8>
__device__ __forceinline__ uint4 kv_chunk(const PagedArgs& a, bool value,
                                          int64_t slot, int hk, int c) {
  const int64_t off = slot * (a.hkv * a.d) + (int64_t)hk * a.d + c;
  if constexpr (Q8) {
    const int8_t* base = static_cast<const int8_t*>(value ? a.v : a.k);
    const float* scales = value ? a.v_scales : a.k_scales;
    const uint2 raw = *reinterpret_cast<const uint2*>(base + off);
    const float s = scales[slot * a.s_lanes + (int64_t)hk * a.s_stride];
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    return make_uint4(pack_bf16((float)x[0] * s, (float)x[1] * s),
                      pack_bf16((float)x[2] * s, (float)x[3] * s),
                      pack_bf16((float)x[4] * s, (float)x[5] * s),
                      pack_bf16((float)x[6] * s, (float)x[7] * s));
  } else {
    return ld128(static_cast<const __nv_bfloat16*>(value ? a.v : a.k) + off);
  }
}

// Keys a sequence holds: its length, cut to what its table can address.
__device__ __forceinline__ int seq_keys(const PagedArgs& a, int bi) {
  return min(max(a.lengths[bi], 0), a.pps * a.page_size);
}

// ---------------------------------------------------------------------------
// decode (B3, B4; over int8 pages B7 at s_q = 1 and B9)
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 128;
constexpr int kDecodeKeys = 64;  // keys per tile
constexpr int kMaxGroup = 8;     // query heads per kv head

template <int D, bool Q8>
__global__ void __launch_bounds__(kDecodeThreads)
    paged_decode_kernel(const PagedArgs a) {
  constexpr int kCpr = D / 8;                   // 8-column chunks per key row
  constexpr int kLanes = kDecodeThreads / kCpr;  // keys read per pass
  __shared__ float qs[kMaxGroup][D];
  __shared__ float sc[kMaxGroup][kDecodeKeys];
  __shared__ float red[kLanes][kMaxGroup][D];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int hk = blockIdx.x;
  const int bi = blockIdx.y;
  const int group = a.h / a.hkv;
  const int tid = threadIdx.x;
  const int c0 = (tid % kCpr) * 8;  // this thread's 8 columns
  const int kl = tid / kCpr;        // this thread's key lane
  const bool col_ok = c0 < a.d;
  const int length = a.lengths[bi];
  const int n_keys = seq_keys(a, bi);
  const bool alibi = a.slopes != nullptr;

  for (int i = tid; i < kMaxGroup * D; i += kDecodeThreads) {
    const int g = i / D, c = i % D;
    qs[g][c] = (g < group && c < a.d)
                   ? __bfloat162float(
                         a.q[((int64_t)bi * a.h + hk * group + g) * a.d + c])
                   : 0.f;
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup][8];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += kDecodeKeys) {
    // scores of the tile's keys for every row of the group
    for (int j = kl; j < kDecodeKeys; j += kLanes) {
      const int key = k0 + j;
      float part[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) part[g] = 0.f;
      if (key < n_keys && col_ok) {
        const uint4 raw = kv_chunk<Q8>(a, false, page_slot(a, bi, key), hk, c0);
        const __nv_bfloat16* kv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kf = __bfloat162float(kv[e]);
#pragma unroll
          for (int g = 0; g < kMaxGroup; ++g) {
            if (g < group) part[g] += qs[g][c0 + e] * kf;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g >= group) break;
#pragma unroll
        for (int off = kCpr / 2; off > 0; off >>= 1) {
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
        }
        if (tid % kCpr == 0) {
          float x = part[g] * a.scale;
          if (alibi) {
            x += a.slopes[hk * group + g] * (float)(key - (length - 1));
          }
          sc[g][j] = key < n_keys ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per row, two keys per lane
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < group; g += kDecodeThreads / 32) {
      const float x0 = sc[g][lane], x1 = sc[g][lane + 32];
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = x0 == kNegInf ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == kNegInf ? 0.f : expf(x1 - m_new);
      sc[g][lane] = p0;
      sc[g][lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      }
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha_s[g] = al;
        l_s[g] = l_s[g] * al + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p V over this thread's keys of the tile
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        const float al = alpha_s[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= al;
      }
    }
    for (int j = kl; j < kDecodeKeys; j += kLanes) {
      const int key = k0 + j;
      if (key < n_keys && col_ok) {
        const uint4 raw = kv_chunk<Q8>(a, true, page_slot(a, bi, key), hk, c0);
        const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < group) {
            const float p = sc[g][j];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] += p * __bfloat162float(vv[e]);
          }
        }
      }
    }
    __syncthreads();  // sc and alpha_s are rewritten by the next tile
  }

  // sum the key lanes' partial P@V and normalise
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < group) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[kl][g][c0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < group * a.d; i += kDecodeThreads) {
    const int g = i / a.d, c = i % a.d;
    float sum = 0.f;
    for (int r = 0; r < kLanes; ++r) sum += red[r][g][c];
    const float l = l_s[g];
    a.out[((int64_t)bi * a.h + hk * group + g) * a.d + c] =
        __float2bfloat16(sum / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// window (B5, B6; over int8 pages B7 and B8): the tile engine over paged K/V
// ---------------------------------------------------------------------------

// Block (blockIdx.x = tile of ROWS of the kv head's group * s_q rows,
// blockIdx.y = kv head, blockIdx.z = sequence); block row r is row
// r0 + r = g * s_q + t.
template <int ROWS, bool Q8>
struct PagedWindowProblem {
  struct Row {
    int pos;      // true query position, length - s_q + t
    int t;        // window slot
    int qh;       // query head
    float slope;  // its ALiBi slope, 0 without
    bool live;
  };
  const PagedArgs a;  // by value: a reference would force a local copy
  int bi, hk, r0, group, n_total, length, keys;

  __device__ explicit PagedWindowProblem(const PagedArgs& args)
      : a(args),
        bi(blockIdx.z),
        hk(blockIdx.y),
        r0(blockIdx.x * ROWS),
        group(args.h / args.hkv),
        n_total(args.h / args.hkv * args.s_q),
        length(args.lengths[blockIdx.z]),
        keys(seq_keys(args, blockIdx.z)) {}

  __device__ Row row(int r) const {
    const int rg = r0 + r;
    const int g = rg / a.s_q, t = rg % a.s_q;
    const int qh = hk * group + g;
    const bool live = rg < n_total;
    const float slope = (live && a.slopes != nullptr) ? a.slopes[qh] : 0.f;
    return Row{length - a.s_q + t, t, qh, slope, live};
  }
  __device__ bool live(const Row& rw) const { return rw.live; }
  __device__ int n_rows() const { return min(ROWS, n_total - r0); }
  __device__ int n_keys() const { return keys; }
  __device__ int key_end() const { return keys; }
  __device__ const __nv_bfloat16* q_row(int r) const {
    const int rg = r0 + r;
    const int g = rg / a.s_q, t = rg % a.s_q;
    return a.q + (((int64_t)bi * a.s_q + t) * a.h + hk * group + g) * a.d;
  }
  __device__ uint4 k_chunk(int key, int c) const {
    return kv_chunk<Q8>(a, false, page_slot(a, bi, key), hk, c);
  }
  __device__ uint4 v_chunk(int key, int c) const {
    return kv_chunk<Q8>(a, true, page_slot(a, bi, key), hk, c);
  }
  __device__ float logit(const Row& rw, int ki, float s) const {
    const float x = (s * a.scale + rw.slope * (float)(ki - rw.pos)) * kLog2e;
    return (ki < keys && ki <= rw.pos) ? x : kNegInf;
  }
  __device__ __nv_bfloat16* out_row(const Row& rw) const {
    return a.out + (((int64_t)bi * a.s_q + rw.t) * a.h + rw.qh) * a.d;
  }
  __device__ void store_lse(const Row&, float) const {}
};

constexpr int kWindowWarps = 4;

template <int DP, bool SPLIT_KEYS, bool Q8>
__global__ void __launch_bounds__(32 * kWindowWarps)
    paged_window_kernel(const PagedArgs a) {
  constexpr int kRows = SPLIT_KEYS ? 16 : 16 * kWindowWarps;
  attention_tile<DP, kWindowWarps, SPLIT_KEYS>(
      PagedWindowProblem<kRows, Q8>(a), a.d);
}

template <int DP, bool SPLIT_KEYS, bool Q8>
cudaError_t launch_window(const PagedArgs& a, cudaStream_t s) {
  constexpr int kRows = SPLIT_KEYS ? 16 : 16 * kWindowWarps;
  const int rows = a.h / a.hkv * a.s_q;
  const dim3 grid((rows + kRows - 1) / kRows, a.hkv, a.b);
  return launch_grid(paged_window_kernel<DP, SPLIT_KEYS, Q8>, grid,
                     32 * kWindowWarps,
                     tile_smem_bytes<DP, kWindowWarps, SPLIT_KEYS>(), a, s);
}

// s_lanes = 0: bf16 pages; else int8 pages with (P, page, s_lanes) scales.
PagedArgs make_args(const void* q, const void* k, const void* k_scales,
                    const void* v, const void* v_scales, const void* lengths,
                    const void* tables, const void* slopes, void* out, int b,
                    int s_q, int h, int hkv, int d, int page_size, int pps,
                    int s_lanes, float scale) {
  PagedArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.lengths = static_cast<const int*>(lengths);
  a.tables = static_cast<const int*>(tables);
  a.slopes = static_cast<const float*>(slopes);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.b = b;
  a.s_q = s_q;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.page_size = page_size;
  a.pps = pps;
  a.s_lanes = s_lanes;
  a.s_stride = (hkv > 0 && s_lanes / hkv > 1) ? s_lanes / hkv : 1;
  a.scale = scale;
  return a;
}

// The shapes the kernels take: whole query groups of at most kMaxGroup
// heads (decode), d a multiple of 8 up to 128, and every kv head's scale
// lane inside the scale row.
bool bad_shape(int h, int hkv, int d, int s_lanes, bool decode) {
  return hkv <= 0 || h % hkv || (decode && h / hkv > kMaxGroup) || d % 8 ||
         d > 128 || (s_lanes > 0 && hkv > s_lanes);
}

template <bool Q8>
int launch_decode(const PagedArgs& a, cudaStream_t s) {
  const dim3 grid(a.hkv, a.b);
  if (a.d <= 64) {
    paged_decode_kernel<64, Q8><<<grid, kDecodeThreads, 0, s>>>(a);
  } else {
    paged_decode_kernel<128, Q8><<<grid, kDecodeThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool Q8>
int launch_window_any(const PagedArgs& a, int split_keys, cudaStream_t s) {
  if (a.d <= 64) {
    return (int)(split_keys ? launch_window<64, true, Q8>(a, s)
                            : launch_window<64, false, Q8>(a, s));
  }
  return (int)(split_keys ? launch_window<128, true, Q8>(a, s)
                          : launch_window<128, false, Q8>(a, s));
}

}  // namespace merlin

extern "C" int merlin_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, const void* slopes, void* out,
    int b, int h, int hkv, int d, int page_size, int pps, float scale,
    void* stream) {
  using namespace merlin;
  if (bad_shape(h, hkv, d, 0, true)) return (int)cudaErrorInvalidValue;
  return launch_decode<false>(
      make_args(q, k_pages, nullptr, v_pages, nullptr, lengths, tables,
                slopes, out, b, 1, h, hkv, d, page_size, pps, 0, scale),
      static_cast<cudaStream_t>(stream));
}

extern "C" int merlin_paged_decode_q8(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* tables, const void* slopes, void* out, int b, int h, int hkv,
    int d, int page_size, int pps, int s_lanes, float scale, void* stream) {
  using namespace merlin;
  if (s_lanes <= 0 || bad_shape(h, hkv, d, s_lanes, true)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_decode<true>(
      make_args(q, k_pages, k_scales, v_pages, v_scales, lengths, tables,
                slopes, out, b, 1, h, hkv, d, page_size, pps, s_lanes, scale),
      static_cast<cudaStream_t>(stream));
}

extern "C" int merlin_paged_window_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, const void* slopes, void* out,
    int b, int s_q, int h, int hkv, int d, int page_size, int pps,
    float scale, int split_keys, void* stream) {
  using namespace merlin;
  if (bad_shape(h, hkv, d, 0, false)) return (int)cudaErrorInvalidValue;
  return launch_window_any<false>(
      make_args(q, k_pages, nullptr, v_pages, nullptr, lengths, tables,
                slopes, out, b, s_q, h, hkv, d, page_size, pps, 0, scale),
      split_keys, static_cast<cudaStream_t>(stream));
}

extern "C" int merlin_paged_window_q8(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* tables, const void* slopes, void* out, int b, int s_q, int h,
    int hkv, int d, int page_size, int pps, int s_lanes, float scale,
    int split_keys, void* stream) {
  using namespace merlin;
  if (s_lanes <= 0 || bad_shape(h, hkv, d, s_lanes, false)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_window_any<true>(
      make_args(q, k_pages, k_scales, v_pages, v_scales, lengths, tables,
                slopes, out, b, s_q, h, hkv, d, page_size, pps, s_lanes,
                scale),
      split_keys, static_cast<cudaStream_t>(stream));
}
