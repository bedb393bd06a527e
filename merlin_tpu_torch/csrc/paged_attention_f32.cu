// B3-B9 for f32 models and f32 pages: paged attention whenever q or the
// pages are not both bf16 (sm_90a). Every product runs on the tensor cores
// as mma.sync m16n8k8 with tf32 operands (tf32x3.cuh), in as many passes as
// its operands need for f32 accuracy. The bf16 kernels (paged_attention.cu)
// stay for bf16 q over bf16 or int8 pages.
//
// Replaces, at these operand dtypes, merlin_tpu/ops/paged_attention.py:
// _paged_dma_kernel (B3, pallas_call :365), _paged_kernel (B4, :143),
// _paged_dma_multi_kernel (B5, :631), _paged_multi_blocked_kernel (B6,
// :772), _paged_dma_multi_q8_kernel (B7, :1172, s_q = 1 and windows),
// _paged_multi_blocked_q8_kernel (B8, :916) and _paged_q8_kernel (B9,
// :1353). Two kernels:
//   * paged_rows_f32_kernel, the few-rows kernel: decode (B3, B4, B7 at
//     s_q = 1, B9) and windows of <= 16 query rows per kv head (B5, B7
//     windows), in tiles of 16 query rows of a kv head;
//   * paged_window_f32_kernel, the window kernel: larger windows (B6, B8:
//     the engine's 128-token prefill chunks), in tiles of 64 query rows.
// The wrapper picks one as the bf16 route does (its few_rows argument).
// Contract of both: s_q queries per sequence (1 at decode), lengths
// INCLUDE the window, query row t at length - s_q + t sees the keys at
// positions <= its own; optional ALiBi slope * (k - q_pos); any query group
// (query head hk * group + g reads kv head hk); ragged lengths over
// permuted page tables. q / out (b, s_q, h, d) contiguous: f32 over bf16,
// f32 or int8 pages, or bf16 over f32 pages; pages (P, page_size, hkv * d)
// with, for int8, f32 scale pages (P, page_size, S), head hk's scale at
// lane hk * max(S / hkv, 1) (trap C11); d % 8 == 0, d <= 256 (each kernel
// in two forms, DP = 128 and 256 head dims a tile, d zero-padded). No table
// entry, length or page past a sequence's own keys is read (trap C8), and a
// row that sees no key writes 0 (trap C2).
//
// Numerics: what the TPU kernel computes at these operand dtypes.
//   * float pages (B3-B6): q . k at the promoted dtype (a bf16 operand
//     widened to f32, exactly), f32 sums; p rounded to the page dtype before
//     P V (bf16 pages: to bf16; f32 pages: not), l summed from the f32 p;
//     out in q's dtype from the f32 accumulator (trap C48: JAX's reference,
//     the CPU route, keeps p in f32).
//   * int8 pages, q's-dtype mode (B8, B9): K and V dequantized to q's dtype
//     (int8 * scale in f32), p kept in f32.
//   * int8 pages, bf16 mode (B7, trap C49): bf16 operands whatever q's
//     dtype: q rounded to bf16, s = (q . k_int8) * k_scale * scale, and
//     p * v_scale rounded to bf16 for the product with the int8 V.
// Keys go through the online softmax in 64-key tiles from the first key of
// each key split, a split starting from m = NEG_INF: p is rounded against
// the running max of its own split, and the splits merge by the LSE
// rescale in split order, so two runs are bit-identical. The plain versions
// take the same splits (split_keys) and blocks (block_keys = 64).
//
// TF32 passes. The tensor core reads the top 19 bits of an operand, so a
// value of 11 significant bits or fewer (a bf16 value, an int8 value, p
// rounded to bf16) is one exact tf32 operand, and an f32 value is split
// into big + small (tf32x3.cuh): a product takes 1 pass when both operands
// are exact, 2 when one is split, 3 when both are. q . k: f32 q over bf16
// pages 2, bf16 q over f32 pages 2, f32 over f32 3, B7 1 (q rounded to
// bf16, the int8 K), B8/B9 3 (K dequantized to f32); P V: over bf16 pages
// 1, over f32 pages 3, B7 1 (p * v_scale rounded to bf16, the int8 V),
// B8/B9 3. Each mma chain starts from 0 over a 32-column chunk (q . k) or a
// tile's keys (P V) and is added in f32, because the tensor core's f32
// accumulate truncates.
//
// What bounds them on the H100. Decode reads each key's K and V once for
// 4 FLOP per head dim per query row: bytes, ~1 FLOP a byte at Vicuna's
// MHA. At Vicuna-7B, 4 slots of 2894 keys read 47 MB of bf16 pages (14 us at
// 3.35 TB/s) or 95 MB of f32 pages (28 us). A 128-row prefill window does
// 128 FLOP per key per head dim against the same bytes: the tensor cores
// at 495 TFLOP/s a TF32 pass, in the passes above (640 keys at 32 heads:
// 1.2 GFLOP, 3.7 us at f32 q over bf16 pages, 2 + 1 passes, under the
// 4.4 us its 15 MB take; 7.3 us at f32 over f32, 3 + 3).
//
// Design of the few-rows kernel (what each choice does about the bytes),
// modelled on paged_rows_kernel:
//   * Keys split over CTAs: the grid is (key splits, kv head x 16-row tile,
//     sequence), a split a whole number of pages (~SPLIT_KEYS keys, the
//     wrapper's split_pages); a CTA whose split starts past its sequence's
//     keys exits at once. At Vicuna-7B decode 4 slots run ~420 live CTAs
//     where one CTA a (sequence, kv head) ran 128. The live splits write
//     (O, m, l) to a workspace and count themselves in on the shared arrival
//     counters; the last to arrive merges them in split order and sets the
//     counter back to 0. A sequence with one live split writes out directly.
//   * The split's slice of the table is copied to shared memory once.
//   * A cp.async ring of three slots, each a 64-key K or V tile in the page
//     dtype: the ring takes K_0, V_0, K_1, V_1, ... in turn, so two slots
//     are in flight while one is multiplied. An f32 slot is 33 KB at d =
//     128, so a CTA takes 111 KB and two fit an SM (a ring of whole K + V
//     stages would take 135 KB, one CTA an SM); over bf16 pages 62 KB. At
//     d = 256 (O's 128 accumulators a thread) 216 KB over f32 pages and
//     118 KB over bf16: one CTA an SM.
//   * Each of the 4 warps takes 16 keys of every tile for the tile's 16
//     rows. The warps exchange their rows' tile max through shared memory
//     at the barrier the V tile needs anyway, so all four keep the tile's
//     running max: p is rounded against it (C48), and the warps' (O, l) add
//     up at the end without a rescale.
//   * Q in shared memory as f32 (bf16 q widened, B7's rounded to bf16), its
//     dims permuted within each 8 where K and V are bf16 or int8, so that
//     one 4- or 2-byte load gives a lane both of its k-values of a k-step;
//     f32 K comes by ldmatrix in natural order. Every operand is split as
//     its fragment is loaded.
// Design of the window kernel: attention_f32.cu's tile step over pages.
//   * At d = 256 a CTA owns one 128-column half of O (two CTAs a row tile):
//     both compute the same S and P, each reads its half of V.
//   * A CTA of 4 warps owns 64 query rows of a kv head, a warp 16 (rows g *
//     s_q + t, each with its own position, slope and output row); K and V of
//     a 64-key tile pass through one buffer each (K_{j+1} is copied during
//     tile j's softmax and P V, V_{j+1} during tile j+1's scores), S and P
//     stay in registers, P V is computed transposed (tf32x3.cuh's pv).
//   * Keys split over CTAs, merged in the same launch in split order: each
//     sequence's 64-key tiles are cut into at most `splits` runs, the
//     wrapper's plan (about two CTAs an SM for the launch's row tiles), so
//     the engine's one-sequence 128-row window at 32 heads runs 320 CTAs
//     where one CTA a (kv head, row tile) ran 64 on 132 SMs.
//   * K and V tiles in the page dtype, rows addressed through the split's
//     page ids, copied to shared memory once.

#include <type_traits>

#include "tf32x3.cuh"

namespace merlin {
namespace paged_f32 {

using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::cp_async_wait;
using tf32x3::lds2;
using tf32x3::ldsm4;
using tf32x3::mma_tf32;
using tf32x3::quad_max;
using tf32x3::quad_sum;
using tf32x3::to_pv_rows;

// Two forms by head dims a tile holds, DP = 128 (d <= 128) and DP = 256
// (128 < d <= 256); the window kernel's CTA owns kCols = min(DP, 128) of
// O's columns (two CTAs a row tile at DP = 256, each computing S whole).
constexpr int kMaxDP = 256;
constexpr int kCols = 128;            // O columns of a window CTA, at most
constexpr int kThreads = 128;         // 4 warps
constexpr int kKeys = 64;             // keys of a tile: the softmax block
// the f32 Q tile's row stride
template <int DP>
__host__ __device__ constexpr int q_ld() { return DP + 4; }
constexpr int kRowsTile = 16;         // query rows of a few-rows CTA
constexpr int kWindowRows = 64;       // query rows of a window CTA
constexpr int kRingSlots = 3;         // the few-rows kernel's cp.async ring
constexpr int kMaxSplits = 256;       // few-rows: key splits of a table row
constexpr int kWindowMaxSplits = 16;  // window: key splits of a row tile
constexpr int kWindowMaxPages = 4096; // window: table entries of a row

constexpr int cmax(int x, int y) { return x > y ? x : y; }

enum { kPagesBf16 = 0, kPagesF32 = 1, kPagesInt8 = 2 };
// (q, pages) modes: f32 q over bf16 pages, bf16 q over f32 pages, f32 over
// f32, f32 over int8 dequantized to f32 (B8, B9), f32 over int8 with bf16
// operands (B7, trap C49)
enum { kQf32Bf16 = 0, kQbf16F32 = 1, kQf32F32 = 2, kQf32Int8 = 3,
       kQf32Int8B7 = 4 };

template <int MODE>
struct Rule {
  static constexpr int kPages =
      MODE == kQf32Bf16 ? kPagesBf16
      : (MODE == kQbf16F32 || MODE == kQf32F32) ? kPagesF32 : kPagesInt8;
  static constexpr bool kQBf16 = MODE == kQbf16F32;   // q and out bf16
  static constexpr bool kB7 = MODE == kQf32Int8B7;
  // which operands hold more bits than one tf32 pass reads
  static constexpr bool kSplitQ = !kQBf16 && !kB7;
  static constexpr bool kSplitKV =
      kPages == kPagesF32 || MODE == kQf32Int8;
  static constexpr bool kRoundP = kPages == kPagesBf16;  // C48
  static constexpr bool kSplitP = !kRoundP && !kB7;
  // K fragments from pairs of adjacent dims (bf16, int8), so Q's dims are
  // permuted to match; f32 K by ldmatrix in natural order
  static constexpr bool kPairs = kPages != kPagesF32;
  using T = std::conditional_t<
      kPages == kPagesF32, float,
      std::conditional_t<kPages == kPagesBf16, __nv_bfloat16, int8_t>>;
};

// A 64-key K or V tile of NC columns in the page dtype: its row stride
// (one that keeps each fragment load on distinct banks), bytes, and its
// slot (the tile and, over int8 pages, its keys' scales).
template <int MODE, int NC>
struct Tile {
  using T = typename Rule<MODE>::T;
  static constexpr int kPages = Rule<MODE>::kPages;
  static constexpr int kLd = kPages == kPagesF32    ? NC + 4
                             : kPages == kPagesBf16 ? NC + 8
                                                    : NC + 16;
  static constexpr int kTile = kKeys * kLd * (int)sizeof(T);
  static constexpr int kSlot = kTile + (kPages == kPagesInt8 ? kKeys * 4 : 0);
};

struct PagedArgs {
  const void* q;
  const void* k;
  const float* k_scales;  // int8 pages: (P, page_size, s_lanes); else null
  const void* v;
  const float* v_scales;
  const int* lengths;
  const int* tables;
  const float* slopes;  // (h,) or null
  void* out;
  // more than one key split, f32: the few-rows kernel's O (b, hkv, splits,
  // rows, d) then (m, l) (b, hkv, splits, rows, 2); the window kernel's
  // per (sequence, kv head, row tile, split) each thread's O accumulators,
  // then its rows' (m, l), in fragment order
  float* ws;
  int* counters;  // (b, hkv, row tiles), 0 between launches
  // split: the few-rows kernel's pages a key split; the window kernel's
  // most key splits of a sequence
  int b, s_q, h, hkv, d, page_size, pps, s_lanes, s_stride, split;
  float scale;
};

// Keys a sequence holds: its length, cut to what its table can address.
__device__ __forceinline__ int seq_keys(const PagedArgs& a, int bi) {
  return min(max(a.lengths[bi], 0), a.pps * a.page_size);
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0) : "memory");
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Byte K of the four int8 in x, as an exact float, given xu = x ^
// 0x80808080: the bits 0x4B0000uu are 2^23 + x_K + 128 (a byte permute and
// one FADD, where a conversion would take the quarter-rate I2F).
template <int K>
__device__ __forceinline__ float i8_float(uint32_t xu) {
  return __int_as_float(__byte_perm(xu, 0x4B000000u, 0x7650 | K)) -
         8388736.f;
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// An A or B fragment: split into big + small where the operand holds more
// bits than a tf32 pass reads, else its bits as they are.
template <bool SPLIT>
__device__ __forceinline__ void frag_a(FragA& f, const float (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (SPLIT) {
      tf32x3::split(x[i], f.big[i], f.small[i]);
    } else {
      f.big[i] = __float_as_uint(x[i]);
    }
  }
}

template <bool SPLIT>
__device__ __forceinline__ void frag_b(FragB& f, float b0, float b1) {
  if constexpr (SPLIT) {
    tf32x3::split(b0, f.big[0], f.small[0]);
    tf32x3::split(b1, f.big[1], f.small[1]);
  } else {
    f.big[0] = __float_as_uint(b0);
    f.big[1] = __float_as_uint(b1);
  }
}

// c += a b in the passes the operands need, the small terms first
template <bool SA, bool SB>
__device__ __forceinline__ void mma_passes(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  if constexpr (SA) mma_tf32(c, a.small, b.big[0], b.big[1]);
  if constexpr (SB) mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// Rows [r0, r0 + R) of kv head hk's query rows (row g * s_q + t: query
// head hk * group + g at window slot t) of sequence bi into the f32 tile Qs
// (row stride q_ld<DP>()): bf16 q widened, B7's q rounded to bf16, dims
// permuted within each 8 (0 2 4 6 1 3 5 7) where K comes in pairs; rows
// past `rows` and dims past d zero.
template <int MODE, int R, int DP>
__device__ __forceinline__ void load_q(float* Qs, const PagedArgs& a, int bi,
                                       int hk, int r0, int rows, int tid) {
  using Ru = Rule<MODE>;
  const int group = a.h / a.hkv;
  for (int i = tid; i < R * (DP / 8); i += kThreads) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int rg = r0 + r;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (rg < rows && c < a.d) {
      const int64_t at = (((int64_t)bi * a.s_q + rg % a.s_q) * a.h +
                          hk * group + rg / a.s_q) * a.d + c;
      if constexpr (Ru::kQBf16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.q) + at);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[2 * u] = bf16_lo(w[u]);
          x[2 * u + 1] = bf16_hi(w[u]);
        }
      } else {
        const float4* src = reinterpret_cast<const float4*>(
            static_cast<const float*>(a.q) + at);
        const float4 lo = src[0], hi = src[1];
        x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
        x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
        if constexpr (Ru::kB7) {
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = round_bf16(x[u]);
        }
      }
    }
    float* dst = Qs + r * q_ld<DP>() + c;
    if constexpr (Ru::kPairs) {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[2], x[4], x[6]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(x[1], x[3], x[5], x[7]);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// The 64 keys [k0, k0 + 64) of kv head hk, its NC dims from c0, from
// `pool` (and, over int8 pages, each key's scale lane from `scales`) into
// the tile at dst (Tile<MODE, NC>) by cp.async: keys at or past k_end and
// dims past d zero-filled, never read. The keys' pages come from the
// shared page ids, entry p0 first. 16-byte copies, neighbouring threads on
// neighbouring bytes of a key's d-wide slice (8-byte ones for int8 where
// d % 16 != 0: a head's int8 slice is then only 8-byte aligned).
template <int MODE, int NC>
__device__ __forceinline__ void copy_tile(uint32_t dst, const void* pool,
                                          const float* scales,
                                          const PagedArgs& a,
                                          const int* pages, int p0, int k0,
                                          int k_end, int hk, int tid,
                                          int c0 = 0) {
  using Ru = Rule<MODE>;
  using Ti = Tile<MODE, NC>;
  using T = typename Ru::T;
  const int64_t row_elems = (int64_t)a.hkv * a.d;
  const T* src0 = static_cast<const T*>(pool) + (int64_t)hk * a.d + c0;
  auto copy_rows = [&](auto width) {
    constexpr int kW = decltype(width)::value;
    constexpr int kWCols = kW / (int)sizeof(T);
    constexpr int kChunks = NC / kWCols;
    static_assert(kKeys * kChunks % kThreads == 0, "whole passes");
    // 4 copies' addresses at a time: the whole 16 of an f32 tile, issued
    // while the window kernel holds S and O, took it past 255 registers
#pragma unroll 4
    for (int n = 0; n < kKeys * kChunks / kThreads; ++n) {
      const int i = tid + n * kThreads;
      const int r = i / kChunks, c = (i % kChunks) * kWCols;
      const int key = k0 + r;
      const bool ok = key < k_end && c0 + c < a.d;
      int64_t off = 0;
      if (ok) {
        off = ((int64_t)pages[key / a.page_size - p0] * a.page_size +
               key % a.page_size) * row_elems + c;
      }
      const uint32_t so = dst + (r * Ti::kLd + c) * (int)sizeof(T);
      if constexpr (kW == 16) {
        cp_async16(so, src0 + off, ok);
      } else {
        cp_async8(so, src0 + off, ok);
      }
    }
  };
  if constexpr (Ru::kPages != kPagesInt8) {
    copy_rows(std::integral_constant<int, 16>());
  } else if (a.d % 16 == 0) {
    copy_rows(std::integral_constant<int, 16>());
  } else {
    copy_rows(std::integral_constant<int, 8>());
  }
  if constexpr (Ru::kPages == kPagesInt8) {
    if (tid < kKeys) {
      const int key = k0 + tid;
      const bool ok = key < k_end;
      int64_t off = 0;
      if (ok) {
        off = ((int64_t)pages[key / a.page_size - p0] * a.page_size +
               key % a.page_size) * a.s_lanes + (int64_t)hk * a.s_stride;
      }
      cp_async4(dst + Ti::kTile + tid * 4, scales + off, ok);
    }
  }
}

// K's B fragments of one n-tile (the 8 keys from row0 of tile kt, rows LD
// elements apart) over the 32-dim chunk c0: b[s] for the chunk's k-step s
// (k = t, k = t + 4), as f32 values; int8 K times its key's scale where K
// is dequantized (B8, B9), the bare integers for B7.
template <int MODE, int LD>
__device__ __forceinline__ void k_frags(float (&b)[4][2],
                                        const unsigned char* kt,
                                        const float* ksc, int row0, int c0,
                                        int lane) {
  using Ru = Rule<MODE>;
  if constexpr (Ru::kPages == kPagesF32) {
    // matrices at columns c0 + 4m: lane 4g + t gets K[g][c0 + 4m + t]
    const uint32_t p = smem_addr(kt) +
        ((row0 + (lane & 7)) * LD + c0 + 4 * (lane >> 3)) * 4;
    float y[4];
    ldsm4(y, p);
    b[0][0] = y[0]; b[0][1] = y[1]; b[1][0] = y[2]; b[1][1] = y[3];
    ldsm4(y, p + 64);
    b[2][0] = y[0]; b[2][1] = y[1]; b[3][0] = y[2]; b[3][1] = y[3];
  } else if constexpr (Ru::kPages == kPagesBf16) {
    // b16 matrices at columns c0 + 8m: lane 4g + t gets K[g][c0 + 8m + 2t]
    // and the next dim, k-step m's k = t and k = t + 4 in pair order
    float y[4];
    ldsm4(y, smem_addr(kt) +
                 ((row0 + (lane & 7)) * LD + c0 + 8 * (lane >> 3)) * 2);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      b[s][0] = bf16_lo(__float_as_uint(y[s]));
      b[s][1] = bf16_hi(__float_as_uint(y[s]));
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int8_t* kr = reinterpret_cast<const int8_t*>(kt) +
                       (row0 + g) * LD + c0 + 2 * t;
    const float sc = Ru::kSplitKV ? ksc[row0 + g] : 1.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t x =
          *reinterpret_cast<const uint16_t*>(kr + 8 * s) ^ 0x80808080u;
      b[s][0] = i8_float<0>(x) * sc;
      b[s][1] = i8_float<1>(x) * sc;
    }
  }
}

// V^T's A fragment of the 16-column group m over the 8 keys from row0 of
// tile vt, rows LD elements apart (tf32x3.cuh's pv layout: V[2t][2g],
// V[2t][2g + 1], V[2t + 1][2g], V[2t + 1][2g + 1] of the group); int8 V
// times its keys' scales where it is dequantized.
template <int MODE, int LD>
__device__ __forceinline__ void v_frag(float (&x)[4],
                                       const unsigned char* vt,
                                       const float* vsc, int row0, int m,
                                       int lane) {
  using Ru = Rule<MODE>;
  const int r = row0 + 2 * (lane & 3), c = 16 * m + 2 * (lane >> 2);
  if constexpr (Ru::kPages == kPagesF32) {
    const float* v = reinterpret_cast<const float*>(vt) + r * LD + c;
    const float2 a = lds2(v), b = lds2(v + LD);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else if constexpr (Ru::kPages == kPagesBf16) {
    const __nv_bfloat16* v =
        reinterpret_cast<const __nv_bfloat16*>(vt) + r * LD + c;
    const uint32_t a = ld32(v), b = ld32(v + LD);
    x[0] = bf16_lo(a); x[1] = bf16_hi(a); x[2] = bf16_lo(b); x[3] = bf16_hi(b);
  } else {
    const int8_t* v = reinterpret_cast<const int8_t*>(vt) + r * LD + c;
    const uint32_t a = *reinterpret_cast<const uint16_t*>(v) ^ 0x80808080u;
    const uint32_t b =
        *reinterpret_cast<const uint16_t*>(v + LD) ^ 0x80808080u;
    const float s0 = Ru::kSplitKV ? vsc[r] : 1.f;
    const float s1 = Ru::kSplitKV ? vsc[r + 1] : 1.f;
    x[0] = i8_float<0>(a) * s0; x[1] = i8_float<1>(a) * s0;
    x[2] = i8_float<0>(b) * s1; x[3] = i8_float<1>(b) * s1;
  }
}

// s[j] = Q (the warp's 16 rows, at shared address qa as tf32x3's dots
// addresses A) . K^T (the 8 keys from row kr0 + 8 j of tile kt, rows LD
// apart), over the d dims: one chain a 32-dim chunk, added in f32.
template <int MODE, int NJ, int LD>
__device__ __forceinline__ void qk(float (&s)[NJ][4], uint32_t qa,
                                   const unsigned char* kt, const float* ksc,
                                   int kr0, int d, int lane) {
  using Ru = Rule<MODE>;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < d; c0 += 32) {
    FragA fa[4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      float x[4];
      ldsm4(x, qa + (c0 + 8 * st) * 4);
      frag_a<Ru::kSplitQ>(fa[st], x);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float b[4][2];
      k_frags<MODE, LD>(b, kt, ksc, kr0 + 8 * j, c0, lane);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        FragB fb;
        frag_b<Ru::kSplitKV>(fb, b[st][0], b[st][1]);
        mma_passes<Ru::kSplitQ, Ru::kSplitKV>(part, fa[st], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[e];
    }
  }
}

// o += P V over the 8 NJ keys from row kr0 of tile vt (rows LD apart, its
// first d columns live), p[j] the keys 8 j .. of P in dots' layout, as the
// product takes them (rounded where the rule rounds): O^T += V^T P^T, two
// column groups' four chains at a time (pv's layout), a chain a call,
// added in f32.
template <int MODE, int NJ, int NM, int LD>
__device__ __forceinline__ void pv(float (&o)[NM][2][4],
                                   const float (&p)[NJ][4],
                                   const unsigned char* vt, const float* vsc,
                                   int kr0, int d, int lane) {
  using Ru = Rule<MODE>;
  FragB fb[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    frag_b<Ru::kSplitP>(fb[j][0], p[j][0], p[j][1]);
    frag_b<Ru::kSplitP>(fb[j][1], p[j][2], p[j][3]);
  }
#pragma unroll
  for (int m0 = 0; m0 < NM; m0 += 2) {
    if (16 * m0 < d) {
      float part[2][2][4];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mm][rb][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          float x[4];
          v_frag<MODE, LD>(x, vt, vsc, kr0 + 8 * j, m0 + mm, lane);
          FragA fa;
          frag_a<Ru::kSplitKV>(fa, x);
          mma_passes<Ru::kSplitKV, Ru::kSplitP>(part[mm][0], fa, fb[j][0]);
          mma_passes<Ru::kSplitKV, Ru::kSplitP>(part[mm][1], fa, fb[j][1]);
        }
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[m0 + mm][rb][e] += part[mm][rb][e];
    }
  }
}

// o's rows (pv's layout) times the factors f of dots' rows v[0], v[1]
template <int NM>
__device__ __forceinline__ void scale_rows(float (&o)[NM][2][4],
                                           const float (&v)[2], int lane) {
  float f[2][2];
  to_pv_rows(v, lane, f);
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        o[m][rb][u] *= f[rb][u];
        o[m][rb][u + 2] *= f[rb][u];
      }
}

// Element (row, column) of a query row's output, at window slot rg % s_q
// of query head hk * group + rg / s_q
__device__ __forceinline__ int64_t out_at(const PagedArgs& a, int bi, int hk,
                                          int rg) {
  const int group = a.h / a.hkv;
  return (((int64_t)bi * a.s_q + rg % a.s_q) * a.h + hk * group +
          rg / a.s_q) * a.d;
}

// ---------------------------------------------------------------------------
// few rows: decode (B3, B4; over int8 pages B7 at s_q = 1 and B9) and
// windows of <= 16 rows per kv head (B5; over int8 pages B7 windows)
// ---------------------------------------------------------------------------

// Shared memory of the few-rows kernel: the ring (kRingSlots slots of one
// K or V tile, with its keys' scales over int8 pages; at the end of the
// split it holds the warps' (O, l, m), then the last CTA's merge weights),
// the f32 Q tile, the split's page ids.
template <int MODE, int DP>
struct RowsLayout {
  static constexpr int kQLd = q_ld<DP>();
  static constexpr int kMerge = (4 * kRowsTile * kQLd + 5 * kRowsTile) * 4;
  static constexpr int kWeights = kRowsTile * kMaxSplits * 4;
  static constexpr int kRing =
      cmax(cmax(kRingSlots * Tile<MODE, DP>::kSlot, kMerge), kWeights);
  static constexpr int kQ = kRowsTile * kQLd * 4;
  static int bytes(int split_pages) { return kRing + kQ + split_pages * 4; }
};

// At DP = 256 each thread holds O's 128 accumulators, and the 3-slot ring
// of f32 tiles takes 200 KB: one CTA an SM.
template <int MODE, int DP>
__global__ void __launch_bounds__(kThreads, 2)
    paged_rows_f32_kernel(const PagedArgs a) {
  using Ru = Rule<MODE>;
  using Ti = Tile<MODE, DP>;
  using L = RowsLayout<MODE, DP>;
  constexpr int kNM = DP / 16;          // 16-column groups of O
  constexpr int kQLd = L::kQLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float tile_max[4][kRowsTile];
  __shared__ int last_arrival;
  unsigned char* ring = smem;
  float* Qs = reinterpret_cast<float*>(smem + L::kRing);
  int* pages = reinterpret_cast<int*>(smem + L::kRing + L::kQ);

  const int group = a.h / a.hkv;
  const int rows = group * a.s_q;  // query rows of a kv head
  const int n_rt = (rows + kRowsTile - 1) / kRowsTile;
  const int split = blockIdx.x;
  const int hk = blockIdx.y / n_rt, rt = blockIdx.y % n_rt;
  const int bi = blockIdx.z;
  const int length = a.lengths[bi];
  const int n_keys = seq_keys(a, bi);
  const int split_keys = a.split * a.page_size;
  // a sequence with no key still has one split, which writes zeros
  const int n_live = max(1, (n_keys + split_keys - 1) / split_keys);
  if (split >= n_live) return;
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, n_keys);
  const int n_tiles = max(0, (k_end - k_begin + kKeys - 1) / kKeys);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  const int p0 = split * a.split;
  const int n_pages = max(0, (k_end - k_begin + a.page_size - 1) /
                                 a.page_size);
  for (int i = tid; i < n_pages; i += kThreads) {
    pages[i] = a.tables[(int64_t)bi * a.pps + p0 + i];
  }
  load_q<MODE, kRowsTile, DP>(Qs, a, bi, hk, rt * kRowsTile, rows, tid);
  __syncthreads();  // the page ids (and Q) for every thread

  // this thread's two rows (dots' rows g and g + 8): position (-1 for a
  // row past the head's: it sees no key) and ALiBi slope
  int pos[2];
  float slope[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rg = rt * kRowsTile + g + 8 * r;
    const bool live = rg < rows;
    pos[r] = live ? length - a.s_q + rg % a.s_q : -1;
    slope[r] = (live && a.slopes) ? a.slopes[hk * group + rg / a.s_q] : 0.f;
  }

  // slot i of the ring's sequence: K_{i/2} (i even) or V_{i/2}, one commit
  // group each (empty past the split's tiles)
  auto issue = [&](int i) {
    if (i < 2 * n_tiles) {
      const bool value = i & 1;
      copy_tile<MODE, DP>(smem_addr(ring + (i % kRingSlots) * Ti::kSlot),
                      value ? a.v : a.k, value ? a.v_scales : a.k_scales, a,
                      pages, p0, k_begin + (i >> 1) * kKeys, k_end, hk, tid);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  const uint32_t qa = smem_addr(Qs) +
      (((lane & 7) + 8 * ((lane >> 3) & 1)) * kQLd + 4 * (lane >> 4)) * 4;
  const int kw = warp * 16;  // this warp's keys of every tile
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float o[kNM][2][4];
  tf32x3::zero(o);

  for (int j = 0; j < n_tiles; ++j) {
    // K_j: landed for all; every warp is done with V_{j-1}, whose slot
    // takes K_{j+1}
    cp_async_wait<1>();
    __syncthreads();
    issue(2 * j + 2);
    const unsigned char* kt = ring + ((2 * j) % kRingSlots) * Ti::kSlot;
    const float* ksc = reinterpret_cast<const float*>(kt + Ti::kTile);
    float s[2][4];
    qk<MODE, 2, Ti::kLd>(s, qa, kt, ksc, kw, a.d, lane);
    // scale (B7: times the key's k scale first), ALiBi, the mask, in the
    // log2 domain; the warp's max of each row over its 16 keys
    const int k0 = k_begin + j * kKeys + kw;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kc = 8 * jn + 2 * t + (e & 1);
        const int key = k0 + kc;
        float x = s[jn][e];
        if constexpr (Ru::kB7) x *= ksc[kw + kc];
        x = x * a.scale + slope[r] * (float)(key - pos[r]);
        x = (key < k_end && key <= pos[r]) ? x * kLog2e : kNegInf;
        s[jn][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = quad_max(mt[r]);
      if (t == 0) tile_max[warp][g + 8 * r] = mt[r];
    }
    // V_j, and every warp's tile max; K_j's slot takes V_{j+1}
    cp_async_wait<1>();
    __syncthreads();
    issue(2 * j + 3);
    const unsigned char* vt = ring + ((2 * j + 1) % kRingSlots) * Ti::kSlot;
    const float* vsc = reinterpret_cast<const float*>(vt + Ti::kTile);
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int w = 0; w < 4; ++w) mx = fmaxf(mx, tile_max[w][g + 8 * r]);
      alpha[r] = fast_exp2(m[r] - mx);
      m[r] = mx;
    }
    // p against the tile's running max; l sums the f32 p, P V takes it as
    // the rule rounds it
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            s[jn][e] == kNegInf ? 0.f : fast_exp2(s[jn][e] - m[r]);
        lsum[r] += p;
        if constexpr (Ru::kRoundP) {
          s[jn][e] = round_bf16(p);
        } else if constexpr (Ru::kB7) {
          s[jn][e] = round_bf16(p * vsc[kw + 8 * jn + 2 * t + (e & 1)]);
        } else {
          s[jn][e] = p;
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + lsum[r];
    scale_rows(o, alpha, lane);
    pv<MODE, 2, kNM, Ti::kLd>(o, s, vt, vsc, kw, a.d, lane);
  }
  cp_async_wait<0>();

  // the warps' (O, l) of the same 16 rows and the shared m, through the
  // ring: O summed in warp order, every warp's m being the same
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  __syncthreads();
  float* wo = reinterpret_cast<float*>(ring);           // [4][16][kQLd]
  float* wl = wo + 4 * kRowsTile * kQLd;                // [4][16]
  float* wm = wl + 4 * kRowsTile;                       // [16]
#pragma unroll
  for (int mm = 0; mm < kNM; ++mm)
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float* dst = wo + (warp * kRowsTile + 8 * rb + 2 * t + u) * kQLd +
                     16 * mm + 2 * g;
        *reinterpret_cast<float2*>(dst) =
            make_float2(o[mm][rb][u], o[mm][rb][u + 2]);
      }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wl[warp * kRowsTile + g + 8 * r] = l[r];
      if (warp == 0) wm[g + 8 * r] = m[r];
    }
  }
  __syncthreads();

  const bool single = n_live == 1;
  const int64_t head = (int64_t)bi * a.hkv + hk;
  const int n_splits = gridDim.x;
  float* ws_o = a.ws;
  float* ws_ml = single ? nullptr
                        : a.ws + (int64_t)a.b * a.hkv * n_splits * rows * a.d;
  for (int i = tid; i < kRowsTile * a.d; i += kThreads) {
    const int r = i / a.d, c = i % a.d;
    const int rg = rt * kRowsTile + r;
    if (rg >= rows) continue;
    float ov = 0.f, lv = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      ov += wo[(w * kRowsTile + r) * kQLd + c];
      lv += wl[w * kRowsTile + r];
    }
    if (single) {
      const float v = ov / (lv == 0.f ? 1.f : lv);
      if constexpr (Ru::kQBf16) {
        static_cast<__nv_bfloat16*>(a.out)[out_at(a, bi, hk, rg) + c] =
            __float2bfloat16(v);
      } else {
        static_cast<float*>(a.out)[out_at(a, bi, hk, rg) + c] = v;
      }
    } else {
      const int64_t wr = (head * n_splits + split) * rows + rg;
      ws_o[wr * a.d + c] = ov;
      if (c == 0) {
        ws_ml[wr * 2] = wm[r];
        ws_ml[wr * 2 + 1] = lv;
      }
    }
  }
  if (single) return;

  // count this split in; the last to arrive merges every live split, in
  // split order
  __threadfence();
  __syncthreads();
  int* counter = a.counters + head * n_rt + rt;
  if (tid == 0) last_arrival = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!last_arrival) return;
  __threadfence();
  // weights exp2(m_s - M) / L of each (row, split), in the ring
  float* wt = reinterpret_cast<float*>(ring);  // [16][n_live]
  if (tid < kRowsTile && rt * kRowsTile + tid < rows) {
    const int64_t r0 = head * n_splits * rows + rt * kRowsTile + tid;
    float mx = kNegInf;
    for (int sp = 0; sp < n_live; ++sp) {
      mx = fmaxf(mx, __ldcg(ws_ml + (r0 + (int64_t)sp * rows) * 2));
    }
    float lsum = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float f =
          exp2f(__ldcg(ws_ml + (r0 + (int64_t)sp * rows) * 2) - mx);
      wt[tid * n_live + sp] = f;
      lsum += __ldcg(ws_ml + (r0 + (int64_t)sp * rows) * 2 + 1) * f;
    }
    const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
    for (int sp = 0; sp < n_live; ++sp) wt[tid * n_live + sp] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < kRowsTile * a.d; i += kThreads) {
    const int r = i / a.d, c = i % a.d;
    const int rg = rt * kRowsTile + r;
    if (rg >= rows) continue;
    const int64_t r0 = head * n_splits * rows + rg;
    float ov = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      ov += __ldcg(ws_o + (r0 + (int64_t)sp * rows) * a.d + c) *
            wt[r * n_live + sp];
    }
    if constexpr (Ru::kQBf16) {
      static_cast<__nv_bfloat16*>(a.out)[out_at(a, bi, hk, rg) + c] =
          __float2bfloat16(ov);
    } else {
      static_cast<float*>(a.out)[out_at(a, bi, hk, rg) + c] = ov;
    }
  }
  if (tid == 0) *counter = 0;
}

// ---------------------------------------------------------------------------
// windows of more than 16 rows per kv head (B6, B8): attention_f32.cu's
// tile step over pages, keys split over CTAs
// ---------------------------------------------------------------------------

// Shared memory of the window kernel: the f32 Q tile (64 rows), one K
// tile (DP columns) and one V tile (the CTA's NC columns) in the page
// dtype (with their keys' scales over int8 pages), the split's page ids.
template <int MODE, int DP>
struct WindowLayout {
  static constexpr int NC = DP < kCols ? DP : kCols;  // O columns a CTA
  static constexpr int kHalves = DP / NC;
  using TK = Tile<MODE, DP>;
  using TV = Tile<MODE, NC>;
  static constexpr int kQLd = q_ld<DP>();
  static constexpr int kQ = kWindowRows * kQLd * 4;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + TK::kSlot;
  static constexpr int kPages = kV + TV::kSlot;
  static int bytes(int pps) { return kPages + pps * 4; }
};

// At DP = 256 a 64 x 256 f32 O would leave no registers for S and P, so
// each CTA owns one 128-column half of O (blockIdx.x % 2): both halves
// compute the same S and P (the same products in the same order, so p
// rounds alike in both), each reads its half of V.
template <int MODE, int DP>
__global__ void __launch_bounds__(kThreads, 2)
    paged_window_f32_kernel(const PagedArgs a) {
  using Ru = Rule<MODE>;
  using L = WindowLayout<MODE, DP>;
  using TK = typename L::TK;
  using TV = typename L::TV;
  static_assert(!Ru::kB7, "B7 windows take the few-rows kernel");
  constexpr int NJ = kKeys / 8;
  constexpr int kNM = L::NC / 16;       // 16-column groups of the CTA's O
  constexpr int kQLd = L::kQLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_arrival;
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* kt = smem + L::kK;
  unsigned char* vt = smem + L::kV;
  const float* ksc = reinterpret_cast<const float*>(kt + TK::kTile);
  const float* vsc = reinterpret_cast<const float*>(vt + TV::kTile);
  int* pages = reinterpret_cast<int*>(smem + L::kPages);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int group = a.h / a.hkv;
  const int rows = group * a.s_q;
  const int n_rt = (rows + kWindowRows - 1) / kWindowRows;
  // blockIdx.x = (kv head x row tile) x column half
  const int unit = blockIdx.x / L::kHalves, half = blockIdx.x % L::kHalves;
  const int hk = unit / n_rt, rt = unit % n_rt;
  const int col0 = half * L::NC;
  const int bi = blockIdx.y;
  const int split = blockIdx.z;
  const int r0 = rt * kWindowRows;
  const int length = a.lengths[bi];
  const int n_keys = seq_keys(a, bi);

  // the sequence's 64-key tiles cut into at most gridDim.z runs of `per`
  // (a sequence with no key still has one split, which writes zeros)
  const int seq_tiles = (n_keys + kKeys - 1) / kKeys;
  const int per = max(1, (seq_tiles + (int)gridDim.z - 1) / (int)gridDim.z);
  const int n_live = max(1, (seq_tiles + per - 1) / per);
  if (split >= n_live) return;
  // the row tile's last window slot bounds the keys it sees
  const int r1 = min(r0 + kWindowRows, rows) - 1;
  const int t_max = r1 - r0 + 1 >= a.s_q || r0 % a.s_q > r1 % a.s_q
                        ? a.s_q - 1
                        : r1 % a.s_q;
  const int key_end = max(0, min(n_keys, length - a.s_q + t_max + 1));
  const int k_begin = split * per * kKeys;
  const int k_end = min(k_begin + per * kKeys, key_end);
  const int n_tiles = max(0, (k_end - k_begin + kKeys - 1) / kKeys);

  const int p0 = k_begin / a.page_size;
  const int n_pages =
      k_end > k_begin ? (k_end - 1) / a.page_size - p0 + 1 : 0;
  for (int i = tid; i < n_pages; i += kThreads) {
    pages[i] = a.tables[(int64_t)bi * a.pps + p0 + i];
  }
  load_q<MODE, kWindowRows, DP>(Qs, a, bi, hk, r0, rows, tid);
  __syncthreads();  // the page ids for the copies, Q for the products

  // this thread's two rows (dots' rows g and g + 8 of its warp): position
  // and ALiBi slope; a row past the head's masks nothing and is not written
  int pos[2];
  float slope[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rg = r0 + 16 * warp + g + 8 * r;
    const bool live = rg < rows;
    pos[r] = live ? length - a.s_q + rg % a.s_q : 1 << 30;
    slope[r] = (live && a.slopes) ? a.slopes[hk * group + rg / a.s_q] : 0.f;
  }
  // the warp's first position: its tiles wholly below it need no mask
  const int warp_pos = __reduce_min_sync(0xffffffffu, min(pos[0], pos[1]));

  auto copy = [&](int j, bool value) {
    if (value) {
      copy_tile<MODE, L::NC>(smem_addr(vt), a.v, a.v_scales, a, pages, p0,
                             k_begin + j * kKeys, k_end, hk, tid, col0);
    } else {
      copy_tile<MODE, DP>(smem_addr(kt), a.k, a.k_scales, a, pages, p0,
                          k_begin + j * kKeys, k_end, hk, tid);
    }
  };
  if (n_tiles > 0) copy(0, false);
  cp_async_commit();
  if (n_tiles > 0) copy(0, true);
  cp_async_commit();

  const uint32_t qa = smem_addr(Qs) +
      (((16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * kQLd) +
       4 * (lane >> 4)) * 4;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums
  float o[kNM][2][4];
  tf32x3::zero(o);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * kKeys;
    cp_async_wait<1>();
    __syncthreads();  // K_j
    float s[NJ][4];
    qk<MODE, NJ, TK::kLd>(s, qa, kt, ksc, 0, a.d, lane);
    __syncthreads();  // every warp is done with K_j
    if (j + 1 < n_tiles) copy(j + 1, false);
    cp_async_commit();
    // the mask, only where a key of the tile may be past the split's end
    // or past a row's position
    const bool edge = k0 + kKeys > k_end || k0 + kKeys - 1 > warp_pos;
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * jn + 2 * t + e;
          float x = s[jn][2 * r + e] * a.scale +
                    slope[r] * (float)(key - pos[r]);
          x *= kLog2e;
          if (edge && !(key < k_end && key <= pos[r])) x = kNegInf;
          s[jn][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(m[r], quad_max(mx));
      alpha[r] = fast_exp2(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[jn][2 * r + e];
          const float p = x == kNegInf ? 0.f : fast_exp2(x - mx);
          sum += p;
          s[jn][2 * r + e] = Ru::kRoundP ? round_bf16(p) : p;
        }
      l[r] = l[r] * alpha[r] + sum;
    }
    scale_rows(o, alpha, lane);
    cp_async_wait<1>();
    __syncthreads();  // V_j
    pv<MODE, NJ, kNM, TV::kLd>(o, s, vt, vsc, 0, a.d - col0, lane);
    __syncthreads();  // every warp is done with V_j
    if (j + 1 < n_tiles) copy(j + 1, true);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  // More than one split: each writes its unnormalized O and its rows' (m,
  // l) to the workspace in fragment order (a thread's accumulators as
  // float4s, kThreads apart), counts itself in, and the last to arrive
  // merges every split, its own included, in split order with the LSE
  // rescale. The order must not depend on which split arrives last.
  const bool direct = n_live == 1;
  // one counter and one run of workspace blobs a (sequence, kv head, row
  // tile, column half)
  const int64_t cta0 =
      (((int64_t)bi * a.hkv + hk) * n_rt + rt) * L::kHalves + half;
  int* counter = a.counters + cta0;
  if (!direct) {
    const int64_t blob0 = cta0 * gridDim.z;  // split 0's
    float4* ws_o = reinterpret_cast<float4*>(a.ws);
    float4* ws_ml = ws_o + (int64_t)a.b * a.hkv * n_rt * L::kHalves *
                               gridDim.z * kThreads * (2 * kNM);
#pragma unroll
    for (int mm = 0; mm < kNM; ++mm)
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
        ws_o[((blob0 + split) * (2 * kNM) + 2 * mm + rb) * kThreads + tid] =
            make_float4(o[mm][rb][0], o[mm][rb][1], o[mm][rb][2],
                        o[mm][rb][3]);
      }
    ws_ml[(blob0 + split) * kThreads + tid] =
        make_float4(m[0], m[1], l[0], l[1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last_arrival = atomicAdd(counter, 1) == n_live - 1;
    __syncthreads();
    if (!last_arrival) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
    tf32x3::zero(o);
    for (int sp = 0; sp < n_live; ++sp) {
      const float4 ml = __ldcg(ws_ml + (blob0 + sp) * kThreads + tid);
      const float ms[2] = {ml.x, ml.y}, ls[2] = {ml.z, ml.w};
      float fa[2], fb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = fmaxf(m[r], ms[r]);
        fa[r] = exp2f(m[r] - mx);
        fb[r] = exp2f(ms[r] - mx);
        l[r] = l[r] * fa[r] + ls[r] * fb[r];
        m[r] = mx;
      }
      float pa[2][2], pb[2][2];
      to_pv_rows(fa, lane, pa);
      to_pv_rows(fb, lane, pb);
#pragma unroll
      for (int mm = 0; mm < kNM; ++mm)
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
          const float4 x = __ldcg(
              ws_o + ((blob0 + sp) * (2 * kNM) + 2 * mm + rb) * kThreads +
              tid);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[mm][rb][e] = o[mm][rb][e] * pa[rb][e & 1] +
                           xs[e] * pb[rb][e & 1];
          }
        }
    }
  }
  // normalized out in q's dtype (a row that saw no key writes 0)
  float lrow[2][2];
  to_pv_rows(l, lane, lrow);
#pragma unroll
  for (int rb = 0; rb < 2; ++rb)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rg = r0 + 16 * warp + 8 * rb + 2 * t + u;
      if (rg >= rows) continue;
      const float inv = lrow[rb][u] > 0.f ? 1.f / lrow[rb][u] : 0.f;
      const int64_t at = out_at(a, bi, hk, rg);
#pragma unroll
      for (int mm = 0; mm < kNM; ++mm) {
        const int col = col0 + 16 * mm + 2 * g;
        if (col < a.d) {
          const float x0 = o[mm][rb][u] * inv, x1 = o[mm][rb][u + 2] * inv;
          if constexpr (Ru::kQBf16) {
            *reinterpret_cast<__nv_bfloat162*>(
                static_cast<__nv_bfloat16*>(a.out) + at + col) =
                __floats2bfloat162_rn(x0, x1);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at +
                                       col) = make_float2(x0, x1);
          }
        }
      }
    }
  if (!direct && tid == 0) *counter = 0;
}

template <int MODE, int DP>
cudaError_t launch_rows(const PagedArgs& a, cudaStream_t s) {
  const int rows = a.h / a.hkv * a.s_q;
  const dim3 grid((a.pps + a.split - 1) / a.split,
                  a.hkv * ((rows + kRowsTile - 1) / kRowsTile), a.b);
  return launch_grid(paged_rows_f32_kernel<MODE, DP>, grid, kThreads,
                     RowsLayout<MODE, DP>::bytes(a.split), a, s);
}

// Grid ((kv heads x row tiles) x column halves, sequences, key splits):
// the splits vary slowest, so the CTAs of the first split, all live, are
// dispatched first.
template <int MODE, int DP>
cudaError_t launch_window(const PagedArgs& a, cudaStream_t s) {
  using L = WindowLayout<MODE, DP>;
  const int rows = a.h / a.hkv * a.s_q;
  const dim3 grid(
      a.hkv * ((rows + kWindowRows - 1) / kWindowRows) * L::kHalves, a.b,
      a.split);
  return launch_grid(paged_window_f32_kernel<MODE, DP>, grid, kThreads,
                     L::bytes(a.pps), a, s);
}

template <int MODE, int DP>
cudaError_t launch_dp(const PagedArgs& a, bool few_rows, cudaStream_t s) {
  if constexpr (Rule<MODE>::kB7) {
    return few_rows ? launch_rows<MODE, DP>(a, s) : cudaErrorInvalidValue;
  } else {
    return few_rows ? launch_rows<MODE, DP>(a, s)
                    : launch_window<MODE, DP>(a, s);
  }
}

// the DP = 128 form up to d = 128, the DP = 256 one past it
template <int MODE>
cudaError_t launch(const PagedArgs& a, bool few_rows, cudaStream_t s) {
  return a.d <= 128 ? launch_dp<MODE, 128>(a, few_rows, s)
                    : launch_dp<MODE, 256>(a, few_rows, s);
}

// The launch's shape and splits: whole query groups, d a multiple of 8 up
// to 256, every kv head's scale lane inside the scale row; the few-rows
// kernel's splits at least one page each, at most kMaxSplits, the window
// kernel's 1 to kWindowMaxSplits with a table row whose page ids fit
// shared memory; a workspace and counters where there may be more than
// one split.
bool bad_launch(int b, int s_q, int h, int hkv, int d, int page_size,
                int pps, int s_lanes, bool q8, int split, bool few_rows,
                const void* ws, const void* counters) {
  if (b < 1 || s_q < 1 || hkv < 1 || h % hkv || d % 8 || d > kMaxDP ||
      page_size < 1 || pps < 1 || split < 1 || (q8 && s_lanes < hkv)) {
    return true;
  }
  const int splits = few_rows ? (pps + split - 1) / split : split;
  if (few_rows ? splits > kMaxSplits
               : (splits > kWindowMaxSplits || pps > kWindowMaxPages)) {
    return true;
  }
  return splits > 1 && (ws == nullptr || counters == nullptr);
}

}  // namespace paged_f32
}  // namespace merlin

// Paged attention at every (q, pages) pair but bf16 q over bf16 or int8
// pages: q_bf16 says q / out are bf16 (over f32 pages only), page_kind
// 0/1/2 bf16/f32/int8 pages (int8 with their scale pages), bf16_ops B7's
// rule over int8 pages (few rows only). few_rows = 1: the few-rows kernel,
// `split` pages a key split; 0: the window kernel, at most `split` key
// splits of a sequence. Either takes the workspace and counters where it
// may split. Returns cudaGetLastError() after the launch.
extern "C" int merlin_paged_attention_f32(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* tables, const void* slopes, void* out, void* ws,
    void* counters, int b, int s_q, int h, int hkv, int d, int page_size,
    int pps, int scale_lanes, int q_bf16, int page_kind, int bf16_ops,
    int split, int few_rows, float scale, void* stream) {
  using namespace merlin::paged_f32;
  const bool q8 = page_kind == kPagesInt8;
  int mode;
  if (q_bf16) {
    mode = page_kind == kPagesF32 ? kQbf16F32 : -1;
  } else if (page_kind == kPagesBf16) {
    mode = kQf32Bf16;
  } else if (page_kind == kPagesF32) {
    mode = kQf32F32;
  } else if (q8) {
    mode = bf16_ops ? kQf32Int8B7 : kQf32Int8;
  } else {
    mode = -1;
  }
  if (mode < 0 || (bf16_ops && !q8) ||
      bad_launch(b, s_q, h, hkv, d, page_size, pps, scale_lanes, q8, split,
                 few_rows, ws, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  PagedArgs a;
  a.q = q;
  a.k = k_pages;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v = v_pages;
  a.v_scales = static_cast<const float*>(v_scales);
  a.lengths = static_cast<const int*>(lengths);
  a.tables = static_cast<const int*>(tables);
  a.slopes = static_cast<const float*>(slopes);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.b = b; a.s_q = s_q; a.h = h; a.hkv = hkv; a.d = d;
  a.page_size = page_size; a.pps = pps; a.s_lanes = scale_lanes;
  a.s_stride = (q8 && scale_lanes / hkv > 1) ? scale_lanes / hkv : 1;
  a.split = split;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool few = few_rows != 0;
  switch (mode) {
    case kQf32Bf16: return static_cast<int>(launch<kQf32Bf16>(a, few, s));
    case kQbf16F32: return static_cast<int>(launch<kQbf16F32>(a, few, s));
    case kQf32F32: return static_cast<int>(launch<kQf32F32>(a, few, s));
    case kQf32Int8: return static_cast<int>(launch<kQf32Int8>(a, few, s));
    default: return static_cast<int>(launch<kQf32Int8B7>(a, few, s));
  }
}
