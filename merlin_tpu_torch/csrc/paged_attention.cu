// Paged attention over a head-packed KV pool, for Hopper (sm_90a).
//
// Replaces merlin_tpu/ops/paged_attention.py:
//   * paged decode (merlin_paged_decode_bf16) for B3 _paged_dma_kernel
//     (paged_attention_dma, pallas_call :365) and B4 _paged_kernel
//     (paged_attention, pallas_call :143): one query token per sequence,
//     keys at positions < lengths[b], optional per-query-head ALiBi
//     slope * (k - (len - 1)), GQA by group = h / hkv (any group);
//   * paged window (merlin_paged_window_bf16) for B5 _paged_dma_multi_kernel
//     (paged_attention_dma_multi, pallas_call :631) and B6
//     _paged_multi_blocked_kernel (paged_attention_multi_blocked, pallas_call
//     :772): s_q queries per sequence, lengths INCLUDE the window, row t sits
//     at length - s_q + t and sees keys <= that position, optional ALiBi
//     slope * (k - q_pos), GQA.
// and the same over int8 pages:
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
// hkv = 1). Query head hk * group + g reads kv head hk. A row that sees no
// key writes 0, as the JAX finalize (l == 0 -> 1) does.
//
// Two kernels:
//   * paged_rows_kernel, the few-rows kernel: decode (B3, B4, B7 at s_q =
//     1, B9) and windows of <= 16 query rows per kv head (B5, B7 windows);
//   * paged_window_kernel, the mma.sync tile engine of attention_core.cuh
//     over paged K/V in 64-row tiles, each warp 16 rows, the block walking
//     every key once: prefill windows (B6, B8).
// Neither reads a table entry, a length or a page past a sequence's own (the
// TPU kernels' prefetch predicate reads lengths[b] one past the end on
// their last grid step: trap C8), and the ragged last page is masked by
// position, not by padding.
//
// What bounds them on the H100: the K/V bytes. Decode does 4 FLOP per key
// per head dim for each query row of a kv head against 4 bytes of K+V per
// key per head dim (bf16): group FLOP per byte, 1 at Vicuna's MHA, far below
// the ~295 FLOP/byte ridge. At Vicuna-7B (hkv = 32, d = 128), 4 slots of
// ~2k tokens read ~134 MB: ~40 us at 3.35 TB/s. A 5-row verify window does 5
// FLOP per byte, a 128-row prefill window 128: bytes again. int8 pages halve
// the K/V bytes and add 8 bytes of scales per (key, kv head): 264 bytes per
// key per head at d = 128 instead of 512.
//
// Design of paged_rows_kernel (what each choice does about the bytes):
//   * Keys split over CTAs. The grid is (key splits, kv head x 16-row tile
//     of the head's group * s_q rows, sequence); a split is a whole number
//     of pages, split_pages * page_size keys (~256, set by the wrapper).
//     The host knows only the table's capacity, so the grid covers it, and
//     a CTA whose split starts past its sequence's keys exits at once. A
//     2k-token sequence is then read by 8 CTAs per kv head at once instead
//     of by one, and the card's SMs all stream. 128- and 512-key splits
//     were each slower on some of the serving shapes (PERF.md).
//   * A CTA copies its split's slice of the table row to shared memory
//     once; no key waits on a table read.
//   * K and V stream through a 2-stage cp.async ring of 64-key tiles: 16-
//     byte copies (8-byte ones for int8 where d % 16 != 0), plus each key's
//     4-byte scale lane, neighbouring threads on neighbouring bytes of a
//     key's d-wide slice of its pool row. The next tile is in flight while
//     one is multiplied; one block barrier per tile. At d = 128 a bf16 stage
//     is 34 KB, so three CTAs fit an SM. A third stage (two CTAs an SM) ran
//     1.06-1.16x slower over bf16 pages and 1.18-1.33x over int8, a fourth
//     up to 1.6x (merlin_tpu_torch/utils/ablate_paged.py, PERF.md): more
//     CTAs in flight beat a deeper ring here, where each CTA walks 4 tiles.
//   * Tensor-core tiles of 16 rows: S = Q K^T and O += P V on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), Q's fragments in
//     registers for the whole split. Decode at group 1 pads 1 row to 16,
//     which costs no time while bytes bound it. (wgmma needs 64 rows: 4x to
//     64x padding here, for no gain.) Each of the 4 warps takes 16 keys of
//     every tile, so no warp waits on another's keys; they merge their (m,
//     l, O) once, through shared memory, at the end of the split. V's
//     fragments come from ldmatrix.trans. int8 K and V are dequantized
//     from shared memory into the fragments: ldmatrix reads their bytes in
//     pairs as b16 (so a thread holds 4 consecutive head dims of a key, and
//     Q's fragments take the same order of the contraction; V's columns
//     come interleaved, and O is written back in that order), and a byte
//     permute and one FADD make each int8 an exact float where I2F runs at
//     a quarter rate. Over byte loads and I2F this took B7's decode from
//     0.0311 to 0.0269 ms (PERF.md).
//   * Masks only where they can bite: a warp compares keys with lengths
//     and query positions only on a tile that reaches past the keys every
//     row sees (the sequence's last tile, a window's causal edge). ALiBi
//     adds its bias on every tile.
//   * The splits combine in the same launch: each live split writes its
//     live rows' m, l and unnormalised f32 O to a workspace, fences, and
//     counts itself in on a counter of its (sequence, kv head, row tile);
//     the CTA that arrives last merges the splits with the LSE rescale,
//     writes bf16 out and sets the counter back to 0. A split whose rows
//     see no key brings m = NEG_INF, l = 0 and merges to nothing. A
//     sequence with one live split writes out directly. The counters live
//     across launches (zeroed once by the wrapper, left at 0 by the kernel):
//     two streams must not share them, and the port runs one.
//
// Numerics: scores are f32 from bf16 products, scaled in f32 and
// exponentiated in the log2 domain; p is rounded to bf16 for P V, as B4's
// TPU kernel does (p.astype(v.dtype)) and as B2 does, while l sums the f32
// p; masked scores take the finite NEG_INF and masked p is 0. int8 values
// are dequantized as dequantize_pages does: (float)x * scale, rounded to
// bf16 once. B7's TPU kernel instead multiplies the f32 scores by the k
// scale and p by the v scale: the two orders differ by at most a bf16 ulp of
// K or of p * scale, and this one is the plain version's.

#include <type_traits>

#include "hopper.cuh"

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
  // few-rows kernel, more than one split: per split and live row, O (b,
  // hkv, splits, rows, d) then (m, l) (b, hkv, splits, rows, 2), f32
  float* ws;
  int* counters;  // (b, hkv, row tiles), 0 between launches
  int b, s_q, h, hkv, d, page_size, pps, s_lanes, s_stride, split_pages;
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
// few rows: decode (B3, B4; over int8 pages B7 at s_q = 1 and B9) and
// windows of <= 16 rows per kv head (B5; over int8 pages B7 windows)
// ---------------------------------------------------------------------------

constexpr int kRowsThreads = 128;  // 4 warps, 16 keys of every tile each
constexpr int kRowsKeys = 64;      // keys per ring stage
constexpr int kRowsStages = 2;
constexpr int kMaxSplits = 256;    // the last CTA's merge weights fit smem

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0) : "memory");
}

// wait until at most N of this thread's committed cp.async groups are in
// flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory, transposed: lane i gives the
// address of row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Shared memory of the few-rows kernel: a ring of kRowsStages stages, each
// a K tile, a V tile (64 keys, rows kLd elements apart) and, over int8
// pages, the 64 keys' K and V scales; then the Q tile (16 rows) and the
// split's page ids. At the end of the split the ring holds the warps' (m,
// l, O) for their merge, then the last CTA's merge weights.
template <int DP, bool Q8>
struct RowsLayout {
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  static constexpr int kLd = Q8 ? DP + 16 : DP + 8;  // staggers the banks
  static constexpr int kTile = kRowsKeys * kLd * (int)sizeof(T);
  static constexpr int kScales = Q8 ? kRowsKeys * 4 : 0;
  static constexpr int kStage = 2 * (kTile + kScales);
  static constexpr int kRing = kRowsStages * kStage;
  static constexpr int kQLd = DP + 8;
  static constexpr int kQ = 16 * kQLd * 2;
  static constexpr int kOLd = DP + 4;  // the warps' O rows, f32
  static_assert((4 * 16 * 2 + 4 * 16 * kOLd) * 4 <= kRing,
                "the warps' merge must fit the ring");
  static_assert(16 * kMaxSplits * 4 <= kRing,
                "the splits' merge weights must fit the ring");
  static int bytes(int split_pages) { return kRing + kQ + split_pages * 4; }
};

// four 8x8 b16 matrices from shared memory: lane i gives the address of
// row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Byte K of the four int8 in x, as an exact float, given xu = x ^
// 0x80808080: the bits 0x4B0000uu are 2^23 + x_K + 128. An integer byte
// permute and one FADD, where a conversion would take the quarter-rate
// I2F.
template <int K>
__device__ __forceinline__ float i8_float(uint32_t xu) {
  return __int_as_float(__byte_perm(xu, 0x4B000000u, 0x7650 | K)) -
         8388736.f;
}

// Two int8 of xu (bytes K0 and K1) dequantized with their scales, each
// (float)x * scale rounded to bf16 once, as a bf16x2 fragment register
template <int K0, int K1>
__device__ __forceinline__ uint32_t dequant2(uint32_t xu, float s0,
                                             float s1) {
  return pack_bf16(i8_float<K0>(xu) * s0, i8_float<K1>(xu) * s1);
}

template <int DP, bool Q8>
__global__ void __launch_bounds__(kRowsThreads)
    paged_rows_kernel(const PagedArgs a) {
  using L = RowsLayout<DP, Q8>;
  using T = typename L::T;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_arrival;
  unsigned char* ring = smem;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kRing);
  int* pages = reinterpret_cast<int*>(smem + L::kRing + L::kQ);

  const int group = a.h / a.hkv;
  const int rows = group * a.s_q;  // query rows of a kv head, row g * s_q + t
  const int n_rt = (rows + 15) / 16;
  const int split = blockIdx.x;
  const int hk = blockIdx.y / n_rt, rt = blockIdx.y % n_rt;
  const int bi = blockIdx.z;
  const int length = a.lengths[bi];
  const int n_keys = seq_keys(a, bi);
  const int split_keys = a.split_pages * a.page_size;
  // a sequence with no key still has one split, which writes zeros
  const int n_live = max(1, (n_keys + split_keys - 1) / split_keys);
  if (split >= n_live) return;
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, n_keys);
  const int n_tiles = max(0, (k_end - k_begin + kRowsKeys - 1) / kRowsKeys);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  // the split's page ids, and the Q tile (rows past the head's, columns
  // past d: zeros)
  const int n_pages =
      max(0, (k_end - k_begin + a.page_size - 1) / a.page_size);
  for (int i = tid; i < n_pages; i += kRowsThreads) {
    pages[i] = a.tables[(int64_t)bi * a.pps + split * a.split_pages + i];
  }
  for (int i = tid; i < 16 * DP / 8; i += kRowsThreads) {
    const int r = i / (DP / 8), c = (i % (DP / 8)) * 8;
    const int rg = rt * 16 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rg < rows && c < a.d) {
      val = ld128(a.q + (((int64_t)bi * a.s_q + rg % a.s_q) * a.h +
                         hk * group + rg / a.s_q) * a.d + c);
    }
    *reinterpret_cast<uint4*>(qs + r * L::kQLd + c) = val;
  }
  __syncthreads();

  const int64_t row_elems = (int64_t)a.hkv * a.d;
  const T* kpool = static_cast<const T*>(a.k);
  const T* vpool = static_cast<const T*>(a.v);
  // tile j of the split into its stage: each key's d columns (and its scale
  // lanes), keys past the split's end and columns past d zero-filled
  auto load_tile = [&](int j) {
    const uint32_t kdst = smem_addr(ring + (j % kRowsStages) * L::kStage);
    const uint32_t vdst = kdst + L::kTile;
    const int k0 = j * kRowsKeys;  // within the split
    // W-byte copies of a key's d columns: 16 bytes (8 bf16, or 16 int8
    // where d % 16 == 0), else 8 (8 int8: a head's int8 slice is only
    // 8-byte aligned when d % 16 != 0)
    auto copy_rows = [&](auto width) {
      constexpr int kW = decltype(width)::value;
      constexpr int kCols = kW / (int)sizeof(T);
      constexpr int kChunks = DP / kCols;
      static_assert(kRowsKeys * kChunks % kRowsThreads == 0, "whole passes");
#pragma unroll
      for (int n = 0; n < kRowsKeys * kChunks / kRowsThreads; ++n) {
        const int i = tid + n * kRowsThreads;
        const int r = i / kChunks, c = (i % kChunks) * kCols;
        const int key = k0 + r;
        const bool ok = k_begin + key < k_end && c < a.d;
        int64_t off = 0;
        if (ok) {
          off = ((int64_t)pages[key / a.page_size] * a.page_size +
                 key % a.page_size) * row_elems + hk * a.d + c;
        }
        const uint32_t so = (r * L::kLd + c) * (int)sizeof(T);
        if constexpr (kW == 16) {
          cp_async16(kdst + so, kpool + off, ok);
          cp_async16(vdst + so, vpool + off, ok);
        } else {
          cp_async8(kdst + so, kpool + off, ok);
          cp_async8(vdst + so, vpool + off, ok);
        }
      }
    };
    if (!Q8 || a.d % 16 == 0) {
      copy_rows(std::integral_constant<int, 16>());
    } else {
      copy_rows(std::integral_constant<int, 8>());
    }
    if constexpr (Q8) {
      // thread i < 64: key i's K scale; 64 + i: its V scale
      const int key = k0 + tid % kRowsKeys;
      const bool ok = k_begin + key < k_end;
      int64_t off = 0;
      if (ok) {
        off = ((int64_t)pages[key / a.page_size] * a.page_size +
               key % a.page_size) * a.s_lanes + (int64_t)hk * a.s_stride;
      }
      const float* src = (tid < kRowsKeys ? a.k_scales : a.v_scales) + off;
      cp_async4(vdst + L::kTile + tid * 4, src, ok);
    }
  };

  // Q's A fragments, for the whole split. Over int8 pages the K fragments
  // come from ldmatrix as four consecutive head dims a thread (the int8
  // pairs of a key row read as b16), so the contraction's k = 2t + e is
  // head dim 4t + e and k = 2t + 8 + e is 4t + 2 + e, in Q as in K.
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* qr = qs + g * L::kQLd + kk * 16 + t * (Q8 ? 4 : 2);
    constexpr int kHi = Q8 ? 2 : 8;  // where k = 2t + 8 lies in the row
    qf[kk][0] = ld32(qr);
    qf[kk][1] = ld32(qr + 8 * L::kQLd);
    qf[kk][2] = ld32(qr + kHi);
    qf[kk][3] = ld32(qr + 8 * L::kQLd + kHi);
  }
  // this thread's two rows: fragment rows g and g + 8
  int pos[2];
  float slope[2];  // ALiBi slope in the log2 domain, 0 without
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rg = rt * 16 + g + 8 * r;
    pos[r] = length - a.s_q + rg % a.s_q;
    slope[r] = (a.slopes != nullptr && rg < rows)
                   ? a.slopes[hk * group + rg / a.s_q] * kLog2e
                   : 0.f;
  }
  // keys of the split below this one are visible to every row (no
  // per-key mask); a tile's keys past the split's end are masked, not
  // only zero-filled
  const int open_end = min(k_end, length - a.s_q + 1);
  const float scale2 = a.scale * kLog2e;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < kRowsStages - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }
  const int kw = warp * 16;  // this warp's keys of every tile
  // ldmatrix: lane i addresses row i % 8 of matrix i / 8, the tile's key
  // kw + (i / 8 % 2) * 8 + i % 8 at byte (i / 16) * 16 of a column block
  const int lane_off =
      (kw + ((lane >> 3) & 1) * 8 + (lane & 7)) * L::kLd * (int)sizeof(T) +
      (lane >> 4) * 16;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kRowsStages - 2>();
    __syncthreads();  // tile j landed for all; all are done with tile j - 1
    if (j + kRowsStages - 1 < n_tiles) load_tile(j + kRowsStages - 1);
    cp_async_commit();
    const unsigned char* ks = ring + (j % kRowsStages) * L::kStage;
    const unsigned char* vs = ks + L::kTile;
    const float* kscale = reinterpret_cast<const float*>(vs + L::kTile);
    const float* vscale = kscale + kRowsKeys;
    const int k0 = k_begin + j * kRowsKeys + kw;  // the warp's first key

    // S = Q K^T: 16 rows x the warp's 16 keys (two n-tiles of 8)
    float s[2][4];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
      s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
    }
    if constexpr (Q8) {
      // int8 K by ldmatrix, two k-steps a call: matrices 0/1 are n-tiles
      // 0/1 of k-step kk, 2/3 those of kk + 1; each register holds a key's
      // 4 head dims 4t.. of its k-step
      const uint32_t kaddr = smem_addr(ks) + lane_off;
      const float ks0 = kscale[kw + g], ks1 = kscale[kw + 8 + g];
#pragma unroll
      for (int kk = 0; kk < DP / 16; kk += 2) {
        if (kk * 16 < a.d) {
          uint32_t x[4];
          ldmatrix_x4(x, kaddr + kk * 16);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t xu = x[q] ^ 0x80808080u;
            const float sc = q & 1 ? ks1 : ks0;
            mma_16816(s[q & 1], qf[kk + q / 2], dequant2<0, 1>(xu, sc, sc),
                      dequant2<2, 3>(xu, sc, sc));
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk * 16 < a.d) {
#pragma unroll
          for (int jn = 0; jn < 2; ++jn) {
            const __nv_bfloat16* kr = reinterpret_cast<const __nv_bfloat16*>(
                                          ks) +
                                      (kw + jn * 8 + g) * L::kLd + kk * 16 +
                                      t * 2;
            mma_16816(s[jn], qf[kk], ld32(kr), ld32(kr + 8));
          }
        }
      }
    }

    // scale (+ bias) in the log2 domain, the mask where it can bite, and
    // the online softmax over the warp's keys
    const bool open = k0 + 16 <= open_end;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + jn * 8 + t * 2 + (e & 1);
        float x = s[jn][e] * scale2 + slope[r] * (float)(key - pos[r]);
        if (!open && !(key < k_end && key <= pos[r])) x = kNegInf;
        s[jn][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[jn][e] == kNegInf ? 0.f : exp2f(s[jn][e] - m[r]);
        s[jn][e] = p;
        lsum[r] += p;
      }
    }
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];

    // O += P V over the warp's 16 keys: S's accumulators are P's A fragment
    const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }
    // V by ldmatrix, transposed (the addresses of K's), a block of columns
    // a call: matrices 0/1 give b0/b1 of its first 16 bytes' columns, 2/3
    // of the next 16's
    const uint32_t vaddr = smem_addr(vs) + lane_off;
    if constexpr (Q8) {
      // a 32-column block: each register holds int8 columns 2g, 2g + 1 of
      // keys 2t, 2t + 1 (+ 8), so o[4q + x] accumulates block q's columns
      // 16 (x / 2) + 2n + x % 2 (n the fragment column)
      const float* vsc = vscale + kw + t * 2;
      const float s0 = vsc[0], s1 = vsc[1], s8 = vsc[8], s9 = vsc[9];
#pragma unroll
      for (int q = 0; q < DP / 32; ++q) {
        if (q * 32 < a.d) {
          uint32_t x[4];
          ldmatrix_x4_trans(x, vaddr + q * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t lo = x[2 * h] ^ 0x80808080u;
            const uint32_t hi = x[2 * h + 1] ^ 0x80808080u;
            mma_16816(o[4 * q + 2 * h], pf, dequant2<0, 2>(lo, s0, s1),
                      dequant2<0, 2>(hi, s8, s9));
            mma_16816(o[4 * q + 2 * h + 1], pf, dequant2<1, 3>(lo, s0, s1),
                      dequant2<1, 3>(hi, s8, s9));
          }
        }
      }
    } else {
      // 16 bf16 columns a call: matrices 0/1 are b0/b1 of n-tile dn, 2/3
      // those of dn + 1
#pragma unroll
      for (int dn = 0; dn < DP / 8; dn += 2) {
        if (dn * 8 < a.d) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vaddr + dn * 8 * 2);
          mma_16816(o[dn], pf, b[0], b[1]);
          mma_16816(o[dn + 1], pf, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // merge the 4 warps' (m, l, O) of the same 16 rows through the ring
  __syncthreads();
  float* wm = reinterpret_cast<float*>(ring);  // [4][16]
  float* wl = wm + 4 * 16;                     // [4][16]
  float* wo = wl + 4 * 16;                     // [4][16][kOLd]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int wr = warp * 16 + g + 8 * r;
    if (t == 0) {
      wm[wr] = m[r];
      wl[wr] = l[r];
    }
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      if constexpr (Q8) {  // fragment column n of o[dn]: see the V loop
        float* wc = wo + wr * L::kOLd + (dn / 4) * 32 + (dn % 4 / 2) * 16 +
                    dn % 2 + t * 4;
        wc[0] = o[dn][2 * r];
        wc[2] = o[dn][2 * r + 1];
      } else {
        *reinterpret_cast<float2*>(wo + wr * L::kOLd + dn * 8 + t * 2) =
            make_float2(o[dn][2 * r], o[dn][2 * r + 1]);
      }
    }
  }
  __syncthreads();

  const bool single = n_live == 1;
  const int64_t head = (int64_t)bi * a.hkv + hk;
  const int n_splits = gridDim.x;
  float* ws_o = a.ws;
  float* ws_ml = single ? nullptr
                        : a.ws + (int64_t)a.b * a.hkv * n_splits * rows * a.d;
  for (int i = tid; i < 16 * DP; i += kRowsThreads) {
    const int r = i / DP, c = i % DP;
    const int rg = rt * 16 + r;
    if (rg >= rows || c >= a.d) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w * 16 + r]);
    float lsum = 0.f, ov = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = exp2f(wm[w * 16 + r] - mx);
      lsum += wl[w * 16 + r] * f;
      ov += wo[(w * 16 + r) * L::kOLd + c] * f;
    }
    if (single) {
      a.out[(((int64_t)bi * a.s_q + rg % a.s_q) * a.h + hk * group +
             rg / a.s_q) * a.d + c] =
          __float2bfloat16(ov / (lsum == 0.f ? 1.f : lsum));
    } else {
      const int64_t wr = (head * n_splits + split) * rows + rg;
      ws_o[wr * a.d + c] = ov;
      if (c == 0) {
        ws_ml[wr * 2] = mx;
        ws_ml[wr * 2 + 1] = lsum;
      }
    }
  }
  if (single) return;

  // count this split in; the last to arrive merges every live split
  __threadfence();
  __syncthreads();
  int* counter = a.counters + head * n_rt + rt;
  if (tid == 0) last_arrival = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!last_arrival) return;
  __threadfence();
  // weights exp2(m_s - M) / L of each (row, split), in the ring
  float* wt = reinterpret_cast<float*>(ring);  // [16][n_live]
  if (tid < 16 && rt * 16 + tid < rows) {
    const int64_t r0 = head * n_splits * rows + rt * 16 + tid;
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
  for (int i = tid; i < 16 * DP; i += kRowsThreads) {
    const int r = i / DP, c = i % DP;
    const int rg = rt * 16 + r;
    if (rg >= rows || c >= a.d) continue;
    const int64_t r0 = head * n_splits * rows + rg;
    float ov = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      ov += __ldcg(ws_o + (r0 + (int64_t)sp * rows) * a.d + c) *
            wt[r * n_live + sp];
    }
    a.out[(((int64_t)bi * a.s_q + rg % a.s_q) * a.h + hk * group +
           rg / a.s_q) * a.d + c] = __float2bfloat16(ov);
  }
  if (tid == 0) *counter = 0;
}

template <bool Q8>
int launch_rows(const PagedArgs& a, cudaStream_t s) {
  const int rows = a.h / a.hkv * a.s_q;
  const dim3 grid((a.pps + a.split_pages - 1) / a.split_pages,
                  a.hkv * ((rows + 15) / 16), a.b);
  if (a.d <= 64) {
    return (int)launch_grid(paged_rows_kernel<64, Q8>, grid, kRowsThreads,
                            RowsLayout<64, Q8>::bytes(a.split_pages), a, s);
  }
  return (int)launch_grid(paged_rows_kernel<128, Q8>, grid, kRowsThreads,
                          RowsLayout<128, Q8>::bytes(a.split_pages), a, s);
}

// ---------------------------------------------------------------------------
// prefill windows (B6; over int8 pages B8): the tile engine over paged K/V
// ---------------------------------------------------------------------------

constexpr int kWindowWarps = 4;
constexpr int kWindowRows = 16 * kWindowWarps;

// Block (blockIdx.x = tile of kWindowRows of the kv head's group * s_q
// rows, blockIdx.y = kv head, blockIdx.z = sequence); block row r is row
// r0 + r = g * s_q + t.
template <bool Q8>
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
        r0(blockIdx.x * kWindowRows),
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
  __device__ int n_rows() const { return min(kWindowRows, n_total - r0); }
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

template <int DP, bool Q8>
__global__ void __launch_bounds__(32 * kWindowWarps)
    paged_window_kernel(const PagedArgs a) {
  attention_tile<DP, kWindowWarps>(PagedWindowProblem<Q8>(a), a.d);
}

template <bool Q8>
int launch_window(const PagedArgs& a, cudaStream_t s) {
  const int rows = a.h / a.hkv * a.s_q;
  const dim3 grid((rows + kWindowRows - 1) / kWindowRows, a.hkv, a.b);
  if (a.d <= 64) {
    return (int)launch_grid(paged_window_kernel<64, Q8>, grid,
                            32 * kWindowWarps,
                            tile_smem_bytes<64, kWindowWarps>(), a, s);
  }
  return (int)launch_grid(paged_window_kernel<128, Q8>, grid,
                          32 * kWindowWarps,
                          tile_smem_bytes<128, kWindowWarps>(), a, s);
}

// s_lanes = 0: bf16 pages; else int8 pages with (P, page, s_lanes) scales.
PagedArgs make_args(const void* q, const void* k, const void* k_scales,
                    const void* v, const void* v_scales, const void* lengths,
                    const void* tables, const void* slopes, void* out,
                    void* ws, void* counters, int b, int s_q, int h, int hkv,
                    int d, int page_size, int pps, int s_lanes,
                    int split_pages, float scale) {
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
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.b = b;
  a.s_q = s_q;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.page_size = page_size;
  a.pps = pps;
  a.s_lanes = s_lanes;
  a.s_stride = (hkv > 0 && s_lanes / hkv > 1) ? s_lanes / hkv : 1;
  a.split_pages = split_pages;
  a.scale = scale;
  return a;
}

// The shapes the kernels take: whole query groups, d a multiple of 8 up to
// 128, and every kv head's scale lane inside the scale row.
bool bad_shape(int h, int hkv, int d, int s_lanes) {
  return hkv <= 0 || h % hkv || d % 8 || d > 128 ||
         (s_lanes > 0 && hkv > s_lanes);
}

// The few-rows kernel's splits: at least one page each, at most
// kMaxSplits, and a workspace and counters where there is more than one.
bool bad_split(int pps, int split_pages, const void* ws,
               const void* counters) {
  if (split_pages <= 0) return true;
  const int n_splits = (pps + split_pages - 1) / split_pages;
  return n_splits > kMaxSplits ||
         (n_splits > 1 && (ws == nullptr || counters == nullptr));
}

}  // namespace merlin

extern "C" int merlin_paged_decode_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, const void* slopes, void* out,
    void* ws, void* counters, int b, int h, int hkv, int d, int page_size,
    int pps, int split_pages, float scale, void* stream) {
  using namespace merlin;
  if (bad_shape(h, hkv, d, 0) || bad_split(pps, split_pages, ws, counters)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_rows<false>(
      make_args(q, k_pages, nullptr, v_pages, nullptr, lengths, tables,
                slopes, out, ws, counters, b, 1, h, hkv, d, page_size, pps,
                0, split_pages, scale),
      static_cast<cudaStream_t>(stream));
}

extern "C" int merlin_paged_decode_q8(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* tables, const void* slopes, void* out, void* ws,
    void* counters, int b, int h, int hkv, int d, int page_size, int pps,
    int s_lanes, int split_pages, float scale, void* stream) {
  using namespace merlin;
  if (s_lanes <= 0 || bad_shape(h, hkv, d, s_lanes) ||
      bad_split(pps, split_pages, ws, counters)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_rows<true>(
      make_args(q, k_pages, k_scales, v_pages, v_scales, lengths, tables,
                slopes, out, ws, counters, b, 1, h, hkv, d, page_size, pps,
                s_lanes, split_pages, scale),
      static_cast<cudaStream_t>(stream));
}

// split_keys = 1: the few-rows kernel (B5, B7 windows); 0: the 64-row tile
// engine (B6, B8), which takes no workspace.
extern "C" int merlin_paged_window_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, const void* slopes, void* out,
    void* ws, void* counters, int b, int s_q, int h, int hkv, int d,
    int page_size, int pps, int split_pages, float scale, int split_keys,
    void* stream) {
  using namespace merlin;
  if (bad_shape(h, hkv, d, 0) ||
      (split_keys && bad_split(pps, split_pages, ws, counters))) {
    return (int)cudaErrorInvalidValue;
  }
  const PagedArgs a = make_args(q, k_pages, nullptr, v_pages, nullptr,
                                lengths, tables, slopes, out, ws, counters, b,
                                s_q, h, hkv, d, page_size, pps, 0,
                                split_pages, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return split_keys ? launch_rows<false>(a, s) : launch_window<false>(a, s);
}

extern "C" int merlin_paged_window_q8(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* tables, const void* slopes, void* out, void* ws,
    void* counters, int b, int s_q, int h, int hkv, int d, int page_size,
    int pps, int s_lanes, int split_pages, float scale, int split_keys,
    void* stream) {
  using namespace merlin;
  if (s_lanes <= 0 || bad_shape(h, hkv, d, s_lanes) ||
      (split_keys && bad_split(pps, split_pages, ws, counters))) {
    return (int)cudaErrorInvalidValue;
  }
  const PagedArgs a = make_args(q, k_pages, k_scales, v_pages, v_scales,
                                lengths, tables, slopes, out, ws, counters, b,
                                s_q, h, hkv, d, page_size, pps, s_lanes,
                                split_pages, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return split_keys ? launch_rows<true>(a, s) : launch_window<true>(a, s);
}
