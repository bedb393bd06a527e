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
//   * paged_window_kernel, the window kernel: the dense wgmma forward
//     (attention_fwd.cu) over pages, for prefill windows (B6, B8).
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
// FLOP per byte, a 128-row prefill window 128: bytes again, though within
// 3x of the ridge, so the window kernel has to run its products near the
// tensor cores' rate too. The engine's prefill window is one sequence, (1,
// 128, 32, 128) at up to ~1.5k keys: 640 keys read 10.5 MB of K/V (3.1 us)
// for 1.2 GFLOP (1.2 us). int8 pages halve the K/V bytes and add 8 bytes of
// scales per (key, kv head): 264 bytes per key per head at d = 128 instead
// of 512.
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
// Design of paged_window_kernel (what each choice does about its limits):
//   * attention_fwd's tiles and schedule: a CTA owns 128 query rows of a
//     kv head at d = 128 (two consumer warpgroups, 128-key tiles, one CTA
//     an SM) or 64 at d = 64 (one warpgroup, 64-key tiles, three CTAs an
//     SM); S = Q K^T on wgmma with Q and K K-major in shared memory (SS),
//     O += P V with P packed to bf16 from S's accumulators (RS); S_j is
//     issued with P_{j-1} V_{j-1} and tile j's softmax runs while the
//     latter is on the tensor cores. A paged copy of that body, not one
//     body with a loader policy: its rows are a kv head's group * s_q
//     rows (row g * s_q + t, each with its own position length - s_q + t,
//     slope and output row), int8 pages add a dequantize stage between
//     the copy and wgmma, and the split-key merge closes it; attention_fwd
//     runs at 255 registers at d = 128, where the added state would spill.
//   * Keys split over CTAs, merged in the same launch, as in the few-rows
//     kernel: the engine's prefill window is one sequence, so one CTA per
//     (kv head, row tile) would launch 32 (Vicuna) or 40 (Baichuan) CTAs
//     on 132 SMs. The grid is (kv heads x row tiles, sequences, the
//     wrapper's most splits); each CTA reads every sequence's length and takes
//     as many key tiles as fill the card's CTA slots about once (all the
//     launch's key tiles over SMs x CTAs an SM, read by the launcher from
//     the occupancy API), and enough that its row tile needs no more
//     splits than the grid holds. A 640-key window at Vicuna's 32 heads
//     then runs 3 splits of 2 tiles (96 CTAs), 1536 keys 4 of 3 (128); a
//     ragged batch splits only what overflows one wave. Measured against
//     no split and fixed splits of 256, 512 and 1024 keys
//     (utils/ablate_paged.py, PERF.md), it ran within 6% of the best of
//     them at the engine's windows (256-1536 keys) and 13% behind the
//     best at a 4-sequence batch, where no split was 1.27x slower at 640
//     keys and 1.63x at 1536. The merge (a round of L2 loads a split)
//     costs 4-10 us of that; the tile step is the dense forward's.
//   * A paged K/V source. A CTA copies its split's table entries to shared
//     memory once. Where page_size is a multiple of the tile's keys, a tile
//     lies in one page and its rows are one strided block; else (pages of
//     16, 32 or 64 keys) each row takes its page from shared memory. Keys
//     past the split and columns past d are zero-filled and masked.
//   * A 2-stage cp.async ring in the 128-byte swizzle wgmma reads: over
//     bf16 pages K_{j+1} and V_j are in flight while tile j is multiplied.
//     Over int8 pages the copies fill a 2-stage staging ring (the int8
//     tiles and each key's scale lane); each step dequantizes K_j and
//     V_{j-1} into one bf16 K and one bf16 V tile in the swizzle (a byte
//     permute and one FADD a value, then the scale: (float)x * scale
//     rounded to bf16 once, as dequantize_pages), fences them to the async
//     proxy and only then issues wgmma.
//   * Masks only where they can bite: keys below a warp's first row
//     position and inside the split are visible to all its rows, so only
//     the window's causal tiles and a split's ragged last tile compare
//     positions; a tile with no mask and no bias takes the max of the raw
//     dots and scales inside the exponent. ALiBi adds slope * (key - pos)
//     on every tile.
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
  // more than one key split, f32: the few-rows kernel's O (b, hkv, splits,
  // rows, d) then (m, l) (b, hkv, splits, rows, 2) of its live rows; the
  // window kernel's per (sequence, kv head, row tile, split) each
  // thread's O accumulators, then its rows' (m, l), in fragment order
  float* ws;
  int* counters;  // (b, hkv, row tiles), 0 between launches
  // split_pages: the few-rows kernel's pages a key split; the window
  // kernel's most key splits a row tile. slots: the card's CTA slots for
  // the window kernel (its launcher sets them).
  int b, s_q, h, hkv, d, page_size, pps, s_lanes, s_stride, split_pages,
      slots;
  float scale;
};

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
// prefill windows (B6; over int8 pages B8): the wgmma forward over pages
// ---------------------------------------------------------------------------

constexpr int kWindowMaxSplits = 16;   // key splits of a row tile, at most
constexpr int kWindowMaxPages = 4096;  // a table row's entries, at most
// stages of the K/V ring (over int8 pages, of the staging ring): a third
// (225 KB of shared memory at d = 128) ran 0.98-1.32x the time of two
// (utils/ablate_paged.py, PERF.md)
constexpr int kWindowStages = 2;

// The tiles of the DP-column window kernel, as attention_fwd.cu's
// FwdTiles: consumer warpgroups of 64 query rows, keys per K/V tile.
template <int DP>
struct WindowTiles {
  static constexpr int kWarpGroups = DP == 128 ? 2 : 1;
  static constexpr int kKeys = DP == 128 ? 128 : 64;
  static constexpr int kThreads = kWarpGroups * 128;
  static constexpr int kRows = kWarpGroups * 64;  // query rows of a CTA
  static_assert(kThreads == 2 * kKeys, "a thread per K or V scale of a tile");
};

// Shared memory of the window kernel, in bytes from a 1024-aligned base:
// the Q tiles (a 64-row tile a warpgroup), then over bf16 pages the
// stages of K and of V, the tiles wgmma reads; over int8 pages one bf16 K
// and one bf16 V tile, which wgmma reads, and the stages of the int8 K and
// V tiles and their scales, which the copies fill; then the split's page
// ids.
template <int DP, bool Q8>
struct WindowLayout {
  using W = WindowTiles<DP>;
  static constexpr int kQTile = 64 * DP * 2;
  static constexpr int kTile = W::kKeys * DP * 2;  // a bf16 K or V tile
  static constexpr int kTile8 = W::kKeys * DP;     // an int8 one
  static constexpr int kStage8 = 2 * kTile8 + 2 * W::kKeys * 4;
  static constexpr int kK = W::kWarpGroups * kQTile;
  static constexpr int kV = kK + (Q8 ? 1 : kWindowStages) * kTile;
  static constexpr int kStaged = kV + (Q8 ? 1 : kWindowStages) * kTile;
  static constexpr int kPages = kStaged + (Q8 ? kWindowStages * kStage8 : 0);
  static int bytes(int pps) { return kPages + pps * 4 + 1024; }
};

// Tiles a key split of a row tile takes: enough that the launch's CTAs
// fill the card's CTA slots about once (every sequence's key tiles, times
// the kv heads and row tiles, over the slots), and enough that the row
// tile's `tiles` need at most `splits` CTAs.
__device__ __forceinline__ int window_split_tiles(const PagedArgs& a,
                                                  int keys, int n_rt,
                                                  int tiles, int splits) {
  int work = 0;
  for (int i = 0; i < a.b; ++i) work += (seq_keys(a, i) + keys - 1) / keys;
  work *= a.hkv * n_rt;
  return max(max(1, (work + a.slots - 1) / a.slots),
             (tiles + splits - 1) / splits);
}

template <int DP, bool Q8>
__global__ void __launch_bounds__(WindowTiles<DP>::kThreads,
                                  DP == 64 ? 3 : 1)
    paged_window_kernel(const PagedArgs a) {
  using W = WindowTiles<DP>;
  using L = WindowLayout<DP, Q8>;
  using T = std::conditional_t<Q8, int8_t, __nv_bfloat16>;
  constexpr int KEYS = W::kKeys;
  constexpr int NT = W::kThreads;
  constexpr int ROWS = W::kRows;
  constexpr int kS = KEYS / 2;             // S accumulators a thread holds
  constexpr int kKeyBlock = KEYS * 128;    // a tile's 64-column block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_arrival;
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sb = smem_raw + (base - raw);  // generic pointer of base
  int* pages = reinterpret_cast<int*>(sb + L::kPages);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;  // within the warpgroup
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  // rows: a kv head's group * s_q query rows, row g * s_q + t at position
  // length - s_q + t, in tiles of ROWS (blockIdx.x = kv head x row tile)
  const int group = a.h / a.hkv;
  const int rows = group * a.s_q;
  const int n_rt = (rows + ROWS - 1) / ROWS;
  const int hk = blockIdx.x / n_rt, rt = blockIdx.x % n_rt;
  const int bi = blockIdx.y;
  const int r0 = rt * ROWS;
  const int length = a.lengths[bi];
  // the tile's last window slot bounds the keys it sees
  const int r1 = min(r0 + ROWS, rows) - 1;
  const int t_max = r1 - r0 + 1 >= a.s_q || r0 % a.s_q > r1 % a.s_q
                        ? a.s_q - 1
                        : r1 % a.s_q;
  const int key_end =
      max(0, min(seq_keys(a, bi), length - a.s_q + t_max + 1));
  const int tiles = (key_end + KEYS - 1) / KEYS;

  // this CTA's key split (a row tile with no key still has one, which
  // writes zeros)
  const int per = window_split_tiles(a, KEYS, n_rt, tiles, gridDim.z);
  const int n_live = max(1, (tiles + per - 1) / per);
  const int split = blockIdx.z;
  if (split >= n_live) return;
  const int k_begin = split * per * KEYS;
  const int k_end = min(k_begin + per * KEYS, key_end);
  const int n_tiles = max(0, (k_end - k_begin + KEYS - 1) / KEYS);

  // the Q tiles, in flight while the page ids are read: row r of the CTA
  // into warpgroup r / 64's tile
  for (int i = tid; i < ROWS * (DP / 8); i += NT) {
    const int r = i / (DP / 8), col = (i % (DP / 8)) * 8;
    const int rg = r0 + r;
    const bool ok = rg < rows && col < a.d;
    const __nv_bfloat16* src =
        ok ? a.q + (((int64_t)bi * a.s_q + rg % a.s_q) * a.h + hk * group +
                    rg / a.s_q) * a.d + col
           : a.q;
    cp_async16(base + (r / 64) * L::kQTile + sw128<64>(r % 64, col), src,
               ok);
  }

  // the split's page ids, once
  const int p0 = k_begin / a.page_size;
  const int n_pages = k_end > k_begin ? (k_end - 1) / a.page_size - p0 + 1
                                      : 0;
  for (int i = tid; i < n_pages; i += NT) {
    pages[i] = a.tables[(int64_t)bi * a.pps + p0 + i];
  }

  // this thread's two rows (fragment rows g and g + 8 of its warp): the
  // position, ALiBi slope and whether live; a dead row masks nothing
  int pos[2];
  float slope[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rg = r0 + wg * 64 + warp * 16 + g + 8 * r;
    const bool live = rg < rows;
    pos[r] = live ? length - a.s_q + rg % a.s_q : 1 << 30;
    slope[r] = (live && a.slopes != nullptr)
                   ? a.slopes[hk * group + rg / a.s_q]
                   : 0.f;
  }
  // the warp's first position: its tiles below it need no mask
  const int warp_pos = __reduce_min_sync(0xffffffffu, min(pos[0], pos[1]));
  const float c = a.scale * kLog2e;
  __syncthreads();  // the page ids

  const int64_t row_elems = (int64_t)a.hkv * a.d;
  const T* kpool = static_cast<const T*>(a.k);
  const T* vpool = static_cast<const T*>(a.v);
  // A tile whose keys lie in one page (page_size a multiple of KEYS) is a
  // strided block from one table entry; else each row takes its own.
  const bool one_page = a.page_size % KEYS == 0;
  auto slot = [&](int key) -> int64_t {
    return (int64_t)pages[key / a.page_size - p0] * a.page_size +
           key % a.page_size;
  };

  // tile j's K (value = false) or V rows of the pool: keys past the
  // split's end and columns past d zero-filled, never read. bf16 pages go
  // straight into the swizzled tile wgmma reads; int8 pages into a
  // staging stage, [KEYS][DP] bytes, with each key's scale at lane
  // hk * s_stride, in 16-byte copies (8-byte ones where d % 16 != 0: a
  // head's int8 slice is then only 8-byte aligned).
  auto load = [&](int j, bool value) {
    const int kt0 = k_begin + j * KEYS;
    const int64_t first = one_page ? slot(kt0) : 0;
    const T* pool = value ? vpool : kpool;
    auto copy_rows = [&](auto width) {
      constexpr int kW = decltype(width)::value;
      constexpr int kCols = kW / (int)sizeof(T);
      constexpr int kChunks = DP / kCols;
      static_assert(KEYS * kChunks % NT == 0, "whole passes");
#pragma unroll
      for (int n = 0; n < KEYS * kChunks / NT; ++n) {
        const int i = tid + n * NT;
        const int r = i / kChunks, col = (i % kChunks) * kCols;
        const int key = kt0 + r;
        const bool ok = key < k_end && col < a.d;
        const int64_t row = !ok ? 0 : one_page ? first + r : slot(key);
        const T* src = pool + row * row_elems + hk * a.d + col;
        if constexpr (Q8) {
          const uint32_t dst = base + L::kStaged + (j % kWindowStages) * L::kStage8 +
                               (value ? L::kTile8 : 0) + r * DP + col;
          if constexpr (kW == 16) {
            cp_async16(dst, src, ok);
          } else {
            cp_async8(dst, src, ok);
          }
        } else {
          cp_async16(base + (value ? L::kV : L::kK) + (j % kWindowStages) * L::kTile +
                         sw128<KEYS>(r, col),
                     src, ok);
        }
      }
    };
    if (!Q8 || a.d % 16 == 0) {
      copy_rows(std::integral_constant<int, 16>());
    } else {
      copy_rows(std::integral_constant<int, 8>());
    }
    if constexpr (Q8) {
      // threads 0..KEYS-1 copy K's scales, KEYS.. V's
      if ((tid >= KEYS) == value) {
        const int r = tid % KEYS;
        const int key = kt0 + r;
        const bool ok = key < k_end;
        const int64_t row = !ok ? 0 : one_page ? first + r : slot(key);
        const float* src = (value ? a.v_scales : a.k_scales) +
                           row * a.s_lanes + (int64_t)hk * a.s_stride;
        cp_async4(base + L::kStaged + (j % kWindowStages) * L::kStage8 + 2 * L::kTile8 +
                      (value ? KEYS * 4 : 0) + r * 4,
                  src, ok);
      }
    }
  };

  // int8 pages: staged tile j's K or V into the bf16 tile wgmma reads,
  // each value (float)x * scale rounded to bf16 once, 8 columns a step
  // (an exact float from a byte permute and one FADD, see i8_float)
  auto dequant = [&](int j, bool value) {
    const unsigned char* st =
        sb + L::kStaged + (j % kWindowStages) * L::kStage8 + (value ? L::kTile8 : 0);
    const float* sc = reinterpret_cast<const float*>(
        sb + L::kStaged + (j % kWindowStages) * L::kStage8 + 2 * L::kTile8 +
        (value ? KEYS * 4 : 0));
    unsigned char* dst = sb + (value ? L::kV : L::kK);
#pragma unroll
    for (int n = 0; n < KEYS * DP / 8 / NT; ++n) {
      const int i = tid + n * NT;
      const int r = i / (DP / 8), col = (i % (DP / 8)) * 8;
      const uint2 x = *reinterpret_cast<const uint2*>(st + r * DP + col);
      const float s = sc[r];
      const uint32_t lo = x.x ^ 0x80808080u, hi = x.y ^ 0x80808080u;
      *reinterpret_cast<uint4*>(dst + sw128<KEYS>(r, col)) =
          make_uint4(dequant2<0, 1>(lo, s, s), dequant2<2, 3>(lo, s, s),
                     dequant2<0, 1>(hi, s, s), dequant2<2, 3>(hi, s, s));
    }
  };

  // Q and K_0, then K_1 and V_0 (and on to K_{S-1} and V_{S-2} for S
  // stages), a commit group each, all in flight at once
  if (n_tiles > 0) load(0, false);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kWindowStages; ++st) {
    if (st < n_tiles) load(st, false);
    if (st - 1 < n_tiles) load(st - 1, true);
    cp_async_commit();
  }

  float o[DP / 2], s[kS];
  uint32_t pf[kS / 2];  // P as bf16 A fragments of the k16 steps
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  float alpha[2], lsum[2];

  // S = Q K_j^T for this warpgroup's 64 rows x KEYS keys (SS)
  auto issue_s = [&](int j) {
    const uint32_t sQ = base + wg * L::kQTile;
    const uint32_t sK = base + L::kK + (Q8 ? 0 : (j % kWindowStages) * L::kTile);
    wgmma_fence();
    pin(s);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t qoff = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      const uint32_t koff = (kk >> 2) * kKeyBlock + (kk & 3) * 32;
      if constexpr (KEYS == 128) {
        wgmma_ss_n128<0, 0>(s, kmajor(sQ + qoff), kmajor(sK + koff), kk > 0);
      } else {
        wgmma_ss_n64<0, 0>(s, kmajor(sQ + qoff), kmajor(sK + koff), kk > 0);
      }
    }
    wgmma_commit();
  };

  // O += P_j V_j (RS), keys 16 kk.. being P's chunks 2 kk and 2 kk + 1
  auto issue_pv = [&](int j) {
    const uint32_t sV = base + L::kV + (Q8 ? 0 : (j % kWindowStages) * L::kTile);
    wgmma_fence();
    pin(o);
    pin(pf);
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      wgmma_rs<DP>(o, pf + 4 * kk, mnmajor<KEYS>(sV + kk * 2048));
    }
    wgmma_commit();
  };

  // Tile j's scores s -> p (in s, f32), the new row max m, the factor
  // alpha that rescales the old O and l, and the tile's row sums lsum.
  // Element i = 4 jc + e is (row e / 2, key k0 + 8 jc + 2 t + e % 2). Keys
  // below every row's position and inside the split need no mask.
  auto softmax = [&](int j) {
    const int k0 = k_begin + j * KEYS;
    const bool masked = k0 + KEYS > k_end || k0 + KEYS - 1 > warp_pos;
    // every score visible and no bias: the max of the raw dots, scaled
    // inside the exponent, one FFMA and one ex2 a score
    const bool plain = !masked && a.slopes == nullptr && c > 0.f;
    float mt[2] = {kNegInf, kNegInf};
    if (plain) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
      }
    } else {
      // element i's key is k0 + 2 t + off(i), off(i) = 8 (i / 4) + i % 2:
      // per row, the distance of key k0 + 2 t to the query and the last
      // visible offset (below 0: none)
      int dist[2], last[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dist[r] = k0 + t * 2 - pos[r];
        last[r] = min(pos[r], k_end - 1) - k0 - t * 2;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int r = (i >> 1) & 1;
        const int off = (i >> 2) * 8 + (i & 1);
        float x = a.slopes != nullptr
                      ? (s[i] * a.scale + slope[r] * (float)(dist[r] + off)) *
                            kLog2e
                      : s[i] * c;
        if (masked && off > last[r]) x = kNegInf;
        s[i] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], plain ? mt[r] * c : mt[r]);
      alpha[r] = fast_exp2(m[r] - mn);
      m[r] = mn;
      // a row that has seen no key yet keeps every p at exp2(NEG_INF) = 0
      mu[r] = mn == kNegInf ? 0.f : mn;
      lsum[r] = 0.f;
    }
    if (plain) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        s[i] = fast_exp2(fmaf(s[i], c, -mu[(i >> 1) & 1]));
        lsum[(i >> 1) & 1] += s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        s[i] = fast_exp2(s[i] - mu[(i >> 1) & 1]);
        lsum[(i >> 1) & 1] += s[i];
      }
    }
  };

  // O *= alpha, l = l alpha + lsum, and P packed from s (once the last
  // P V that reads the P registers and writes O has landed)
  auto rescale_pack = [&]() {
    pin(o);
    pin(pf);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int jc = 0; jc < KEYS / 8; ++jc) {
      pf[2 * jc] = pack_bf16(s[jc * 4], s[jc * 4 + 1]);
      pf[2 * jc + 1] = pack_bf16(s[jc * 4 + 2], s[jc * 4 + 3]);
    }
  };

  // every thread's copies so far have landed and are visible to wgmma
  // (and to the dequantize), and every thread is done with the last tile
  auto sync_tiles = [&]() {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
  };
  // int8 pages: the dequantized tiles visible to wgmma
  auto sync_dequant = [&]() {
    fence_async_smem();
    __syncthreads();
  };

  if (n_tiles > 0) {
    cp_async_wait<kWindowStages - 1>();  // Q and K_0 (the rest may fly)
    fence_async_smem();
    __syncthreads();
    if constexpr (Q8) {
      dequant(0, false);
      sync_dequant();
    }
    issue_s(0);
    wgmma_wait<0>();
    pin(s);
    softmax(0);
    rescale_pack();
  }
  // Tile j: issue S_j and then P_{j-1} V_{j-1}, wait for S_j only, and run
  // its softmax while P_{j-1} V_{j-1} runs. K's stage of tile j - 1 and V's
  // of tile j - 2 are free: K_{j+S-1} and V_{j+S-2} go there.
  for (int j = 1; j < n_tiles; ++j) {
    cp_async_wait<kWindowStages - 2>();  // K_j and V_{j-1} have landed
    fence_async_smem();
    __syncthreads();
    if (j + kWindowStages - 1 < n_tiles) load(j + kWindowStages - 1, false);
    if (j + kWindowStages - 2 < n_tiles) load(j + kWindowStages - 2, true);
    cp_async_commit();
    if constexpr (Q8) {
      dequant(j, false);
      dequant(j - 1, true);
      sync_dequant();
    }
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();  // S_j; P_{j-1} V_{j-1} may still run
    pin(s);
    softmax(j);
    wgmma_wait<0>();
    rescale_pack();
  }
  if (n_tiles > 0) {
    sync_tiles();  // V of the last tile
    if constexpr (Q8) {
      dequant(n_tiles - 1, true);
      sync_dequant();
    }
    issue_pv(n_tiles - 1);
  }
  wgmma_wait<0>();
  pin(o);
  cp_async_wait_all();  // a split with no tile still copied Q

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // More than one split: each writes its unnormalized O and its rows' (m,
  // l) to the workspace in fragment order (a thread's accumulators as
  // float4s, NT apart: coalesced), counts itself in, and the last to
  // arrive merges the others' into its own registers with the LSE
  // rescale, one round of loads a split, and sets the counter back to 0.
  // A split whose rows see no key brings m = NEG_INF, l = 0 and weighs 0.
  const bool direct = n_live == 1;
  int* counter = a.counters + ((int64_t)bi * a.hkv + hk) * n_rt + rt;
  if (!direct) {
    const int64_t blob0 = (((int64_t)bi * a.hkv + hk) * n_rt + rt) *
                          gridDim.z;  // split 0's
    float4* ws_o = reinterpret_cast<float4*>(a.ws);
    float4* ws_ml = ws_o + (int64_t)a.b * a.hkv * n_rt * gridDim.z * NT *
                               (DP / 8);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      ws_o[((blob0 + split) * (DP / 8) + i) * NT + tid] =
          make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
    }
    ws_ml[(blob0 + split) * NT + tid] = make_float4(m[0], m[1], l[0], l[1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) last_arrival = atomicAdd(counter, 1) == n_live - 1;
    __syncthreads();
    if (!last_arrival) return;
    __threadfence();
    for (int sp = 0; sp < n_live; ++sp) {
      if (sp == split) continue;
      const float4 ml = __ldcg(ws_ml + (blob0 + sp) * NT + tid);
      float4 x[DP / 8];
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        x[i] = __ldcg(ws_o + ((blob0 + sp) * (DP / 8) + i) * NT + tid);
      }
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
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] = o[4 * i] * fa[0] + x[i].x * fb[0];
        o[4 * i + 1] = o[4 * i + 1] * fa[0] + x[i].y * fb[0];
        o[4 * i + 2] = o[4 * i + 2] * fa[1] + x[i].z * fb[1];
        o[4 * i + 3] = o[4 * i + 3] * fa[1] + x[i].w * fb[1];
      }
    }
  }
  // normalized bf16 out (a row that saw no key writes 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rg = r0 + wg * 64 + warp * 16 + g + 8 * r;
    if (rg >= rows) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = a.out + (((int64_t)bi * a.s_q + rg % a.s_q) * a.h +
                                   hk * group + rg / a.s_q) * a.d;
#pragma unroll
    for (int jc = 0; jc < DP / 8; ++jc) {
      const int col = jc * 8 + t * 2;
      if (col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[jc * 4 + 2 * r] / l_safe,
                                  o[jc * 4 + 2 * r + 1] / l_safe);
      }
    }
  }
  if (!direct && tid == 0) *counter = 0;
}

// The card's CTA slots for `kernel` (SMs x CTAs an SM at `smem` bytes),
// read once: the fill the window kernel's key splits aim at.
template <typename Kernel>
int cta_slots(Kernel kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return sms * per_sm;
}

// Grid (kv heads x row tiles, sequences, key splits): the splits vary
// slowest, so the CTAs of the first split, all live, are dispatched first
// and the ones past a sequence's live splits, which exit at once, last.
// a.split_pages is the most key splits of a row tile (the workspace's).
template <int DP, bool Q8>
int launch_window_tiles(PagedArgs a, cudaStream_t s) {
  using W = WindowTiles<DP>;
  const auto kernel = paged_window_kernel<DP, Q8>;
  const int smem = WindowLayout<DP, Q8>::bytes(a.pps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  static int slots = 0;
  if (slots == 0) slots = cta_slots(kernel, W::kThreads, smem);
  if (slots <= 0) return (int)cudaErrorInvalidValue;
  a.slots = slots;
  const int rows = a.h / a.hkv * a.s_q;
  const dim3 grid(a.hkv * ((rows + W::kRows - 1) / W::kRows), a.b,
                  a.split_pages);
  kernel<<<grid, W::kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool Q8>
int launch_window(const PagedArgs& a, cudaStream_t s) {
  return a.d <= 64 ? launch_window_tiles<64, Q8>(a, s)
                   : launch_window_tiles<128, Q8>(a, s);
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

// The window kernel's launch: 1 to kWindowMaxSplits key splits a row tile,
// a workspace and counters where there may be more than one, and a table
// row whose page ids fit shared memory.
bool bad_window(int pps, int splits, const void* ws, const void* counters) {
  return pps <= 0 || pps > kWindowMaxPages || splits <= 0 ||
         splits > kWindowMaxSplits ||
         (splits > 1 && (ws == nullptr || counters == nullptr));
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

// few_rows = 1: the few-rows kernel (B5, B7 windows), `split` pages a key
// split; 0: the window kernel (B6, B8), at most `split` key splits a row
// tile. Either takes the workspace and counters where it may split.
extern "C" int merlin_paged_window_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, const void* slopes, void* out,
    void* ws, void* counters, int b, int s_q, int h, int hkv, int d,
    int page_size, int pps, int split, float scale, int few_rows,
    void* stream) {
  using namespace merlin;
  if (bad_shape(h, hkv, d, 0) ||
      (few_rows ? bad_split(pps, split, ws, counters)
                : bad_window(pps, split, ws, counters))) {
    return (int)cudaErrorInvalidValue;
  }
  const PagedArgs a = make_args(q, k_pages, nullptr, v_pages, nullptr,
                                lengths, tables, slopes, out, ws, counters, b,
                                s_q, h, hkv, d, page_size, pps, 0, split,
                                scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return few_rows ? launch_rows<false>(a, s) : launch_window<false>(a, s);
}

extern "C" int merlin_paged_window_q8(
    const void* q, const void* k_pages, const void* k_scales,
    const void* v_pages, const void* v_scales, const void* lengths,
    const void* tables, const void* slopes, void* out, void* ws,
    void* counters, int b, int s_q, int h, int hkv, int d, int page_size,
    int pps, int s_lanes, int split, float scale, int few_rows,
    void* stream) {
  using namespace merlin;
  if (s_lanes <= 0 || bad_shape(h, hkv, d, s_lanes) ||
      (few_rows ? bad_split(pps, split, ws, counters)
                : bad_window(pps, split, ws, counters))) {
    return (int)cudaErrorInvalidValue;
  }
  const PagedArgs a = make_args(q, k_pages, k_scales, v_pages, v_scales,
                                lengths, tables, slopes, out, ws, counters, b,
                                s_q, h, hkv, d, page_size, pps, s_lanes,
                                split, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return few_rows ? launch_rows<true>(a, s) : launch_window<true>(a, s);
}
