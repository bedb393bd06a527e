// B1, B2 and B12 - the dense attention forward for Hopper (sm_90a): one
// wgmma kernel with a cp.async K/V ring, the softmax of one key tile
// overlapped with the next tile's Q K^T.
//
// Replaces merlin_tpu/ops/flash_attention.py: _fwd_kernel (B2, :83,
// pallas_call :161), reached through _flash_fwd_pallas; and
// merlin_tpu/ops/onepass_attention.py: _make_kernel (emit_lse=False, :54)
// and _make_kernel_bd (:132) (B1), and _make_kernel with emit_lse=True (B12,
// the trained path's forward, _onepass_fwd_rule :301), all reached through
// _onepass_fwd and its pallas_call (:254).
// Online-softmax attention of q (b, sq, h, d) over k/v (b, skv, hkv, d),
// strided with d contiguous: causal (top-left) or not, packed-sequence
// segment ids (qseg == kseg), in-kernel ALiBi (slope * (k - q)) and GQA (kv
// head = h / group). Writes out (b, sq, h, d) in bf16 and, given a pointer,
// the natural-log LSE (b, h, sq) in f32: B2 always, B12 as the residual of
// the tower's backward, B1 not (the TPU's (b, h, 8, sq) sublane broadcast
// is a layout, not part of the contract). B1 and B12 are the non-causal,
// unmasked, non-GQA case, and subtract the row max as B2 does (the TPU's
// inference kernel clamps at 2^120 instead, trap C5: the two agree while
// natural logits stay below ~88, as they do after the tower's LayerNorms).
//
// Numerics (trap C2): scores are scaled in f32 after the bf16 product and
// exponentiated in the log2 domain; masked scores take the finite NEG_INF
// and masked p is 0, so a row that sees no key writes 0 and LSE = NEG_INF,
// never NaN; p is rounded to bf16 for P V while l sums the f32 p. The
// ragged edge (rows past sq, keys past skv) is masked here, so callers pad
// nothing.
//
// What bounds it on the H100: at the Vicuna-7B prompt (1, 512, 32, 128)
// causal, ~2.2 GFLOP against 16.8 MB of q/k/v/out: device memory (5.0 us
// at 3.35 TB/s). At the training shape (1, 2048, 32, 128) causal, 34.4
// GFLOP against 67 MB, and at the tower's training call (8, 1025, 16, 64),
// 34.4 GFLOP against 67 MB: the tensor cores (~35 us at 989 TFLOP/s).
//
// Design (the FlashAttention-3 forward, without TMA):
//   * One CTA per (64 * WGS query rows, head, batch), the last query tile
//     (the longest causal walk) launched first. WGS consumer warpgroups of
//     128 threads, 64 query rows each, share one K/V ring, so each K/V tile
//     is loaded once for 64 * WGS rows. The tiles are FwdTiles' (measured,
//     PERF.md): at d = 128 two warpgroups and 128-key tiles, one CTA an
//     SM; at d = 64 one warpgroup and 64-key tiles, three CTAs an SM (the
//     two-warpgroup form ran 1.3x slower at the tower's shapes); at d =
//     256 a 64 x 256 f32 O would leave no registers for S, so each CTA
//     owns one 128-column half of O (blockIdx.y) and both halves compute
//     S and the softmax: 1.5x the products.
//   * Q is loaded once. K and V arrive through a 2-stage cp.async ring of
//     KEYS-key tiles in the 128-byte swizzle wgmma reads (hopper.cuh):
//     while tile j is multiplied, K of tile j + 1 and V of tile j are in
//     flight (V trails K by one tile, as P V trails Q K^T).
//   * Both products on wgmma (m64nNk16, bf16 in, f32 accumulate), no
//     mma.sync: S = Q K^T with Q and K K-major in shared memory (SS); O +=
//     P V with P packed to bf16 straight from S's accumulator registers (an
//     m64nN accumulator is the A fragment of its k16 steps) and V read
//     MN-major (RS).
//   * Overlap (FlashAttention-3's within a warpgroup): step j issues S_j =
//     Q K_j^T and then O += P_{j-1} V_{j-1}, waits for S_j only
//     (wgmma.wait_group 1), and runs tile j's mask/max/exp2/sum pass while
//     P_{j-1} V_{j-1} is on the tensor cores; only the O rescale and the
//     bf16 packing of P_j wait for it. (Issuing S_{j+1} ahead of tile j's
//     softmax, with S of two tiles in registers, made ptxas serialize the
//     wgmmas and ran no faster: PERF.md.) A tile with no mask and no bias
//     takes the max of the raw dots and scales inside the exponent, one
//     FFMA and one ex2 a score.
//   * Masks only where they can bite: a warp skips the per-element mask on
//     a tile wholly below the diagonal (or not causal), inside the ragged
//     edge and, with segment ids, whose keys all carry the one segment of
//     the warp's 16 query rows (the tile's key segments are copied to
//     shared memory with K, and compared once per tile). Elsewhere each
//     score is compared with its row's last visible key and segment, its
//     key offset a constant of the unrolled loop. ALiBi adds its bias on
//     every tile.
//   * B2 launches flash_attention_fwd_kernel and B1/B12
//     onepass_attention_kernel: two names for the one kernel body, so a
//     trace tells the decoder's calls from the tower's.

#include "hopper.cuh"

namespace merlin {

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;   // (b, sq, h, d) contiguous
  float* lse;           // (b, h, sq) natural log, or nullptr
  const int* qseg;      // (b, sq) or nullptr (then kseg is nullptr too)
  const int* kseg;      // (b, skv) or nullptr
  const float* slopes;  // (h,) ALiBi slopes, or nullptr
  int b, sq, skv, h, hkv, d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// The tiles of the DP-column form (PERF.md has the measured choices):
// consumer warpgroups (64 query rows each), keys per K/V tile, and the
// output columns a CTA owns (at DP = 256 a 64 x 256 f32 O would leave no
// registers for S, so each CTA owns one 128-column half, blockIdx.y).
template <int DP>
struct FwdTiles {
  static constexpr int kWarpGroups = DP == 128 ? 2 : 1;
  static constexpr int kKeys = DP == 128 ? 128 : 64;
  static constexpr int kCols = DP > 128 ? 128 : DP;
};

template <int DP, int WGS, int KEYS>
constexpr int fwd_smem_bytes() {
  // Q (a 64-row tile per warpgroup), two stages of K and of V, two stages
  // of the keys' segment ids, and the slack that aligns the base to 1024
  return WGS * 64 * DP * 2 + 4 * KEYS * DP * 2 + 2 * KEYS * 4 + 1024;
}

template <int DP, int WGS, int KEYS, bool CAUSAL>
__device__ __forceinline__ void attention_fwd(const FwdArgs& a) {
  constexpr int kThreadsF = WGS * 128;
  constexpr int kRows = WGS * 64;             // query rows per CTA
  constexpr int kQTile = 64 * DP * 2;         // bytes of a warpgroup's Q
  constexpr int kKVTile = KEYS * DP * 2;      // bytes of a K or V tile
  constexpr int kKeyBlock = KEYS * 128;       // its 64-column block
  constexpr int kS = KEYS / 2;                // S accumulators a thread holds
  constexpr int kCols = FwdTiles<DP>::kCols;  // O columns this CTA owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ0 = base;
  const uint32_t sK0 = sQ0 + WGS * kQTile;    // two stages
  const uint32_t sV0 = sK0 + 2 * kKVTile;     // two stages
  const uint32_t sSeg = sV0 + 2 * kKVTile;    // two stages of KEYS ints
  const int* kseg_s = reinterpret_cast<const int*>(smem_raw + (sSeg - raw));

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;  // within the warpgroup
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int n_qt = (a.sq + kRows - 1) / kRows;
  const int heads = a.h * a.b;
  const int q0 = (n_qt - 1 - (int)blockIdx.x / heads) * kRows;
  const int hi = blockIdx.x % a.h;
  const int bi = (blockIdx.x / a.h) % a.b;
  const int hk = hi / (a.h / a.hkv);
  // first O column of the CTA (a constant below d = 256)
  const int col0 = DP > kCols ? blockIdx.y * kCols : 0;
  // tiles wholly above the diagonal hold no visible key for any row
  const int key_end = CAUSAL ? min(a.skv, q0 + kRows) : a.skv;
  const int n_tiles = (key_end + KEYS - 1) / KEYS;
  const int qw = q0 + wg * 64 + warp * 16;  // this warp's first query row
  const int qi[2] = {qw + g, qw + g + 8};   // this thread's two rows
  const float slope = a.slopes != nullptr ? a.slopes[hi] : 0.f;
  const float c = a.scale * kLog2e;

  // the warp's rows' segments, and whether they share one (rows past sq
  // write nothing and match any)
  int qseg[2] = {0, 0};
  int warp_seg = 0;
  bool seg_one = true;
  if (a.qseg != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qseg[r] = qi[r] < a.sq ? a.qseg[(int64_t)bi * a.sq + qi[r]] : 0;
    }
    warp_seg = __shfl_sync(0xffffffffu, qseg[0], 0);
    seg_one = __all_sync(0xffffffffu,
                         (qi[0] >= a.sq || qseg[0] == warp_seg) &&
                             (qi[1] >= a.sq || qseg[1] == warp_seg));
  }

  const __nv_bfloat16* kb = a.k + bi * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vb = a.v + bi * a.v_sb + hk * a.v_sh;
  auto load_k = [&](int j) {
    const int k0 = j * KEYS;
    load_tile<DP, KEYS, kThreadsF>(sK0 + (j & 1) * kKVTile,
                                   kb + (int64_t)k0 * a.k_ss, a.k_ss,
                                   min(KEYS, a.skv - k0), a.d, tid);
    if (a.qseg != nullptr && tid < KEYS) {
      const bool ok = k0 + tid < a.skv;
      cp_async4(sSeg + ((j & 1) * KEYS + tid) * 4,
                a.kseg + (int64_t)bi * a.skv + (ok ? k0 + tid : 0), ok);
    }
  };
  auto load_v = [&](int j) {
    const int k0 = j * KEYS;
    load_tile<DP, KEYS, kThreadsF>(sV0 + (j & 1) * kKVTile,
                                   vb + (int64_t)k0 * a.v_ss, a.v_ss,
                                   min(KEYS, a.skv - k0), a.d, tid);
  };

#pragma unroll
  for (int w = 0; w < WGS; ++w) {
    const int r0 = q0 + w * 64;
    load_tile<DP, 64, kThreadsF>(
        sQ0 + w * kQTile,
        r0 < a.sq ? a.q + bi * a.q_sb + (int64_t)r0 * a.q_ss + hi * a.q_sh
                  : a.q,
        a.q_ss, a.sq - r0, a.d, tid);
  }
  if (n_tiles > 0) load_k(0);
  cp_async_commit();

  float o[kCols / 2], s[kS];
  uint32_t pf[kS / 2];  // P as bf16 A fragments of the k16 steps
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kS; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  float alpha[2], lsum[2];

  // S = Q K_j^T for this warpgroup's 64 rows x KEYS keys
  auto issue_s = [&](int j) {
    const uint32_t sQ = sQ0 + wg * kQTile;
    const uint32_t sK = sK0 + (j & 1) * kKVTile;
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

  // O += P_j V_j, keys 16 kk.. being P's chunks 2 kk and 2 kk + 1
  auto issue_pv = [&](int j) {
    const uint32_t sV = sV0 + (j & 1) * kKVTile + (col0 >> 6) * kKeyBlock;
    wgmma_fence();
    pin(o);
    pin(pf);
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      wgmma_rs<kCols>(o, pf + 4 * kk, mnmajor<KEYS>(sV + kk * 2048));
    }
    wgmma_commit();
  };

  // Tile j's scores s -> p (in s, f32), the new row max m, the factor
  // alpha that rescales the old O and l, and the tile's row sums lsum.
  // Element i = 4 jc + e is (row qi[e / 2], key j KEYS + 8 jc + 2 t + e % 2).
  auto softmax = [&](int j) {
    const int k0 = j * KEYS;
    const int* ks = kseg_s + (j & 1) * KEYS;
    bool masked = (CAUSAL && k0 + KEYS - 1 > qw) || k0 + KEYS > a.skv;
    if (a.qseg != nullptr && !masked) {
      // every key of the tile in the one segment of the warp's rows
      bool same = seg_one;
#pragma unroll
      for (int i = 0; i < KEYS / 32; ++i) {
        same = same && ks[lane + 32 * i] == warp_seg;
      }
      masked = !__all_sync(0xffffffffu, same);
    }
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
      // element i's key is k0 + 2 t + off(i), off(i) = 8 (i / 4) + i % 2 a
      // constant: per row, the distance of key k0 + 2 t to the query and
      // the last visible offset (below 0: none)
      const int* kst = ks + t * 2;
      int dist[2], last[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dist[r] = k0 + t * 2 - qi[r];
        last[r] = (CAUSAL ? min(qi[r], a.skv - 1) : a.skv - 1) - k0 - t * 2;
      }
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int r = (i >> 1) & 1;
        const int off = (i >> 2) * 8 + (i & 1);
        float x = a.slopes != nullptr
                      ? (s[i] * a.scale + slope * (float)(dist[r] + off)) *
                            kLog2e
                      : s[i] * c;
        if (masked) {
          bool ok = off <= last[r];
          if (a.qseg != nullptr) ok = ok && qseg[r] == kst[off];
          x = ok ? x : kNegInf;
        }
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
    for (int i = 0; i < kCols / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int jc = 0; jc < KEYS / 8; ++jc) {
      pf[2 * jc] = pack_bf16(s[jc * 4], s[jc * 4 + 1]);
      pf[2 * jc + 1] = pack_bf16(s[jc * 4 + 2], s[jc * 4 + 3]);
    }
  };

  // every thread's copies so far have landed and are visible to wgmma,
  // and every thread is done with the previous tile
  auto sync_tiles = [&]() {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
  };

  if (n_tiles > 0) {
    sync_tiles();  // Q and K_0
    issue_s(0);
    if (n_tiles > 1) load_k(1);
    load_v(0);
    cp_async_commit();
    wgmma_wait<0>();
    pin(s);
    softmax(0);
    rescale_pack();
  }
  // Tile j: issue S_j and then P_{j-1} V_{j-1}, wait for S_j only, and run
  // its softmax while P_{j-1} V_{j-1} runs.
  for (int j = 1; j < n_tiles; ++j) {
    // K_j and V_{j-1} have landed; K's stage (j + 1) & 1 (tile j - 1) and
    // V's stage j & 1 (tile j - 2) are free
    sync_tiles();
    if (j + 1 < n_tiles) load_k(j + 1);
    load_v(j);
    cp_async_commit();
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
    issue_pv(n_tiles - 1);
  }
  wgmma_wait<0>();
  pin(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (qi[r] >= a.sq) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow =
        a.out + (((int64_t)bi * a.sq + qi[r]) * a.h + hi) * a.d;
#pragma unroll
    for (int jc = 0; jc < kCols / 8; ++jc) {
      const int col = col0 + jc * 8 + t * 2;
      if (col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[jc * 4 + 2 * r] / l_safe,
                                  o[jc * 4 + 2 * r + 1] / l_safe);
      }
    }
    if (t == 0 && col0 == 0 && a.lse != nullptr) {
      a.lse[((int64_t)bi * a.h + hi) * a.sq + qi[r]] =
          l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]);
    }
  }
}

// three CTAs share an SM at d = 64
template <int DP, int WGS, int KEYS, bool CAUSAL>
__global__ void __launch_bounds__(WGS * 128, DP == 64 ? 3 : 1)
    flash_attention_fwd_kernel(const FwdArgs a) {
  attention_fwd<DP, WGS, KEYS, CAUSAL>(a);
}

template <int DP, int WGS, int KEYS>
__global__ void __launch_bounds__(WGS * 128, DP == 64 ? 3 : 1)
    onepass_attention_kernel(const FwdArgs a) {
  attention_fwd<DP, WGS, KEYS, false>(a);
}

// (query tiles, heads, batch) flattened, as attention_fwd reads
// blockIdx.x, and the output column blocks
template <int DP, typename Kernel>
cudaError_t launch_fwd(Kernel kernel, int smem, const FwdArgs& a,
                       cudaStream_t s) {
  constexpr int W = FwdTiles<DP>::kWarpGroups;
  const dim3 grid((a.sq + W * 64 - 1) / (W * 64) * a.h * a.b,
                  DP / FwdTiles<DP>::kCols);
  return launch_grid(kernel, grid, W * 128, smem, a, s);
}

template <int DP>
cudaError_t launch_flash(const FwdArgs& a, bool causal, cudaStream_t s) {
  constexpr int W = FwdTiles<DP>::kWarpGroups;
  constexpr int K = FwdTiles<DP>::kKeys;
  constexpr int smem = fwd_smem_bytes<DP, W, K>();
  return causal
             ? launch_fwd<DP>(flash_attention_fwd_kernel<DP, W, K, true>, smem,
                              a, s)
             : launch_fwd<DP>(flash_attention_fwd_kernel<DP, W, K, false>,
                              smem, a, s);
}

template <int DP>
cudaError_t launch_onepass(const FwdArgs& a, cudaStream_t s) {
  constexpr int W = FwdTiles<DP>::kWarpGroups;
  constexpr int K = FwdTiles<DP>::kKeys;
  return launch_fwd<DP>(onepass_attention_kernel<DP, W, K>,
                        fwd_smem_bytes<DP, W, K>(), a, s);
}

FwdArgs fwd_args(const void* q, const void* k, const void* v, void* out,
                 void* lse, int b, int sq, int skv, int h, int hkv, int d,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
                 int64_t v_sh, float scale) {
  FwdArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
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
  return a;
}

}  // namespace merlin

// B2: q (b, sq, h, d), k/v (b, skv, hkv, d) strided (b, s, h) with d
// contiguous, d a multiple of 8 up to 256; qseg/kseg (b, sq)/(b, skv)
// int32 or both NULL; slopes (h,) f32 or NULL; out (b, sq, h, d) and lse
// (b, h, sq) contiguous.
extern "C" int merlin_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* qseg, const void* kseg, const void* slopes, int b, int sq,
    int skv, int h, int hkv, int d, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, float scale, int causal, void* stream) {
  using namespace merlin;
  FwdArgs a = fwd_args(q, k, v, out, lse, b, sq, skv, h, hkv, d, q_sb, q_ss,
                       q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  a.qseg = static_cast<const int*>(qseg);
  a.kseg = static_cast<const int*>(kseg);
  a.slopes = static_cast<const float*>(slopes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch_flash<64>(a, causal != 0, s);
  if (d <= 128) return (int)launch_flash<128>(a, causal != 0, s);
  if (d <= 256) return (int)launch_flash<256>(a, causal != 0, s);
  return (int)cudaErrorInvalidValue;
}

// B1 (lse NULL) and B12: as B2, non-causal, no masks, hkv = h, d <= 128.
extern "C" int merlin_onepass_attention_bf16(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int b, int sq, int skv, int h, int d, int64_t q_sb, int64_t q_ss,
    int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
    int64_t v_ss, int64_t v_sh, float scale, void* stream) {
  using namespace merlin;
  const FwdArgs a = fwd_args(q, k, v, out, lse, b, sq, skv, h, h, d, q_sb,
                             q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                             scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return (int)launch_onepass<64>(a, s);
  if (d <= 128) return (int)launch_onepass<128>(a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* merlin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
