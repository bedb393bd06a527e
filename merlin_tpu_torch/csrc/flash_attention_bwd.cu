// B10 + B11 + B13 - flash-attention backward for Hopper (sm_90a): one fused
// key-major kernel computes dq, dk and dv.
//
// Replaces merlin_tpu/ops/flash_attention.py: _bwd_dq_kernel (B10, :209,
// pallas_call :365) and _bwd_dkv_gqa_kernel (B11, :256, pallas_call :398),
// reached through _flash_bwd_pallas; and merlin_tpu/ops/onepass_attention.py:
// _make_dq_kernel (:312, pallas_call :407) and _make_dkv_kernel (:346,
// pallas_call :432), B13, reached through _onepass_bwd_rule, which this
// kernel runs non-causal and unmasked. With s = q k^T, p = exp(s - lse)
// (masked p = 0), dp = do v^T and ds = p (dp - di) scale:
//   dq = ds k,  dk = ds^T q,  dv = p^T do,
// p and ds rounded to bf16 for their products, as the TPU kernels round
// them. s is recomputed tile by tile from the saved natural-log LSE with
// B2's mask semantics: top-left causal, qseg == kseg, ALiBi slope * (k - q),
// the ragged edge (rows past sq, keys past skv) masked here, so callers pad
// nothing. A row that saw no key in the forward (LSE = NEG_INF, trap C2) has
// every p masked to 0 and contributes 0, never NaN.
//
// What bounds it on the H100: at the Vicuna-7B training shape (1, 2048, 32,
// 128) causal, the five products of 2 sq skv d per head over the visible
// half of the (query, key) square are ~89 GFLOP against ~84 MB of
// q/k/v/do/dq/dk/dv/lse/di: ~1000 FLOP per byte, far above the card's ~295
// FLOP/byte ridge, so the tensor cores bound it (~0.09 ms at 989 TFLOP/s).
// B13 at the tower's (8, 1025, 16, 64) is operations-bound too.
//
// Design (the FlashAttention-2/-3 backward scheme):
//   * One CTA, one warpgroup of 128 threads, per (64 keys, kv head, batch),
//     key tile 0 (the longest causal walk) launched first. K and V are
//     loaded once and stay in shared memory; the CTA walks the query heads
//     of its GQA group and, per head, the 64-query tiles from the diagonal
//     on, so dk and dv (a GQA group summed in f32, one rounding) never leave
//     the CTA: they are the same bits from run to run.
//   * Q, dO, LSE, di (and query segment ids) arrive through a 2-stage
//     cp.async ring: tile i+1 is in flight while tile i is multiplied.
//     Every tile is stored in the 128-byte swizzle wgmma's descriptors read
//     (each 64-column block of a row-major tile: 16-byte chunk XOR row % 8).
//   * The five products run once per visible tile on wgmma (m64nNk16, bf16
//     in, f32 accumulate), no mma.sync and no scalar fragment loads:
//       S^T  = K Q^T,  dP^T = V dO^T   A and B K-major in shared memory;
//       P^T, dS^T in registers (exp2 in the log2 domain, B2's mask);
//       dV += P^T dO,  dK += dS^T Q    A from registers (the f32
//                                      accumulators packed to bf16), B
//                                      MN-major in shared memory;
//       dS^T stored to shared memory as bf16, then dQ = dS K with A and B
//       MN-major in shared memory, 64 columns at a time (a full 64 x 128 dQ
//       accumulator on top of dK, dV, S^T and dP^T would not fit in 255
//       registers).
//     P^T and dS^T are formed element by element once S^T and dP^T have
//     landed, so each S^T / dP^T register dies as its bf16 pair is packed:
//     two CTAs share an SM at d = 128 and three at d = 64, hiding each
//     other's waits, with no spills (ptxas: 254 and 166 registers).
//   * dQ gets a share from every key tile and no CTA owns a query row: each
//     share is added into an f32 (b, sq, h, d) buffer with
//     red.global.add.v4.f32 (lanes t and t ^ 1 swap halves of their rows so
//     each red carries 16 contiguous bytes).
//     A pre-pass kernel zeroes that buffer (and, given the forward's out,
//     computes di = sum(out * do) per row); a post-pass rounds it to bf16.
//     The order of the f32 additions varies from run to run (trap C17):
//     dq is not bit-reproducible, dk and dv are.

#include "attention_core.cuh"

namespace merlin {

constexpr int kBwdThreads = 128;  // one warpgroup
constexpr int kBwdRows = 64;      // keys per CTA; queries per step
constexpr int kBlockBytes = kBwdRows * 128;  // one 64-column swizzled block
constexpr int kStatBytes = 3 * kBwdRows * 4;  // lse, di, qseg of one step

struct BwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;     // (b, h, sq) natural log
  const float* di;      // (b, h, sq) sum(o * do)
  float* dq_acc;        // (b, sq, h, d) f32, zeroed by the pre-pass
  __nv_bfloat16* dk;    // (b, skv, hkv, d) contiguous
  __nv_bfloat16* dv;    // (b, skv, hkv, d) contiguous
  const int* qseg;      // (b, sq) or nullptr
  const int* kseg;      // (b, skv) or nullptr
  const float* slopes;  // (h,) or nullptr
  int b, sq, skv, h, hkv, d;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;  // do's strides
  float scale;
};

// 2^x by the SFU, flushing results below 2^-126 to 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The raw dot s of (query qi, key ki) -> its log2-domain score, or kNegInf
// where the key is not visible to the query (B2's DenseProblem::logit, with
// the query's own edge masked too).
template <bool CAUSAL>
__device__ __forceinline__ float bwd_logit(const BwdArgs& a, float slope,
                                           int qi, int qseg, int ki,
                                           int kseg, float s) {
  const float x = a.slopes != nullptr
                      ? (s * a.scale + slope * (float)(ki - qi)) * kLog2e
                      : s * (a.scale * kLog2e);
  bool ok = ki < a.skv && qi < a.sq;
  if (CAUSAL) ok = ok && ki <= qi;
  if (a.qseg != nullptr) ok = ok && qseg == kseg;
  return ok ? x : kNegInf;
}

// ---------------------------------------------------------------------------
// shared memory, cp.async and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row r, column c) in a 64-row bf16 tile kept as 64-column
// blocks of [64][64], each in the 128-byte swizzle: 16-byte chunk (c / 8)
// of row r sits at chunk (c / 8) ^ (r % 8). Block bases are 1024-aligned.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 6) * kBlockBytes + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for this thread's copies; fence_async_smem then makes every
// thread's writes to shared memory visible to wgmma (the async proxy) once
// the caller syncs
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 64 rows x DP columns of a strided (b, s, h, d) tensor (rows `row_stride`
// apart) into the swizzled tile at `dst`; rows past `rows` and columns past
// d are zero-filled. 16 consecutive threads cover one 256-byte row.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int rows, int d,
                                          int tid) {
  constexpr int kChunks = DP / 8;
#pragma unroll
  for (int i = tid; i < kBwdRows * kChunks; i += kBwdThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool ok = r < rows && c < d;
    cp_async16(dst + sw128(r, c), ok ? src + r * row_stride + c : src, ok);
  }
}

// wgmma descriptor of a swizzled tile at shared address `addr`: strides in
// bytes (lbo: between 64-column blocks along M/N for an MN-major operand,
// unused for a K-major one; sbo: between 8-row groups), 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return wgmma_desc(addr, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return wgmma_desc(addr, kBlockBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma writes (or reads) at this point
// of the program, so the compiler moves no use of them across a wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A B, A (64 x 16) and B (16 x 64) both read from shared memory
// through descriptors; TA / TB mark A / B as MN-major (transposed). With
// scale_d 0 the old d is ignored (d = A B).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d += A B, A (64 x 16) from registers (each warp's 16 rows in the
// mma.sync A fragment layout) and B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// As wgmma_rs_n64 with B (16 x 128).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// ---------------------------------------------------------------------------
// the fused kernel
// ---------------------------------------------------------------------------

template <int DP>
constexpr int bwd_smem_bytes() {
  // K, V, two stages of Q and dO, dS^T, two stages of stats, and the slack
  // that aligns the base to 1024 bytes
  return 6 * kBwdRows * DP * 2 + kBwdRows * kBwdRows * 2 + 2 * kStatBytes +
         1024;
}

// One CTA per (64 keys, kv head, batch): blockIdx.x = (key tile * b + bi)
// * hkv + hk, so key tile 0, the longest causal walk, goes first.
template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(kBwdThreads, DP == 64 ? 3 : 2)
    flash_bwd_kernel(const BwdArgs a) {
  constexpr int kTile = kBwdRows * DP * 2;  // bytes of one 64-row tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base;
  const uint32_t sV = sK + kTile;
  const uint32_t sQ0 = sV + kTile;          // two stages
  const uint32_t sD0 = sQ0 + 2 * kTile;     // two stages
  const uint32_t sS = sD0 + 2 * kTile;      // dS^T, [64 keys][64 queries]
  const uint32_t sStat = sS + kBwdRows * kBwdRows * 2;  // two stages
  unsigned char* dS = smem + (sS - base);
  const float* stats = reinterpret_cast<const float*>(smem + (sStat - base));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hk = blockIdx.x % a.hkv;
  const int bi = (blockIdx.x / a.hkv) % a.b;
  const int k0 = blockIdx.x / (a.hkv * a.b) * kBwdRows;
  const int group = a.h / a.hkv;
  // queries before the tile's first key see none of its keys
  const int q_begin = CAUSAL ? k0 : 0;
  const int n_qt = q_begin < a.sq ? (a.sq - q_begin + kBwdRows - 1) / kBwdRows
                                  : 0;
  const int n_steps = group * n_qt;

  // step i: query head hk * group + i / n_qt, its query tile i % n_qt
  auto load_step = [&](int step, int stage) {
    const int hq = hk * group + step / n_qt;
    const int q0 = q_begin + (step % n_qt) * kBwdRows;
    const int nq = min(kBwdRows, a.sq - q0);
    load_tile<DP>(sQ0 + stage * kTile,
                  a.q + bi * a.q_sb + (int64_t)q0 * a.q_ss + hq * a.q_sh,
                  a.q_ss, nq, a.d, tid);
    load_tile<DP>(sD0 + stage * kTile,
                  a.dout + bi * a.o_sb + (int64_t)q0 * a.o_ss + hq * a.o_sh,
                  a.o_ss, nq, a.d, tid);
    if (tid < kBwdRows) {
      const bool ok = tid < nq;
      const int64_t row =
          ((int64_t)bi * a.h + hq) * a.sq + q0 + (ok ? tid : 0);
      const uint32_t st = sStat + stage * kStatBytes + tid * 4;
      cp_async4(st, a.lse + row, ok);
      cp_async4(st + kBwdRows * 4, a.di + row, ok);
      if (a.qseg != nullptr) {
        cp_async4(st + 2 * kBwdRows * 4,
                  a.qseg + (int64_t)bi * a.sq + q0 + (ok ? tid : 0), ok);
      }
    }
  };
  // this thread's key rows in S^T, dP^T, dK, dV: warp * 16 + g (+ 8)
  int ki[2], kseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ki[r] = k0 + warp * 16 + g + 8 * r;
    kseg[r] = (a.kseg != nullptr && ki[r] < a.skv)
                  ? a.kseg[(int64_t)bi * a.skv + ki[r]] : 0;
  }
  // a thread whose two keys share one segment may skip the mask on a
  // step whose queries all carry that segment too
  const bool kseg_one = kseg[0] == kseg[1];
  float dk[DP / 2], dv[DP / 2], s[32], dp[32], dq[32];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = dq[i] = 0.f;
  uint32_t pf[16], sf[16];  // P^T and dS^T as bf16 A fragments

  // a key tile past every query (causal with sq < skv) has no step: it
  // issues no copy and writes zero dK, dV
  if (n_steps > 0) {
    const int n_keys = min(kBwdRows, a.skv - k0);
    load_tile<DP>(sK, a.k + bi * a.k_sb + (int64_t)k0 * a.k_ss + hk * a.k_sh,
                  a.k_ss, n_keys, a.d, tid);
    load_tile<DP>(sV, a.v + bi * a.v_sb + (int64_t)k0 * a.v_ss + hk * a.v_sh,
                  a.v_ss, n_keys, a.d, tid);
    load_step(0, 0);
  }
  cp_async_commit();

  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1;
    const int hq = hk * group + step / n_qt;
    const int q0 = q_begin + (step % n_qt) * kBwdRows;
    const uint32_t sQ = sQ0 + stage * kTile;
    const uint32_t sD = sD0 + stage * kTile;
    // this step's tiles have landed, and every thread is done with the
    // previous step (its stage, dS^T and all its wgmma)
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    if (step + 1 < n_steps) load_step(step + 1, stage ^ 1);
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, K-major
    wgmma_fence();
    pin(s);
    pin(dp);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
      wgmma_ss_n64<0, 0>(s, kmajor(sK + off), kmajor(sQ + off), kk > 0);
      wgmma_ss_n64<0, 0>(dp, kmajor(sV + off), kmajor(sD + off), kk > 0);
    }
    wgmma_commit();

    // element e of 8-query chunk j is (key ki[e / 2], query q0 + j * 8 +
    // t * 2 + e % 2)
    const float* lse_s = stats + stage * (kStatBytes / 4);
    const float* di_s = lse_s + kBwdRows;
    const int* qseg_s = reinterpret_cast<const int*>(di_s + kBwdRows);
    const float slope = a.slopes != nullptr ? a.slopes[hq] : 0.f;
    // a tile wholly visible: below the diagonal, inside both edges, no
    // ALiBi, and (with segments) one segment for every query and key of
    // the warp
    bool unmasked = a.slopes == nullptr && (!CAUSAL || q0 > k0) &&
                    q0 + kBwdRows <= a.sq && k0 + kBwdRows <= a.skv;
    if (a.qseg != nullptr && unmasked) {
      bool same = kseg_one;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        same = same && qseg_s[j * 8 + t * 2] == kseg[0] &&
               qseg_s[j * 8 + t * 2 + 1] == kseg[0];
      }
      unmasked = __all_sync(0xffffffffu, same);
    }
    wgmma_wait_all();  // S^T and dP^T have landed
    pin(s);
    pin(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qc = j * 8 + t * 2;
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + qc);
      const float2 di2 = *reinterpret_cast<const float2*>(di_s + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse = ((e & 1) ? lse2.y : lse2.x) * kLog2e;
        const float di = ((e & 1) ? di2.y : di2.x) * a.scale;
        float p;
        if (unmasked) {
          p = fast_exp2(s[j * 4 + e] * (a.scale * kLog2e) - lse);
        } else {
          const float x = bwd_logit<CAUSAL>(
              a, slope, q0 + qc + (e & 1), qseg_s[qc + (e & 1)], ki[e >> 1],
              kseg[e >> 1], s[j * 4 + e]);
          p = x == kNegInf ? 0.f : fast_exp2(x - lse);
        }
        s[j * 4 + e] = p;
        dp[j * 4 + e] = p * fmaf(dp[j * 4 + e], a.scale, -di);
      }
      pf[2 * j] = pack_bf16(s[j * 4], s[j * 4 + 1]);
      pf[2 * j + 1] = pack_bf16(s[j * 4 + 2], s[j * 4 + 3]);
      sf[2 * j] = pack_bf16(dp[j * 4], dp[j * 4 + 1]);
      sf[2 * j + 1] = pack_bf16(dp[j * 4 + 2], dp[j * 4 + 3]);
      // dS^T row (key) warp * 16 + g (+ 8), queries qc, qc + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h;
        *reinterpret_cast<uint32_t*>(dS + row * 128 + ((j ^ g) << 4) +
                                     t * 4) = sf[2 * j + h];
      }
    }

    // dV += P^T dO over the step's 64 queries (the A fragment of queries
    // 16 kk.. is chunks 2 kk and 2 kk + 1)
    wgmma_fence();
    pin(dv);
    pin(pf);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DP>(dv, pf + 4 * kk, mnmajor(sD + kk * 2048));
    }

    // dK += dS^T Q
    wgmma_fence();
    pin(dk);
    pin(sf);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DP>(dk, sf + 4 * kk, mnmajor(sQ + kk * 2048));
    }
    wgmma_commit();
    fence_async_smem();
    __syncthreads();  // dS^T is in shared memory for every warp

    // dQ = dS K, 64 columns at a time, added into the f32 buffer
#pragma unroll
    for (int half = 0; half < DP / 64; ++half) {
      wgmma_fence();
      pin(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_n64<1, 1>(dq, mnmajor(sS + kk * 2048),
                           mnmajor(sK + half * kBlockBytes + kk * 2048),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(dq);
      // lanes t and t ^ 1 swap halves of their rows: an even t adds 4
      // columns of row g, an odd t 4 columns of row g + 8, 16 bytes a red
      const int h = t & 1;
      const int qi = q0 + warp * 16 + g + 8 * h;
      float* row = a.dq_acc + (((int64_t)bi * a.sq + qi) * a.h + hq) * a.d;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* c = dq + j * 4;
        const float x = __shfl_xor_sync(0xffffffffu, h ? c[0] : c[2], 1);
        const float y = __shfl_xor_sync(0xffffffffu, h ? c[1] : c[3], 1);
        const int col = half * 64 + j * 8 + (t & 2) * 2;
        if (qi < a.sq && col < a.d) {
          asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::
                           "l"(row + col), "f"(h ? x : c[0]),
                       "f"(h ? y : c[1]), "f"(h ? c[2] : x),
                       "f"(h ? c[3] : y)
                       : "memory");
        }
      }
    }
    pin(dv);
    pin(dk);
    pin(pf);
    pin(sf);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (ki[r] >= a.skv) continue;
    const int64_t at = (((int64_t)bi * a.skv + ki[r]) * a.hkv + hk) * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + t * 2;
      if (col < a.d) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + at + col) =
            __floats2bfloat162_rn(dk[j * 4 + 2 * r], dk[j * 4 + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + at + col) =
            __floats2bfloat162_rn(dv[j * 4 + 2 * r], dv[j * 4 + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pre-pass and post-pass
// ---------------------------------------------------------------------------

// One warp per (b, q, h) row: zero the row of dq_acc and, when `out` is
// given, write di = sum(out * do) over d (f32) to `di`.
__global__ void __launch_bounds__(256)
    flash_bwd_prepass_kernel(const BwdArgs a, const __nv_bfloat16* out,
                             int64_t out_sb, int64_t out_ss, int64_t out_sh,
                             float* di) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)a.b * a.sq * a.h) return;
  const int hh = row % a.h;
  const int qi = (row / a.h) % a.sq;
  const int bi = row / ((int64_t)a.h * a.sq);
  float* acc = a.dq_acc + row * a.d;
  for (int c = lane * 4; c < a.d; c += 128) {
    *reinterpret_cast<float4*>(acc + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (out == nullptr) return;
  const __nv_bfloat16* o =
      out + bi * out_sb + (int64_t)qi * out_ss + hh * out_sh;
  const __nv_bfloat16* g = a.dout + bi * a.o_sb + (int64_t)qi * a.o_ss +
                           hh * a.o_sh;
  float sum = 0.f;
  for (int c = lane * 8; c < a.d; c += 256) {
    const uint4 ov = ld128(o + c);
    const uint4 gv = ld128(g + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 gf = __bfloat1622float2(g2[i]);
      sum += of.x * gf.x + of.y * gf.y;
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) di[((int64_t)bi * a.h + hh) * a.sq + qi] = sum;
}

// dq = bf16(dq_acc), 4 values per thread
__global__ void __launch_bounds__(256)
    flash_bwd_postpass_kernel(const float* acc, __nv_bfloat16* dq,
                              int64_t n) {
  const int64_t i = ((int64_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const float4 x = *reinterpret_cast<const float4*>(acc + i);
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dq + i);
  out[0] = __floats2bfloat162_rn(x.x, x.y);
  out[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, bool causal, cudaStream_t s) {
  const dim3 grid((a.skv + kBwdRows - 1) / kBwdRows * a.hkv * a.b);
  return causal ? launch_grid(flash_bwd_kernel<DP, true>, grid, kBwdThreads,
                              bwd_smem_bytes<DP>(), a, s)
                : launch_grid(flash_bwd_kernel<DP, false>, grid, kBwdThreads,
                              bwd_smem_bytes<DP>(), a, s);
}

}  // namespace merlin

// q, k, v, do (and out) strided (b, s, h, d) with d contiguous; lse (b, h,
// sq) f32. With `out` given, di (b, h, sq) f32 is written by the pre-pass;
// without, it is read. dq_acc: (b, sq, h, d) f32 scratch; dq written (b, sq,
// h, d) contiguous in bf16; dk, dv (b, skv, hkv, d) contiguous. strides: q,
// k, v, do, out, each (b, s, h).
extern "C" int merlin_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* di, void* dq_acc, void* dq,
    void* dk, void* dv, const void* qseg, const void* kseg,
    const void* slopes, int b, int sq, int skv, int h, int hkv, int d,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb,
    int64_t o_ss, int64_t o_sh, int64_t out_sb, int64_t out_ss,
    int64_t out_sh, float scale, int causal, void* stream) {
  using namespace merlin;
  if (d > 128) return (int)cudaErrorInvalidValue;
  BwdArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
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
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  const int64_t rows = (int64_t)b * sq * h;
  flash_bwd_prepass_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      a, static_cast<const __nv_bfloat16*>(out), out_sb, out_ss, out_sh,
      static_cast<float*>(di));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = d <= 64 ? launch_bwd<64>(a, causal != 0, s)
                : launch_bwd<128>(a, causal != 0, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = rows * d;
  flash_bwd_postpass_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), n);
  return (int)cudaGetLastError();
}
