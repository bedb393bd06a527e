// Shared numerics of the port's attention kernels, and the mma.sync tile
// engine of the paged prefill-window kernel (paged_attention.cu: B6, and B8
// over int8 pages). The dense forward (attention_fwd.cu: B1, B2, B12) and
// the fused backward run on wgmma instead (hopper.cuh).
//
// A thread block of WARPS warps owns up to 16 * WARPS query rows: each warp
// owns 16. The block stages its Q tile in shared memory once, then walks
// the keys in 64-row tiles staged through shared memory. Scores and P@V run
// on the tensor cores as mma.sync.m16n8k16 (bf16 in, f32 accumulate); the
// softmax is online (running max m and sum l per row, kept in registers of
// the quad of threads that owns the row).
//
// What differs between the kernels is a "problem": where each query row,
// key row and value row lies, which (row, key) pairs are visible with what
// bias, and where a row's output goes. attention_tile<DP, WARPS, Problem>
// takes it as a template argument (PagedWindowProblem in
// paged_attention.cu, over bf16 or int8 pages). A problem provides:
//   Row row(int r)                  per-row state of block row r
//   bool live(const Row&)           the row exists and writes an output
//   int n_rows(), n_keys(), key_end()
//                                   live rows; keys that exist; keys the
//                                   block has to walk (a causal bound)
//   const bf16* q_row(int r)        query row r
//   uint4 k_chunk(int key, int c), v_chunk(int key, int c)
//                                   the 8 bf16 of columns c..c+7 of a key
//                                   or value row (a load, or int8 values
//                                   dequantized on the way to smem)
//   float logit(const Row&, int key, float s)
//                                   the raw dot s -> log2-domain score, or
//                                   kNegInf where the key is not visible
//   bf16* out_row(const Row&); void store_lse(const Row&, float lse)
//
// Numerics shared by every kernel:
//   * scores are scaled in f32 after the bf16 matmul (never by scaling q in
//     bf16) and exponentiated with exp2 in the log2 domain;
//   * masked scores take the finite NEG_INF = -1e30 of the JAX package, and
//     masked p is 0, so a row that sees no key ends with l = 0 and writes
//     0 (not NaN; not the JAX reference's uniform average either);
//   * the ragged edge (rows or keys past the end) is masked here, so
//     callers pad nothing;
//   * p is rounded to bf16 for P@V while l sums the f32 p, as the TPU
//     kernels do.
//
// Every row pointer must be 16-byte aligned with the head dim contiguous
// (the wrappers check): rows are loaded 8 bf16 at a time.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace merlin {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBlockN = 64;   // key rows per KV tile
constexpr int kPad = 8;       // bf16 per smem row, staggers banks

// Dynamic shared memory of a block: its Q tile and one K and one V tile.
template <int DP, int WARPS>
constexpr int tile_smem_bytes() {
  return (16 * WARPS + 2 * kBlockN) * (DP + kPad) * (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, f32 acc.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ld128(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Stage NROWS rows into smem [NROWS][DP + kPad] with NTHREADS threads (this
// one is `tid`), 8 bf16 (16 bytes) per thread per step, chunk(r, c) giving
// columns c..c+7 of row r; rows past `rows` and columns past d are
// zero-filled, and chunk is never asked for them.
template <int DP, int NTHREADS, int NROWS, class Chunk>
__device__ __forceinline__ void load_rows(__nv_bfloat16* smem, Chunk chunk,
                                          int rows, int d, int tid) {
  constexpr int kChunks = DP / 8;
  for (int i = tid; i < NROWS * kChunks; i += NTHREADS) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < d) val = chunk(r, c);
    *reinterpret_cast<uint4*>(smem + r * (DP + kPad) + c) = val;
  }
}

// The whole forward for the block's query rows. DP is the head dim d
// rounded up to a supported width (zero columns cost MMA work, not
// results).
template <int DP, int WARPS, class Problem>
__device__ __forceinline__ void attention_tile(const Problem& pb, int d) {
  constexpr int kRows = 16 * WARPS;
  constexpr int kNThreads = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DP + kPad;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kRows * LD;
  __nv_bfloat16* Vs = Ks + kBlockN * LD;
  const uint16_t* Vbits = reinterpret_cast<const uint16_t*>(Vs);

  const int g = lane >> 2;  // fragment row within the warp's 16
  const int t = lane & 3;   // thread within the quad that shares a row
  const int r_lo = warp * 16 + g;

  load_rows<DP, kNThreads, kRows>(
      Qs, [&](int r, int c) { return ld128(pb.q_row(r) + c); }, pb.n_rows(),
      d, threadIdx.x);
  const typename Problem::Row row[2] = {pb.row(r_lo), pb.row(r_lo + 8)};

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[DP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DP / 8; ++dn) {
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  }

  const int n_keys = pb.n_keys();
  const int n_tiles = (pb.key_end() + kBlockN - 1) / kBlockN;
  const int dk = (d + 15) / 16 * 16;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBlockN;
    const int rows = min(kBlockN, n_keys - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<DP, kNThreads, kBlockN>(
        Ks, [&](int r, int c) { return pb.k_chunk(k0 + r, c); }, rows, d,
        threadIdx.x);
    load_rows<DP, kNThreads, kBlockN>(
        Vs, [&](int r, int c) { return pb.v_chunk(k0 + r, c); }, rows, d,
        threadIdx.x);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      if (kk < dk) {
        const __nv_bfloat16* qr = Qs + r_lo * LD + kk + t * 2;
        const uint32_t af[4] = {ld32(qr), ld32(qr + 8 * LD), ld32(qr + 8),
                                ld32(qr + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* kr = Ks + (j * 8 + g) * LD + kk + t * 2;
          mma_16816(s[j], af, ld32(kr), ld32(kr + 8));
        }
      }
    }

    // scale (+ bias), mask, and the tile's row max, in the log2 domain
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int ki = k0 + j * 8 + t * 2 + (e & 1);
        const float x = pb.logit(row[r], ki, s[j][e]);
        s[j][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float alpha[2];
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float mn = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - m[r]);
        s[j][e] = p;
        lsum[r] += p;
      }
    }
    l[0] = l[0] * alpha[0] + lsum[0];
    l[1] = l[1] * alpha[1] + lsum[1];
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two adjacent n-tiles are exactly
    // the A fragment of one k=16 step
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t pf[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                              pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                              pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                              pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const uint16_t* vr = Vbits + (ks * 16 + t * 2) * LD + g;
#pragma unroll
      for (int dn = 0; dn < DP / 8; ++dn) {
        if (dn * 8 < d) {
          const uint16_t* vc = vr + dn * 8;
          const uint32_t b0 = (uint32_t)vc[0] | ((uint32_t)vc[LD] << 16);
          const uint32_t b1 =
              (uint32_t)vc[8 * LD] | ((uint32_t)vc[9 * LD] << 16);
          mma_16816(o[dn], pf, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!pb.live(row[r])) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = pb.out_row(row[r]);
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = dn * 8 + t * 2;
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            o[dn][2 * r] / l_safe, o[dn][2 * r + 1] / l_safe);
      }
    }
    if (t == 0) {
      pb.store_lse(row[r], l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]));
    }
  }
}

// Raise the dynamic shared-memory limit and launch `kernel` on `stream`.
template <typename Kernel, typename Args>
cudaError_t launch_grid(Kernel kernel, dim3 grid, int threads, int smem,
                        const Args& args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace merlin
