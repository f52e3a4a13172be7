// Pieces shared by the patch merge / expand forwards (fused_patch.cu) and
// backwards (fused_patch_bwd.cu).
#pragma once

#include "common.cuh"

namespace ssa {

constexpr int kRows = 32;   // rows per block (8 warps x 4 rows)
constexpr int kChunk = 16;  // K per shared-memory step

// Offset in x (B,H,W,C) of channel k of a merged row, from the row's base
// (b, 2i, 2j, 0): block q = k / C is x0..x3 = (dy,dx) = (0,0), (1,0),
// (0,1), (1,1) -- the [x0|x1|x2|x3] order of merge_2x2.
__device__ __forceinline__ long long merge_offset(int k, int C, long long wc) {
  const int q = k / C;
  return (long long)(q & 1) * wc + (long long)(q >> 1) * C + (k - q * C);
}

// Base offset in x of merged row m (-1 past the end).
__device__ __forceinline__ long long merge_base(int m, int H, int W, int C, int M) {
  if (m >= M) return -1;
  const int H2 = H / 2, W2 = W / 2;
  const int b = m / (H2 * W2), rem = m - b * H2 * W2;
  const int i = rem / W2, j = rem - i * W2;
  return ((long long)(b * H + 2 * i) * W + 2 * j) * C;
}

// The same for a row m < M with one division: m = q * W/2 + j with
// q = b * H/2 + i, so the base ((b*H + 2i) * W + 2j) * C is
// 2C * (q * W + j) = 2C * (m + q * W/2).
__device__ __forceinline__ long long merge_row_base(int m, int W, int C) {
  const int W2 = W / 2;
  return 2LL * C * (m + (long long)(m / W2) * W2);
}

// The expand product of one block: acc[r][c] = sum_k x[m0 + warp*4 + r, k] *
// w[k, n0 + lane + 32c] in float32 for the block's 32 rows and 32*NPT
// columns; x is (M, C), w is (C, 2C) input-major.  Ends synchronised, so
// the caller may reuse Bs.
template <typename T, int NPT>
__device__ __forceinline__ void expand_product(const T* __restrict__ x,
                                               const T* __restrict__ w,
                                               float (*As)[kRows + 1],
                                               float (*Bs)[32 * NPT], float (&acc)[4][NPT],
                                               int m0, int n0, int C, int M) {
  constexpr int NG = 32 * NPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = 2 * C;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NPT; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += kChunk) {
    for (int e = threadIdx.x; e < kRows * kChunk; e += blockDim.x) {
      const int row = e / kChunk, kk = e - row * kChunk, m = m0 + row;
      As[kk][row] = (m < M) ? to_f(x[(long long)m * C + k0 + kk]) : 0.0f;
    }
    for (int e = threadIdx.x; e < kChunk * NG; e += blockDim.x) {
      const int kk = e / NG, nn = e - kk * NG;
      Bs[kk][nn] = to_f(w[(long long)(k0 + kk) * N + n0 + nn]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[4], bv[NPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk][warp * 4 + r];
#pragma unroll
      for (int c = 0; c < NPT; ++c) bv[c] = Bs[kk][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NPT; ++c) acc[r][c] += a[r] * bv[c];
    }
    __syncthreads();
  }
}

// Every group width C/2 = 32 * NPT the expand kernels take (C/2 a multiple
// of 32 up to 512).
#define SSA_EXPAND_NPT(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// ---------------------------------------------------------------------------
// The bfloat16 tensor-core product core (float32 sums) of the patch
// backwards: `mma.sync.m16n8k16` on `ldmatrix` fragments, 8 warps a block
// as 2 (rows) x 4 (columns), operand tiles staged by 16-byte `cp.async`
// into a ring of shared-memory stages, 64 reduction values a stage.  A tile
// row of R 16-byte chunks keeps chunk c at c ^ (row & 7) (R a multiple of
// 8), so the eight rows one `ldmatrix` reads lie in eight bank groups.
// Every operand is row-major in device memory and none is transposed there;
// the three orientations:
//  * A.B with W input-major (expand's z = x W): A's rows are output rows (A
//    by `ldmatrix`), B's rows the reduction index (B by `ldmatrix.trans`);
//  * A.B^T with W in torch layout (merge's dn = dy W^T, expand's dx =
//    dz W^T): the torch-layout weight read row-major is W^T, whose rows are
//    the reduction index, so it loads as B of A.B;
//  * A^T.B summed over a chunk of rows (the split-K weight gradients
//    n^T dy and x^T dz): A's rows are the reduction index as well (A by
//    `ldmatrix.trans`).
// ---------------------------------------------------------------------------
namespace mma {
constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 64;  // tile of the A.B and A^T.B kernels
constexpr int kStages = 3;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kStageBytes = kABytes + kBK * kBN * 2;
constexpr int kSmem = kStages * kStageBytes;  // 96 KB: two blocks an SM
}  // namespace mma

// out (M, N) = round(a (M, K) . b (K, N)) in bfloat16 with float32 sums, all
// row-major, K a multiple of 64, N of 8: the product kernel of the bf16
// patch backwards (dn, dx) and forwards (expand's z, merge's output),
// defined once, in fused_patch_bwd.cu.
cudaError_t mma_ab_round(const bf16* a, const bf16* b, bf16* out, int M, int K, int N,
                         cudaStream_t st);

// Merged rows a block of the tensor-core merges' row passes (backward: n,
// dx and the column sums; forward: n); 8 and 32 were slower on the H100.
constexpr int kMergeRows = 16;

// Byte offset of 16-byte chunk `chunk` of tile row `row`, rows of
// `row_chunks` chunks.
__device__ __forceinline__ uint32_t swz(int row, int chunk, int row_chunks) {
  return (uint32_t)((row * row_chunks + (chunk ^ (row & 7))) << 4);
}

// acc[i][j] = the warp's MI x NJ tiles of 16 x 8 of the block's product,
// summed over `steps` stages of 64 reduction values.  `load(stage, step)`
// issues the cp.async copies of one step's A and B tiles into ring stage
// `stage` (A at the stage's start, B `A_BYTES` after it).  The A tile is
// rows x 64 (A_T false: ACH = 8 chunks a row) or 64 x columns (A_T true);
// the B tile is 64 x columns, BCH chunks a row.  `a0`: the warp's first
// output row in the A tile, `b0` its first output column in the B tile.
// Ends with the ring drained and the block synchronised.
template <bool A_T, int MI, int NJ, int ACH, int BCH, int STAGES, int A_BYTES, int STAGE_BYTES,
          typename Load>
__device__ __forceinline__ void mma_mainloop(uint32_t smem, int steps, int a0, int b0, Load load,
                                             float (&acc)[MI][NJ][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  // per-lane parts of the fragment addresses
  const int a_row = A_T ? (lane & 7) + ((lane >> 4) << 3) : a0 + (lane & 15);
  const int a_ch = A_T ? (a0 >> 3) + ((lane >> 3) & 1) : (lane >> 4);
  const int b_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_ch = (b0 >> 3) + (lane >> 4);
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nt = t + STAGES - 1;
      if (nt < steps) load(nt % STAGES, nt);
      cp_async_commit();
    }
    const uint32_t as = smem + (uint32_t)((t % STAGES) * STAGE_BYTES);
    const uint32_t bs = as + A_BYTES;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if constexpr (A_T)
          ldsm4_trans(a[i], as + swz(ks * 16 + a_row, a_ch + 2 * i, ACH));
        else
          ldsm4(a[i], as + swz(a_row + 16 * i, 2 * ks + a_ch, ACH));
      }
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        uint32_t b[4];
        ldsm4_trans(b, bs + swz(ks * 16 + b_row, b_ch + 2 * p, BCH));
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16_16816(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16_16816(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
      if constexpr (NJ % 2 == 1) {
        uint32_t b0r, b1r;
        ldsm2_trans(b0r, b1r, bs + swz(ks * 16 + b_row, (b0 >> 3) + NJ - 1, BCH));
#pragma unroll
        for (int i = 0; i < MI; ++i) mma_bf16_16816(acc[i][NJ - 1], a[i], b0r, b1r);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace ssa
