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

}  // namespace ssa
