// What the window-attention kernels of fused_window_attention.cu (windows of
// up to 64 tokens, and the entry points) and fused_window_attention_tiled.cu
// (windows of more than 64 tokens) share: the kernel families, the quad
// reductions and transposes of the `mma.sync` accumulator layout, the sum of
// the backward's bias-gradient partials, and the tiled launchers.
#pragma once

#include "common.cuh"

namespace ssa {

constexpr int kRowsPad = 64;  // the largest window of the first three families
enum Route { kRouteCore = 0, kRouteWmma = 1, kRouteMma = 2, kRouteTiled = 3, kRouteTiledMma = 4 };
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTiledMaxHd = 128;  // head widths of the tiled routes

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4x4 transpose of 32-bit items among the four lanes of a quad: before, lane
// t holds piece t of items 0..3; after, lane t holds pieces 0..3 of item t.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1, hi = t & 2;
  uint32_t r;
  r = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  if (odd) v[0] = r; else v[1] = r;
  r = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) v[2] = r; else v[3] = r;
  r = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  if (hi) v[0] = r; else v[2] = r;
  r = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) v[1] = r; else v[3] = r;
}

// dbias[h][i][j] = sum over the blocks c of a head of part[c][h][i][j]
// (partials with rows `ps` floats apart), in a fixed order: eight strided
// sums, then their sum.  Block 32 x 8: 32 outputs, 8 lanes over the blocks.
static __global__ void __launch_bounds__(256)
dbias_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias, int chunks, int rows,
                 int n, int ps) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int o = blockIdx.x * 32 + tx;  // over (heads * n) rows x n columns
  float acc = 0.0f;
  if (o < rows * n) {
    const int row = o / n, j = o - row * n;
    const float* src = part + (long long)row * ps + j;
    const long long stride = (long long)rows * ps;
    for (int c = ty; c < chunks; c += 8) acc += src[c * stride];
  }
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && o < rows * n) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += red[k][tx];
    dbias[o] = s;
  }
}

// The tiled kernels (fused_window_attention_tiled.cu).  `kRouteTiled`:
// float32 and bfloat16 on the CUDA cores, `plan` windows per backward block.
// `kRouteTiledMma`: bfloat16 on the tensor cores, `plan` as
// ops/fused_window_attention.py::bwd_plan and launch_plan give it.
cudaError_t tiled_fwd(const void* qkv, const void* bias, void* out, int B, int Hp, int Wp, int C,
                      int heads, int wh, int ww, int sh, int sw, int dtype, cudaStream_t st);
cudaError_t tiled_bwd(const void* qkv, const void* dctx, const void* bias, void* dqkv, void* part,
                      void* dbias, int B, int Hp, int Wp, int C, int heads, int wh, int ww, int sh,
                      int sw, int plan, int dtype, cudaStream_t st);
cudaError_t tiled_mma_fwd(const void* qkv, const void* bias, void* out, int B, int Hp, int Wp,
                          int C, int heads, int wh, int ww, int sh, int sw, int plan,
                          cudaStream_t st);
cudaError_t tiled_mma_bwd(const void* qkv, const void* dctx, const void* bias, void* dqkv,
                          void* part, void* dbias, int B, int Hp, int Wp, int C, int heads, int wh,
                          int ww, int sh, int sw, int plan, cudaStream_t st);
// The floats of `part` that tiled_mma_bwd lays out for this plan.
long long tiled_mma_bwd_scratch(int B, int Hp, int Wp, int C, int heads, int wh, int ww,
                                int plan);

}  // namespace ssa
