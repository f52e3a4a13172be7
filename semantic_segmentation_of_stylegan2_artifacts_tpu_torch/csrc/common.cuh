// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel takes float32 or bfloat16 storage and accumulates in
// float32.  `round_to<T>` reproduces a cast to the storage type and back,
// which is where the TPU kernels round (probs before P.v, the LayerNorm
// output before a product, a conv sum before its bias).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ssa {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// tanh-approximate GELU in float32, the formula of the JAX kernels'
// `_gelu_f32` (ops/fused_refine_head.py).
__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(u));
}

// Derivative of gelu_tanh (the JAX kernels' `_gelu_grad_f32`).
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float x2 = x * x;
  const float t = tanhf(0.7978845608028654f * (x + 0.044715f * x * x2));
  const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * x2);
  return 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * du;
}

constexpr float kLnEps = 1e-5f;

// out[i] = sum_r part[r * stride + i] for i < L, summed in a fixed order
// (the second pass of every cross-block reduction, so a result does not
// change from run to run).  Block 32 x 32: 32 outputs, 32 row lanes.
static __global__ void __launch_bounds__(1024)
sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, int L,
                long long stride) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.x * 32 + tx;
  float acc = 0.0f;
  if (i < L)
    for (int r = ty; r < rows; r += 32) acc += part[(long long)r * stride + i];
  red[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && i < L) {
    float s = 0.0f;
    for (int k = 0; k < 32; ++k) s += red[k][tx];
    out[i] = s;
  }
}

static cudaError_t sum_rows(const float* part, float* out, int rows, int L, long long stride,
                            cudaStream_t st) {
  sum_rows_kernel<<<(L + 31) / 32, dim3(32, 32), 0, st>>>(part, out, rows, L, stride);
  return cudaGetLastError();
}

}  // namespace ssa
