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

#include <cstdint>

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

// ---------------------------------------------------------------------------
// PTX helpers of the tensor-core kernels (the refine head's conv core and
// the window-attention kernels): asynchronous 16-byte copies into shared
// memory, 8x8 matrix fragment loads and stores, bf16 pair packing.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing registers; `ok` false writes
// zeros (SAME padding, ragged edges) and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 bf16 matrices, one 16-byte row address per lane (lane 8i + j
// gives row j of matrix i); register i holds matrix i as an mma fragment.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// The same with each matrix transposed on the way in.
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The reverse of `ldsm4`: four 8x8 bf16 matrices from fragment registers to
// the rows the lanes address.
__device__ __forceinline__ void stsm4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 16 bytes global -> shared, unconditionally.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
// One 16-byte (8-byte) store to device memory: the compiler may split a
// uint4 (float2) assignment into 4-byte stores.
__device__ __forceinline__ void st_global16(void* dst, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(dst), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}
__device__ __forceinline__ void st_global8(float* dst, float a, float b) {
  asm volatile("st.global.v2.f32 [%0], {%1, %2};\n" ::"l"(dst), "f"(a), "f"(b) : "memory");
}
// Two 8x8 bf16 matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// The same with each matrix transposed on the way in.
__device__ __forceinline__ void ldsm2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// D (16 x 8, float32) += A (16 x 16 bf16, row fragments) . B (16 x 8 bf16,
// column fragments): one warp-level tensor-core product.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
