// Decoder head: tanh-GELU then x4 depth-to-space, and its backward.
//
// Replaces: the Pallas kernels `_fwd_kernel` (launcher `_fwd_pallas`) and
// `_bwd_kernel` (launcher `_bwd_pallas`) in
// semantic_segmentation_of_stylegan2_artifacts_tpu/ops/fused_head.py.
//
// Forward: out[b, 4h+p1, 4w+p2, c] = GELU(x[b, h, w, (4*p1+p2)*C + c]),
// (B,H,W,16C) -> (B,4H,4W,C), the GELU in float32 and rounded to the
// storage type.  Backward: dx[b, h, w, (4*p1+p2)*C + c] =
// dout[b, 4h+p1, 4w+p2, c] * GELU'(x[...]) in float32, rounded.
//
// Bound on the H100: pure bandwidth, each element read once and written
// once (forward) or two read and one written (backward), a few float32
// operations each.  Design: one thread moves one 16-byte vector (8 bf16 or
// 4 float32 values); a vector never straddles a C-channel block when
// C is a multiple of the vector width, so the depth-to-space is one
// computed store address per vector.  Reads are contiguous; writes are
// runs of C values.  A grid-stride loop covers any size.
#include "common.cuh"

namespace ssa {

// One 16-byte vector of T, moved as a uint4 and unpacked by memcpy
// (register moves after optimisation).
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(v, &raw, 16);
  }
  __device__ __forceinline__ void store(T* p) const {
    uint4 raw;
    memcpy(&raw, v, 16);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// Output offset (in elements) of input element e = vector start.
__device__ __forceinline__ long long d2s4_offset(long long e, int H, int W, int C) {
  const long long c16 = 16LL * C;
  const long long pix = e / c16;
  const int ch = (int)(e - pix * c16);
  const int q = ch / C, c = ch - q * C;
  const long long bh = pix / W;
  const int w = (int)(pix - bh * W);
  const long long b = bh / H;
  const int h = (int)(bh - b * H);
  return ((b * 4 * H + 4 * h + (q >> 2)) * (4LL * W) + 4 * w + (q & 3)) * C + c;
}

template <typename T>
__global__ void __launch_bounds__(256)
gelu_d2s4_fwd_kernel(const T* __restrict__ x, T* __restrict__ out, int H, int W, int C,
                     long long nvec) {
  using V = Vec16<T>;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * V::N;
    V a;
    a.load(x + e);
#pragma unroll
    for (int j = 0; j < V::N; ++j) a.v[j] = from_f<T>(gelu_tanh(to_f(a.v[j])));
    a.store(out + d2s4_offset(e, H, W, C));
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
gelu_d2s4_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                     int H, int W, int C, long long nvec) {
  using V = Vec16<T>;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * V::N;
    V a, d;
    a.load(x + e);
    d.load(g + d2s4_offset(e, H, W, C));
#pragma unroll
    for (int j = 0; j < V::N; ++j)
      a.v[j] = from_f<T>(to_f(d.v[j]) * gelu_tanh_grad(to_f(a.v[j])));
    a.store(dx + e);
  }
}

static int grid_for(long long nvec) {
  const long long blocks = (nvec + 255) / 256;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

template <typename T>
static cudaError_t fwd(const void* x, void* out, int B, int H, int W, int C, cudaStream_t st) {
  if (C % Vec16<T>::N) return cudaErrorInvalidValue;
  const long long nvec = (long long)B * H * W * 16 * C / Vec16<T>::N;
  gelu_d2s4_fwd_kernel<T><<<grid_for(nvec), 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), H, W, C, nvec);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bwd(const void* x, const void* g, void* dx, int B, int H, int W, int C,
                       cudaStream_t st) {
  if (C % Vec16<T>::N) return cudaErrorInvalidValue;
  const long long nvec = (long long)B * H * W * 16 * C / Vec16<T>::N;
  gelu_d2s4_bwd_kernel<T><<<grid_for(nvec), 256, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), H, W, C, nvec);
  return cudaGetLastError();
}

}  // namespace ssa

// x (B,H,W,16C) -> out (B,4H,4W,C); C a multiple of 8 (bf16) or 4 (float32).
extern "C" int ssa_gelu_d2s4_fwd(const void* x, void* out, int B, int H, int W, int C,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16) return (int)ssa::fwd<__nv_bfloat16>(x, out, B, H, W, C, st);
  return (int)ssa::fwd<float>(x, out, B, H, W, C, st);
}

// x (B,H,W,16C), g = dout (B,4H,4W,C) -> dx (B,H,W,16C).
extern "C" int ssa_gelu_d2s4_bwd(const void* x, const void* g, void* dx, int B, int H, int W,
                                 int C, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16) return (int)ssa::bwd<__nv_bfloat16>(x, g, dx, B, H, W, C, st);
  return (int)ssa::bwd<float>(x, g, dx, B, H, W, C, st);
}
