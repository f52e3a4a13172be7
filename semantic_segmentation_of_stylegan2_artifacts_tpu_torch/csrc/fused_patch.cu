// PatchMerging and PatchExpand forwards: relayout + LayerNorm + Linear.
//
// Replaces: the Pallas kernels `_merge_fwd_kernel` (launcher
// `_merge_fwd_pallas`) and `_expand_fwd_kernel` (launcher
// `_expand_fwd_pallas`) in
// semantic_segmentation_of_stylegan2_artifacts_tpu/ops/fused_patch.py.
//
// Merge: (B,H,W,C) -> 2x2 space-to-depth in [x0|x1|x2|x3] order -> LN(4C)
// with float32 fast-variance stats clamped at 0 -> rounded to the storage
// type -> @W (4C,2C) with float32 accumulation -> (B,H/2,W/2,2C).
// Expand: (B,H,W,C) @W (C,2C) in float32 -> rounded to the storage type ->
// LN over each C/2 group g = 2*p1+p2 -> stored at (b, 2h+p1, 2w+p2, :).
//
// Bound on the H100: at the main-path shapes both are small GEMMs
// (K <= 2048, N <= 1024) whose inputs are read once; by bytes over
// 3.35 TB/s and FLOPs over 989 TFLOP/s they sit near the balance point, so
// the relayout passes the TPU kernel removed are what matter.  Design: the
// 2x2 gather (merge) and the depth-to-space scatter (expand) are index
// arithmetic on the global addresses, so neither relayout touches device
// memory.  Merge computes each row tile's LN stats first, then streams K in
// chunks of 16 and applies the LN while loading the A tile (a whole
// 64 x 2048 A block would not fit shared memory); expand keeps a
// 32 x C/2 float32 accumulator in registers so the LN of a group runs in
// the epilogue with one warp per row; it takes every group width C/2 that
// is a multiple of 32 up to 512 (one template instance per width, Swin-B's
// 128/256/512 and Swin-T's 96/192/384 among them).  The products run on
// the CUDA cores in float32; tensor cores are later work.
#include "fused_patch.cuh"

namespace ssa {

template <typename T, int NPT>
__global__ void __launch_bounds__(256)
patch_merge_fwd_kernel(const T* __restrict__ x, const float* __restrict__ sc,
                       const float* __restrict__ lb, const T* __restrict__ w,
                       T* __restrict__ out, int H, int W, int C, int M) {
  constexpr int BN = 32 * NPT;
  __shared__ float mean_s[kRows], rstd_s[kRows];
  __shared__ long long base_s[kRows];
  __shared__ float As[kChunk][kRows + 1];
  __shared__ float Bs[kChunk][BN];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * BN;
  const int K = 4 * C, N = 2 * C;
  const long long wc = (long long)W * C;

  if (threadIdx.x < kRows) base_s[threadIdx.x] = merge_base(m0 + threadIdx.x, H, W, C, M);
  __syncthreads();
  auto offset = [&](int k) { return merge_offset(k, C, wc); };

  for (int r = 0; r < 4; ++r) {
    const int row = warp * 4 + r;
    const long long base = base_s[row];
    float s = 0.0f, s2 = 0.0f;
    if (base >= 0)
      for (int k = lane; k < K; k += 32) {
        const float v = to_f(x[base + offset(k)]);
        s += v;
        s2 += v * v;
      }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s / K;
      const float var = fmaxf(s2 / K - mean * mean, 0.0f);
      mean_s[row] = mean;
      rstd_s[row] = 1.0f / sqrtf(var + kLnEps);
    }
  }
  __syncthreads();

  float acc[4][NPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NPT; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int e = threadIdx.x; e < kRows * kChunk; e += blockDim.x) {
      const int row = e / kChunk, kk = e - row * kChunk, k = k0 + kk;
      const long long base = base_s[row];
      float v = 0.0f;
      if (base >= 0) {
        const float xhat = (to_f(x[base + offset(k)]) - mean_s[row]) * rstd_s[row];
        v = round_to<T>(xhat * sc[k] + lb[k]);
      }
      As[kk][row] = v;
    }
    for (int e = threadIdx.x; e < kChunk * BN; e += blockDim.x) {
      const int kk = e / BN, nn = e - kk * BN;
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

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + warp * 4 + r;
    if (m < M)
#pragma unroll
      for (int c = 0; c < NPT; ++c)
        out[(long long)m * N + n0 + lane + 32 * c] = from_f<T>(acc[r][c]);
  }
}

template <typename T, int NPT>
__global__ void __launch_bounds__(256)
patch_expand_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ sc, const float* __restrict__ lb,
                        T* __restrict__ out, int H, int W, int C, int M) {
  constexpr int NG = 32 * NPT;  // group width C/2
  __shared__ float As[kChunk][kRows + 1];
  __shared__ float Bs[kChunk][NG];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kRows, g = blockIdx.y, n0 = g * NG;
  float acc[4][NPT];
  expand_product<T, NPT>(x, w, As, Bs, acc, m0, n0, C, M);

  const int p1 = g >> 1, p2 = g & 1;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      acc[r][c] = round_to<T>(acc[r][c]);
      s += acc[r][c];
      s2 += acc[r][c] * acc[r][c];
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / NG;
    const float var = fmaxf(s2 / NG - mean * mean, 0.0f);
    const float rstd = 1.0f / sqrtf(var + kLnEps);
    const int m = m0 + warp * 4 + r;
    if (m < M) {
      const int b = m / (H * W), rem = m - b * H * W;
      const int hh = rem / W, wv = rem - hh * W;
      const long long base =
          ((long long)(b * 2 * H + 2 * hh + p1) * (2 * W) + 2 * wv + p2) * NG;
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const int col = lane + 32 * c;
        const float xhat = (acc[r][c] - mean) * rstd;
        out[base + col] = from_f<T>(xhat * sc[col] + lb[col]);
      }
    }
  }
}

template <typename T>
static cudaError_t merge(const void* x, const void* sc, const void* lb, const void* w, void* out,
                         int B, int H, int W, int C, cudaStream_t st) {
  const int M = B * (H / 2) * (W / 2), N = 2 * C;
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  const auto* s = static_cast<const float*>(sc);
  const auto* l = static_cast<const float*>(lb);
  auto* o = static_cast<T*>(out);
  const int gm = (M + kRows - 1) / kRows;
  if (N % 128 == 0)
    patch_merge_fwd_kernel<T, 4><<<dim3(gm, N / 128), 256, 0, st>>>(xt, s, l, wt, o, H, W, C, M);
  else
    patch_merge_fwd_kernel<T, 1><<<dim3(gm, N / 32), 256, 0, st>>>(xt, s, l, wt, o, H, W, C, M);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t expand(const void* x, const void* w, const void* sc, const void* lb, void* out,
                          int B, int H, int W, int C, cudaStream_t st) {
  const int M = B * H * W;
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  const auto* s = static_cast<const float*>(sc);
  const auto* l = static_cast<const float*>(lb);
  auto* o = static_cast<T*>(out);
  dim3 grid((M + kRows - 1) / kRows, 4);
  if (C % 64 || C / 64 < 1 || C / 64 > 16) return cudaErrorInvalidValue;
  switch (C / 64) {  // C/2 = 32 * NPT
#define SSA_CASE(n) \
  case n: patch_expand_fwd_kernel<T, n><<<grid, 256, 0, st>>>(xt, wt, s, l, o, H, W, C, M); break;
    SSA_EXPAND_NPT(SSA_CASE)
#undef SSA_CASE
  }
  return cudaGetLastError();
}

}  // namespace ssa

// w is (4C, 2C), input-major; sc/lb are float32 (4C).
extern "C" int ssa_patch_merge_fwd(const void* x, const void* sc, const void* lb, const void* w,
                                   void* out, int B, int H, int W, int C, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16)
    return (int)ssa::merge<__nv_bfloat16>(x, sc, lb, w, out, B, H, W, C, st);
  return (int)ssa::merge<float>(x, sc, lb, w, out, B, H, W, C, st);
}

// w is (C, 2C), input-major; sc/lb are float32 (C/2).
extern "C" int ssa_patch_expand_fwd(const void* x, const void* w, const void* sc, const void* lb,
                                    void* out, int B, int H, int W, int C, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16)
    return (int)ssa::expand<__nv_bfloat16>(x, w, sc, lb, out, B, H, W, C, st);
  return (int)ssa::expand<float>(x, w, sc, lb, out, B, H, W, C, st);
}
