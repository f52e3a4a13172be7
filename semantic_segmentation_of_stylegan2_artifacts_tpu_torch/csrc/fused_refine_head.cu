// Decoder head tail forward: tanh-GELU -> x4 depth-to-space -> 3x3 conv
// + b1 -> tanh-GELU -> 3x3 conv + b2 -> LayerNorm(C), C = 128.
//
// Replaces: the Pallas kernel `_fwd_kernel` (inference variant of the
// shared `_fwd_body`, launcher `_fwd_pallas`) in
// semantic_segmentation_of_stylegan2_artifacts_tpu/ops/fused_refine_head.py.
//
// Numerics as the TPU kernel: the conv input is GELU(y) in float32 rounded
// to the storage type; each conv accumulates in float32, rounds to the
// storage type and adds its bias in the storage type; h1 outside the image
// is zero (SAME padding of conv2's input, not GELU of a padded conv); the
// LayerNorm takes float32 fast-variance stats (not clamped, as the TPU
// kernel) and applies gamma/beta in float32.
//
// Bound on the H100: operations.  Each conv is a (B*4Ht*4Wt) x 128 x 1152
// implicit GEMM, 2 x 618 GFLOP at 512^2 batch 8, ~1.25 ms at 989 TFLOP/s
// bf16, against ~0.8 GB of traffic.  Design: two launches (one call of
// the wrapper, one count).  The first
// builds its A tiles on the fly from y (GELU + the p1-major depth-to-space
// gather are index arithmetic on the load, so the x4-upsampled input never
// exists in device memory), and writes h1 = GELU(conv1 + b1) in the storage
// type; the second reads h1 with zero padding, adds b2 and runs the
// LayerNorm in its epilogue with one warp per pixel row.  The h1 round trip
// costs 2 x B*512*512*128 x itemsize bytes (1.07 GB in bf16 at batch 8,
// ~0.3 ms at 3.35 TB/s), small against the convs.  Each block owns one
// segment of an output row and all 128 output channels and streams the
// weights one tap at a time.  bfloat16 (the deployment type) runs on the
// tensor cores with nvcuda::wmma tiles and float32 accumulators (see
// refine_conv_wmma_kernel); float32 (the parity type) runs on the CUDA
// cores in float32, 8 x 4 outputs per thread.  Both are far from the
// bound: no asynchronous copies, one block per SM; wgmma/TMA tiles are
// later work.
#include <mma.h>

#include "common.cuh"

namespace ssa {

constexpr int kC = 128;     // channels (the only width the kernel takes)
constexpr int kPix = 64;    // output pixels per block (one row segment)
constexpr int kCin = 16;    // input channels per shared-memory step

template <typename T, bool kFirst>
__global__ void __launch_bounds__(256)
refine_conv_kernel(const T* __restrict__ src, const T* __restrict__ w,
                   const T* __restrict__ bias, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ dst, int H, int W) {
  __shared__ float As[kCin][kPix + 1];
  __shared__ float Bs[kCin][kC];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kPix, r = blockIdx.y, b = blockIdx.z;
  const int Ht = H / 4, Wt = W / 4;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int rr = r + tap / 3 - 1, dv = tap % 3 - 1;
    const bool row_ok = rr >= 0 && rr < H;
    for (int ci0 = 0; ci0 < kC; ci0 += kCin) {
      for (int e = threadIdx.x; e < kPix * kCin; e += blockDim.x) {
        const int m = e / kCin, kk = e - m * kCin;
        const int cc = p0 + m + dv, ci = ci0 + kk;
        float val = 0.0f;
        if (row_ok && cc >= 0 && cc < W && p0 + m < W) {
          if (kFirst) {
            // depth-to-space x4, p1-major: pixel (rr, cc) is channel block
            // (rr%4)*4 + cc%4 of token (rr/4, cc/4)
            const long long t = ((long long)(b * Ht + rr / 4) * Wt + cc / 4) * (16 * kC);
            val = round_to<T>(gelu_tanh(to_f(src[t + ((rr & 3) * 4 + (cc & 3)) * kC + ci])));
          } else {
            val = to_f(src[((long long)(b * H + rr) * W + cc) * kC + ci]);
          }
        }
        As[kk][m] = val;
      }
      for (int e = threadIdx.x; e < kCin * kC; e += blockDim.x) {
        const int kk = e / kC, n = e - kk * kC;
        Bs[kk][n] = to_f(w[((long long)tap * kC + ci0 + kk) * kC + n]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kCin; ++kk) {
        float a[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[kk][warp * 8 + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][lane + 32 * c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] += a[i] * bv[c];
      }
      __syncthreads();
    }
  }

  float bb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) bb[c] = to_f(bias[lane + 32 * c]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + warp * 8 + i;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = round_to<T>(round_to<T>(acc[i][c]) + bb[c]);
    const long long o = ((long long)(b * H + r) * W + p) * kC;
    if (kFirst) {
      if (p < W)
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[o + lane + 32 * c] = from_f<T>(gelu_tanh(v[c]));
    } else {
      float s = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s += v[c];
        s2 += v[c] * v[c];
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float mu = s / kC;
      const float inv = 1.0f / sqrtf(s2 / kC - mu * mu + kLnEps);
      if (p < W)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = lane + 32 * c;
          dst[o + n] = from_f<T>((v[c] - mu) * inv * gamma[n] + beta[n]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 path on the tensor cores (nvcuda::wmma 16x16x16, float32
// accumulators).  A block owns 128 pixels of one output row and all 128
// output channels.  It stages the three input rows it needs (130 pixels
// with the halo, GELU'd and depth-to-space gathered for conv1) once in
// shared memory, so every tap's A tile is an offset view of that stage and
// nothing is recomputed per tap; the weights stream one 128x128 tap at a
// time.  8 warps as 4 (pixels) x 2 (channels), each 32 x 64 outputs.  The
// epilogue writes the accumulators to shared memory (over the stage) and
// runs bias, GELU or LayerNorm one warp per pixel.
// ---------------------------------------------------------------------------
constexpr int kTile = 128;          // pixels per block
constexpr int kHaloW = kTile + 2;   // staged pixels per row
constexpr size_t kWmmaSmem =
    sizeof(__nv_bfloat16) * (3 * kHaloW * kC + kC * kC);  // 132,608 bytes

template <bool kFirst>
__global__ void __launch_bounds__(256)
refine_conv_wmma_kernel(const __nv_bfloat16* __restrict__ src,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        __nv_bfloat16* __restrict__ dst, int H, int W) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [3][kHaloW][kC]
  bf16* ws = xs + 3 * kHaloW * kC;               // [kC][kC], one tap
  float* cs = reinterpret_cast<float*>(smem_raw);  // [kTile][kC] after the GEMM

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kTile, r = blockIdx.y, b = blockIdx.z;
  const int Ht = H / 4, Wt = W / 4;
  constexpr int kVec = kC / 8;  // 16-byte chunks per pixel

  for (int e = threadIdx.x; e < 3 * kHaloW * kVec; e += blockDim.x) {
    const int q = e % kVec, pix = e / kVec;
    const int rr = r + pix / kHaloW - 1, cc = p0 + pix % kHaloW - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
      if (kFirst) {
        const long long t = ((long long)(b * Ht + rr / 4) * Wt + cc / 4) * (16 * kC);
        v = *reinterpret_cast<const uint4*>(src + t + ((rr & 3) * 4 + (cc & 3)) * kC + q * 8);
        bf16* e8 = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) e8[i] = from_f<bf16>(gelu_tanh(to_f(e8[i])));
      } else {
        v = *reinterpret_cast<const uint4*>(src + ((long long)(b * H + rr) * W + cc) * kC +
                                            q * 8);
      }
    }
    *reinterpret_cast<uint4*>(xs + (size_t)pix * kC + q * 8) = v;
  }

  const int wm = warp >> 1, wn = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // the stage is complete; the previous tap's reads are done
    const uint4* wsrc = reinterpret_cast<const uint4*>(w + (size_t)tap * kC * kC);
    for (int e = threadIdx.x; e < kC * kC / 8; e += blockDim.x)
      reinterpret_cast<uint4*>(ws)[e] = wsrc[e];
    __syncthreads();
    const int u = tap / 3, v = tap % 3;
#pragma unroll 2
    for (int k0 = 0; k0 < kC; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + ((size_t)u * kHaloW + wm * 32 + i * 16 + v) * kC + k0,
                               kC);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bm[j], ws + (size_t)k0 * kC + wn * 64 + j * 16, kC);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
    }
  }
  __syncthreads();  // every warp is done with the stage before it is overwritten
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(cs + (size_t)(wm * 32 + i * 16) * kC + wn * 64 + j * 16,
                              acc[i][j], kC, wmma::mem_row_major);
  __syncthreads();

  float bb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) bb[c] = to_f(bias[lane + 32 * c]);
  for (int i = 0; i < kTile / 8; ++i) {
    const int m = warp * (kTile / 8) + i, p = p0 + m;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[c] = round_to<bf16>(round_to<bf16>(cs[m * kC + lane + 32 * c]) + bb[c]);
    const long long o = ((long long)(b * H + r) * W + p) * kC;
    if (kFirst) {
      if (p < W)
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[o + lane + 32 * c] = from_f<bf16>(gelu_tanh(v[c]));
    } else {
      float s = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s += v[c];
        s2 += v[c] * v[c];
      }
      s = warp_sum(s);
      s2 = warp_sum(s2);
      const float mu = s / kC;
      const float inv = 1.0f / sqrtf(s2 / kC - mu * mu + kLnEps);
      if (p < W)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = lane + 32 * c;
          dst[o + n] = from_f<bf16>((v[c] - mu) * inv * gamma[n] + beta[n]);
        }
    }
  }
}

static cudaError_t refine_wmma(const void* y, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* g, const void* be, void* h1,
                               void* out, int B, int Ht, int Wt, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const int H = 4 * Ht, W = 4 * Wt;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(refine_conv_wmma_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kWmmaSmem)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(refine_conv_wmma_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kWmmaSmem)) != cudaSuccess)
    return e;
  dim3 grid((W + kTile - 1) / kTile, H, B);
  refine_conv_wmma_kernel<true><<<grid, 256, kWmmaSmem, st>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      nullptr, nullptr, static_cast<bf16*>(h1), H, W);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  refine_conv_wmma_kernel<false><<<grid, 256, kWmmaSmem, st>>>(
      static_cast<const bf16*>(h1), static_cast<const bf16*>(w2), static_cast<const bf16*>(b2),
      static_cast<const float*>(g), static_cast<const float*>(be), static_cast<bf16*>(out), H,
      W);
  return cudaGetLastError();
}

static cudaError_t refine_f32(const void* y, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* g, const void* be, void* h1,
                              void* out, int B, int Ht, int Wt, cudaStream_t st) {
  using T = float;
  const int H = 4 * Ht, W = 4 * Wt;
  dim3 grid((W + kPix - 1) / kPix, H, B);
  refine_conv_kernel<T, true><<<grid, 256, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(w1), static_cast<const T*>(b1), nullptr,
      nullptr, static_cast<T*>(h1), H, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  refine_conv_kernel<T, false><<<grid, 256, 0, st>>>(
      static_cast<const T*>(h1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const float*>(g), static_cast<const float*>(be), static_cast<T*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace ssa

// y (B,Ht,Wt,16*128); w1/w2 HWIO (3,3,128,128) and b1/b2 (128) in the
// storage type; g/be float32 (128); h1 scratch and out (B,4Ht,4Wt,128).
extern "C" int ssa_refine_head_fwd(const void* y, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* g, const void* be, void* h1,
                                   void* out, int B, int Ht, int Wt, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16)
    return (int)ssa::refine_wmma(y, w1, b1, w2, b2, g, be, h1, out, B, Ht, Wt, st);
  return (int)ssa::refine_f32(y, w1, b1, w2, b2, g, be, h1, out, B, Ht, Wt, st);
}
