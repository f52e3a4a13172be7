// Decoder head tail: tanh-GELU -> x4 depth-to-space -> 3x3 conv + b1 ->
// tanh-GELU -> 3x3 conv + b2 -> LayerNorm(C), C = 128, forward and backward.
//
// Replaces, in semantic_segmentation_of_stylegan2_artifacts_tpu/ops/
// fused_refine_head.py: the Pallas kernels `_fwd_kernel` (inference) and
// `_fwd_res_kernel` (training: it also saves `pre` = conv1 + b1 and `a2` =
// conv2 + b2 in the storage type), both of `_fwd_pallas`, and
// `_bwd_kernel` (`_bwd_pallas`).  The backward is documented below
// `refine_conv_wmma_kernel`.
//
// Numerics as the TPU kernel: the conv input is GELU(y) in float32 rounded
// to the storage type; each conv accumulates in float32, rounds to the
// storage type and adds its bias in the storage type; h1 outside the image
// is zero (SAME padding of conv2's input, not GELU of a padded conv); the
// LayerNorm takes float32 fast-variance stats (not clamped, as the TPU
// kernel) and applies gamma/beta in float32.
//
// Forward bound on the H100: operations.  Each conv is a (B*4Ht*4Wt) x 128 x 1152
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
// cores in float32, 8 x 4 outputs per thread.  The training forward is the
// same two launches with two more stores in their epilogues.  Both are far from the
// bound: no asynchronous copies, one block per SM; wgmma/TMA tiles are
// later work.
#include <mma.h>

#include "common.cuh"

namespace ssa {

constexpr int kC = 128;     // channels (the only width the kernel takes)
constexpr int kPix = 64;    // output pixels per block (one row segment), CUDA cores
constexpr int kCin = 16;    // input channels per shared-memory step
constexpr int kTile = 128;  // output pixels per block, tensor cores

// What one implicit-GEMM conv launch computes.  Every mode is a SAME 3x3
// conv over (B, H, W, 128) with weights (3, 3, Cin, Cout); the modes differ
// in the A operand they build and in the epilogue.
enum ConvMode {
  kConv1 = 0,  // A = GELU(y) x4 depth-to-space; pre = acc + b1; h1 = GELU(pre)
  kConv2 = 1,  // A = h1; a2 = acc + b2; out = LN(a2)
  kDh1 = 2,    // A = da2, W2 flipped; da1 = acc * GELU'(pre); db1 partials
  kDxp = 3,    // A = da1, W1 flipped; dy = s2d(acc) * GELU'(y)
};

template <typename T>
struct ConvArgs {
  const T* src;         // A operand's source (y, h1, da2 or da1)
  const T* w;           // (3, 3, Cin, Cout)
  const T* bias;        // b1 / b2 (forward modes)
  const float* gamma;   // LN (kConv2)
  const float* beta;
  T* dst;               // h1, out, da1 or dy
  T* res;               // optional saved residual: pre (kConv1) / a2 (kConv2)
  const T* aux;         // pre (kDh1) / y (kDxp)
  float* part;          // per-block db1 partials (kDh1), (blocks, 128)
  int H, W;
};

// One A-operand element: pixel (rr, cc), channel ci; zero outside the image.
template <typename T, int kMode>
__device__ __forceinline__ float conv_src(const ConvArgs<T>& a, int b, int rr, int cc, int ci) {
  if (rr < 0 || rr >= a.H || cc < 0 || cc >= a.W) return 0.0f;
  if (kMode == kConv1) {
    // depth-to-space x4, p1-major: pixel (rr, cc) is channel block
    // (rr%4)*4 + cc%4 of token (rr/4, cc/4)
    const long long t = ((long long)(b * (a.H / 4) + rr / 4) * (a.W / 4) + cc / 4) * (16 * kC);
    return round_to<T>(gelu_tanh(to_f(a.src[t + ((rr & 3) * 4 + (cc & 3)) * kC + ci])));
  }
  return to_f(a.src[((long long)(b * a.H + rr) * a.W + cc) * kC + ci]);
}

// Epilogue of one pixel row segment: `v` holds the float32 sums of
// channels lane + 32c of pixel (r, p); `psum` collects db1's per-lane sums.
// Every lane of the warp calls it (the LayerNorm reduces across lanes).
template <typename T, int kMode>
__device__ __forceinline__ void conv_epilogue(const ConvArgs<T>& a, int b, int r, int p,
                                              int lane, const float* acc, float* psum) {
  const bool ok = p < a.W;
  const long long o = ((long long)(b * a.H + r) * a.W + p) * kC;
  float v[4];
  if (kMode == kConv1 || kMode == kConv2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = round_to<T>(round_to<T>(acc[c]) + to_f(a.bias[lane + 32 * c]));
    if (ok && a.res)
#pragma unroll
      for (int c = 0; c < 4; ++c) a.res[o + lane + 32 * c] = from_f<T>(v[c]);
  }
  if (kMode == kConv1) {
    if (ok)
#pragma unroll
      for (int c = 0; c < 4; ++c) a.dst[o + lane + 32 * c] = from_f<T>(gelu_tanh(v[c]));
  } else if (kMode == kConv2) {
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
    if (ok)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = lane + 32 * c;
        a.dst[o + n] = from_f<T>((v[c] - mu) * inv * a.gamma[n] + a.beta[n]);
      }
  } else if (kMode == kDh1) {
    if (ok)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float da1 = acc[c] * gelu_tanh_grad(to_f(a.aux[o + lane + 32 * c]));
        a.dst[o + lane + 32 * c] = from_f<T>(da1);
        psum[c] += da1;
      }
  } else {  // kDxp: space-to-depth back onto y's layout
    if (ok) {
      const long long t = ((long long)(b * (a.H / 4) + r / 4) * (a.W / 4) + p / 4) * (16 * kC) +
                          ((r & 3) * 4 + (p & 3)) * kC;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long i = t + lane + 32 * c;
        a.dst[i] = from_f<T>(acc[c] * gelu_tanh_grad(to_f(a.aux[i])));
      }
    }
  }
}

// db1 partials: the block's 8 warps' per-lane sums -> part[block][128].
__device__ __forceinline__ void block_partial(float* red, float* part, const float* psum,
                                              int warp, int lane) {
#pragma unroll
  for (int c = 0; c < 4; ++c) red[warp * kC + lane + 32 * c] = psum[c];
  __syncthreads();
  if (threadIdx.x < kC) {
    float s = 0.0f;
    for (int k = 0; k < 8; ++k) s += red[k * kC + threadIdx.x];
    const long long blk = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    part[blk * kC + threadIdx.x] = s;
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(256) refine_conv_kernel(const ConvArgs<T> a) {
  __shared__ float As[kCin][kPix + 1];
  __shared__ float Bs[kCin][kC];
  __shared__ float red[8 * kC];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kPix, r = blockIdx.y, b = blockIdx.z;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int rr = r + tap / 3 - 1, dv = tap % 3 - 1;
    for (int ci0 = 0; ci0 < kC; ci0 += kCin) {
      for (int e = threadIdx.x; e < kPix * kCin; e += blockDim.x) {
        const int m = e / kCin, kk = e - m * kCin;
        As[kk][m] = p0 + m < a.W ? conv_src<T, kMode>(a, b, rr, p0 + m + dv, ci0 + kk) : 0.0f;
      }
      for (int e = threadIdx.x; e < kCin * kC; e += blockDim.x) {
        const int kk = e / kC, n = e - kk * kC;
        Bs[kk][n] = to_f(a.w[((long long)tap * kC + ci0 + kk) * kC + n]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kCin; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[kk][warp * 8 + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[kk][lane + 32 * c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] += av[i] * bv[c];
      }
      __syncthreads();
    }
  }

  float psum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    conv_epilogue<T, kMode>(a, b, r, p0 + warp * 8 + i, lane, acc[i], psum);
  if (kMode == kDh1) block_partial(red, a.part, psum, warp, lane);
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
// runs it one warp per pixel.
// ---------------------------------------------------------------------------
constexpr int kHaloW = kTile + 2;   // staged pixels per row
constexpr size_t kWmmaSmem =
    sizeof(__nv_bfloat16) * (3 * kHaloW * kC + kC * kC);  // 132,608 bytes

template <int kMode>
__global__ void __launch_bounds__(256) refine_conv_wmma_kernel(const ConvArgs<__nv_bfloat16> a) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [3][kHaloW][kC]
  bf16* ws = xs + 3 * kHaloW * kC;               // [kC][kC], one tap
  float* cs = reinterpret_cast<float*>(smem_raw);  // [kTile][kC] after the GEMM
  float* red = cs + kTile * kC;                    // [8][kC] db1 partials

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p0 = blockIdx.x * kTile, r = blockIdx.y, b = blockIdx.z;
  const int H = a.H, W = a.W, Ht = H / 4, Wt = W / 4;
  constexpr int kVec = kC / 8;  // 16-byte chunks per pixel

  for (int e = threadIdx.x; e < 3 * kHaloW * kVec; e += blockDim.x) {
    const int q = e % kVec, pix = e / kVec;
    const int rr = r + pix / kHaloW - 1, cc = p0 + pix % kHaloW - 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
      if (kMode == kConv1) {
        const long long t = ((long long)(b * Ht + rr / 4) * Wt + cc / 4) * (16 * kC);
        v = *reinterpret_cast<const uint4*>(a.src + t + ((rr & 3) * 4 + (cc & 3)) * kC + q * 8);
        bf16* e8 = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int i = 0; i < 8; ++i) e8[i] = from_f<bf16>(gelu_tanh(to_f(e8[i])));
      } else {
        v = *reinterpret_cast<const uint4*>(a.src + ((long long)(b * H + rr) * W + cc) * kC +
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
    const uint4* wsrc = reinterpret_cast<const uint4*>(a.w + (size_t)tap * kC * kC);
    for (int e = threadIdx.x; e < kC * kC / 8; e += blockDim.x)
      reinterpret_cast<uint4*>(ws)[e] = wsrc[e];
    __syncthreads();
    const int u = tap / 3, v = tap % 3;
#pragma unroll 2
    for (int k0 = 0; k0 < kC; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + ((size_t)u * kHaloW + wm * 32 + i * 16 + v) * kC + k0,
                               kC);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], ws + (size_t)k0 * kC + wn * 64 + j * 16, kC);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
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

  float psum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < kTile / 8; ++i) {
    const int m = warp * (kTile / 8) + i;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = cs[m * kC + lane + 32 * c];
    conv_epilogue<bf16, kMode>(a, b, r, p0 + m, lane, v, psum);
  }
  if (kMode == kDh1) block_partial(red, a.part, psum, warp, lane);
}

template <int kMode>
static cudaError_t conv_bf16(const ConvArgs<__nv_bfloat16>& a, int B, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(refine_conv_wmma_kernel<kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kWmmaSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.W + kTile - 1) / kTile, a.H, B);
  refine_conv_wmma_kernel<kMode><<<grid, 256, kWmmaSmem, st>>>(a);
  return cudaGetLastError();
}

template <int kMode>
static cudaError_t conv_f32(const ConvArgs<float>& a, int B, cudaStream_t st) {
  dim3 grid((a.W + kPix - 1) / kPix, a.H, B);
  refine_conv_kernel<float, kMode><<<grid, 256, 0, st>>>(a);
  return cudaGetLastError();
}

template <int kMode, typename T>
static cudaError_t conv(const ConvArgs<T>& a, int B, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) return conv_bf16<kMode>(a, B, st);
  else return conv_f32<kMode>(a, B, st);
}

template <typename T>
static cudaError_t refine_fwd(const void* y, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* g, const void* be, void* h1, void* out,
                              void* pre, void* a2, int B, int Ht, int Wt, cudaStream_t st) {
  ConvArgs<T> a{};
  a.H = 4 * Ht;
  a.W = 4 * Wt;
  a.src = static_cast<const T*>(y);
  a.w = static_cast<const T*>(w1);
  a.bias = static_cast<const T*>(b1);
  a.dst = static_cast<T*>(h1);
  a.res = static_cast<T*>(pre);
  cudaError_t e = conv<kConv1>(a, B, st);
  if (e != cudaSuccess) return e;
  a.src = static_cast<const T*>(h1);
  a.w = static_cast<const T*>(w2);
  a.bias = static_cast<const T*>(b2);
  a.gamma = static_cast<const float*>(g);
  a.beta = static_cast<const float*>(be);
  a.dst = static_cast<T*>(out);
  a.res = static_cast<T*>(a2);
  return conv<kConv2>(a, B, st);
}

// ===========================================================================
// Backward (replaces `_bwd_kernel`).  From y, pre, a2 and dout it computes
// dy and the float32 gradients of W1, b1, W2, b2, gamma, beta with no conv
// recomputed (JAX fused_refine_head.py:235-377):
//   1. ln_bwd: per pixel, LN statistics recomputed from a2, da2 (stored in
//      the storage type), and per-block partial sums of dgamma, dbeta, db2
//      from the float32 values;
//   2. conv kDh1: dh1 = da2 (*) W2 transposed (a forward conv with the taps
//      flipped and in/out swapped), da1 = dh1 * GELU'(pre) stored in the
//      storage type, db1 partials from the float32 da1; only in-image
//      pixels are computed, which is what the TPU's halo zeroing left;
//   3. dW2 = sum over pixels of h1-patch^T . da2, h1 = GELU(pre) rounded as
//      in the forward;
//   4. conv kDxp: dxp = da1 (*) W1 transposed in float32, then dy = the
//      space-to-depth gather of dxp * GELU'(y);
//   5. dW1 = sum over pixels of xp-patch^T . da1, xp = GELU(y) rounded;
//   6. sum_rows adds every partial in a fixed order.
// Bound on the H100: operations.  Steps 2-5 are four conv-sized products,
// 4 x 618 GFLOP at 512^2 batch 8, ~2.5 ms at 989 TFLOP/s bf16, twice the
// forward's bound.  The weight gradients reduce over B*512*512 pixels: the
// TPU summed them in scratch across its sequential grid; here each block
// owns one tap and a chunk of pixel rows (split-K) and writes a float32
// 128 x 128 partial, which sum_rows adds, so results do not change from
// run to run.  bfloat16 runs every product on nvcuda::wmma tiles, float32
// on the CUDA cores.
// ===========================================================================
constexpr int kLnPix = 256;  // pixels per ln_bwd block
constexpr int kDwK = 64;     // pixels per weight-gradient step (tensor cores)
constexpr int kDwKf = 32;    // pixels per weight-gradient step (CUDA cores)

template <typename T>
__global__ void __launch_bounds__(256)
refine_ln_bwd_kernel(const T* __restrict__ a2, const T* __restrict__ dout,
                     const float* __restrict__ gamma, T* __restrict__ da2,
                     float* __restrict__ part, long long npix) {
  __shared__ float red[3][8][kC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sg[4] = {0, 0, 0, 0}, sb[4] = {0, 0, 0, 0}, s2[4] = {0, 0, 0, 0};
  float gm[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) gm[c] = gamma[lane + 32 * c];
  for (int k = warp; k < kLnPix; k += 8) {
    const long long pix = (long long)blockIdx.x * kLnPix + k;
    if (pix >= npix) break;
    const long long o = pix * kC;
    float x[4], d[4], s = 0.0f, sq = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[c] = to_f(a2[o + lane + 32 * c]);
      d[c] = to_f(dout[o + lane + 32 * c]);
      s += x[c];
      sq += x[c] * x[c];
    }
    s = warp_sum(s);
    sq = warp_sum(sq);
    const float mu = s / kC;
    const float inv = 1.0f / sqrtf(sq / kC - mu * mu + kLnEps);
    float xh[4], dxh[4], m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xh[c] = (x[c] - mu) * inv;
      dxh[c] = d[c] * gm[c];
      m1 += dxh[c];
      m2 += dxh[c] * xh[c];
    }
    m1 = warp_sum(m1) / kC;
    m2 = warp_sum(m2) / kC;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float g = (dxh[c] - m1 - xh[c] * m2) * inv;
      da2[o + lane + 32 * c] = from_f<T>(g);
      sg[c] += d[c] * xh[c];
      sb[c] += d[c];
      s2[c] += g;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red[0][warp][lane + 32 * c] = sg[c];
    red[1][warp][lane + 32 * c] = sb[c];
    red[2][warp][lane + 32 * c] = s2[c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 3 * kC; t += blockDim.x) {
    const int q = t / kC, n = t - q * kC;
    float s = 0.0f;
    for (int k = 0; k < 8; ++k) s += red[q][k][n];
    part[(long long)blockIdx.x * 3 * kC + t] = s;
  }
}

// Activation of a weight-gradient product at pixel (rr, cc): GELU of the
// saved pre (kFromY false: h1) or of y gathered by depth-to-space (kFromY
// true: xp), rounded to the storage type; zero outside the image.
template <typename T, bool kFromY>
__device__ __forceinline__ float dw_act(const T* act, int b, int rr, int cc, int ci, int H,
                                        int W) {
  if (rr < 0 || rr >= H || cc < 0 || cc >= W) return 0.0f;
  long long i;
  if (kFromY)
    i = ((long long)(b * (H / 4) + rr / 4) * (W / 4) + cc / 4) * (16 * kC) +
        ((rr & 3) * 4 + (cc & 3)) * kC + ci;
  else
    i = ((long long)(b * H + rr) * W + cc) * kC + ci;
  return round_to<T>(gelu_tanh(to_f(act[i])));
}

// dW[tap][ci][co] partial over pixel rows [rows*chunk, rows*(chunk+1)) of
// the flattened (B*H) rows; CUDA cores, 8 x 8 outputs per thread.
template <typename T, bool kFromY>
__global__ void __launch_bounds__(256)
refine_dw_kernel(const T* __restrict__ act, const T* __restrict__ da, float* __restrict__ part,
                 int B, int H, int W, int rows) {
  __shared__ float as[kDwKf][kC];
  __shared__ float bs[kDwKf][kC];
  const int tap = blockIdx.x, chunk = blockIdx.y;
  const int du = tap / 3 - 1, dv = tap % 3 - 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int r1 = min((chunk + 1) * rows, B * H);
  for (int gr = chunk * rows; gr < r1; ++gr) {
    const int b = gr / H, r = gr - b * H;
    for (int q0 = 0; q0 < W; q0 += kDwKf) {
      for (int e = threadIdx.x; e < kDwKf * kC; e += blockDim.x) {
        const int m = e / kC, c = e - m * kC, q = q0 + m;
        const bool ok = q < W;
        as[m][c] = ok ? dw_act<T, kFromY>(act, b, r + du, q + dv, c, H, W) : 0.0f;
        bs[m][c] = ok ? to_f(da[((long long)(b * H + r) * W + q) * kC + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kDwKf; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = as[k][ty * 8 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
      }
      __syncthreads();
    }
  }
  float* out = part + ((long long)chunk * 9 + tap) * kC * kC;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(ty * 8 + i) * kC + tx + 16 * j] = acc[i][j];
}

// The same on the tensor cores: A = act^T (ci x pixels, col-major view of
// the pixel-major stage), B = da (pixels x co); 8 warps as 4 (ci) x 2 (co),
// each 32 x 64 outputs, stored straight from the fragments.
template <bool kFromY>
__global__ void __launch_bounds__(256)
refine_dw_wmma_kernel(const __nv_bfloat16* __restrict__ act,
                      const __nv_bfloat16* __restrict__ da, float* __restrict__ part, int B,
                      int H, int W, int rows) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  __shared__ __align__(128) bf16 as[kDwK * kC];
  __shared__ __align__(128) bf16 bs[kDwK * kC];
  const int tap = blockIdx.x, chunk = blockIdx.y;
  const int du = tap / 3 - 1, dv = tap % 3 - 1;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  constexpr int kVec = kC / 8;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int r1 = min((chunk + 1) * rows, B * H);
  for (int gr = chunk * rows; gr < r1; ++gr) {
    const int b = gr / H, r = gr - b * H;
    for (int q0 = 0; q0 < W; q0 += kDwK) {
      for (int e = threadIdx.x; e < kDwK * kVec; e += blockDim.x) {
        const int m = e / kVec, c8 = (e - m * kVec) * 8;
        const int q = q0 + m, rr = r + du, cc = q + dv;
        uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
        if (q < W) {
          vb = *reinterpret_cast<const uint4*>(da + ((long long)(b * H + r) * W + q) * kC + c8);
          if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
            long long i;
            if (kFromY)
              i = ((long long)(b * (H / 4) + rr / 4) * (W / 4) + cc / 4) * (16 * kC) +
                  ((rr & 3) * 4 + (cc & 3)) * kC + c8;
            else
              i = ((long long)(b * H + rr) * W + cc) * kC + c8;
            va = *reinterpret_cast<const uint4*>(act + i);
            bf16* e8 = reinterpret_cast<bf16*>(&va);
#pragma unroll
            for (int k = 0; k < 8; ++k) e8[k] = from_f<bf16>(gelu_tanh(to_f(e8[k])));
          }
        }
        *reinterpret_cast<uint4*>(as + m * kC + c8) = va;
        *reinterpret_cast<uint4*>(bs + m * kC + c8) = vb;
      }
      __syncthreads();
#pragma unroll
      for (int k0 = 0; k0 < kDwK; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + k0 * kC + wm * 32 + i * 16, kC);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], bs + k0 * kC + wn * 64 + j * 16, kC);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* out = part + ((long long)chunk * 9 + tap) * kC * kC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(out + (wm * 32 + i * 16) * kC + wn * 64 + j * 16, acc[i][j], kC,
                              wmma::mem_row_major);
}

template <bool kFromY, typename T>
static cudaError_t dw(const T* act, const T* da, float* part, int B, int H, int W, int rows,
                      cudaStream_t st) {
  dim3 grid(9, (B * H + rows - 1) / rows);
  if constexpr (sizeof(T) == 2)
    refine_dw_wmma_kernel<kFromY><<<grid, 256, 0, st>>>(act, da, part, B, H, W, rows);
  else
    refine_dw_kernel<T, kFromY><<<grid, 256, 0, st>>>(act, da, part, B, H, W, rows);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t refine_bwd(void* const* p, int B, int Ht, int Wt, int rows, cudaStream_t st) {
  const T* y = static_cast<const T*>(p[0]);
  const T* pre = static_cast<const T*>(p[1]);
  const T* a2 = static_cast<const T*>(p[2]);
  const T* dout = static_cast<const T*>(p[3]);
  const T* w1f = static_cast<const T*>(p[4]);
  const T* w2f = static_cast<const T*>(p[5]);
  const float* gamma = static_cast<const float*>(p[6]);
  T* da2 = static_cast<T*>(p[7]);
  T* da1 = static_cast<T*>(p[8]);
  float* part_ln = static_cast<float*>(p[9]);
  float* part_db1 = static_cast<float*>(p[10]);
  float* part_dw1 = static_cast<float*>(p[11]);
  float* part_dw2 = static_cast<float*>(p[12]);
  T* dy = static_cast<T*>(p[13]);
  float* dw1 = static_cast<float*>(p[14]);
  float* db1 = static_cast<float*>(p[15]);
  float* dw2 = static_cast<float*>(p[16]);
  float* db2 = static_cast<float*>(p[17]);
  float* dg = static_cast<float*>(p[18]);
  float* dbe = static_cast<float*>(p[19]);
  const int H = 4 * Ht, W = 4 * Wt;
  const long long npix = (long long)B * H * W;
  const int n_ln = (int)((npix + kLnPix - 1) / kLnPix);
  const int n_conv = ((W + (sizeof(T) == 2 ? kTile : kPix) - 1) / (sizeof(T) == 2 ? kTile : kPix)) *
                     H * B;
  const int n_chunk = (B * H + rows - 1) / rows;
  cudaError_t e;
  refine_ln_bwd_kernel<T><<<n_ln, 256, 0, st>>>(a2, dout, gamma, da2, part_ln, npix);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ConvArgs<T> a{};
  a.H = H;
  a.W = W;
  a.src = da2;
  a.w = w2f;
  a.aux = pre;
  a.dst = da1;
  a.part = part_db1;
  if ((e = conv<kDh1>(a, B, st)) != cudaSuccess) return e;
  if ((e = dw<false>(pre, da2, part_dw2, B, H, W, rows, st)) != cudaSuccess) return e;
  a.src = da1;
  a.w = w1f;
  a.aux = y;
  a.dst = dy;
  a.part = nullptr;
  if ((e = conv<kDxp>(a, B, st)) != cudaSuccess) return e;
  if ((e = dw<true>(y, da1, part_dw1, B, H, W, rows, st)) != cudaSuccess) return e;
  const int L = 9 * kC * kC;
  if ((e = sum_rows(part_dw1, dw1, n_chunk, L, L, st)) != cudaSuccess) return e;
  if ((e = sum_rows(part_dw2, dw2, n_chunk, L, L, st)) != cudaSuccess) return e;
  if ((e = sum_rows(part_db1, db1, n_conv, kC, kC, st)) != cudaSuccess) return e;
  if ((e = sum_rows(part_ln, dg, n_ln, kC, 3 * kC, st)) != cudaSuccess) return e;
  if ((e = sum_rows(part_ln + kC, dbe, n_ln, kC, 3 * kC, st)) != cudaSuccess) return e;
  return sum_rows(part_ln + 2 * kC, db2, n_ln, kC, 3 * kC, st);
}

}  // namespace ssa

// y (B,Ht,Wt,16*128); w1/w2 HWIO (3,3,128,128) and b1/b2 (128) in the
// storage type; g/be float32 (128); h1 scratch, out and (training, else
// null) pre and a2 (B,4Ht,4Wt,128).
extern "C" int ssa_refine_head_fwd(const void* y, const void* w1, const void* b1, const void* w2,
                                   const void* b2, const void* g, const void* be, void* h1,
                                   void* out, void* pre, void* a2, int B, int Ht, int Wt,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16)
    return (int)ssa::refine_fwd<__nv_bfloat16>(y, w1, b1, w2, b2, g, be, h1, out, pre, a2, B, Ht,
                                               Wt, st);
  return (int)ssa::refine_fwd<float>(y, w1, b1, w2, b2, g, be, h1, out, pre, a2, B, Ht, Wt, st);
}

// Inputs y, pre, a2, dout, the flipped weights w1f/w2f (3,3,Cout,Cin) in the
// storage type, gamma float32; scratch da2, da1 (storage type) and float32
// partials part_ln (ceil(B*H*W/256),3,128), part_db1 (conv blocks,128),
// part_dw1/part_dw2 (ceil(B*H/rows),9,128,128); outputs dy (storage type),
// dw1/dw2 HWIO and db1, db2, dgamma, dbeta (128) in float32.
extern "C" int ssa_refine_head_bwd(const void* y, const void* pre, const void* a2,
                                   const void* dout, const void* w1f, const void* w2f,
                                   const void* gamma, void* da2, void* da1, void* part_ln,
                                   void* part_db1, void* part_dw1, void* part_dw2, void* dy,
                                   void* dw1, void* db1, void* dw2, void* db2, void* dg,
                                   void* dbe, int B, int Ht, int Wt, int rows, int dtype,
                                   void* stream) {
  void* const p[20] = {const_cast<void*>(y),    const_cast<void*>(pre), const_cast<void*>(a2),
                       const_cast<void*>(dout), const_cast<void*>(w1f), const_cast<void*>(w2f),
                       const_cast<void*>(gamma), da2, da1, part_ln, part_db1, part_dw1, part_dw2,
                       dy, dw1, db1, dw2, db2, dg, dbe};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16) return (int)ssa::refine_bwd<__nv_bfloat16>(p, B, Ht, Wt, rows, st);
  return (int)ssa::refine_bwd<float>(p, B, Ht, Wt, rows, st);
}
