// Decoder head tail: tanh-GELU -> x4 depth-to-space -> 3x3 conv + b1 ->
// tanh-GELU -> 3x3 conv + b2 -> LayerNorm(C), C = 128, forward and backward.
//
// Replaces, in semantic_segmentation_of_stylegan2_artifacts_tpu/ops/
// fused_refine_head.py: the Pallas kernels `_fwd_kernel` (inference) and
// `_fwd_res_kernel` (training: it also saves `pre` = conv1 + b1 and `a2` =
// conv2 + b2 in the storage type), both of `_fwd_pallas`, and
// `_bwd_kernel` (`_bwd_pallas`).  The backward is documented above
// `refine_ln_bwd_kernel`.
//
// Numerics as the TPU kernel: the conv input is GELU(y) in float32 rounded
// to the storage type; each conv accumulates in float32, rounds to the
// storage type and adds its bias in the storage type; h1 outside the image
// is zero (SAME padding of conv2's input, not GELU of a padded conv); the
// LayerNorm takes float32 fast-variance stats (not clamped, as the TPU
// kernel) and applies gamma/beta in float32.
//
// Bound on the H100: operations.  Each conv is a (B*4Ht*4Wt) x 128 x 1152
// implicit GEMM, 618 GFLOP at 512^2 batch 8: the forward's two take ~1.25 ms
// at 989 TFLOP/s bf16 against ~0.8 GB of traffic (h1 makes one round trip
// through device memory between the convs, ~0.3 ms at 3.35 TB/s).  One call
// of the wrapper is two launches of one conv core (and one launch count);
// the training forward is the same two launches with two more stores.
//
// What limits a conv on this card, and what the bfloat16 core
// (`refine_conv_mma_kernel`) does about each:
//   - the tensor cores reach their rate only through `wgmma`: a warpgroup
//     owns 64 pixels x 128 output channels as one m64n128k16 accumulator in
//     registers; B is one tap's 128 x 64 half of the weights (Cout x Cin,
//     Cin contiguous) in 128-byte-swizzled shared memory, read through a
//     matrix descriptor; A comes from registers, loaded with `ldmatrix` from
//     the staged pixels.  `ldmatrix` takes any row address, so the one-pixel
//     shifts between taps and a two-dimensional pixel tile cost nothing (a
//     swizzled descriptor's two strides cannot walk a 16-wide tile with an
//     18-wide halo);
//   - input re-read: a block owns 8 x 16 output pixels and stages 10 x 18
//     (1.4 pixels read per output; a row segment with its three rows read
//     3.05), GELU'd once on the way in for conv1, XOR-swizzled by pixel so
//     that `ldmatrix` rows fall in distinct banks;
//   - nothing overlapped: the weights stream through a ring of four 16 KB
//     stages filled by `cp.async` ahead of the products; a K step's products
//     run asynchronously while the block meets, refills the ring and loads
//     the next step's A fragments into a second register set; and 112 KB of
//     shared memory a block lets two blocks share an SM, so one block's
//     staging and epilogue run under the other's products;
//   - the epilogue runs on the accumulators: a pixel's 128 channels lie in
//     one quad of lanes, so the LayerNorm sums take two shuffles, and bias,
//     GELU and GELU' are applied in registers.  The accumulator layout gives
//     a lane 4 bytes of 8 pixels, though, which stores badly (8 cache lines
//     an instruction; such stores were the conv's largest single cost), so
//     each warp passes its 16 pixels through a private 4 KB tile of the (by then
//     free) weight ring with `stmatrix` / `ldmatrix` and moves whole pixels
//     with 16-byte accesses; no block-wide exchange, no float32 round trip;
//   - GELU costs instructions on every staged and every output value: the
//     tensor-core path computes it as x * sigmoid(2u) (one exp, one
//     reciprocal) instead of through tanhf.
// What still holds it back on an H100 at 512^2 batch 8, where a conv runs
// at 2-2.5 times its bound: the two blocks of an SM overlap only in part
// (they start together and tend to stay in step), the two warpgroups of a
// block move in step, and conv1's input staging (loads, GELU, stores) and
// the outputs' device-memory traffic (the training and backward modes write
// two arrays and read a third) are not hidden under products.  A
// persistent, warp-specialised block with a TMA producer is the next step.
// float32 (the parity type) stays on the CUDA cores (`refine_conv_kernel`),
// 8 x 4 outputs per thread.
#include <cstdint>

#include "common.cuh"

namespace ssa {

constexpr int kC = 128;     // channels (the only width the kernel takes)
constexpr int kPix = 64;    // output pixels per block (one row segment), CUDA cores
constexpr int kCin = 16;    // input channels per shared-memory step

// What one implicit-GEMM conv launch computes.  Every mode is a SAME 3x3
// conv over (B, H, W, 128); the modes differ in the A operand they build
// and in the epilogue.
enum ConvMode {
  kConv1 = 0,  // A = GELU(y) x4 depth-to-space; pre = acc + b1; h1 = GELU(pre)
  kConv2 = 1,  // A = h1; a2 = acc + b2; out = LN(a2)
  kDh1 = 2,    // A = da2, W2 flipped; da1 = acc * GELU'(pre); db1 partials
  kDxp = 3,    // A = da1, W1 flipped; dy = s2d(acc) * GELU'(y)
};

template <typename T>
struct ConvArgs {
  const T* src;         // A operand's source (y, h1, da2 or da1)
  const T* w;           // float32: (3, 3, Cin, Cout); bfloat16: (3, 3, Cout, Cin)
  const T* bias;        // b1 / b2 (forward modes)
  const float* gamma;   // LN (kConv2)
  const float* beta;
  T* dst;               // h1, out, da1 or dy
  T* res;               // optional saved residual: pre (kConv1) / a2 (kConv2)
  const T* aux;         // pre (kDh1) / y (kDxp)
  T* act;               // bfloat16 backward: GELU(aux) as (B, H, W, 128), the
                        // weight gradient's activation (h1 / xp), else null
  float* part;          // per-block db1 partials (kDh1), (blocks, 128)
  int H, W;
};

// Offset of pixel (rr, cc) of the x4 depth-to-space view in y's layout
// (p1-major: the pixel is channel block (rr%4)*4 + cc%4 of token (rr/4, cc/4)).
__device__ __forceinline__ long long d2s_offset(int b, int rr, int cc, int H, int W) {
  return ((long long)(b * (H / 4) + rr / 4) * (W / 4) + cc / 4) * (16 * kC) +
         ((rr & 3) * 4 + (cc & 3)) * kC;
}

// One A-operand element: pixel (rr, cc), channel ci; zero outside the image.
template <typename T, int kMode>
__device__ __forceinline__ float conv_src(const ConvArgs<T>& a, int b, int rr, int cc, int ci) {
  if (rr < 0 || rr >= a.H || cc < 0 || cc >= a.W) return 0.0f;
  if (kMode == kConv1)
    return round_to<T>(gelu_tanh(to_f(a.src[d2s_offset(b, rr, cc, a.H, a.W) + ci])));
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
      const long long t = d2s_offset(b, r, p, a.H, a.W);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long i = t + lane + 32 * c;
        a.dst[i] = from_f<T>(acc[c] * gelu_tanh_grad(to_f(a.aux[i])));
      }
    }
  }
}

// db1 partials: the block's 8 warps' sums red[warp][128] -> part[block][128],
// added in warp order.
__device__ __forceinline__ void block_partial(const float* red, float* part) {
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
  if (kMode == kDh1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp * kC + lane + 32 * c] = psum[c];
    block_partial(red, a.part);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: PTX helpers for Hopper's warpgroup products
// (the asynchronous copies and the matrix fragment loads are in common.cuh).
// ---------------------------------------------------------------------------
// Makes this thread's completed shared-memory writes visible to wgmma's
// reads (the asynchronous proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// tanh-GELU and its derivative through one exp and one reciprocal:
// 0.5 (1 + tanh u) = sigmoid(2u), u = sqrt(2/pi) (x + 0.044715 x^3), so
// GELU(x) = x s and GELU'(x) = s + 2 x s (1 - s) u'(x).  The same functions
// as `gelu_tanh` / `gelu_tanh_grad` to float32 rounding, at a fifth of
// tanhf's instructions: the conv core applies them to every staged and
// every output value, which otherwise takes as many instruction slots as the
// products.
__device__ __forceinline__ float gelu_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-1.5957691216057308f * (x + 0.044715f * x * x * x)));
}
__device__ __forceinline__ float gelu_fast(float x) { return x * gelu_sigmoid(x); }
__device__ __forceinline__ void gelu_and_grad_fast(float x, float& g, float& dg) {
  const float s = gelu_sigmoid(x);
  g = x * s;
  dg = s + g * (1.0f - s) * (1.5957691216057308f * (1.0f + 3.0f * 0.044715f * x * x));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: 8 rows of 128
// bytes form a swizzle atom; `sbo` is the byte stride between atoms along
// the 8-row direction, `lbo` between atoms along the other (unused when the
// operand is one atom wide).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x N, float32, in registers) += A (64 x 16 bf16, registers: the
// warp's 16 rows as an m16k16 mma fragment) . B (shared memory, by
// descriptor).  `wgmma_n128`: B is N x K with K contiguous; `wgmma_n128_tb`:
// B is K x N with N contiguous (transposed on the way in).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

__device__ __forceinline__ void wgmma_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc), "r"(1));
}

// ---------------------------------------------------------------------------
// The conv core.  256 threads = 2 warpgroups; the block owns an 8 x 16 tile
// of output pixels, warpgroup g rows 4g..4g+3, warp w of it row 4g + w (16
// pixels = the 16 rows of its A fragments).  K runs over 18 steps of 64
// input channels (9 taps x 2 halves), each one ring stage of weights.
// ---------------------------------------------------------------------------
constexpr int kTileH = 8, kTileW = 16;
constexpr int kHaloW = kTileW + 2;
constexpr int kStagePix = (kTileH + 2) * kHaloW;  // 180 staged pixels, 256 bytes each
constexpr int kWStage = kC * 64 * 2;              // one tap's K half: 128 rows of 128 bytes
constexpr int kWStages = 4;
constexpr int kKSteps = 18;
constexpr size_t kConvSmem = 1024 + kWStages * kWStage + kStagePix * kC * 2;  // 112,640

// Offset of pixel (r, p) in a (B, H, W, 128) array, or (kD2s) in y's layout.
template <bool kD2s>
__device__ __forceinline__ long long pixel_offset(int b, int r, int p, int H, int W) {
  return kD2s ? d2s_offset(b, r, p, H, W) : ((long long)(b * H + r) * W + p) * kC;
}

// A warp's 16 pixels x 128 channels pass between registers and device
// memory through a 4 KB tile of shared memory (pixel i at 256 i, 16-byte
// chunk c at c ^ (i%8)): the accumulator layout gives a lane 4 bytes of 8
// pixels, which would touch 8 cache lines a store; through the tile a lane
// moves 16 bytes and a warp instruction two whole pixels (512 contiguous
// bytes).  Lane l moves chunk l%16 of pixels 2i + l/16, i < 8; pixels
// outside the image are skipped (stores) or zero (loads).
template <bool kD2s>
__device__ __forceinline__ void store_tile(const unsigned char* tile, bf16* dst, int b, int r,
                                           int p0, int H, int W, int lane) {
  const int c = lane & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pix = 2 * i + (lane >> 4), p = p0 + pix;
    if (r < H && p < W)
      *reinterpret_cast<uint4*>(dst + pixel_offset<kD2s>(b, r, p, H, W) + c * 8) =
          *reinterpret_cast<const uint4*>(tile + pix * 256 + ((c ^ (pix & 7)) << 4));
  }
}
template <bool kD2s>
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* src, int b, int r,
                                          int p0, int H, int W, int lane) {
  const int c = lane & 15;
  uint4 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = p0 + 2 * i + (lane >> 4);
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r < H && p < W)
      v[i] = *reinterpret_cast<const uint4*>(src + pixel_offset<kD2s>(b, r, p, H, W) + c * 8);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pix = 2 * i + (lane >> 4);
    *reinterpret_cast<uint4*>(tile + pix * 256 + ((c ^ (pix & 7)) << 4)) = v[i];
  }
}

// Epilogue on the accumulators.  Lane l of a warp holds, of the warp's tile
// row, pixels l/4 and l/4 + 8 and of each the channel pairs 8j + 2(l%4),
// j < 16: d[4j + 2h + e] is pixel l/4 + 8h, channel 8j + 2(l%4) + e, which
// is the fragment layout of `ldmatrix` / `stmatrix`: matrix i of step jp is
// (pixel half h = i%2, chunk j = 2jp + i/2).  `tiles`: this warp's two 4 KB
// tiles.  `psum[2j + e]` collects db1's sums of this lane's channels.
template <int kMode>
__device__ __forceinline__ void conv_mma_epilogue(const ConvArgs<bf16>& a, float (&d)[64], int b,
                                                  int r, int p0, int lane, unsigned char* tiles,
                                                  float (&psum)[32]) {
  const int H = a.H, W = a.W;
  const int q2 = (lane & 3) * 2;
  const int mi = lane >> 3, fpix = (mi & 1) * 8 + (lane & 7);
  unsigned char* t0 = tiles;
  unsigned char* t1 = tiles + 4096;
  const uint32_t f0 = smem_u32(t0) + fpix * 256, f1 = f0 + 4096;
  auto fchunk = [&](int jp) { return (uint32_t)(((2 * jp + (mi >> 1)) ^ (fpix & 7)) << 4); };
  if (kMode == kConv1 || kMode == kConv2) {
    float s[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      uint32_t pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, j = 2 * jp + (i >> 1);
        const float2 bias = unpack2(*reinterpret_cast<const uint32_t*>(a.bias + 8 * j + q2));
        float& x0 = d[4 * j + 2 * h];
        float& x1 = d[4 * j + 2 * h + 1];
        x0 = round_to<bf16>(round_to<bf16>(x0) + bias.x);
        x1 = round_to<bf16>(round_to<bf16>(x1) + bias.y);
        s[h] += x0 + x1;
        s2[h] += x0 * x0 + x1 * x1;
        pk[i] = pack2(x0, x1);
      }
      if (a.res) stsm4(f1 + fchunk(jp), pk);
    }
    if (a.res) {
      __syncwarp();
      store_tile<false>(t1, a.res, b, r, p0, H, W, lane);
    }
    float mu[2], inv[2];
    if (kMode == kConv2)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 1);
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
        s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 2);
        mu[h] = s[h] / kC;
        inv[h] = 1.0f / sqrtf(s2[h] / kC - mu[h] * mu[h] + kLnEps);
      }
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      uint32_t pk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, j = 2 * jp + (i >> 1);
        const float x0 = d[4 * j + 2 * h], x1 = d[4 * j + 2 * h + 1];
        if (kMode == kConv1) {
          pk[i] = pack2(gelu_fast(x0), gelu_fast(x1));
        } else {
          const float2 g = *reinterpret_cast<const float2*>(a.gamma + 8 * j + q2);
          const float2 be = *reinterpret_cast<const float2*>(a.beta + 8 * j + q2);
          pk[i] = pack2((x0 - mu[h]) * inv[h] * g.x + be.x, (x1 - mu[h]) * inv[h] * g.y + be.y);
        }
      }
      stsm4(f0 + fchunk(jp), pk);
    }
    __syncwarp();
    store_tile<false>(t0, a.dst, b, r, p0, H, W, lane);
  } else {
    // kDh1 reads pre and writes da1 and h1 at the pixel; kDxp reads y and
    // writes dy at the pixel's place in y's layout, and xp at the pixel
    constexpr bool kD2s = kMode == kDxp;
    load_tile<kD2s>(t0, a.aux, b, r, p0, H, W, lane);
    __syncwarp();
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) ok[h] = r < H && p0 + (lane >> 2) + 8 * h < W;
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      uint32_t x[4], pg[4], pa[4];
      ldsm4(x, f0 + fchunk(jp));
      __syncwarp();  // the gradient goes back where the input was read
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1, j = 2 * jp + (i >> 1);
        const float2 xv = unpack2(x[i]);
        float a0, a1, g0, g1;
        gelu_and_grad_fast(xv.x, a0, g0);
        gelu_and_grad_fast(xv.y, a1, g1);
        g0 *= d[4 * j + 2 * h];
        g1 *= d[4 * j + 2 * h + 1];
        pg[i] = pack2(g0, g1);
        pa[i] = pack2(a0, a1);
        if (kMode == kDh1 && ok[h]) {
          psum[2 * j] += g0;
          psum[2 * j + 1] += g1;
        }
      }
      stsm4(f0 + fchunk(jp), pg);
      stsm4(f1 + fchunk(jp), pa);
    }
    __syncwarp();
    store_tile<kD2s>(t0, a.dst, b, r, p0, H, W, lane);
    store_tile<false>(t1, a.act, b, r, p0, H, W, lane);
  }
}

template <int kMode>
__global__ void __launch_bounds__(256, 2) refine_conv_mma_kernel(const ConvArgs<bf16> a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ws = (smem_u32(smem_raw) + 1023u) & ~1023u;  // weight ring, 1 KB aligned
  const uint32_t xs = ws + kWStages * kWStage;                // staged pixels
  unsigned char* xs_ptr = smem_raw + (xs - smem_u32(smem_raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kTileW, r0 = blockIdx.y * kTileH, b = blockIdx.z;
  const int H = a.H, W = a.W;

  // K step s = (tap s/2, input channels 64(s%2)..) -> ring slot s%4: rows =
  // output channels, 128 bytes each, 16-byte chunk c of row n at c ^ (n%8)
  auto load_w = [&](int s) {
    const bf16* src = a.w + (size_t)(s >> 1) * kC * kC + (s & 1) * 64;
    const uint32_t dst = ws + (s % kWStages) * kWStage;
#pragma unroll
    for (int e = tid; e < kC * 8; e += 256) {
      const int n = e >> 3, c = e & 7;
      cp_async16(dst + n * 128 + ((c ^ (n & 7)) << 4), src + n * kC + c * 8, true);
    }
  };

  // the tile's input with its halo: pixel i at 256 i, chunk q at q ^ (i%8)
  load_w(0);
  if (kMode != kConv1)
    for (int e = tid; e < kStagePix * 16; e += 256) {
      const int pix = e >> 4, q = e & 15;
      const int rr = r0 + pix / kHaloW - 1, cc = p0 + pix % kHaloW - 1;
      const bool ok = rr >= 0 && rr < H && cc >= 0 && cc < W;
      cp_async16(xs + pix * 256 + ((q ^ (pix & 7)) << 4),
                 ok ? a.src + ((long long)(b * H + rr) * W + cc) * kC + q * 8 : a.src, ok);
    }
  cp_async_commit();
  load_w(1);
  cp_async_commit();
  load_w(2);
  cp_async_commit();
  if (kMode == kConv1) {
    // GELU and the depth-to-space gather on the way in: every load first
    // (their latencies overlap), then the arithmetic and the stores
    constexpr int kPer = (kStagePix * 16 + 255) / 256;
    uint4 v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + 256 * k, pix = e >> 4, q = e & 15;
      const int rr = r0 + pix / kHaloW - 1, cc = p0 + pix % kHaloW - 1;
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kStagePix * 16 && rr >= 0 && rr < H && cc >= 0 && cc < W)
        v[k] = *reinterpret_cast<const uint4*>(a.src + d2s_offset(b, rr, cc, H, W) + q * 8);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + 256 * k, pix = e >> 4, q = e & 15;
      bf16* e8 = reinterpret_cast<bf16*>(&v[k]);
#pragma unroll
      for (int i = 0; i < 8; ++i) e8[i] = from_f<bf16>(gelu_fast(to_f(e8[i])));
      if (e < kStagePix * 16)
        *reinterpret_cast<uint4*>(xs_ptr + pix * 256 + ((q ^ (pix & 7)) << 4)) = v[k];
    }
  }

  const int trow = (warp >> 2) * 4 + (warp & 3);  // this warp's tile row
  const int mi = lane >> 3;                       // ldmatrix matrix of this lane's address
  const int col = (mi & 1) * 8 + (lane & 7);      // matrices 0/2: pixels 0-7, 1/3: 8-15
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // A fragments of K step s: four k16 slices of this warp's 16 pixels at
  // tap s/2, input channels 64(s%2)..
  auto load_a = [&](uint32_t(&af)[4][4], int s) {
    const int tap = s >> 1, u = tap / 3, v = tap - 3 * u;
    const int pix = (trow + u) * kHaloW + col + v;
    const int chunk = (s & 1) * 8 + (mi >> 1);  // matrices 2/3: channels 8-15 of the k16 slice
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm4(af[kk], xs + pix * 256 + (((chunk + 2 * kk) ^ (pix & 7)) << 4));
  };
  // One K step: its products go to the tensor cores, and while they run the
  // block meets (everyone has finished step s - 1, whose ring slot takes
  // step s + 3) and loads the next step's A fragments into the other set.
  auto step = [&](const uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4], int s) {
    const uint64_t bd = wgmma_desc(ws + (s % kWStages) * kWStage, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_n128(acc, cur[kk], bd + 2 * kk);  // 32 bytes along K
    wgmma_commit();
    if (s + 1 < kKSteps) {
      cp_async_wait<kWStages - 3>();  // this thread's copies of step s + 1 have landed
      fence_proxy_async();
      __syncthreads();
      if (s + kWStages - 1 < kKSteps) load_w(s + kWStages - 1);
      cp_async_commit();
      load_a(nxt, s + 1);
    }
    wgmma_wait();
  };
  uint32_t af0[4][4], af1[4][4];
  cp_async_wait<kWStages - 2>();
  fence_proxy_async();
  __syncthreads();  // step 0's weights and the staged pixels are in place
  load_a(af0, 0);
  for (int s = 0; s < kKSteps; s += 2) {
    step(af0, af1, s);
    step(af1, af0, s + 1);
  }

  __syncthreads();  // every product is done: the weight ring becomes the warps' tiles
  float psum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) psum[i] = 0.0f;
  conv_mma_epilogue<kMode>(a, acc, b, r0 + trow, p0, lane,
                           smem_raw + (ws - smem_u32(smem_raw)) + warp * 8192, psum);
  if (kMode == kDh1) {
    // lanes l, l^4, l^8, l^16 hold the same channels of other pixels
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 4);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 8);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 16);
    }
    float* red = reinterpret_cast<float*>(xs_ptr);  // the staged pixels are free
    if (lane < 4)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        red[warp * kC + 8 * j + 2 * lane] = psum[2 * j];
        red[warp * kC + 8 * j + 2 * lane + 1] = psum[2 * j + 1];
      }
    block_partial(red, a.part);
  }
}

template <int kMode>
static cudaError_t conv_bf16(const ConvArgs<bf16>& a, int B, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(refine_conv_mma_kernel<kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kConvSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.W + kTileW - 1) / kTileW, (a.H + kTileH - 1) / kTileH, B);
  refine_conv_mma_kernel<kMode><<<grid, 256, kConvSmem, st>>>(a);
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

// Conv blocks of one launch: the length of the db1 partials.
template <typename T>
static int conv_blocks(int B, int H, int W) {
  if (sizeof(T) == 2) return ((W + kTileW - 1) / kTileW) * ((H + kTileH - 1) / kTileH) * B;
  return ((W + kPix - 1) / kPix) * H * B;
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
// owns a chunk of pixel rows (split-K) and writes float32 128 x 128
// partials, which sum_rows adds, so results do not change from run to run.
//
// bfloat16: steps 2 and 4 are the conv core above, whose epilogue reads pre
// (or y) for GELU' anyway and also writes h1 (or xp) = GELU of it to a
// scratch, so the activation of a weight gradient is computed once per
// pixel and steps 3 and 5 are one pure product kernel fed by `cp.async`
// (`refine_dw_mma_kernel`, below).  float32 runs every product on the CUDA
// cores (`refine_dw_kernel` recomputes the activation while loading).
// ===========================================================================
constexpr int kLnPix = 256;  // pixels per ln_bwd block
constexpr int kDwKf = 32;    // pixels per weight-gradient step (CUDA cores)

// Four consecutive channels of one pixel, as float32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

// One warp per pixel, lane l channels 4l..4l+3 (one 8- or 16-byte access).
template <typename T>
__global__ void __launch_bounds__(256)
refine_ln_bwd_kernel(const T* __restrict__ a2, const T* __restrict__ dout,
                     const float* __restrict__ gamma, T* __restrict__ da2,
                     float* __restrict__ part, long long npix) {
  __shared__ float red[3][8][kC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sg[4] = {0, 0, 0, 0}, sb[4] = {0, 0, 0, 0}, s2[4] = {0, 0, 0, 0};
  float gm[4];
  load4(gamma + 4 * lane, gm);
  for (int k = warp; k < kLnPix; k += 8) {
    const long long pix = (long long)blockIdx.x * kLnPix + k;
    if (pix >= npix) break;
    const long long o = pix * kC + 4 * lane;
    float x[4], d[4], s = 0.0f, sq = 0.0f;
    load4(a2 + o, x);
    load4(dout + o, d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
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
    float g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      g[c] = (dxh[c] - m1 - xh[c] * m2) * inv;
      sg[c] += d[c] * xh[c];
      sb[c] += d[c];
      s2[c] += g[c];
    }
    store4(da2 + o, g);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    red[0][warp][4 * lane + c] = sg[c];
    red[1][warp][4 * lane + c] = sb[c];
    red[2][warp][4 * lane + c] = s2[c];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 3 * kC; t += blockDim.x) {
    const int q = t / kC, n = t - q * kC;
    float s = 0.0f;
    for (int k = 0; k < 8; ++k) s += red[q][k][n];
    part[(long long)blockIdx.x * 3 * kC + t] = s;
  }
}

// Activation of a float32 weight-gradient product at pixel (rr, cc): GELU
// of the saved pre (kFromY false: h1) or of y gathered by depth-to-space
// (kFromY true: xp), rounded to the storage type; zero outside the image.
template <typename T, bool kFromY>
__device__ __forceinline__ float dw_act(const T* act, int b, int rr, int cc, int ci, int H,
                                        int W) {
  if (rr < 0 || rr >= H || cc < 0 || cc >= W) return 0.0f;
  const long long i = kFromY ? d2s_offset(b, rr, cc, H, W) + ci
                             : ((long long)(b * H + rr) * W + cc) * kC + ci;
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

// ---------------------------------------------------------------------------
// The weight gradient on the tensor cores: for one tap row u and a chunk of
// pixel rows, dW[3u + v][ci][co] = sum over pixels of act[pixel + (u-1,
// v-1)][ci] * da[pixel][co], v = 0..2: three 128 x 128 products that share
// their operands.  Pixels are K.  A ring stage holds a 64-pixel row segment
// of da (swizzled as wgmma's B, pixels x channels with channels
// contiguous) and the 66 pixels of act's row r + u - 1 around it; the three
// v are one-pixel shifts of the same staged row, taken by `ldmatrix.trans`
// (which turns pixels x channels into the channels x pixels A fragment).
// The six (v, 64-channel half) row blocks of the result are dealt three to
// each of the two warpgroups, 192 accumulator registers a thread; a k16
// slice's three products run while the next slice's fragments load into a
// second register set.  The operands are read once per tap row (3 times),
// the GELU is computed once per pixel (in the conv epilogues), and the ring
// runs ahead of the products.  What limits it on an H100 at 512^2 batch 8,
// at about twice its bound: the operand stream; a block cannot hold more
// than three taps of float32 accumulators to reuse its operands further.
// ---------------------------------------------------------------------------
constexpr int kDwPix = 64;                   // pixels per stage
constexpr int kDwDa = kDwPix * kC * 2;       // 16 KB: [2 halves][64 pixels][128 bytes]
constexpr int kDwAct = 17 * 1024;            // 66 pixels x 256 bytes, padded to 1 KB
constexpr int kDwStage = kDwDa + kDwAct;
constexpr int kDwStages = 4;
constexpr size_t kDwSmem = 1024 + kDwStages * kDwStage;  // 136,192

__global__ void __launch_bounds__(256, 1)
refine_dw_mma_kernel(const bf16* __restrict__ act, const bf16* __restrict__ da,
                     float* __restrict__ part, int B, int H, int W, int rows) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int u = blockIdx.x, chunk = blockIdx.y;
  const int g0 = chunk * rows, g1 = min(g0 + rows, B * H);
  const int nseg = (W + kDwPix - 1) / kDwPix;
  const int nst = (g1 - g0) * nseg;

  auto load = [&](int i) {
    const int gr = g0 + i / nseg, q0 = (i % nseg) * kDwPix;
    const int b = gr / H, r = gr - b * H, rr = r + u - 1;
    const bool rok = rr >= 0 && rr < H;
    const uint32_t dbase = ring + (i % kDwStages) * kDwStage, abase = dbase + kDwDa;
    const bf16* drow = da + (long long)(b * H + r) * W * kC;
    const bf16* arow = act + (long long)(b * H + (rok ? rr : r)) * W * kC;
#pragma unroll
    for (int e = tid; e < kDwPix * 16; e += 256) {
      const int m = e >> 4, c = e & 15, q = q0 + m;
      const bool ok = q < W;
      cp_async16(dbase + (c >> 3) * (kDwDa / 2) + m * 128 + (((c & 7) ^ (m & 7)) << 4),
                 ok ? drow + (long long)q * kC + c * 8 : da, ok);
    }
    for (int e = tid; e < (kDwPix + 2) * 16; e += 256) {
      const int m = e >> 4, c = e & 15, cc = q0 + m - 1;
      const bool ok = rok && cc >= 0 && cc < W;
      cp_async16(abase + m * 256 + ((c ^ (m & 7)) << 4),
                 ok ? arow + (long long)cc * kC + c * 8 : act, ok);
    }
  };

  const int wg = warp >> 2, w4 = warp & 3, mi = lane >> 3;
  float acc[3][64];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.0f;

#pragma unroll
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < nst) load(i);
    cp_async_commit();
  }
  // A fragments of pixels k0..k0+15 of stage i, one set per job
  auto load_a = [&](uint32_t(&af)[3][4], int i, int k0) {
    const uint32_t abase = ring + (i % kDwStages) * kDwStage + kDwDa;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int job = 3 * wg + j, v = job >> 1, half = job & 1;
      // matrices 0/1: pixels k0..k0+7, 2/3: k0+8..; 1/3: channels +8
      const int pix = k0 + (mi >> 1) * 8 + (lane & 7) + v;
      const int c = half * 8 + 2 * w4 + (mi & 1);
      ldsm4_trans(af[j], abase + pix * 256 + ((c ^ (pix & 7)) << 4));
    }
  };
  // One k16 slice: its three products go to the tensor cores, and while they
  // run the next slice's fragments are loaded into the other set; at a
  // stage's last slice the block meets first (everyone has finished stage
  // i - 1, whose ring slot takes stage i + 3).
  auto step = [&](const uint32_t(&cur)[3][4], uint32_t(&nxt)[3][4], int i, int k0) {
    // B: 16 pixels x 128 channels; the two 64-channel halves kDwDa/2 apart
    const uint64_t bd =
        wgmma_desc(ring + (i % kDwStages) * kDwStage + k0 * 128, kDwDa / 2, 1024);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 3; ++j) wgmma_n128_tb(acc[j], cur[j], bd);
    wgmma_commit();
    if (k0 + 16 < kDwPix) {
      load_a(nxt, i, k0 + 16);
    } else if (i + 1 < nst) {
      cp_async_wait<kDwStages - 3>();  // this thread's copies of stage i + 1 have landed
      fence_proxy_async();
      __syncthreads();
      if (i + kDwStages - 1 < nst) load(i + kDwStages - 1);
      cp_async_commit();
      load_a(nxt, i + 1, 0);
    }
    wgmma_wait();
  };
  uint32_t af0[3][4], af1[3][4];
  cp_async_wait<kDwStages - 2>();
  fence_proxy_async();
  __syncthreads();  // stage 0 is in place
  if (nst > 0) load_a(af0, 0, 0);
  for (int i = 0; i < nst; ++i) {
    step(af0, af1, i, 0);
    step(af1, af0, i, 16);
    step(af0, af1, i, 32);
    step(af1, af0, i, 48);
  }

  // d[4j + 2h + e]: row (ci) 16 w4 + lane/4 + 8h of the 64-row block,
  // column (co) 8j + 2(lane%4) + e
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int job = 3 * wg + j, v = job >> 1, half = job & 1;
    float* out = part + ((long long)chunk * 9 + 3 * u + v) * kC * kC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = half * 64 + 16 * w4 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        *reinterpret_cast<float2*>(out + ci * kC + 8 * jj + 2 * (lane & 3)) =
            make_float2(acc[j][4 * jj + 2 * h], acc[j][4 * jj + 2 * h + 1]);
    }
  }
}

static cudaError_t dw_bf16(const bf16* act, const bf16* da, float* part, int B, int H, int W,
                           int rows, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(refine_dw_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kDwSmem);
  if (e != cudaSuccess) return e;
  dim3 grid(3, (B * H + rows - 1) / rows);
  refine_dw_mma_kernel<<<grid, 256, kDwSmem, st>>>(act, da, part, B, H, W, rows);
  return cudaGetLastError();
}

template <bool kFromY>
static cudaError_t dw_f32(const float* act, const float* da, float* part, int B, int H, int W,
                          int rows, cudaStream_t st) {
  dim3 grid(9, (B * H + rows - 1) / rows);
  refine_dw_kernel<float, kFromY><<<grid, 256, 0, st>>>(act, da, part, B, H, W, rows);
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
  T* act = static_cast<T*>(p[9]);
  float* part_ln = static_cast<float*>(p[10]);
  float* part_db1 = static_cast<float*>(p[11]);
  float* part_dw1 = static_cast<float*>(p[12]);
  float* part_dw2 = static_cast<float*>(p[13]);
  T* dy = static_cast<T*>(p[14]);
  float* dw1 = static_cast<float*>(p[15]);
  float* db1 = static_cast<float*>(p[16]);
  float* dw2 = static_cast<float*>(p[17]);
  float* dln = static_cast<float*>(p[18]);
  const int H = 4 * Ht, W = 4 * Wt;
  const long long npix = (long long)B * H * W;
  const int n_ln = (int)((npix + kLnPix - 1) / kLnPix);
  const int n_conv = conv_blocks<T>(B, H, W);
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
  a.act = act;  // h1
  a.part = part_db1;
  if ((e = conv<kDh1>(a, B, st)) != cudaSuccess) return e;
  if constexpr (sizeof(T) == 2) e = dw_bf16(act, da2, part_dw2, B, H, W, rows, st);
  else e = dw_f32<false>(pre, da2, part_dw2, B, H, W, rows, st);
  if (e != cudaSuccess) return e;
  a.src = da1;
  a.w = w1f;
  a.aux = y;
  a.dst = dy;
  a.part = nullptr;  // a.act: xp, over h1, which dW2 has read
  if ((e = conv<kDxp>(a, B, st)) != cudaSuccess) return e;
  if constexpr (sizeof(T) == 2) e = dw_bf16(act, da1, part_dw1, B, H, W, rows, st);
  else e = dw_f32<true>(y, da1, part_dw1, B, H, W, rows, st);
  if (e != cudaSuccess) return e;
  const int L = 9 * kC * kC;
  if ((e = sum_rows(part_dw1, dw1, n_chunk, L, L, st)) != cudaSuccess) return e;
  if ((e = sum_rows(part_dw2, dw2, n_chunk, L, L, st)) != cudaSuccess) return e;
  if ((e = sum_rows(part_db1, db1, n_conv, kC, kC, st)) != cudaSuccess) return e;
  return sum_rows(part_ln, dln, n_ln, 3 * kC, 3 * kC, st);  // dgamma, dbeta, db2
}

}  // namespace ssa

// y (B,Ht,Wt,16*128); b1/b2 (128) in the storage type and the conv weights
// w1/w2 (3,3,128,128) in it, float32 as (kh, kw, Cin, Cout), bfloat16 as
// (kh, kw, Cout, Cin); g/be float32 (128); h1 scratch, out and (training,
// else null) pre and a2 (B,4Ht,4Wt,128).
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

// Inputs y, pre, a2, dout, the tap-flipped weights w1f/w2f of the
// transposed convs (their input channels are the forward's outputs; laid
// out by type as the forward's), gamma float32; scratch da2, da1 and (for
// bfloat16, else null) act (B,4Ht,4Wt,128) in the storage type and float32
// partials part_ln (ceil(B*H*W/256),3,128), part_db1 (conv blocks,128),
// part_dw1/part_dw2 (ceil(B*H/rows),9,128,128); outputs dy (storage type),
// and in float32 dw1/dw2 (kh,kw,Cin,Cout), db1 (128) and dln (3,128) =
// dgamma, dbeta, db2.
extern "C" int ssa_refine_head_bwd(const void* y, const void* pre, const void* a2,
                                   const void* dout, const void* w1f, const void* w2f,
                                   const void* gamma, void* da2, void* da1, void* act,
                                   void* part_ln, void* part_db1, void* part_dw1,
                                   void* part_dw2, void* dy, void* dw1, void* db1, void* dw2,
                                   void* dln, int B, int Ht, int Wt, int rows, int dtype,
                                   void* stream) {
  void* const p[19] = {const_cast<void*>(y),    const_cast<void*>(pre), const_cast<void*>(a2),
                       const_cast<void*>(dout), const_cast<void*>(w1f), const_cast<void*>(w2f),
                       const_cast<void*>(gamma), da2, da1, act, part_ln, part_db1, part_dw1,
                       part_dw2, dy, dw1, db1, dw2, dln};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16) return (int)ssa::refine_bwd<__nv_bfloat16>(p, B, Ht, Wt, rows, st);
  return (int)ssa::refine_bwd<float>(p, B, Ht, Wt, rows, st);
}
