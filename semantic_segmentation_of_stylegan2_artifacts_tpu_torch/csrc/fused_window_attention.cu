// Shifted-window attention forward, the middle of the Swin block.
//
// Replaces: the Pallas kernel `_fwd_kernel` (launcher `_fwd_pallas`) in
// semantic_segmentation_of_stylegan2_artifacts_tpu/ops/fused_window_attention.py.
//
// Contract (as the TPU kernel): qkv is the rolled, zero-padded projection
// (B, Hp, Wp, 3C); for each (image, window, head) it computes
// S = q.k^T in float32, S*hd^-0.5, + the gathered relative-position bias,
// + the -100 nine-region shift mask (shifted blocks only), a float32 row
// softmax, probs rounded to the storage type, ctx = P.v in float32,
// written to (B, Hp, Wp, C) at the tokens' own positions.
//
// Bound on the H100: memory.  Per token it reads 3C and writes C values;
// the two 49x49xhd products are ~0.6 MFLOP per window and head, well under
// the card's 295 FLOP/byte balance point.  Design: one block per
// (window, head, image) gathers its 49 tokens' q/k/v slices by index
// arithmetic straight from the spatial layout (no window-partition copy in
// device memory), keeps q/k/v and the 49x49 float32 scores in shared
// memory, reduces each softmax row with warp shuffles, and computes the
// shift mask from the region ids of the rolled grid instead of reading a
// (nW, N, N) mask array.  In bfloat16 (the deployment type) the two
// products run on the tensor cores (nvcuda::wmma, the window padded to 64
// tokens); in float32 (the parity type), and for head widths that are not
// a multiple of 16, they run on the CUDA cores in float32.
#include <mma.h>

#include "common.cuh"

namespace ssa {

template <typename T>
__global__ void window_attention_fwd_kernel(const T* __restrict__ qkv,
                                            const float* __restrict__ bias,
                                            T* __restrict__ out, int Hp, int Wp, int C,
                                            int heads, int wh, int ww, int sh, int sw,
                                            float scale) {
  const int n = wh * ww;
  const int hd = C / heads;
  const int nww = Wp / ww;
  const int win = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wr = win / nww, wc = win % nww;

  extern __shared__ float smem[];
  float* qs = smem;                 // n x hd
  float* ks = qs + n * hd;          // n x (hd + 1), padded against bank conflicts
  float* vs = ks + n * (hd + 1);    // n x hd
  float* ss = vs + n * hd;          // n x n scores, then probs

  const long long c3 = 3LL * C;
  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int t = idx / hd, d = idx - t * hd;
    const int r = wr * wh + t / ww, c = wc * ww + t % ww;
    const T* src = qkv + ((long long)(b * Hp + r) * Wp + c) * c3 + h * hd + d;
    qs[t * hd + d] = to_f(src[0]);
    ks[t * (hd + 1) + d] = to_f(src[C]);
    vs[t * hd + d] = to_f(src[2 * C]);
  }
  __syncthreads();

  const bool masked = (sh | sw) != 0;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc += qs[i * hd + d] * ks[j * (hd + 1) + d];
    float s = acc * scale;
    s += bias[(h * n + i) * n + j];
    if (masked) {
      // region ids of the rolled, padded grid (ops/window_attention.py
      // shifted_window_mask): 3 row regions x 3 column regions
      const int ri = wr * wh + i / ww, ci = wc * ww + i % ww;
      const int rj = wr * wh + j / ww, cj = wc * ww + j % ww;
      const int gi = 3 * ((ri >= Hp - wh) + (ri >= Hp - sh)) + (ci >= Wp - ww) + (ci >= Wp - sw);
      const int gj = 3 * ((rj >= Hp - wh) + (rj >= Hp - sh)) + (cj >= Wp - ww) + (cj >= Wp - sw);
      s += (gi != gj) ? -100.0f : 0.0f;
    }
    ss[idx] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int i = warp; i < n; i += nwarps) {
    float* row = ss + i * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = round_to<T>(row[j] / sum);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx - i * hd;
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc += ss[i * n + j] * vs[j * hd + d];
    const int r = wr * wh + i / ww, c = wc * ww + i % ww;
    out[((long long)(b * Hp + r) * Wp + c) * C + h * hd + d] = from_f<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 path on the tensor cores: one block of 4 warps per (window,
// head, image), the window's tokens padded to 64 rows with zeros.
// S = Q.K^T (64 x 64) and ctx = P.V (64 x hd) are nvcuda::wmma 16x16x16
// products with float32 accumulators, one 16-row band per warp; the scale,
// bias, mask and softmax run between them one warp per row, as above.
// Needs hd % 16 == 0 (32 on the main path) and N <= 64.
// ---------------------------------------------------------------------------
constexpr int kRowsPad = 64;

__global__ void __launch_bounds__(128)
window_attention_fwd_wmma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                                 int Hp, int Wp, int C, int heads, int wh, int ww, int sh,
                                 int sw, float scale) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  const int n = wh * ww;
  const int hd = C / heads;
  const int nww = Wp / ww;
  const int win = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wr = win / nww, wc = win % nww;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ss = reinterpret_cast<float*>(smem_raw);         // [64][64] scores
  float* os = ss + kRowsPad * kRowsPad;                    // [64][hd] context
  bf16* qs = reinterpret_cast<bf16*>(os + kRowsPad * hd);  // [64][hd]
  bf16* ks = qs + kRowsPad * hd;                           // [64][hd]
  bf16* vs = ks + kRowsPad * hd;                           // [64][hd]
  bf16* ps = vs + kRowsPad * hd;                           // [64][64] probs

  const long long c3 = 3LL * C;
  const int vec = hd / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < kRowsPad * vec; e += blockDim.x) {
    const int t = e / vec, q = e - t * vec;
    uint4 z = make_uint4(0u, 0u, 0u, 0u), qv = z, kv = z, vv = z;
    if (t < n) {
      const int r = wr * wh + t / ww, c = wc * ww + t % ww;
      const bf16* src = qkv + ((long long)(b * Hp + r) * Wp + c) * c3 + h * hd + q * 8;
      qv = *reinterpret_cast<const uint4*>(src);
      kv = *reinterpret_cast<const uint4*>(src + C);
      vv = *reinterpret_cast<const uint4*>(src + 2 * C);
    }
    reinterpret_cast<uint4*>(qs)[e] = qv;
    reinterpret_cast<uint4*>(ks)[e] = kv;
    reinterpret_cast<uint4*>(vs)[e] = vv;
  }
  __syncthreads();

  {  // S = Q.K^T: warp owns rows [16*warp, 16*warp+16)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int k0 = 0; k0 < hd; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + warp * 16 * hd + k0, hd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
        wmma::load_matrix_sync(bk, ks + j * 16 * hd + k0, hd);
        wmma::mma_sync(acc[j], a, bk, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(ss + warp * 16 * kRowsPad + j * 16, acc[j], kRowsPad,
                              wmma::mem_row_major);
  }
  __syncthreads();

  const bool masked = (sh | sw) != 0;
  for (int i = warp; i < kRowsPad; i += 4) {
    if (i >= n) {
      for (int j = lane; j < kRowsPad; j += 32) ps[i * kRowsPad + j] = from_f<bf16>(0.0f);
      continue;
    }
    const int ri = wr * wh + i / ww, ci = wc * ww + i % ww;
    const int gi = 3 * ((ri >= Hp - wh) + (ri >= Hp - sh)) + (ci >= Wp - ww) + (ci >= Wp - sw);
    float s[2];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      s[u] = -INFINITY;
      if (j < n) {
        float x = ss[i * kRowsPad + j] * scale;
        x += bias[(h * n + i) * n + j];
        if (masked) {
          const int rj = wr * wh + j / ww, cj = wc * ww + j % ww;
          const int gj =
              3 * ((rj >= Hp - wh) + (rj >= Hp - sh)) + (cj >= Wp - ww) + (cj >= Wp - sw);
          x += (gi != gj) ? -100.0f : 0.0f;
        }
        s[u] = x;
        m = fmaxf(m, x);
      }
    }
    m = warp_max(m);
    float e[2], sum = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      e[u] = (lane + 32 * u < n) ? expf(s[u] - m) : 0.0f;
      sum += e[u];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = lane + 32 * u;
      ps[i * kRowsPad + j] = from_f<bf16>(j < n ? e[u] / sum : 0.0f);
    }
  }
  __syncthreads();

  {  // ctx = P.V: warp owns rows [16*warp, 16*warp+16), all hd columns
    for (int d0 = 0; d0 < hd; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int k0 = 0; k0 < kRowsPad; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, ps + warp * 16 * kRowsPad + k0, kRowsPad);
        wmma::load_matrix_sync(bv, vs + k0 * hd + d0, hd);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(os + warp * 16 * hd + d0, acc, hd, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
    const int i = idx / hd, d = idx - i * hd;
    const int r = wr * wh + i / ww, c = wc * ww + i % ww;
    out[((long long)(b * Hp + r) * Wp + c) * C + h * hd + d] = from_f<bf16>(os[i * hd + d]);
  }
}

static cudaError_t launch_wmma(const void* qkv, const void* bias, void* out, int B, int Hp,
                               int Wp, int C, int heads, int wh, int ww, int sh, int sw,
                               cudaStream_t st) {
  const int hd = C / heads;
  const size_t smem = sizeof(float) * (size_t)(kRowsPad * kRowsPad + kRowsPad * hd) +
                      sizeof(__nv_bfloat16) * (size_t)(3 * kRowsPad * hd + kRowsPad * kRowsPad);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(window_attention_fwd_wmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = (float)pow((double)hd, -0.5);
  dim3 grid((Hp / wh) * (Wp / ww), heads, B);
  window_attention_fwd_wmma_kernel<<<grid, 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), Hp, Wp, C, heads, wh, ww, sh, sw, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* qkv, const void* bias, void* out, int B, int Hp, int Wp,
                          int C, int heads, int wh, int ww, int sh, int sw, cudaStream_t st) {
  const int n = wh * ww, hd = C / heads;
  const size_t smem = sizeof(float) * (size_t)(2 * n * hd + n * (hd + 1) + n * n);
  auto kern = window_attention_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const float scale = (float)pow((double)hd, -0.5);
  dim3 grid((Hp / wh) * (Wp / ww), heads, B);
  kern<<<grid, 128, smem, st>>>(static_cast<const T*>(qkv), static_cast<const float*>(bias),
                                static_cast<T*>(out), Hp, Wp, C, heads, wh, ww, sh, sw, scale);
  return cudaGetLastError();
}

}  // namespace ssa

extern "C" int ssa_window_attention_fwd(const void* qkv, const void* bias, void* out, int B,
                                        int Hp, int Wp, int C, int heads, int wh, int ww,
                                        int sh, int sw, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = C / heads;
  if (dtype == ssa::kBF16 && hd % 16 == 0 && wh * ww <= ssa::kRowsPad)
    return (int)ssa::launch_wmma(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw, st);
  if (dtype == ssa::kBF16)
    return (int)ssa::launch<__nv_bfloat16>(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw,
                                           st);
  return (int)ssa::launch<float>(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw, st);
}
