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
// the card's 295 FLOP/byte balance point.  Five kernel families, chosen by
// the wrapper from the static shape (`Route`); the first three take windows
// of up to 64 tokens:
//  * bfloat16 at head widths 16, 32 and 64 (the deployment type; 32 at every
//    stage of the main path): the `mma.sync` kernels at the end of this
//    file, where a block walks a run of windows of one head with the next
//    window's operands in flight and the scores stay in registers;
//  * bfloat16 at other head widths that are a multiple of 16: one block per
//    (window, head, image), the two products as nvcuda::wmma tiles with the
//    window padded to 64 tokens, scores in shared memory;
//  * float32 (the parity type) and the remaining widths: the same block on
//    the CUDA cores in float32;
// and windows of more than 64 tokens (window 12 and up) take the tiled
// kernels of fused_window_attention_tiled.cu:
//  * bfloat16 at head widths that are a multiple of 16 up to 128: the tiled
//    `mma.sync` kernels (16-row bands on the tensor cores, a band's whole
//    score row in registers up to 144 tokens, key chunks split over blocks
//    beyond);
//  * float32 and the other bfloat16 widths up to 128: the tiled kernels on
//    the CUDA cores, which stream 64-token tiles of queries and keys
//    through shared memory.
// All gather a window's tokens' q/k/v slices by index arithmetic straight
// from the spatial layout (no window-partition copy in device memory) and
// compute the shift mask from the region ids of the rolled grid instead of
// reading a (nW, N, N) mask array.
#include <mma.h>

#include "fused_window_attention.cuh"

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

// ===========================================================================
// Backward.
//
// Replaces: the Pallas kernel `_bwd_kernel` (launcher `_bwd_pallas`) in
// semantic_segmentation_of_stylegan2_artifacts_tpu/ops/fused_window_attention.py.
//
// Contract (as the TPU kernel): from the saved qkv and the context's
// cotangent dctx (B, Hp, Wp, C) it recomputes P (scores scaled after q.k^T,
// + bias, + shift mask, float32 softmax), forms dP = dctx.v^T and
// dS = P*(dP - rowsum(dP*P)) in float32, sums the float32 dS into the bias
// gradient, rounds dS to the storage type for dq = dS.k*scale and
// dk = dS^T.q*scale, rounds P for dv = P^T.dctx, and writes dq/dk/dv in the
// storage type to (B, Hp, Wp, 3C) at the tokens' own positions.
//
// Bound on the H100: memory.  Per token it reads 3C (qkv) + C (dctx) and
// writes 3C values, ~7C against the forward's 4C; the five 49x49xhd
// products (~1.5 MFLOP per window and head) stay far below the balance
// point.  Design: the TPU grid summed the bias gradient in scratch across
// its sequential grid; blocks here run in no order, so each block walks a
// group of windows of one head, sums its dS on chip (each (i, j) owned by
// one thread: no atomics) and writes one float32 partial; a second launch
// (sum_rows) adds the partials in a fixed order, so dbias is the same from
// run to run.  Grouping keeps the partials small (a per-window partial
// would be ~110 MB at stage 0).  Padded rows and columns (49 -> 64 tokens
// on the tensor-core paths) are zero in P and dS, so they add nothing to
// rowsum, dbias, dq, dk or dv.  The same three families as the forward: the
// `mma.sync` kernel at the end of this file, the five products as
// nvcuda::wmma tiles, or float32 on the CUDA cores.
// ===========================================================================
template <typename T>
__global__ void window_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                                            const float* __restrict__ bias,
                                            T* __restrict__ dqkv, float* __restrict__ part,
                                            int B, int Hp, int Wp, int C, int heads, int wh,
                                            int ww, int sh, int sw, int group, float scale) {
  const int n = wh * ww;
  const int hd = C / heads;
  const int nwh = Hp / wh, nww = Wp / ww, nwin = nwh * nww;
  const int h = blockIdx.y;
  extern __shared__ float smem[];
  float* qs = smem;                   // n x hd
  float* ks = qs + n * hd;            // n x (hd + 1)
  float* vs = ks + n * (hd + 1);      // n x (hd + 1)
  float* dcs = vs + n * (hd + 1);     // n x hd
  float* ps = dcs + n * hd;           // n x n: scores, then rounded probs
  float* dss = ps + n * n;            // n x n: dP, then rounded dS
  float* db = dss + n * n;            // n x n bias-gradient sum of the group
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) db[idx] = 0.0f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const bool masked = (sh | sw) != 0;
  const long long c3 = 3LL * C;
  for (int g = 0; g < group; ++g) {
    const int gw = blockIdx.x * group + g;
    if (gw >= B * nwin) break;
    const int b = gw / nwin, win = gw - b * nwin;
    const int wr = win / nww, wc = win % nww;
    __syncthreads();  // the previous window is done with the tiles
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int t = idx / hd, d = idx - t * hd;
      const long long tok = (long long)(b * Hp + wr * wh + t / ww) * Wp + wc * ww + t % ww;
      const T* src = qkv + tok * c3 + h * hd + d;
      qs[t * hd + d] = to_f(src[0]);
      ks[t * (hd + 1) + d] = to_f(src[C]);
      vs[t * (hd + 1) + d] = to_f(src[2 * C]);
      dcs[t * hd + d] = to_f(dctx[tok * C + h * hd + d]);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, j = idx - i * n;
      float s = 0.0f, dp = 0.0f;
      for (int d = 0; d < hd; ++d) {
        s += qs[i * hd + d] * ks[j * (hd + 1) + d];
        dp += dcs[i * hd + d] * vs[j * (hd + 1) + d];
      }
      ps[idx] = s;
      dss[idx] = dp;
    }
    __syncthreads();
    for (int i = warp; i < n; i += nwarps) {
      const int ri = wr * wh + i / ww, ci = wc * ww + i % ww;
      const int gi = 3 * ((ri >= Hp - wh) + (ri >= Hp - sh)) + (ci >= Wp - ww) + (ci >= Wp - sw);
      float s[2], dp[2], m = -INFINITY;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        s[u] = -INFINITY;
        dp[u] = 0.0f;
        if (j < n) {
          float x = ps[i * n + j] * scale + bias[(h * n + i) * n + j];
          if (masked) {
            const int rj = wr * wh + j / ww, cj = wc * ww + j % ww;
            const int gj =
                3 * ((rj >= Hp - wh) + (rj >= Hp - sh)) + (cj >= Wp - ww) + (cj >= Wp - sw);
            x += (gi != gj) ? -100.0f : 0.0f;
          }
          s[u] = x;
          dp[u] = dss[i * n + j];
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
      float p[2], rs = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        p[u] = e[u] / sum;
        rs += p[u] * dp[u];
      }
      rs = warp_sum(rs);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        if (j < n) {
          const float ds = p[u] * (dp[u] - rs);
          db[i * n + j] += ds;
          ps[i * n + j] = round_to<T>(p[u]);
          dss[i * n + j] = round_to<T>(ds);
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int t = idx / hd, d = idx - t * hd;
      float dq = 0.0f, dk = 0.0f, dv = 0.0f;
      for (int j = 0; j < n; ++j) {
        dq += dss[t * n + j] * ks[j * (hd + 1) + d];
        dk += dss[j * n + t] * qs[j * hd + d];
        dv += ps[j * n + t] * dcs[j * hd + d];
      }
      const long long tok = (long long)(b * Hp + wr * wh + t / ww) * Wp + wc * ww + t % ww;
      T* dst = dqkv + tok * c3 + h * hd + d;
      dst[0] = from_f<T>(dq * scale);
      dst[C] = from_f<T>(dk * scale);
      dst[2 * C] = from_f<T>(dv);
    }
  }
  __syncthreads();
  float* out = part + ((long long)blockIdx.x * heads + h) * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) out[idx] = db[idx];
}

// bfloat16 on the tensor cores: 4 warps, the window padded to 64 tokens,
// warp w owns rows [16w, 16w+16) of every 64-row product.
__global__ void __launch_bounds__(128)
window_attention_bwd_wmma_kernel(const __nv_bfloat16* __restrict__ qkv,
                                 const __nv_bfloat16* __restrict__ dctx,
                                 const float* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ dqkv, float* __restrict__ part,
                                 int B, int Hp, int Wp, int C, int heads, int wh, int ww,
                                 int sh, int sw, int group, float scale) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int R = kRowsPad;
  const int n = wh * ww;
  const int hd = C / heads;
  const int nwh = Hp / wh, nww = Wp / ww, nwin = nwh * nww;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ss = reinterpret_cast<float*>(smem_raw);  // [64][64] scores
  float* dps = ss + R * R;                          // [64][64] dP
  float* os = dps + R * R;                          // [3][64][hd] dq, dk, dv
  float* db = os + 3 * R * hd;                      // [n][n] bias-gradient sum
  bf16* qs = reinterpret_cast<bf16*>(db + ((n * n + 31) & ~31));  // [64][hd]
  bf16* ks = qs + R * hd;
  bf16* vs = ks + R * hd;
  bf16* dcs = vs + R * hd;
  bf16* ps = dcs + R * hd;  // [64][64] rounded probs
  bf16* dss = ps + R * R;   // [64][64] rounded dS
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) db[idx] = 0.0f;

  const bool masked = (sh | sw) != 0;
  const long long c3 = 3LL * C;
  const int vec = hd / 8;  // 16-byte chunks per row
  for (int g = 0; g < group; ++g) {
    const int gw = blockIdx.x * group + g;
    if (gw >= B * nwin) break;
    const int b = gw / nwin, win = gw - b * nwin;
    const int wr = win / nww, wc = win % nww;
    __syncthreads();  // the previous window is done with every tile
    for (int e = threadIdx.x; e < R * vec; e += blockDim.x) {
      const int t = e / vec, q = e - t * vec;
      uint4 z = make_uint4(0u, 0u, 0u, 0u), qv = z, kv = z, vv = z, dv = z;
      if (t < n) {
        const long long tok = (long long)(b * Hp + wr * wh + t / ww) * Wp + wc * ww + t % ww;
        const bf16* src = qkv + tok * c3 + h * hd + q * 8;
        qv = *reinterpret_cast<const uint4*>(src);
        kv = *reinterpret_cast<const uint4*>(src + C);
        vv = *reinterpret_cast<const uint4*>(src + 2 * C);
        dv = *reinterpret_cast<const uint4*>(dctx + tok * C + h * hd + q * 8);
      }
      reinterpret_cast<uint4*>(qs)[e] = qv;
      reinterpret_cast<uint4*>(ks)[e] = kv;
      reinterpret_cast<uint4*>(vs)[e] = vv;
      reinterpret_cast<uint4*>(dcs)[e] = dv;
    }
    __syncthreads();

    {  // S = Q.K^T and dP = dC.V^T
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> as[4], ad[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fill_fragment(as[j], 0.0f);
        wmma::fill_fragment(ad[j], 0.0f);
      }
      for (int k0 = 0; k0 < hd; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> aq, ac;
        wmma::load_matrix_sync(aq, qs + warp * 16 * hd + k0, hd);
        wmma::load_matrix_sync(ac, dcs + warp * 16 * hd + k0, hd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk, bv;
          wmma::load_matrix_sync(bk, ks + j * 16 * hd + k0, hd);
          wmma::load_matrix_sync(bv, vs + j * 16 * hd + k0, hd);
          wmma::mma_sync(as[j], aq, bk, as[j]);
          wmma::mma_sync(ad[j], ac, bv, ad[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(ss + warp * 16 * R + j * 16, as[j], R, wmma::mem_row_major);
        wmma::store_matrix_sync(dps + warp * 16 * R + j * 16, ad[j], R, wmma::mem_row_major);
      }
    }
    __syncthreads();

    for (int i = warp; i < R; i += 4) {
      if (i >= n) {
        for (int j = lane; j < R; j += 32) {
          ps[i * R + j] = from_f<bf16>(0.0f);
          dss[i * R + j] = from_f<bf16>(0.0f);
        }
        continue;
      }
      const int ri = wr * wh + i / ww, ci = wc * ww + i % ww;
      const int gi = 3 * ((ri >= Hp - wh) + (ri >= Hp - sh)) + (ci >= Wp - ww) + (ci >= Wp - sw);
      float s[2], dp[2], m = -INFINITY;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        s[u] = -INFINITY;
        dp[u] = 0.0f;
        if (j < n) {
          float x = ss[i * R + j] * scale + bias[(h * n + i) * n + j];
          if (masked) {
            const int rj = wr * wh + j / ww, cj = wc * ww + j % ww;
            const int gj =
                3 * ((rj >= Hp - wh) + (rj >= Hp - sh)) + (cj >= Wp - ww) + (cj >= Wp - sw);
            x += (gi != gj) ? -100.0f : 0.0f;
          }
          s[u] = x;
          dp[u] = dps[i * R + j];
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
      float p[2], rs = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        p[u] = e[u] / sum;
        rs += p[u] * dp[u];
      }
      rs = warp_sum(rs);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const float ds = p[u] * (dp[u] - rs);  // 0 for j >= n (p = 0)
        if (j < n) db[i * n + j] += ds;
        ps[i * R + j] = from_f<bf16>(p[u]);
        dss[i * R + j] = from_f<bf16>(ds);
      }
    }
    __syncthreads();

    // dq = dS.K, dk = dS^T.Q, dv = P^T.dC: warp owns output rows [16w, 16w+16)
    for (int d0 = 0; d0 < hd; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> aq, ak, av;
      wmma::fill_fragment(aq, 0.0f);
      wmma::fill_fragment(ak, 0.0f);
      wmma::fill_fragment(av, 0.0f);
#pragma unroll
      for (int k0 = 0; k0 < R; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a_ds;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a_dst, a_pt;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bk, bq, bc;
        wmma::load_matrix_sync(a_ds, dss + warp * 16 * R + k0, R);
        wmma::load_matrix_sync(a_dst, dss + k0 * R + warp * 16, R);
        wmma::load_matrix_sync(a_pt, ps + k0 * R + warp * 16, R);
        wmma::load_matrix_sync(bk, ks + k0 * hd + d0, hd);
        wmma::load_matrix_sync(bq, qs + k0 * hd + d0, hd);
        wmma::load_matrix_sync(bc, dcs + k0 * hd + d0, hd);
        wmma::mma_sync(aq, a_ds, bk, aq);
        wmma::mma_sync(ak, a_dst, bq, ak);
        wmma::mma_sync(av, a_pt, bc, av);
      }
      wmma::store_matrix_sync(os + warp * 16 * hd + d0, aq, hd, wmma::mem_row_major);
      wmma::store_matrix_sync(os + R * hd + warp * 16 * hd + d0, ak, hd, wmma::mem_row_major);
      wmma::store_matrix_sync(os + 2 * R * hd + warp * 16 * hd + d0, av, hd,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * hd; idx += blockDim.x) {
      const int t = idx / hd, d = idx - t * hd;
      const long long tok = (long long)(b * Hp + wr * wh + t / ww) * Wp + wc * ww + t % ww;
      bf16* dst = dqkv + tok * c3 + h * hd + d;
      dst[0] = from_f<bf16>(os[t * hd + d] * scale);
      dst[C] = from_f<bf16>(os[R * hd + t * hd + d] * scale);
      dst[2 * C] = from_f<bf16>(os[2 * R * hd + t * hd + d]);
    }
  }
  __syncthreads();
  float* out = part + ((long long)blockIdx.x * heads + h) * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) out[idx] = db[idx];
}

static cudaError_t launch_bwd(const void* qkv, const void* dctx, const void* bias, void* dqkv,
                             void* part, void* dbias, int B, int Hp, int Wp, int C, int heads,
                             int wh, int ww, int sh, int sw, int route, int group, int dtype,
                             cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const int n = wh * ww, hd = C / heads;
  const int nblk = (B * (Hp / wh) * (Wp / ww) + group - 1) / group;
  const float scale = (float)pow((double)hd, -0.5);
  const dim3 grid(nblk, heads);
  cudaError_t e;
  if (route == kRouteWmma) {
    const int R = kRowsPad;
    const size_t smem = sizeof(float) * (size_t)(2 * R * R + 3 * R * hd + ((n * n + 31) & ~31)) +
                        sizeof(bf16) * (size_t)(4 * R * hd + 2 * R * R);
    if ((e = cudaFuncSetAttribute(window_attention_bwd_wmma_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return e;
    window_attention_bwd_wmma_kernel<<<grid, 128, smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dctx),
        static_cast<const float*>(bias), static_cast<bf16*>(dqkv), static_cast<float*>(part), B,
        Hp, Wp, C, heads, wh, ww, sh, sw, group, scale);
  } else {
    const size_t smem = sizeof(float) * (size_t)(2 * n * hd + 2 * n * (hd + 1) + 3 * n * n);
    if (dtype == kBF16) {
      auto kern = window_attention_bwd_kernel<bf16>;
      if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
        return e;
      kern<<<grid, 128, smem, st>>>(static_cast<const bf16*>(qkv),
                                    static_cast<const bf16*>(dctx),
                                    static_cast<const float*>(bias), static_cast<bf16*>(dqkv),
                                    static_cast<float*>(part), B, Hp, Wp, C, heads, wh, ww, sh,
                                    sw, group, scale);
    } else {
      auto kern = window_attention_bwd_kernel<float>;
      if ((e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)) != cudaSuccess)
        return e;
      kern<<<grid, 128, smem, st>>>(static_cast<const float*>(qkv),
                                    static_cast<const float*>(dctx),
                                    static_cast<const float*>(bias), static_cast<float*>(dqkv),
                                    static_cast<float*>(part), B, Hp, Wp, C, heads, wh, ww, sh,
                                    sw, group, scale);
    }
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return sum_rows(static_cast<const float*>(part), static_cast<float*>(dbias), nblk,
                  heads * n * n, (long long)heads * n * n, st);
}

// ===========================================================================
// bfloat16 at head widths 16, 32 and 64: the kernels of the main path, built
// for the H100 around `mma.sync.m16n8k16`.
//
// Both move few bytes per window (12.5 KB forward and 21.9 KB backward at
// head width 32, for ~0.6 and ~1.5 MFLOP) and are bound by bytes on paper;
// in practice what limits them is instruction throughput, so the design keeps
// loads in flight and spends as few instructions per window as it can:
//
// * A block of four warps owns one head and walks a run of consecutive
//   windows (runs are balanced over `chunks` blocks per head so that one wave
//   fills the card; the wrapper sizes them from the SM count).  Neighbouring
//   blocks take neighbouring heads of the same run, so the 64-byte head slices
//   of a token's 128-byte lines are asked for at about the same time.
// * The q, k, v (and dctx) slices of the next windows arrive by `cp.async`,
//   16 bytes a lane, in a ring of stages while the current window is
//   computed: one barrier per window in the forward, two in the backward.
//   Each thread keeps its copies' token offsets and swizzled destinations in
//   registers and the window position is advanced, not divided out.  Rows are
//   XOR-swizzled so that `ldmatrix` reads them without bank conflicts at
//   32/64/128-byte rows; every fragment address is a per-lane constant XOR or
//   plus a compile-time term.
// * The head's bias is read once per block, prescaled by log2(e), into shared
//   memory with -inf in the padded key columns (the mask of the padding for
//   free); the 2-bit region codes of the shift mask are computed once per
//   block and applied only in the last row and column of windows.
// * Warp w owns query rows [16w, 16w+16).  Scores, probabilities, dP and dS
//   live in accumulator registers: the logits are `fma(S, scale*log2e,
//   bias*log2e)`, max and sum run over the four lanes that share a row,
//   `ex2.approx` gives the exponentials, and the rounded P (dS) is packed
//   straight into the A fragments of the next product.  No float32 score tile
//   exists in shared memory.  Keys take NT n8 tiles: 7 for N <= 56 (49 on the
//   main path), 8 up to 64.
// * Backward: dq comes from the register dS.  dk = dS^T.q and dv = P^T.dctx
//   need the columns of dS and P: the warps pass their rounded bands through
//   two 8 KB bf16 tiles (`stmatrix`), and after the window's second barrier
//   warp w reads key band w with `ldmatrix.trans`.  The bias gradient stays in
//   accumulator-layout registers over the whole run and leaves as one float32
//   partial per block; `dbias_sum_kernel` adds the partials in a fixed order.
// * Outputs leave 16 bytes a lane: a 4x4 transpose among the four lanes of a
//   row (shuffles) turns the accumulator layout into whole 16-byte pieces.
// * Padded rows (>= N) are never looped over: their lanes compute on finite
//   leftovers, their P and dS are forced to zero, and nothing of them is
//   stored.  Rows of the ring past an operand alias the next operand or a
//   zeroed tail, so every fragment load is finite.
// ===========================================================================
constexpr int kMmaThreads = 128;
constexpr int kFwdStages = 2;
constexpr int kBwdStages = 2;
constexpr int kPTileBytes = 64 * 128;  // 64 query rows x 64 keys, bf16

struct MmaGeom {
  int B, Hp, Wp, C, heads, wh, ww, sh, sw, chunks;
  float scale, scale_log2;
};

// Shared-memory layout, one definition for the host (size) and the device
// (offsets): the ring of stages, in the backward the P and dS tiles, the
// bias tile, the tokens' mask codes.
template <int HD, int NT, int NOPS>
struct MmaLayout {
  static constexpr int RB = 2 * HD;   // bytes per row of an operand tile
  static constexpr int CH = HD / 8;   // 16-byte chunks per row
  // float32 bias rows 8 or 24 (mod 32) words apart, so the four rows a
  // half-warp reads as float2 fall into distinct banks
  static constexpr int kBStride = 8 * NT + ((NT & 1) ? 0 : 8);
  int n, op_bytes, stage_bytes;
  __host__ __device__ explicit MmaLayout(int n_) : n(n_) {
    op_bytes = (n * RB + 127) & ~127;
    // a fragment load may touch 64 rows from an operand's base
    const int over = 64 * RB - op_bytes;
    stage_bytes = NOPS * op_bytes + (over > 0 ? ((over + 127) & ~127) : 0);
  }
  __host__ __device__ int total(int stages) const {
    return stages * stage_bytes + (NOPS == 4 ? 2 * kPTileBytes : 0) + 4 * n * kBStride + 4 * 64;
  }
};

// Swizzle term of row r of an operand tile whose rows are 2*HD bytes: the
// 16-byte chunk index is XORed with the index of the row's 128-byte line
// group, so 8 consecutive rows at one chunk hit 8 distinct bank groups.  It
// depends on r mod 8 only.
template <int HD>
__device__ __forceinline__ int swz(int r) {
  constexpr int kShift = HD == 16 ? 2 : (HD == 32 ? 1 : 0);
  return (r >> kShift) & (HD / 8 - 1);
}

// A warp's 16 x HD band in accumulator layout (lane: rows lo/hi, columns
// 8c + 2t, +1) times `mul`, rounded to bf16 and stored 16 bytes a lane.
// `row_lo` / `row_hi` point at the head slice of the two rows' tokens.
template <int HD, bool kScale>
__device__ __forceinline__ void store_band(const float (&o)[HD / 8][4], float mul, bf16* row_lo,
                                           bf16* row_hi, bool v_lo, bool v_hi, int t) {
  auto pk = [mul](float a, float b) { return kScale ? pack2(a * mul, b * mul) : pack2(a, b); };
  if constexpr (HD == 16) {
    uint32_t v[4] = {pk(o[0][0], o[0][1]), pk(o[1][0], o[1][1]), pk(o[0][2], o[0][3]),
                     pk(o[1][2], o[1][3])};
    quad_transpose(v, t);  // lane t: tile t & 1 of row half t >> 1
    bf16* dst = (t >> 1) ? row_hi : row_lo;
    if ((t >> 1) ? v_hi : v_lo) st_global16(dst + (t & 1) * 8, v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int g = 0; g < HD / 32; ++g) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = pk(o[4 * g + i][0], o[4 * g + i][1]);
        hi[i] = pk(o[4 * g + i][2], o[4 * g + i][3]);
      }
      quad_transpose(lo, t);  // lane t: tile 4g + t
      quad_transpose(hi, t);
      if (v_lo) st_global16(row_lo + (4 * g + t) * 8, lo[0], lo[1], lo[2], lo[3]);
      if (v_hi) st_global16(row_hi + (4 * g + t) * 8, hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// What a thread keeps for its run.
template <int HD>
struct MmaCtx {
  static constexpr int kCopies = HD / 16;  // ceil(64 rows * CH chunks / 128 threads)
  // asynchronous copies: token offset in a window (-1: none) and swizzled
  // destination of each of the thread's 16-byte pieces; all at chunk c8 / 8
  int cp_tok[kCopies];
  uint32_t cp_dst[kCopies];
  int c8;
  // the warp's band: rows, validity, token offsets, shift-mask codes of the
  // rows and (2 bits each, tile j, u at 4j + 2u) of the key columns held
  int r_lo, r_hi, rt_lo, rt_hi, rc_lo, rc_hi;
  bool v_lo, v_hi;
  uint32_t colcodes;
  // per-lane fragment offsets in an operand tile: `t_off` for x4 loads of
  // 16 rows x 2 chunks (A fragments of rows 0..15, and transposed B
  // fragments), `k_off` for 8 rows x 4 chunks (B fragments of [key][HD])
  uint32_t t_off, k_off;
  // the block's head, the end of its run of windows, the grid of windows
  int h, w_end, nww, nwh;
};

struct WinPos {
  int gw, b, wr, wc;
};

__device__ __forceinline__ WinPos win_pos(int gw, int nwh, int nww) {
  WinPos p;
  p.gw = gw;
  const int nwin = nwh * nww;
  p.b = gw / nwin;
  const int win = gw - p.b * nwin;
  p.wr = win / nww;
  p.wc = win - p.wr * nww;
  return p;
}
__device__ __forceinline__ void win_next(WinPos& p, int nwh, int nww) {
  ++p.gw;
  if (++p.wc == nww) {
    p.wc = 0;
    if (++p.wr == nwh) {
      p.wr = 0;
      ++p.b;
    }
  }
}
__device__ __forceinline__ long long win_tok0(const WinPos& p, const MmaGeom& g) {
  return ((long long)p.b * g.Hp + p.wr * g.wh) * g.Wp + p.wc * g.ww;
}

// 2-bit region code of token i of a window: bit 0 rows below the shift line,
// bit 1 columns right of it; a window masks pairs whose codes differ in the
// bits its position enables (last row / last column of windows).
__device__ __forceinline__ int token_code(int i, const MmaGeom& g) {
  const int r = i / g.ww, c = i - r * g.ww;
  return ((g.sh > 0 && r >= g.wh - g.sh) ? 1 : 0) | ((g.sw > 0 && c >= g.ww - g.sw) ? 2 : 0);
}

// Block set-up: zero the ring and the tiles (rows past an operand must stay
// finite), the tokens' mask codes, the thread's copy plan and fragment
// offsets.  Ends with a barrier.
template <int HD, int NT, int NOPS>
__device__ __forceinline__ void mma_setup(unsigned char* smem, int zero_bytes, int* codes,
                                          const MmaGeom& g, const MmaLayout<HD, NT, NOPS>& l,
                                          MmaCtx<HD>& cx) {
  constexpr int RB = 2 * HD, CH = HD / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = l.n;
  for (int i = tid; i < zero_bytes / 16; i += kMmaThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < 64) codes[tid] = tid < n ? token_code(tid, g) : 0;
  cx.c8 = (tid % CH) * 8;
#pragma unroll
  for (int i = 0; i < MmaCtx<HD>::kCopies; ++i) {
    const int r = (tid + i * kMmaThreads) / CH;
    cx.cp_tok[i] = r < n ? (r / g.ww) * g.Wp + r % g.ww : -1;
    cx.cp_dst[i] = (uint32_t)(r * RB + (((tid % CH) ^ swz<HD>(r)) << 4));
  }
  cx.r_lo = warp * 16 + (lane >> 2);
  cx.r_hi = cx.r_lo + 8;
  cx.v_lo = cx.r_lo < n;
  cx.v_hi = cx.r_hi < n;
  cx.rt_lo = cx.v_lo ? (cx.r_lo / g.ww) * g.Wp + cx.r_lo % g.ww : 0;
  cx.rt_hi = cx.v_hi ? (cx.r_hi / g.ww) * g.Wp + cx.r_hi % g.ww : 0;
  {
    const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
    cx.t_off = (uint32_t)(r * RB + ((((lane >> 4) ^ swz<HD>(r)) & (CH - 1)) << 4));
    const int rk = lane & 7;
    cx.k_off = (uint32_t)(rk * RB + ((((lane >> 3) ^ swz<HD>(rk)) & (CH - 1)) << 4));
  }
  __syncthreads();
  cx.rc_lo = codes[cx.r_lo];
  cx.rc_hi = codes[cx.r_hi & 63];
  cx.colcodes = 0u;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      cx.colcodes |= (uint32_t)codes[8 * j + 2 * (lane & 3) + u] << (4 * j + 2 * u);
}

// The head's bias, prescaled by log2(e), -inf in the padded key columns.
// Every load of a thread is in flight before its first store: the fill costs
// one round trip to L2, not one per element.
template <int NT, int kBStride>
__device__ __forceinline__ void load_bias(float* bias_s, const float* __restrict__ bias, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v[16][2];
#pragma unroll
  for (int it = 0; it < 16; ++it)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = warp + 4 * it, j = lane + 32 * u;
      v[it][u] = (i < n && j < n) ? __ldg(bias + i * n + j) * kLog2e : -INFINITY;
    }
#pragma unroll
  for (int it = 0; it < 16; ++it)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = warp + 4 * it, j = lane + 32 * u;
      if (i < n && j < 8 * NT) bias_s[i * kBStride + j] = v[it][u];
    }
}

// Asynchronous loads of window `p`'s operands into a stage: the head slices
// of q, k, v (channel offsets 0, C, 2C of qkv) and, in the backward, dctx.
template <int HD, bool kBwd>
__device__ __forceinline__ void mma_load_window(const bf16* __restrict__ qkv,
                                          const bf16* __restrict__ dctx, uint32_t stage_u32,
                                          int op_bytes, const MmaGeom& g, const MmaCtx<HD>& cx,
                                          const WinPos& p) {
  const long long tok0 = win_tok0(p, g);
  const int c3 = 3 * g.C;
  const bf16* src0 = qkv + tok0 * c3 + cx.h * HD + cx.c8;
  const bf16* dsrc0 = kBwd ? dctx + tok0 * g.C + cx.h * HD + cx.c8 : nullptr;
#pragma unroll
  for (int i = 0; i < MmaCtx<HD>::kCopies; ++i) {
    if (cx.cp_tok[i] >= 0) {
      const bf16* src = src0 + (long long)cx.cp_tok[i] * c3;
      const uint32_t dst = stage_u32 + cx.cp_dst[i];
      cp_async16(dst, src);
      cp_async16(dst + op_bytes, src + g.C);
      cp_async16(dst + 2 * op_bytes, src + 2 * g.C);
      if constexpr (kBwd) cp_async16(dst + 3 * op_bytes, dsrc0 + (long long)cx.cp_tok[i] * g.C);
    }
  }
}

// The band's 16 x HD A fragments (q or dctx rows [16 warp, 16 warp + 16));
// `band_u32` is the operand's base plus 16 warp rows.
template <int HD>
__device__ __forceinline__ void load_band(uint32_t (&a)[HD / 16][4], uint32_t band_u32,
                                          uint32_t t_off) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm4(a[kk], band_u32 + (t_off ^ (uint32_t)(kk << 5)));
}

// acc[j] (16 rows x keys 8j..8j+7) += A (the band's 16 x HD fragments) . B^T
// with B an operand tile stored [key][HD] (k for S, v for dP).
template <int HD, int NT>
__device__ __forceinline__ void band_times_keys_t(float (&acc)[NT][4],
                                                  const uint32_t (&a)[HD / 16][4],
                                                  uint32_t op_u32, uint32_t k_off) {
  constexpr int KS = HD / 16, RB = 2 * HD;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if constexpr (KS == 1) {
      uint32_t b0, b1;
      ldsm2(b0, b1, op_u32 + j * 8 * RB + k_off);
      mma_bf16_16816(acc[j], a[0], b0, b1);
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t b[4];
        ldsm4(b, op_u32 + j * 8 * RB + (k_off ^ (uint32_t)(kk << 5)));
        mma_bf16_16816(acc[j], a[kk], b[0], b[1]);
        mma_bf16_16816(acc[j], a[kk + 1], b[2], b[3]);
      }
    }
  }
}

// o (16 rows x HD) += A (16 x 16, packed bf16 fragments of one k16 step) . B
// with B 16 rows of an operand tile stored [row][HD] from `rows_u32`: keys
// (v for ctx, k for dq) or queries (q for dk, dctx for dv).
template <int HD>
__device__ __forceinline__ void frag_times_rows(float (&o)[HD / 8][4], const uint32_t (&a)[4],
                                                uint32_t rows_u32, uint32_t t_off) {
#pragma unroll
  for (int c0 = 0; c0 < HD / 8; c0 += 2) {
    uint32_t b[4];
    ldsm4_trans(b, rows_u32 + (t_off ^ (uint32_t)(c0 << 4)));
    mma_bf16_16816(o[c0], a, b[0], b[1]);
    mma_bf16_16816(o[c0 + 1], a, b[2], b[3]);
  }
}

// In place: raw scores -> float32 probabilities of the band's two rows per
// lane (padded key columns come out as exact zeros).
template <int HD, int NT, int kBStride>
__device__ __forceinline__ void band_softmax(float (&s)[NT][4], const float* bias_s,
                                             const MmaCtx<HD>& cx, int wmask, float scale_log2,
                                             int lane) {
  const float* b_lo = bias_s + cx.r_lo * kBStride + 2 * (lane & 3);
  const float* b_hi = bias_s + cx.r_hi * kBStride + 2 * (lane & 3);
  const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bl = cx.v_lo ? *reinterpret_cast<const float2*>(b_lo + 8 * j) : zero;
    const float2 bh = cx.v_hi ? *reinterpret_cast<const float2*>(b_hi + 8 * j) : zero;
    s[j][0] = fmaf(s[j][0], scale_log2, bl.x);
    s[j][1] = fmaf(s[j][1], scale_log2, bl.y);
    s[j][2] = fmaf(s[j][2], scale_log2, bh.x);
    s[j][3] = fmaf(s[j][3], scale_log2, bh.y);
  }
  if (wmask) {
    constexpr float kMasked = -100.0f * kLog2e;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int cc = (cx.colcodes >> (4 * j + 2 * u)) & 3;
        if ((cx.rc_lo ^ cc) & wmask) s[j][u] += kMasked;
        if ((cx.rc_hi ^ cc) & wmask) s[j][2 + u] += kMasked;
      }
  }
  float m_lo = fmaxf(s[0][0], s[0][1]), m_hi = fmaxf(s[0][2], s[0][3]);
#pragma unroll
  for (int j = 1; j < NT; ++j) {
    m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
    m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
  }
  m_lo = quad_max(m_lo);
  m_hi = quad_max(m_hi);
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = ex2(s[j][0] - m_lo);
    s[j][1] = ex2(s[j][1] - m_lo);
    s[j][2] = ex2(s[j][2] - m_hi);
    s[j][3] = ex2(s[j][3] - m_hi);
    sum_lo += s[j][0] + s[j][1];
    sum_hi += s[j][2] + s[j][3];
  }
  const float inv_lo = __fdividef(1.0f, quad_sum(sum_lo));
  const float inv_hi = __fdividef(1.0f, quad_sum(sum_hi));
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] *= inv_lo;
    s[j][1] *= inv_lo;
    s[j][2] *= inv_hi;
    s[j][3] *= inv_hi;
  }
}

// Rounds a band (accumulator layout) to bf16 A fragments, one per k16 step
// over the keys (with 7 tiles the last step's upper half is zero).
template <int NT>
__device__ __forceinline__ void pack_band(uint32_t (&a)[4][4], const float (&p)[NT][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    a[s][0] = pack2(p[2 * s][0], p[2 * s][1]);
    a[s][1] = pack2(p[2 * s][2], p[2 * s][3]);
    if (2 * s + 1 < NT) {
      a[s][2] = pack2(p[2 * s + 1][0], p[2 * s + 1][1]);
      a[s][3] = pack2(p[2 * s + 1][2], p[2 * s + 1][3]);
    } else {
      a[s][2] = a[s][3] = 0u;
    }
  }
}

// The block's head and run of windows (block = chunk * heads + head; the run
// is a balanced split of all B * nW windows over `chunks`).
template <int HD>
__device__ __forceinline__ int mma_run(const MmaGeom& g, MmaCtx<HD>& cx) {
  cx.nww = g.Wp / g.ww;
  cx.nwh = g.Hp / g.wh;
  const long long total = (long long)g.B * cx.nwh * cx.nww;
  cx.h = blockIdx.x % g.heads;
  const long long chunk = blockIdx.x / g.heads;
  cx.w_end = (int)((chunk + 1) * total / g.chunks);
  return (int)(chunk * total / g.chunks);
}

__device__ __forceinline__ int window_mask_bits(const MmaGeom& g, const WinPos& p, int nwh,
                                                int nww) {
  return ((g.sh > 0 && p.wr == nwh - 1) ? 1 : 0) | ((g.sw > 0 && p.wc == nww - 1) ? 2 : 0);
}

// Four blocks an SM (the wrapper's FWD_BLOCKS_PER_SM sizes the grid by it).
template <int HD, int NT>
__global__ void __launch_bounds__(kMmaThreads, 4)
window_attention_fwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                                bf16* __restrict__ out, const MmaGeom g) {
  using L = MmaLayout<HD, NT, 3>;
  constexpr int RB = 2 * HD;
  const L l(g.wh * g.ww);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ring_bytes = kFwdStages * l.stage_bytes;
  float* bias_s = reinterpret_cast<float*>(smem_raw + ring_bytes);
  int* codes = reinterpret_cast<int*>(bias_s + l.n * L::kBStride);
  const uint32_t ring_u32 = smem_u32(smem_raw);
  MmaCtx<HD> cx;
  const int w_begin = mma_run(g, cx);
  mma_setup<HD, NT, 3>(smem_raw, ring_bytes, codes, g, l, cx);

  WinPos pi = win_pos(w_begin, cx.nwh, cx.nww);  // the window being loaded
  WinPos pc = pi;                                // the window being computed
#pragma unroll
  for (int s = 0; s < kFwdStages - 1; ++s) {
    if (pi.gw < cx.w_end) {
      mma_load_window<HD, false>(qkv, nullptr, ring_u32 + s * l.stage_bytes, l.op_bytes, g, cx, pi);
      win_next(pi, cx.nwh, cx.nww);
    }
    cp_async_commit();
  }
  load_bias<NT, L::kBStride>(bias_s, bias + (long long)cx.h * l.n * l.n, l.n);

  const bool active = warp * 16 < l.n;
  int stage = 0, istage = kFwdStages - 1;
  for (; pc.gw < cx.w_end; win_next(pc, cx.nwh, cx.nww)) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // this window has landed; everyone is done with the one before
    if (pi.gw < cx.w_end) {
      mma_load_window<HD, false>(qkv, nullptr, ring_u32 + istage * l.stage_bytes, l.op_bytes, g,
                                 cx, pi);
      win_next(pi, cx.nwh, cx.nww);
    }
    cp_async_commit();
    const uint32_t sq = ring_u32 + stage * l.stage_bytes;
    stage = stage + 1 == kFwdStages ? 0 : stage + 1;
    istage = istage + 1 == kFwdStages ? 0 : istage + 1;
    if (!active) continue;
    const uint32_t sk = sq + l.op_bytes, sv = sk + l.op_bytes;

    uint32_t qa[HD / 16][4];
    load_band<HD>(qa, sq + warp * 16 * RB, cx.t_off);
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    band_times_keys_t<HD, NT>(s, qa, sk, cx.k_off);
    band_softmax<HD, NT, L::kBStride>(s, bias_s, cx, window_mask_bits(g, pc, cx.nwh, cx.nww),
                                      g.scale_log2, lane);
    uint32_t pa[4][4];
    pack_band<NT>(pa, s);
    float o[HD / 8][4];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) frag_times_rows<HD>(o, pa[ks], sv + ks * 16 * RB, cx.t_off);
    bf16* base = out + win_tok0(pc, g) * g.C + cx.h * HD;
    store_band<HD, false>(o, 1.0f, base + (long long)cx.rt_lo * g.C,
                          base + (long long)cx.rt_hi * g.C, cx.v_lo, cx.v_hi, lane & 3);
  }
  cp_async_wait<0>();
}

// Three blocks an SM (the wrapper's BWD_BLOCKS_PER_SM).
template <int HD, int NT>
__global__ void __launch_bounds__(kMmaThreads, 3)
window_attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                                const float* __restrict__ bias, bf16* __restrict__ dqkv,
                                float* __restrict__ part, const MmaGeom g) {
  using L = MmaLayout<HD, NT, 4>;
  constexpr int RB = 2 * HD;
  const L l(g.wh * g.ww);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ring_bytes = kBwdStages * l.stage_bytes;
  float* bias_s = reinterpret_cast<float*>(smem_raw + ring_bytes + 2 * kPTileBytes);
  int* codes = reinterpret_cast<int*>(bias_s + l.n * L::kBStride);
  const uint32_t ring_u32 = smem_u32(smem_raw);
  const uint32_t p_u32 = ring_u32 + ring_bytes, ds_u32 = p_u32 + kPTileBytes;
  MmaCtx<HD> cx;
  const int w_begin = mma_run(g, cx);
  // the tiles are zeroed too: rows of bands past N are never written
  mma_setup<HD, NT, 4>(smem_raw, ring_bytes + 2 * kPTileBytes, codes, g, l, cx);

  WinPos pi = win_pos(w_begin, cx.nwh, cx.nww);
  WinPos pc = pi;
#pragma unroll
  for (int s = 0; s < kBwdStages - 1; ++s) {
    if (pi.gw < cx.w_end) {
      mma_load_window<HD, true>(qkv, dctx, ring_u32 + s * l.stage_bytes, l.op_bytes, g, cx, pi);
      win_next(pi, cx.nwh, cx.nww);
    }
    cp_async_commit();
  }
  load_bias<NT, L::kBStride>(bias_s, bias + (long long)cx.h * l.n * l.n, l.n);

  const bool active = warp * 16 < l.n;
  float db[NT][4];  // the run's bias-gradient sum, accumulator layout
#pragma unroll
  for (int j = 0; j < NT; ++j) db[j][0] = db[j][1] = db[j][2] = db[j][3] = 0.0f;
  const long long c3 = 3LL * g.C;
  // P / dS tiles (128-byte rows, chunk XOR row mod 8): where this lane's
  // stmatrix rows go, and where its transposed loads of key band `warp` start
  const int l7 = lane & 7, m = lane >> 3;
  const uint32_t pt_st = (uint32_t)((warp * 16 + l7 + (m & 1) * 8) * 128 + (((m >> 1) ^ l7) << 4));
  const uint32_t pt_ld =
      (uint32_t)((l7 + (m >> 1) * 8) * 128 + (((2 * warp + (m & 1)) ^ l7) << 4));

  int stage = 0, istage = kBwdStages - 1;
  for (; pc.gw < cx.w_end; win_next(pc, cx.nwh, cx.nww)) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();  // this window has landed; everyone is done with the one before
    if (pi.gw < cx.w_end) {
      mma_load_window<HD, true>(qkv, dctx, ring_u32 + istage * l.stage_bytes, l.op_bytes, g, cx,
                                pi);
      win_next(pi, cx.nwh, cx.nww);
    }
    cp_async_commit();
    const uint32_t sq = ring_u32 + stage * l.stage_bytes;
    const uint32_t sk = sq + l.op_bytes, sv = sk + l.op_bytes, sd = sv + l.op_bytes;
    stage = stage + 1 == kBwdStages ? 0 : stage + 1;
    istage = istage + 1 == kBwdStages ? 0 : istage + 1;
    bf16* base = dqkv + win_tok0(pc, g) * c3 + cx.h * HD;
    bf16* row_lo = base + cx.rt_lo * c3;
    bf16* row_hi = base + cx.rt_hi * c3;

    if (active) {  // rows [16 warp, +16): P, dS, the bias gradient, dq
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.0f;
      }
      {
        uint32_t a[HD / 16][4];
        load_band<HD>(a, sq + warp * 16 * RB, cx.t_off);
        band_times_keys_t<HD, NT>(s, a, sk, cx.k_off);
        load_band<HD>(a, sd + warp * 16 * RB, cx.t_off);
        band_times_keys_t<HD, NT>(dp, a, sv, cx.k_off);
      }
      band_softmax<HD, NT, L::kBStride>(s, bias_s, cx, window_mask_bits(g, pc, cx.nwh, cx.nww),
                                        g.scale_log2, lane);
      float rs_lo = 0.0f, rs_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        rs_lo += s[j][0] * dp[j][0] + s[j][1] * dp[j][1];
        rs_hi += s[j][2] * dp[j][2] + s[j][3] * dp[j][3];
      }
      rs_lo = quad_sum(rs_lo);
      rs_hi = quad_sum(rs_hi);
      if (warp * 16 + 16 > l.n) {  // rows past N: P forced to zero (its scores are leftovers)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!(e < 2 ? cx.v_lo : cx.v_hi)) s[j][e] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ds = s[j][e] * (dp[j][e] - (e < 2 ? rs_lo : rs_hi));
          dp[j][e] = ds;
          db[j][e] += ds;
        }
      uint32_t pa[4][4], dsa[4][4];
      pack_band<NT>(pa, s);
      pack_band<NT>(dsa, dp);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // the rounded bands, for the key bands to read
        stsm4(p_u32 + (pt_st ^ (uint32_t)(ks << 5)), pa[ks]);
        stsm4(ds_u32 + (pt_st ^ (uint32_t)(ks << 5)), dsa[ks]);
      }
      float dq[HD / 8][4];
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) dq[c][0] = dq[c][1] = dq[c][2] = dq[c][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) frag_times_rows<HD>(dq, dsa[ks], sk + ks * 16 * RB, cx.t_off);
      store_band<HD, true>(dq, g.scale, row_lo, row_hi, cx.v_lo, cx.v_hi, lane & 3);
    }
    __syncthreads();  // every band of P and dS is in its tile
    if (active) {  // keys [16 warp, +16): dk = dS^T.q, dv = P^T.dctx
      float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        dk[c][0] = dk[c][1] = dk[c][2] = dk[c][3] = 0.0f;
        dv[c][0] = dv[c][1] = dv[c][2] = dv[c][3] = 0.0f;
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        ldsm4_trans(a, ds_u32 + ks * 16 * 128 + pt_ld);
        frag_times_rows<HD>(dk, a, sq + ks * 16 * RB, cx.t_off);
        ldsm4_trans(a, p_u32 + ks * 16 * 128 + pt_ld);
        frag_times_rows<HD>(dv, a, sd + ks * 16 * RB, cx.t_off);
      }
      store_band<HD, true>(dk, g.scale, row_lo + g.C, row_hi + g.C, cx.v_lo, cx.v_hi, lane & 3);
      store_band<HD, false>(dv, 1.0f, row_lo + 2 * g.C, row_hi + 2 * g.C, cx.v_lo, cx.v_hi,
                            lane & 3);
    }
  }
  cp_async_wait<0>();
  if (active) {
    // rows padded to 8 NT floats: a row's four lanes write whole 32-byte sectors
    float* dst = part + (long long)blockIdx.x * l.n * (8 * NT) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (cx.v_lo) st_global8(dst + cx.r_lo * (8 * NT) + 8 * j, db[j][0], db[j][1]);
      if (cx.v_hi) st_global8(dst + cx.r_hi * (8 * NT) + 8 * j, db[j][2], db[j][3]);
    }
  }
}

static MmaGeom mma_geom(int B, int Hp, int Wp, int C, int heads, int wh, int ww, int sh, int sw,
                        int chunks) {
  const double scale = pow((double)(C / heads), -0.5);
  return MmaGeom{B,  Hp, Wp, C,  heads,  wh,           ww,
                 sh, sw, chunks, (float)scale, (float)(scale * 1.4426950408889634)};
}

template <int HD, int NT>
static cudaError_t launch_fwd_mma(const void* qkv, const void* bias, void* out, const MmaGeom& g,
                                  cudaStream_t st) {
  const int smem = MmaLayout<HD, NT, 3>(g.wh * g.ww).total(kFwdStages);
  auto kern = window_attention_fwd_mma_kernel<HD, NT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<g.chunks * g.heads, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias), static_cast<bf16*>(out), g);
  return cudaGetLastError();
}

template <int HD, int NT>
static cudaError_t launch_bwd_mma(const void* qkv, const void* dctx, const void* bias, void* dqkv,
                                  void* part, void* dbias, const MmaGeom& g, cudaStream_t st) {
  const int n = g.wh * g.ww;
  const int smem = MmaLayout<HD, NT, 4>(n).total(kBwdStages);
  auto kern = window_attention_bwd_mma_kernel<HD, NT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<g.chunks * g.heads, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dctx),
      static_cast<const float*>(bias), static_cast<bf16*>(dqkv), static_cast<float*>(part), g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dbias_sum_kernel<<<(g.heads * n * n + 31) / 32, dim3(32, 8), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), g.chunks, g.heads * n, n,
      8 * NT);
  return cudaGetLastError();
}

// Head width and key tiles are template parameters: 7 tiles up to 56 tokens
// (49 on the main path), 8 up to 64.
template <int NT>
static cudaError_t fwd_mma_by_width(const void* qkv, const void* bias, void* out,
                                    const MmaGeom& g, cudaStream_t st) {
  switch (g.C / g.heads) {
    case 16: return launch_fwd_mma<16, NT>(qkv, bias, out, g, st);
    case 32: return launch_fwd_mma<32, NT>(qkv, bias, out, g, st);
    case 64: return launch_fwd_mma<64, NT>(qkv, bias, out, g, st);
    default: return cudaErrorInvalidValue;
  }
}
template <int NT>
static cudaError_t bwd_mma_by_width(const void* qkv, const void* dctx, const void* bias,
                                    void* dqkv, void* part, void* dbias, const MmaGeom& g,
                                    cudaStream_t st) {
  switch (g.C / g.heads) {
    case 16: return launch_bwd_mma<16, NT>(qkv, dctx, bias, dqkv, part, dbias, g, st);
    case 32: return launch_bwd_mma<32, NT>(qkv, dctx, bias, dqkv, part, dbias, g, st);
    case 64: return launch_bwd_mma<64, NT>(qkv, dctx, bias, dqkv, part, dbias, g, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ssa

// Which kernel a call takes is decided by the wrapper from the static shape
// (`route`: 0 the CUDA-core kernels, 1 the wmma kernels, 2 the mma.sync
// kernels, 3 the tiled kernels on the CUDA cores, 4 the tiled mma.sync
// kernels) and only checked here.  `plan` is the number of blocks per head
// for route 2 (forward and backward) and for route 4 at up to 144 tokens,
// the windows per block for the backward of routes 0, 1 and 3 and of route 4
// beyond (ops/fused_window_attention.py::bwd_plan).
static bool route_ok(int route, int dtype, int C, int heads, int wh, int ww, int sh, int sw,
                     int plan) {
  const int hd = C / heads, n = wh * ww;
  if (plan < 1 || hd < 1) return false;
  // windows of more than 64 tokens take the tiled kernels, and only those
  if (route == ssa::kRouteTiled) return n > ssa::kRowsPad && hd <= ssa::kTiledMaxHd;
  if (route == ssa::kRouteTiledMma)
    return n > ssa::kRowsPad && dtype == ssa::kBF16 && hd % 16 == 0 && hd <= ssa::kTiledMaxHd;
  if (n > ssa::kRowsPad) return false;
  if (route == ssa::kRouteCore) return true;
  if (dtype != ssa::kBF16 || hd % 16) return false;
  if (route == ssa::kRouteWmma) return true;
  return route == ssa::kRouteMma && (hd == 16 || hd == 32 || hd == 64) && sh < wh && sw < ww;
}

extern "C" int ssa_window_attention_fwd(const void* qkv, const void* bias, void* out, int B,
                                        int Hp, int Wp, int C, int heads, int wh, int ww,
                                        int sh, int sw, int route, int plan, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!route_ok(route, dtype, C, heads, wh, ww, sh, sw, plan)) return (int)cudaErrorInvalidValue;
  if (route == ssa::kRouteTiled)
    return (int)ssa::tiled_fwd(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw, dtype, st);
  if (route == ssa::kRouteTiledMma)
    return (int)ssa::tiled_mma_fwd(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw, plan, st);
  if (route == ssa::kRouteMma) {
    const ssa::MmaGeom g = ssa::mma_geom(B, Hp, Wp, C, heads, wh, ww, sh, sw, plan);
    return (int)(wh * ww <= 56 ? ssa::fwd_mma_by_width<7>(qkv, bias, out, g, st)
                               : ssa::fwd_mma_by_width<8>(qkv, bias, out, g, st));
  }
  if (route == ssa::kRouteWmma)
    return (int)ssa::launch_wmma(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw, st);
  if (dtype == ssa::kBF16)
    return (int)ssa::launch<__nv_bfloat16>(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw,
                                           st);
  return (int)ssa::launch<float>(qkv, bias, out, B, Hp, Wp, C, heads, wh, ww, sh, sw, st);
}

// The floats of the backward's scratch `part` that a launch of `route` with
// `plan` lays out (-1: no such launch): the per-block bias-gradient partials
// (plan, heads, N, 56 or 64) for route 2 (rows padded to the key tiles: 56
// floats up to 56 tokens, else 64), (ceil(B*nW/plan), heads, N, N) for
// routes 0 and 1, (ceil(B*nW/plan), heads, N, N + hd + 3) for route 3 (each
// row followed by the block's dq accumulator and row statistics), and for
// route 4 what fused_window_attention_tiled.cu's `tiled_mma_bwd` lays out.
// The wrapper holds the scratch it allocates against this before a launch.
extern "C" long long ssa_window_attention_bwd_scratch(int B, int Hp, int Wp, int C, int heads,
                                                      int wh, int ww, int route, int plan) {
  const long long n = wh * ww, hd = C / heads, total = (long long)B * (Hp / wh) * (Wp / ww);
  if (plan < 1 || heads < 1 || n < 1) return -1;
  const long long blocks = (total + plan - 1) / plan;
  switch (route) {
    case ssa::kRouteCore:
    case ssa::kRouteWmma:
      return blocks * heads * n * n;
    case ssa::kRouteMma:
      return (long long)plan * heads * n * (n <= 56 ? 56 : 64);
    case ssa::kRouteTiled:
      return blocks * heads * n * (n + hd + 3);
    case ssa::kRouteTiledMma:
      return ssa::tiled_mma_bwd_scratch(B, Hp, Wp, C, heads, wh, ww, plan);
    default:
      return -1;
  }
}

// qkv/dqkv (B,Hp,Wp,3C), dctx (B,Hp,Wp,C) in the storage type; bias and
// dbias (heads,N,N) float32; part float32 scratch of at least
// ssa_window_attention_bwd_scratch floats.
extern "C" int ssa_window_attention_bwd(const void* qkv, const void* dctx, const void* bias,
                                        void* dqkv, void* part, void* dbias, int B, int Hp,
                                        int Wp, int C, int heads, int wh, int ww, int sh, int sw,
                                        int route, int plan, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!route_ok(route, dtype, C, heads, wh, ww, sh, sw, plan)) return (int)cudaErrorInvalidValue;
  if (route == ssa::kRouteTiled)
    return (int)ssa::tiled_bwd(qkv, dctx, bias, dqkv, part, dbias, B, Hp, Wp, C, heads, wh, ww,
                               sh, sw, plan, dtype, st);
  if (route == ssa::kRouteTiledMma)
    return (int)ssa::tiled_mma_bwd(qkv, dctx, bias, dqkv, part, dbias, B, Hp, Wp, C, heads, wh,
                                   ww, sh, sw, plan, st);
  if (route == ssa::kRouteMma) {
    const ssa::MmaGeom g = ssa::mma_geom(B, Hp, Wp, C, heads, wh, ww, sh, sw, plan);
    return (int)(wh * ww <= 56
                     ? ssa::bwd_mma_by_width<7>(qkv, dctx, bias, dqkv, part, dbias, g, st)
                     : ssa::bwd_mma_by_width<8>(qkv, dctx, bias, dqkv, part, dbias, g, st));
  }
  return (int)ssa::launch_bwd(qkv, dctx, bias, dqkv, part, dbias, B, Hp, Wp, C, heads, wh, ww,
                              sh, sw, route, plan, dtype, st);
}
