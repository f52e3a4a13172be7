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
// group of windows of one head, sums its dS in shared memory (each (i, j)
// owned by one thread: no atomics) and writes one float32 partial; a
// second launch (sum_rows) adds the partials in a fixed order, so dbias
// is the same from run to run.  Grouping keeps the partials small (a
// per-window partial would be ~110 MB at stage 0).  Padded rows and
// columns (49 -> 64 tokens on the tensor-core path) are zero in P and dS,
// so they add nothing to rowsum, dbias, dq, dk or dv.  bfloat16 runs the
// five products as nvcuda::wmma tiles; float32 (and head widths that are
// not a multiple of 16) on the CUDA cores.
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
                             int wh, int ww, int sh, int sw, int group, int dtype,
                             cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const int n = wh * ww, hd = C / heads;
  const int nblk = (B * (Hp / wh) * (Wp / ww) + group - 1) / group;
  const float scale = (float)pow((double)hd, -0.5);
  const dim3 grid(nblk, heads);
  cudaError_t e;
  if (dtype == kBF16 && hd % 16 == 0 && n <= kRowsPad) {
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

// qkv/dqkv (B,Hp,Wp,3C), dctx (B,Hp,Wp,C) in the storage type; bias and
// dbias (heads,N,N) float32; part (ceil(B*nW/group), heads, N, N) float32
// scratch for the per-block bias-gradient partials.
extern "C" int ssa_window_attention_bwd(const void* qkv, const void* dctx, const void* bias,
                                        void* dqkv, void* part, void* dbias, int B, int Hp,
                                        int Wp, int C, int heads, int wh, int ww, int sh, int sw,
                                        int group, int dtype, void* stream) {
  return (int)ssa::launch_bwd(qkv, dctx, bias, dqkv, part, dbias, B, Hp, Wp, C, heads, wh, ww,
                              sh, sw, group, dtype, static_cast<cudaStream_t>(stream));
}
