// PatchMerging and PatchExpand backwards, from the saved input x alone.
//
// Replaces: the Pallas kernels `_merge_bwd_kernel` (launcher
// `_merge_bwd_pallas`) and `_expand_bwd_kernel` (launcher
// `_expand_bwd_pallas`) in
// semantic_segmentation_of_stylegan2_artifacts_tpu/ops/fused_patch.py.
//
// Merge (rows m = (b, i, j) of the merged map, K = 4C, N = 2C): the LN of
// the merged row is recomputed from x (float32 fast-variance stats clamped
// at 0), n = LN(m) rounded to the storage type;
//   dW = n^T dy (float32), dn = dy W^T rounded to the storage type,
//   dscale = sum dn*xhat, dbias = sum dn,
//   dm = LN backward of dn in float32, rounded, scattered back to x's
//   layout through the [x0|x1|x2|x3] map.
// Expand (rows m = (b, h, w), K = C, N = 2C): z = x W recomputed in float32
// and rounded; per group g = 2*p1+p2 of C/2 channels the LN stats of z and
// the cotangent dy at (b, 2h+p1, 2w+p2, :);
//   dscale, dbias summed over rows and groups, dz = the groups' LN
//   backwards rounded, dW = x^T dz (float32), dx = dz W^T rounded.
//
// Bound on the H100: two products of 2*M*K*N (merge) or three of
// 2*M*C*2C (expand), against reading x and dy and writing dx once; at the
// main-path shapes the operations bound it on the tensor cores' rate.
// Two routes, chosen by the wrapper from (dtype, C) before the launch:
//  * bfloat16 at merge C a multiple of 32 up to 512 and expand C/2 in 96,
//    128, 192, 256, 384, 512 (every width of Swin-B and Swin-T): the
//    tensor-core kernels at the end of this file, on the product core of
//    fused_patch.cuh, four CUDA launches a call.  Merge: dn = dy W^T rounded
//    into device memory (the LN backward needs row means over all 4C
//    columns, more than a product tile holds); a row pass that stages x's
//    four runs of C and dn by 16-byte cp.async, takes each row's stats
//    once, and writes n = round(LN) (the weight gradient's A operand), dx
//    and the dscale/dbias column partials; dW = n^T dy split-K; the sums.
//    Expand: one kernel for z, the group stats, the LN backward and the
//    dscale/dbias partials (a block owns whole groups); dW = x^T dz
//    split-K; dx = dz W^T; the sums.
//  * float32 (the parity type) and the other widths: the first kernels,
//    on the CUDA cores in float32 (seven launches merge, six expand).
// The weight gradient sums over every row: each block of the split-K
// product writes a float32 partial for its chunk of rows, and a second pass
// adds the partials in a fixed order (as the refine head's dW and the
// attention's dbias), so repeated runs give equal bits; dscale/dbias
// likewise.
#include "fused_patch.cuh"

namespace ssa {

// out (M, N) = round(A (M, Kd) @ B (Kd, N)), all row-major, float32 sums.
template <typename T, int NPT>
__global__ void __launch_bounds__(256)
gemm_round_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                  int M, int Kd, int N) {
  constexpr int BN = 32 * NPT;
  __shared__ float As[kChunk][kRows + 1];
  __shared__ float Bs[kChunk][BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * BN;
  float acc[4][NPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NPT; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < Kd; k0 += kChunk) {
    for (int e = threadIdx.x; e < kRows * kChunk; e += blockDim.x) {
      const int row = e / kChunk, kk = e - row * kChunk, m = m0 + row;
      As[kk][row] = (m < M) ? to_f(a[(long long)m * Kd + k0 + kk]) : 0.0f;
    }
    for (int e = threadIdx.x; e < kChunk * BN; e += blockDim.x) {
      const int kk = e / BN, nn = e - kk * BN;
      Bs[kk][nn] = to_f(b[(long long)(k0 + kk) * N + n0 + nn]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float av[4], bv[NPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[kk][warp * 4 + r];
#pragma unroll
      for (int c = 0; c < NPT; ++c) bv[c] = Bs[kk][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NPT; ++c) acc[r][c] += av[r] * bv[c];
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

// part[chunk] (K, N) = sum over the chunk's rows m of A[m, k] * Bm[m, n].
// MERGE: A[m, k] = round(xhat * sc[k] + lb[k]) of merged row m, from x and
// the row stats; otherwise A = a (M, K) row-major.  Block: 32 k x 32*NPT n.
template <typename T, int NPT, bool MERGE>
__global__ void __launch_bounds__(256)
dw_partial_kernel(const T* __restrict__ a, const float* __restrict__ stats,
                  const float* __restrict__ sc, const float* __restrict__ lb,
                  const T* __restrict__ bm, float* __restrict__ part, int H, int W, int C,
                  int M, int K, int N, int rows_per_chunk) {
  constexpr int BN = 32 * NPT;
  __shared__ float As[kChunk][kRows + 1];
  __shared__ float Bs[kChunk][BN];
  __shared__ long long base_s[kChunk];
  __shared__ float mean_s[kChunk], rstd_s[kChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kRows, n0 = blockIdx.y * BN;
  const int r0 = blockIdx.z * rows_per_chunk, r1 = min(M, r0 + rows_per_chunk);
  const long long wc = (long long)W * C;
  float acc[4][NPT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NPT; ++c) acc[r][c] = 0.0f;

  for (int mb = r0; mb < r1; mb += kChunk) {
    if constexpr (MERGE) {
      if (threadIdx.x < kChunk) {
        const int m = mb + threadIdx.x;
        base_s[threadIdx.x] = m < r1 ? merge_base(m, H, W, C, M) : -1;
        mean_s[threadIdx.x] = m < r1 ? stats[2 * m] : 0.0f;
        rstd_s[threadIdx.x] = m < r1 ? stats[2 * m + 1] : 0.0f;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < kChunk * kRows; e += blockDim.x) {
      const int mm = e / kRows, kk = e - mm * kRows, m = mb + mm, k = k0 + kk;
      float v = 0.0f;
      if constexpr (MERGE) {
        const long long base = base_s[mm];
        if (base >= 0) {
          const float xhat = (to_f(a[base + merge_offset(k, C, wc)]) - mean_s[mm]) * rstd_s[mm];
          v = round_to<T>(xhat * sc[k] + lb[k]);
        }
      } else if (m < r1) {
        v = to_f(a[(long long)m * K + k]);
      }
      As[mm][kk] = v;
    }
    for (int e = threadIdx.x; e < kChunk * BN; e += blockDim.x) {
      const int mm = e / BN, nn = e - mm * BN, m = mb + mm;
      Bs[mm][nn] = m < r1 ? to_f(bm[(long long)m * N + n0 + nn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kChunk; ++mm) {
      float av[4], bv[NPT];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[mm][warp * 4 + r];
#pragma unroll
      for (int c = 0; c < NPT; ++c) bv[c] = Bs[mm][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NPT; ++c) acc[r][c] += av[r] * bv[c];
    }
    __syncthreads();
  }
  float* p = part + (long long)blockIdx.z * K * N;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NPT; ++c)
      p[(long long)(k0 + warp * 4 + r) * N + n0 + lane + 32 * c] = acc[r][c];
}

// Merge LN backward, one warp per merged row: stats from x (stored for the
// later passes), dm = (dn*sc - mean(dn*sc) - xhat*mean(dn*sc*xhat)) * rstd,
// rounded and scattered to dx.
template <typename T>
__global__ void __launch_bounds__(256)
merge_rows_kernel(const T* __restrict__ x, const T* __restrict__ dn,
                  const float* __restrict__ sc, T* __restrict__ dx,
                  float* __restrict__ stats, int H, int W, int C, int M) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * 8 + warp;
  if (m >= M) return;
  const int K = 4 * C;
  const long long wc = (long long)W * C, base = merge_base(m, H, W, C, M);
  const T* dnr = dn + (long long)m * K;
  float s = 0.0f, s2 = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float v = to_f(x[base + merge_offset(k, C, wc)]);
    s += v;
    s2 += v * v;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mean = s / K;
  const float rstd = 1.0f / sqrtf(fmaxf(s2 / K - mean * mean, 0.0f) + kLnEps);
  if (lane == 0) {
    stats[2 * m] = mean;
    stats[2 * m + 1] = rstd;
  }
  float m1 = 0.0f, m2 = 0.0f;
  for (int k = lane; k < K; k += 32) {
    const float xhat = (to_f(x[base + merge_offset(k, C, wc)]) - mean) * rstd;
    const float dxh = to_f(dnr[k]) * sc[k];
    m1 += dxh;
    m2 += dxh * xhat;
  }
  m1 = warp_sum(m1) / K;
  m2 = warp_sum(m2) / K;
  for (int k = lane; k < K; k += 32) {
    const long long off = base + merge_offset(k, C, wc);
    const float xhat = (to_f(x[off]) - mean) * rstd;
    const float dxh = to_f(dnr[k]) * sc[k];
    dx[off] = from_f<T>((dxh - m1 - xhat * m2) * rstd);
  }
}

// Merge dscale/dbias partials: part[chunk][0][k] = sum dn*xhat,
// part[chunk][1][k] = sum dn over the chunk's rows.  Block (32, 8): 32
// columns, 8 row lanes summed in order.
template <typename T>
__global__ void __launch_bounds__(256)
merge_colsum_kernel(const T* __restrict__ x, const T* __restrict__ dn,
                    const float* __restrict__ stats, float* __restrict__ part, int H, int W,
                    int C, int M, int rows_per_chunk) {
  __shared__ float red[2][8][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int K = 4 * C, k = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * rows_per_chunk, r1 = min(M, r0 + rows_per_chunk);
  const long long wc = (long long)W * C;
  float s1 = 0.0f, s2 = 0.0f;
  if (k < K) {
    const long long off = merge_offset(k, C, wc);
    for (int m = r0 + ty; m < r1; m += 8) {
      const float xhat = (to_f(x[merge_base(m, H, W, C, M) + off]) - stats[2 * m]) * stats[2 * m + 1];
      const float d = to_f(dn[(long long)m * K + k]);
      s1 += d * xhat;
      s2 += d;
    }
  }
  red[0][ty][tx] = s1;
  red[1][ty][tx] = s2;
  __syncthreads();
  if (ty < 2 && k < K) {
    float s = 0.0f;
    for (int i = 0; i < 8; ++i) s += red[ty][i][tx];
    part[((long long)blockIdx.y * 2 + ty) * K + k] = s;
  }
}

// Expand dz: the forward's product for the block's 32 rows and group g,
// rounded; the group's LN stats; dn read from dy's depth-to-space layout;
// dz = LN backward, rounded; per-block dscale/dbias partials summed over the
// 8 warps in order into part[(blockIdx.x * 4 + g)][0 / 1][:].
template <typename T, int NPT>
__global__ void __launch_bounds__(256)
expand_dz_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
                 const float* __restrict__ sc, T* __restrict__ dz, float* __restrict__ part,
                 int H, int W, int C, int M) {
  constexpr int NG = 32 * NPT;
  __shared__ float As[kChunk][kRows + 1];
  __shared__ float Bs[kChunk][NG];  // after the product: 2 x 8 warps x NG partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kRows, g = blockIdx.y, n0 = g * NG;
  const int p1 = g >> 1, p2 = g & 1;
  float acc[4][NPT];
  expand_product<T, NPT>(x, w, As, Bs, acc, m0, n0, C, M);

  float psc[NPT], plb[NPT];
#pragma unroll
  for (int c = 0; c < NPT; ++c) psc[c] = plb[c] = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + warp * 4 + r;
    if (m >= M) continue;  // warp-uniform
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
    const float rstd = 1.0f / sqrtf(fmaxf(s2 / NG - mean * mean, 0.0f) + kLnEps);
    const int b = m / (H * W), rem = m - b * H * W;
    const int hh = rem / W, wv = rem - hh * W;
    const long long dbase =
        ((long long)(b * 2 * H + 2 * hh + p1) * (2 * W) + 2 * wv + p2) * NG;
    float xhat[NPT], dxh[NPT], m1 = 0.0f, m2 = 0.0f;
#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int col = lane + 32 * c;
      const float d = to_f(dy[dbase + col]);
      xhat[c] = (acc[r][c] - mean) * rstd;
      psc[c] += d * xhat[c];
      plb[c] += d;
      dxh[c] = d * sc[col];
      m1 += dxh[c];
      m2 += dxh[c] * xhat[c];
    }
    m1 = warp_sum(m1) / NG;
    m2 = warp_sum(m2) / NG;
    T* dzr = dz + (long long)m * 2 * C + n0;
#pragma unroll
    for (int c = 0; c < NPT; ++c)
      dzr[lane + 32 * c] = from_f<T>((dxh[c] - m1 - xhat[c] * m2) * rstd);
  }

  float* red = &Bs[0][0];  // expand_product ended synchronised
#pragma unroll
  for (int c = 0; c < NPT; ++c) {
    red[warp * NG + lane + 32 * c] = psc[c];
    red[(8 + warp) * NG + lane + 32 * c] = plb[c];
  }
  __syncthreads();
  float* p = part + ((long long)blockIdx.x * 4 + g) * 2 * NG;
  for (int i = threadIdx.x; i < 2 * NG; i += blockDim.x) {
    const int which = i / NG, col = i - which * NG;
    float s = 0.0f;
    for (int v = 0; v < 8; ++v) s += red[(which * 8 + v) * NG + col];
    p[i] = s;
  }
}

// out[i] = sum_r part[r * L + i], one thread per output in row order (for
// few rows and many outputs: the weight-gradient chunks).
static __global__ void __launch_bounds__(256)
sum_chunks_kernel(const float* __restrict__ part, float* __restrict__ out, int rows,
                  long long L) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < L;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += part[(long long)r * L + i];
    out[i] = s;
  }
}

static cudaError_t sum_chunks(const float* part, float* out, int rows, long long L,
                              cudaStream_t st) {
  const long long blocks = (L + 255) / 256;
  sum_chunks_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(part, out, rows, L);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t gemm_round(const T* a, const T* b, T* out, int M, int Kd, int N,
                              cudaStream_t st) {
  if (Kd % kChunk) return cudaErrorInvalidValue;
  const int gm = (M + kRows - 1) / kRows;
  if (N % 128 == 0)
    gemm_round_kernel<T, 4><<<dim3(gm, N / 128), 256, 0, st>>>(a, b, out, M, Kd, N);
  else if (N % 64 == 0)
    gemm_round_kernel<T, 2><<<dim3(gm, N / 64), 256, 0, st>>>(a, b, out, M, Kd, N);
  else if (N % 32 == 0)
    gemm_round_kernel<T, 1><<<dim3(gm, N / 32), 256, 0, st>>>(a, b, out, M, Kd, N);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// dw (K, N) = sum over chunks of rows_per_chunk rows of A^T Bm, via
// float32 partials (chunks, K, N) and a fixed-order sum.
template <typename T, bool MERGE>
static cudaError_t weight_grad(const T* a, const float* stats, const float* sc, const float* lb,
                               const T* bm, float* part, float* dw, int H, int W, int C, int M,
                               int K, int N, int rows_per_chunk, cudaStream_t st) {
  if (K % kRows || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  const int chunks = (M + rows_per_chunk - 1) / rows_per_chunk;
  const int gk = K / kRows;
  if (N % 128 == 0)
    dw_partial_kernel<T, 4, MERGE><<<dim3(gk, N / 128, chunks), 256, 0, st>>>(
        a, stats, sc, lb, bm, part, H, W, C, M, K, N, rows_per_chunk);
  else if (N % 32 == 0)
    dw_partial_kernel<T, 1, MERGE><<<dim3(gk, N / 32, chunks), 256, 0, st>>>(
        a, stats, sc, lb, bm, part, H, W, C, M, K, N, rows_per_chunk);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_chunks(part, dw, chunks, (long long)K * N, st);
}

template <typename T>
static cudaError_t merge_bwd(const void* x, const void* dy, const void* sc, const void* lb,
                             const void* wt, void* dn, void* stats, void* part_dw,
                             void* part_cs, void* dx, void* dw, void* dsc, void* dlb, int B,
                             int H, int W, int C, int rows_per_chunk, cudaStream_t st) {
  const int M = B * (H / 2) * (W / 2), K = 4 * C, N = 2 * C;
  const auto* xt = static_cast<const T*>(x);
  const auto* dyt = static_cast<const T*>(dy);
  const auto* s = static_cast<const float*>(sc);
  const auto* l = static_cast<const float*>(lb);
  auto* dnt = static_cast<T*>(dn);
  auto* stt = static_cast<float*>(stats);
  auto* pcs = static_cast<float*>(part_cs);
  if (C % 16 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  cudaError_t err = gemm_round<T>(dyt, static_cast<const T*>(wt), dnt, M, N, K, st);
  if (err != cudaSuccess) return err;
  merge_rows_kernel<T><<<(M + 7) / 8, 256, 0, st>>>(xt, dnt, s, static_cast<T*>(dx), stt, H, W,
                                                    C, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = weight_grad<T, true>(xt, stt, s, l, dyt, static_cast<float*>(part_dw),
                             static_cast<float*>(dw), H, W, C, M, K, N, rows_per_chunk, st);
  if (err != cudaSuccess) return err;
  const int chunks = (M + rows_per_chunk - 1) / rows_per_chunk;
  merge_colsum_kernel<T><<<dim3((K + 31) / 32, chunks), dim3(32, 8), 0, st>>>(
      xt, dnt, stt, pcs, H, W, C, M, rows_per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_rows(pcs, static_cast<float*>(dsc), chunks, K, 2LL * K, st)) != cudaSuccess)
    return err;
  return sum_rows(pcs + K, static_cast<float*>(dlb), chunks, K, 2LL * K, st);
}

template <typename T>
static cudaError_t expand_bwd(const void* x, const void* dy, const void* w, const void* wt,
                              const void* sc, void* dz, void* part_ln, void* part_dw, void* dx,
                              void* dw, void* dsc, void* dlb, int B, int H, int W, int C,
                              int rows_per_chunk, cudaStream_t st) {
  const int M = B * H * W, NG = C / 2;
  const auto* xt = static_cast<const T*>(x);
  auto* dzt = static_cast<T*>(dz);
  auto* pln = static_cast<float*>(part_ln);
  if (C % 64 || C / 64 < 1 || C / 64 > 16) return cudaErrorInvalidValue;
  const int gm = (M + kRows - 1) / kRows;
  const dim3 grid(gm, 4);
  const auto* wk = static_cast<const T*>(w);
  const auto* dyt = static_cast<const T*>(dy);
  const auto* s = static_cast<const float*>(sc);
  switch (C / 64) {  // C/2 = 32 * NPT
#define SSA_CASE(n) \
  case n: expand_dz_kernel<T, n><<<grid, 256, 0, st>>>(xt, wk, dyt, s, dzt, pln, H, W, C, M); break;
    SSA_EXPAND_NPT(SSA_CASE)
#undef SSA_CASE
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // partial rows (block, group) hold [dscale | dbias], each NG wide
  if ((err = sum_rows(pln, static_cast<float*>(dsc), 4 * gm, NG, 2LL * NG, st)) != cudaSuccess)
    return err;
  if ((err = sum_rows(pln + NG, static_cast<float*>(dlb), 4 * gm, NG, 2LL * NG, st)) !=
      cudaSuccess)
    return err;
  err = weight_grad<T, false>(xt, nullptr, nullptr, nullptr, dzt, static_cast<float*>(part_dw),
                              static_cast<float*>(dw), H, W, C, M, C, 2 * C, rows_per_chunk, st);
  if (err != cudaSuccess) return err;
  return gemm_round<T>(dzt, static_cast<const T*>(wt), static_cast<T*>(dx), M, 2 * C, C, st);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores (the product core of fused_patch.cuh).
// ---------------------------------------------------------------------------

// out (M, N) = round(a (M, K) . b (K, N)), row-major, K a multiple of 64,
// N of 8.  The rounded tile goes through shared memory so that every store
// to `out` is 16 bytes.
static __global__ void __launch_bounds__(mma::kThreads, 2)
mma_ab_round_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * mma::kBM, n0 = blockIdx.y * mma::kBN;
  float acc[4][4][4];
  mma_mainloop<false, 4, 4, 8, 16, mma::kStages, mma::kABytes, mma::kStageBytes>(
      sm, K / mma::kBK, wm * 64, wn * 32,
      [&](int s, int t) {
        const uint32_t as = sm + s * mma::kStageBytes, bs = as + mma::kABytes;
        const int k = t * mma::kBK;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = tid + i * mma::kThreads;
          const int row = e >> 3, ch = e & 7, m = m0 + row;
          const bool ok = m < M;
          cp_async16(as + swz(row, ch, 8), a + (ok ? (long long)m * K + k + ch * 8 : 0), ok);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = tid + i * mma::kThreads;
          const int row = e >> 4, ch = e & 15, n = n0 + ch * 8;
          const bool ok = n < N;
          cp_async16(bs + swz(row, ch, 16), b + (ok ? (long long)(k + row) * N + n : 0), ok);
        }
      },
      acc);
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm * 64 + i * 16 + gr, col = wn * 32 + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(smem + swz(row, col >> 3, 16) + (col & 7) * 2) =
          pack2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(smem + swz(row + 8, col >> 3, 16) + (col & 7) * 2) =
          pack2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  for (int e = tid; e < mma::kBM * 16; e += mma::kThreads) {
    const int row = e >> 4, ch = e & 15, m = m0 + row, n = n0 + ch * 8;
    if (m < M && n < N) {
      const uint4 v = *reinterpret_cast<const uint4*>(smem + swz(row, ch, 16));
      st_global16(out + (long long)m * N + n, v.x, v.y, v.z, v.w);
    }
  }
}

// part[z] (Mo, N) = sum over the rows r of chunk z of a[r, :]^T b[r, :]
// in float32; a (R, Mo) and b (R, N) row-major, Mo and N multiples of 8.
static __global__ void __launch_bounds__(mma::kThreads, 2)
mma_atb_partial_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                       float* __restrict__ part, int R, int Mo, int N, int rows_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * mma::kBM, n0 = blockIdx.y * mma::kBN;
  const int r0 = blockIdx.z * rows_per_chunk, r1 = min(R, r0 + rows_per_chunk);
  float acc[4][4][4];
  mma_mainloop<true, 4, 4, 16, 16, mma::kStages, mma::kABytes, mma::kStageBytes>(
      sm, (r1 - r0 + mma::kBK - 1) / mma::kBK, wm * 64, wn * 32,
      [&](int s, int t) {
        const uint32_t as = sm + s * mma::kStageBytes, bs = as + mma::kABytes;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = tid + i * mma::kThreads;
          const int row = e >> 4, ch = e & 15, r = r0 + t * mma::kBK + row;
          const int col = m0 + ch * 8, n = n0 + ch * 8;
          const bool oka = r < r1 && col < Mo, okb = r < r1 && n < N;
          cp_async16(as + swz(row, ch, 16), a + (oka ? (long long)r * Mo + col : 0), oka);
          cp_async16(bs + swz(row, ch, 16), b + (okb ? (long long)r * N + n : 0), okb);
        }
      },
      acc);
  float* p = part + (long long)blockIdx.z * Mo * N;
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm * 64 + i * 16 + gr, col = n0 + wn * 32 + j * 8 + 2 * t4;
      if (col >= N) continue;
      if (row < Mo) st_global8(p + (long long)row * N + col, acc[i][j][0], acc[i][j][1]);
      if (row + 8 < Mo) st_global8(p + (long long)(row + 8) * N + col, acc[i][j][2], acc[i][j][3]);
    }
}

// Expand dz on the tensor cores.  A block owns BM rows and one whole group
// g (NG = C/2 = 32 * NT columns of z), so the LN backward of a group needs
// no other block; block = row block * 4 + g.  The block's dy slice
// (16-byte cp.async from dy's depth-to-space layout, contiguous NG values a
// row) is requested first, into its own buffer, and arrives while the
// product runs (warps 2 x 4, warp tile BM/2 rows x 8*NT columns).  The
// rounded z tile then goes to shared memory and a row pass does the rest
// on 16-byte chunks: 16 or 32 lanes a row (NG/8 chunks, one or two a
// lane), the row sums by shuffles within those lanes, dz stored straight
// from registers, and each lane's column sums of dy*xhat and dy added over
// its rows, then over the warps in order: the block's dscale/dbias partial.
template <int NT>
struct DzTile {
  static constexpr int NG = 32 * NT;
  static constexpr int BM = NT <= 4 ? 128 : NT <= 8 ? 64 : 32;
  static constexpr int MI = BM / 32;
  static constexpr int CPR = NG / 8;               // 16-byte chunks a row
  static constexpr int BCH = (CPR + 7) & ~7;       // B / dy / z row chunks, padded to 8
  static constexpr int LPR = CPR <= 16 ? 16 : 32;  // lanes a row in the row pass
  static constexpr int CPL = (CPR + LPR - 1) / LPR;
  static constexpr int STAGES = 2;
  static constexpr int A_BYTES = BM * 64 * 2;
  static constexpr int STAGE = A_BYTES + 64 * BCH * 16;
  static constexpr int DY = BM * BCH * 16;
  static constexpr int SMEM = DY + STAGES * STAGE;  // the ring then holds z and the column sums
  static_assert(DY + 8 * 2 * NG * 4 <= STAGES * STAGE, "z tile and column sums fit the ring");
};

template <int NT>
__global__ void __launch_bounds__(mma::kThreads, NT >= 12 ? 1 : 2)
expand_dz_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ dy, const float* __restrict__ sc,
                     bf16* __restrict__ dz, float* __restrict__ part, int H, int W, int C,
                     int M) {
  using TL = DzTile<NT>;
  constexpr int NG = TL::NG, BM = TL::BM, MI = TL::MI, BCH = TL::BCH, CPR = TL::CPR;
  constexpr int LPR = TL::LPR, CPL = TL::CPL, RPI = 32 / LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sm = smem_u32(smem), ring = sm + TL::DY;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
  const int g = blockIdx.x & 3, m0 = (blockIdx.x >> 2) * BM, n0 = g * NG, N = 2 * C;

  // the dy tile, first
  const int p1 = g >> 1, p2 = g & 1;
  for (int e = tid; e < BM * CPR; e += mma::kThreads) {
    const int row = e / CPR, ch = e - row * CPR, m = m0 + row;
    const bool ok = m < M;
    long long src = 0;
    if (ok) {
      const int b = m / (H * W), rem = m - b * H * W, hh = rem / W, wv = rem - hh * W;
      src = ((long long)(b * 2 * H + 2 * hh + p1) * (2 * W) + 2 * wv + p2) * NG + ch * 8;
    }
    cp_async16(sm + swz(row, ch, BCH), dy + src, ok);
  }
  cp_async_commit();

  float acc[MI][NT][4];
  mma_mainloop<false, MI, NT, 8, BCH, TL::STAGES, TL::A_BYTES, TL::STAGE>(
      ring, C / 64, wm * (BM / 2), wn * 8 * NT,
      [&](int s, int t) {
        const uint32_t as = ring + s * TL::STAGE, bs = as + TL::A_BYTES;
        const int k = t * 64;
        for (int e = tid; e < BM * 8; e += mma::kThreads) {
          const int row = e >> 3, ch = e & 7, m = m0 + row;
          const bool ok = m < M;
          cp_async16(as + swz(row, ch, 8), x + (ok ? (long long)m * C + k + ch * 8 : 0), ok);
        }
        for (int e = tid; e < 64 * CPR; e += mma::kThreads) {
          const int row = e / CPR, ch = e - row * CPR;
          cp_async16(bs + swz(row, ch, BCH), w + (long long)(k + row) * N + n0 + ch * 8);
        }
      },
      acc);

  // z rounded, into the drained ring
  unsigned char* zs = smem + TL::DY;
  const int gr = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = wm * (BM / 2) + i * 16 + gr, col = wn * 8 * NT + j * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(zs + swz(row, col >> 3, BCH) + (col & 7) * 2) =
          pack2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(zs + swz(row + 8, col >> 3, BCH) + (col & 7) * 2) =
          pack2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  // the row pass: lanes sub = lane % LPR of a row take chunks sub + c * LPR
  const int sub = lane % LPR;
  float scv[CPL][8], cx[CPL][8], cd[CPL][8];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int ch = sub + c * LPR;
      scv[c][e] = ch < CPR ? sc[ch * 8 + e] : 0.0f;
      cx[c][e] = cd[c][e] = 0.0f;
    }
  auto lanes_sum = [](float v) {
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  for (int r = warp * RPI + lane / LPR; r < BM; r += 8 * RPI) {
    uint4 zv[CPL], dv[CPL];
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = sub + c * LPR;
      zv[c] = dv[c] = make_uint4(0u, 0u, 0u, 0u);
      if (ch < CPR) {
        zv[c] = *reinterpret_cast<const uint4*>(zs + swz(r, ch, BCH));
        dv[c] = *reinterpret_cast<const uint4*>(smem + swz(r, ch, BCH));
      }
      const uint32_t zz[4] = {zv[c].x, zv[c].y, zv[c].z, zv[c].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack2(zz[q]);
        s += f.x + f.y;
        s2 += f.x * f.x + f.y * f.y;
      }
    }
    s = lanes_sum(s);
    s2 = lanes_sum(s2);
    const float mean = s / NG;
    const float rstd = 1.0f / sqrtf(fmaxf(s2 / NG - mean * mean, 0.0f) + kLnEps);
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const uint32_t zz[4] = {zv[c].x, zv[c].y, zv[c].z, zv[c].w};
      const uint32_t dd[4] = {dv[c].x, dv[c].y, dv[c].z, dv[c].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack2(zz[q]), d = unpack2(dd[q]);
        const float xh0 = (f.x - mean) * rstd, xh1 = (f.y - mean) * rstd;
        const float e0 = d.x * scv[c][2 * q], e1 = d.y * scv[c][2 * q + 1];
        a1 += e0 + e1;
        a2 += e0 * xh0 + e1 * xh1;
        cx[c][2 * q] += d.x * xh0;
        cx[c][2 * q + 1] += d.y * xh1;
        cd[c][2 * q] += d.x;
        cd[c][2 * q + 1] += d.y;
      }
    }
    a1 = lanes_sum(a1) / NG;
    a2 = lanes_sum(a2) / NG;
    const int m = m0 + r;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = sub + c * LPR;
      const uint32_t zz[4] = {zv[c].x, zv[c].y, zv[c].z, zv[c].w};
      const uint32_t dd[4] = {dv[c].x, dv[c].y, dv[c].z, dv[c].w};
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack2(zz[q]), d = unpack2(dd[q]);
        const float xh0 = (f.x - mean) * rstd, xh1 = (f.y - mean) * rstd;
        o[q] = pack2((d.x * scv[c][2 * q] - a1 - xh0 * a2) * rstd,
                     (d.y * scv[c][2 * q + 1] - a1 - xh1 * a2) * rstd);
      }
      if (ch < CPR && m < M)
        st_global16(dz + (long long)m * N + n0 + ch * 8, o[0], o[1], o[2], o[3]);
    }
  }

  // column sums: the lanes of a row group, then the warps in order
  float* red = reinterpret_cast<float*>(zs + TL::DY);  // [8 warps][2][NG], after the z tile
#pragma unroll
  for (int c = 0; c < CPL; ++c)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if constexpr (LPR == 16) {
        cx[c][e] += __shfl_xor_sync(0xffffffffu, cx[c][e], 16);
        cd[c][e] += __shfl_xor_sync(0xffffffffu, cd[c][e], 16);
      }
      const int ch = sub + c * LPR;
      if (lane < LPR && ch < CPR) {
        red[(2 * warp) * NG + ch * 8 + e] = cx[c][e];
        red[(2 * warp + 1) * NG + ch * 8 + e] = cd[c][e];
      }
    }
  __syncthreads();
  float* p = part + (long long)blockIdx.x * 2 * NG;  // partial row (row block, group)
  for (int c = tid; c < 2 * NG; c += mma::kThreads) {
    const int which = c / NG, col = c - which * NG;
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) v += red[(2 * q + which) * NG + col];
    p[c] = v;
  }
}

// Merge row pass, kMergeRows merged rows a block, x's four runs of C and dn
// staged in shared memory by 16-byte cp.async: a warp per row takes the
// row's LN stats (once) and the means of dn*sc and dn*sc*xhat; then a
// thread per 8-channel chunk walks the rows, writing n = round(LN(row)) (the
// weight gradient's A operand) and dx = round(LN backward) with 16-byte
// stores and summing dn*xhat and dn; the block's partial row of those
// column sums adds the row groups in order.
static __global__ void __launch_bounds__(mma::kThreads)
merge_rows_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dn,
                      const float* __restrict__ sc, const float* __restrict__ lb,
                      bf16* __restrict__ nrm, bf16* __restrict__ dx, float* __restrict__ part,
                      int W, int C, int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float stat[kMergeRows][4];  // mean, rstd, mean(dn*sc), mean(dn*sc*xhat)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = 4 * C, NCH = K / 8;
  const int m0 = blockIdx.x * kMergeRows;
  const long long wc = (long long)W * C;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ds = xs + kMergeRows * K;
  for (int r = warp; r < kMergeRows; r += mma::kThreads / 32) {
    const int m = m0 + r;
    const bool ok = m < M;
    const long long base = ok ? merge_row_base(m, W, C) : 0;
    for (int j = lane; j < NCH; j += 32) {
      const int k = 8 * j, q = (k >= C) + (k >= 2 * C) + (k >= 3 * C);  // quarter x0..x3
      const long long xo = base + (q & 1) * wc + (q >> 1) * C + (k - q * C);
      cp_async16(smem_u32(xs + r * K + k), x + (ok ? xo : 0), ok);
      cp_async16(smem_u32(ds + r * K + k), dn + (ok ? (long long)m * K + k : 0), ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int r = warp; r < kMergeRows; r += mma::kThreads / 32) {
    float s = 0.0f, s2 = 0.0f;
    for (int j = lane; j < NCH; j += 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(xs + r * K + 8 * j);
      const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack2(vv[q]);
        s += f.x + f.y;
        s2 += f.x * f.x + f.y * f.y;
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = s / K;
    const float rstd = 1.0f / sqrtf(fmaxf(s2 / K - mean * mean, 0.0f) + kLnEps);
    float a1 = 0.0f, a2 = 0.0f;
    for (int j = lane; j < NCH; j += 32) {
      const uint4 v = *reinterpret_cast<const uint4*>(xs + r * K + 8 * j);
      const uint4 d = *reinterpret_cast<const uint4*>(ds + r * K + 8 * j);
      const uint32_t vv[4] = {v.x, v.y, v.z, v.w}, dd[4] = {d.x, d.y, d.z, d.w};
      const float4 s0 = *reinterpret_cast<const float4*>(sc + 8 * j);
      const float4 s1 = *reinterpret_cast<const float4*>(sc + 8 * j + 4);
      const float scv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack2(vv[q]), g = unpack2(dd[q]);
        const float e0 = g.x * scv[2 * q], e1 = g.y * scv[2 * q + 1];
        a1 += e0 + e1;
        a2 += e0 * (f.x - mean) * rstd + e1 * (f.y - mean) * rstd;
      }
    }
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      stat[r][0] = mean;
      stat[r][1] = rstd;
      stat[r][2] = a1 / K;
      stat[r][3] = a2 / K;
    }
  }
  __syncthreads();

  const int G = mma::kThreads / NCH;  // row groups (NCH <= 256)
  const int grp = tid / NCH, j = tid - grp * NCH;
  float cx[8], cd[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) cx[e] = cd[e] = 0.0f;
  if (grp < G) {
    float scv[8], lbv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      scv[e] = sc[8 * j + e];
      lbv[e] = lb[8 * j + e];
    }
    const long long xo = merge_offset(8 * j, C, wc);
    for (int r = grp; r < kMergeRows && m0 + r < M; r += G) {
      const int m = m0 + r;
      const float mean = stat[r][0], rstd = stat[r][1], a1 = stat[r][2], a2 = stat[r][3];
      const uint4 v = *reinterpret_cast<const uint4*>(xs + r * K + 8 * j);
      const uint4 d = *reinterpret_cast<const uint4*>(ds + r * K + 8 * j);
      const uint32_t vv[4] = {v.x, v.y, v.z, v.w}, dd[4] = {d.x, d.y, d.z, d.w};
      uint32_t no[4], dm[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = unpack2(vv[q]), g = unpack2(dd[q]);
        const float xh0 = (f.x - mean) * rstd, xh1 = (f.y - mean) * rstd;
        no[q] = pack2(xh0 * scv[2 * q] + lbv[2 * q], xh1 * scv[2 * q + 1] + lbv[2 * q + 1]);
        dm[q] = pack2((g.x * scv[2 * q] - a1 - xh0 * a2) * rstd,
                      (g.y * scv[2 * q + 1] - a1 - xh1 * a2) * rstd);
        cx[2 * q] += g.x * xh0;
        cx[2 * q + 1] += g.y * xh1;
        cd[2 * q] += g.x;
        cd[2 * q + 1] += g.y;
      }
      st_global16(nrm + (long long)m * K + 8 * j, no[0], no[1], no[2], no[3]);
      st_global16(dx + merge_row_base(m, W, C) + xo, dm[0], dm[1], dm[2], dm[3]);
    }
  }
  __syncthreads();  // the tiles are read: their space takes the column sums
  float* red = reinterpret_cast<float*>(smem);  // [G][2][K]
  if (grp < G)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[(2 * grp) * K + 8 * j + e] = cx[e];
      red[(2 * grp + 1) * K + 8 * j + e] = cd[e];
    }
  __syncthreads();
  float* p = part + (long long)blockIdx.x * 2 * K;
  for (int c = tid; c < 2 * K; c += mma::kThreads) {
    const int which = c / K, k = c - which * K;
    float s = 0.0f;
    for (int q = 0; q < G; ++q) s += red[(2 * q + which) * K + k];
    p[c] = s;
  }
}

// The fixed-order second pass of the three cross-block sums of a call (dW,
// dscale, dbias) in one launch: out[i] = sum_r part[r * stride + i], i < L,
// L and stride multiples of 4.  A thread sums four neighbouring outputs
// (16-byte loads); a job's blocks are `tx` such threads x 256/tx row lanes
// (tx 256 for few partial rows and many outputs, the weight gradient; tx 2
// for many rows and few outputs, the LayerNorm parameters' gradients), the
// lanes added in order.
struct SumJob {
  const float* part;
  float* out;
  int rows, L, tx, blocks;
  long long stride;
};
struct SumJobs {
  SumJob j0, j1, j2;  // named, not an array: a run-time index would copy them to local memory
};

static __global__ void __launch_bounds__(256) sum_jobs_kernel(SumJobs jobs) {
  __shared__ float4 red[256];
  int b = blockIdx.x;
  const bool in0 = b < jobs.j0.blocks;
  if (!in0) b -= jobs.j0.blocks;
  const bool in1 = !in0 && b < jobs.j1.blocks;
  if (!in0 && !in1) b -= jobs.j1.blocks;
#define SSA_PICK(f) (in0 ? jobs.j0.f : (in1 ? jobs.j1.f : jobs.j2.f))
  const float* part = SSA_PICK(part);
  float* out = SSA_PICK(out);
  const int rows = SSA_PICK(rows), L = SSA_PICK(L), txn = SSA_PICK(tx);
  const long long stride = SSA_PICK(stride);
#undef SSA_PICK
  const int ny = 256 / txn, tx = threadIdx.x % txn, ty = threadIdx.x / txn;
  const long long i = 4 * ((long long)b * txn + tx);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < L)
    for (int r = ty; r < rows; r += ny) {
      const float4 v = *reinterpret_cast<const float4*>(part + r * stride + i);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  if (ny == 1) {
    if (i < L) *reinterpret_cast<float4*>(out + i) = acc;
    return;
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (ty == 0 && i < L) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int y = 0; y < ny; ++y) {
      const float4 v = red[y * txn + tx];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + i) = s;
  }
}

static SumJob sum_job(const float* part, float* out, int rows, int L, long long stride, int tx) {
  return SumJob{part, out, rows, L, tx, (L / 4 + tx - 1) / tx, stride};
}

static cudaError_t sum_jobs(SumJobs jobs, cudaStream_t st) {
  sum_jobs_kernel<<<jobs.j0.blocks + jobs.j1.blocks + jobs.j2.blocks, 256, 0, st>>>(jobs);
  return cudaGetLastError();
}

cudaError_t mma_ab_round(const bf16* a, const bf16* b, bf16* out, int M, int K, int N,
                         cudaStream_t st) {
  if (K % mma::kBK || N % 8) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mma_ab_round_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, mma::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + mma::kBM - 1) / mma::kBM, (N + mma::kBN - 1) / mma::kBN);
  mma_ab_round_kernel<<<grid, mma::kThreads, mma::kSmem, st>>>(a, b, out, M, K, N);
  return cudaGetLastError();
}

// part (chunks, Mo, N): the split-K partials of a^T b over R rows.
static cudaError_t mma_atb_partial(const bf16* a, const bf16* b, float* part, int R, int Mo,
                                   int N, int rows_per_chunk, cudaStream_t st) {
  if (Mo % 8 || N % 8 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mma_atb_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, mma::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Mo + mma::kBM - 1) / mma::kBM, (N + mma::kBN - 1) / mma::kBN,
                  (R + rows_per_chunk - 1) / rows_per_chunk);
  mma_atb_partial_kernel<<<grid, mma::kThreads, mma::kSmem, st>>>(a, b, part, R, Mo, N,
                                                                  rows_per_chunk);
  return cudaGetLastError();
}

// Four CUDA launches: dn = round(dy W^T); the row pass (n, dx, column-sum
// partials); the split-K dW = n^T dy partials; the fixed-order sums of dW,
// dscale and dbias.
static cudaError_t merge_bwd_mma(const bf16* x, const bf16* dy, const float* sc, const float* lb,
                                 const bf16* wt, bf16* dn, bf16* nrm, float* part_dw,
                                 float* part_cs, bf16* dx, float* dw, float* dsc, float* dlb,
                                 int B, int H, int W, int C, int rows_per_chunk,
                                 cudaStream_t st) {
  const int M = B * (H / 2) * (W / 2), K = 4 * C, N = 2 * C;
  if (C % 32 || C > 512 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  cudaError_t e = mma_ab_round(dy, wt, dn, M, N, K, st);
  if (e != cudaSuccess) return e;
  const int row_blocks = (M + kMergeRows - 1) / kMergeRows;
  // the x and dn tiles, then the row groups' column sums
  const int tile_bytes = kMergeRows * K * 4, sum_bytes = (mma::kThreads / (K / 8)) * 2 * K * 4;
  const int smem = tile_bytes > sum_bytes ? tile_bytes : sum_bytes;
  if ((e = cudaFuncSetAttribute(merge_rows_mma_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return e;
  merge_rows_mma_kernel<<<row_blocks, mma::kThreads, smem, st>>>(x, dn, sc, lb, nrm, dx,
                                                                 part_cs, W, C, M);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = mma_atb_partial(nrm, dy, part_dw, M, K, N, rows_per_chunk, st)) != cudaSuccess)
    return e;
  const int chunks = (M + rows_per_chunk - 1) / rows_per_chunk;
  SumJobs jobs{sum_job(part_dw, dw, chunks, K * N, (long long)K * N, 256),
               sum_job(part_cs, dsc, row_blocks, K, 2LL * K, 2),
               sum_job(part_cs + K, dlb, row_blocks, K, 2LL * K, 2)};
  return sum_jobs(jobs, st);
}

template <int NT>
static cudaError_t expand_dz_mma(const bf16* x, const bf16* w, const bf16* dy, const float* sc,
                                 bf16* dz, float* part_ln, int H, int W, int C, int M,
                                 cudaStream_t st) {
  using TL = DzTile<NT>;
  cudaError_t e = cudaFuncSetAttribute(expand_dz_mma_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (e != cudaSuccess) return e;
  const int grid = 4 * ((M + TL::BM - 1) / TL::BM);
  expand_dz_mma_kernel<NT><<<grid, mma::kThreads, TL::SMEM, st>>>(x, w, dy, sc, dz, part_ln, H,
                                                                  W, C, M);
  return cudaGetLastError();
}

// Group widths C/2 = 32 * NT of the tensor-core expand backward (Swin-B's
// 128/256/512, Swin-T's 96/192/384).
#define SSA_EXPAND_MMA_NT(X) X(3) X(4) X(6) X(8) X(12) X(16)

// Four CUDA launches: dz (product, group stats, LN backward, dscale/dbias
// partials); the split-K dW = x^T dz partials; dx = round(dz W^T); the
// fixed-order sums of dW, dscale and dbias.
static cudaError_t expand_bwd_mma(const bf16* x, const bf16* dy, const bf16* w, const bf16* wt,
                                  const float* sc, bf16* dz, float* part_ln, float* part_dw,
                                  bf16* dx, float* dw, float* dsc, float* dlb, int B, int H,
                                  int W, int C, int rows_per_chunk, cudaStream_t st) {
  const int M = B * H * W, NG = C / 2;
  if (C % 64 || rows_per_chunk <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaErrorInvalidValue;
  int bm = 0;
  switch (NG / 32) {
#define SSA_CASE(n)                                                   \
  case n:                                                             \
    e = expand_dz_mma<n>(x, w, dy, sc, dz, part_ln, H, W, C, M, st); \
    bm = DzTile<n>::BM;                                               \
    break;
    SSA_EXPAND_MMA_NT(SSA_CASE)
#undef SSA_CASE
  }
  if (e != cudaSuccess) return e;
  if ((e = mma_atb_partial(x, dz, part_dw, M, C, 2 * C, rows_per_chunk, st)) != cudaSuccess)
    return e;
  if ((e = mma_ab_round(dz, wt, dx, M, 2 * C, C, st)) != cudaSuccess) return e;
  const int chunks = (M + rows_per_chunk - 1) / rows_per_chunk;
  const int ln_rows = 4 * ((M + bm - 1) / bm);
  SumJobs jobs{sum_job(part_dw, dw, chunks, 2 * C * C, 2LL * C * C, 256),
               sum_job(part_ln, dsc, ln_rows, NG, 2LL * NG, 2),
               sum_job(part_ln + NG, dlb, ln_rows, NG, 2LL * NG, 2)};
  return sum_jobs(jobs, st);
}

}  // namespace ssa

// wt is the torch-layout weight (2C, 4C) in the storage type; sc/lb float32
// (4C).  Scratch: dn (M, 4C) storage type, stats (M, 2) float32, part_dw
// (chunks, 4C, 2C) and part_cs (chunks, 2, 4C) float32, chunks =
// ceil(M / rows_per_chunk), M = B*H/2*W/2.  dw is (4C, 2C) input-major.
extern "C" int ssa_patch_merge_bwd(const void* x, const void* dy, const void* sc,
                                   const void* lb, const void* wt, void* dn, void* stats,
                                   void* part_dw, void* part_cs, void* dx, void* dw, void* dsc,
                                   void* dlb, int B, int H, int W, int C, int rows_per_chunk,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16)
    return (int)ssa::merge_bwd<__nv_bfloat16>(x, dy, sc, lb, wt, dn, stats, part_dw, part_cs,
                                              dx, dw, dsc, dlb, B, H, W, C, rows_per_chunk, st);
  return (int)ssa::merge_bwd<float>(x, dy, sc, lb, wt, dn, stats, part_dw, part_cs, dx, dw,
                                    dsc, dlb, B, H, W, C, rows_per_chunk, st);
}

// w is (C, 2C) input-major and wt the torch-layout (2C, C), both in the
// storage type; sc float32 (C/2).  Scratch: dz (M, 2C) storage type,
// part_ln (4 * ceil(M/32), 2, C/2) and part_dw (chunks, C, 2C) float32,
// M = B*H*W.  dw is (C, 2C) input-major.
extern "C" int ssa_patch_expand_bwd(const void* x, const void* dy, const void* w, const void* wt,
                                    const void* sc, void* dz, void* part_ln, void* part_dw,
                                    void* dx, void* dw, void* dsc, void* dlb, int B, int H,
                                    int W, int C, int rows_per_chunk, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssa::kBF16)
    return (int)ssa::expand_bwd<__nv_bfloat16>(x, dy, w, wt, sc, dz, part_ln, part_dw, dx, dw,
                                               dsc, dlb, B, H, W, C, rows_per_chunk, st);
  return (int)ssa::expand_bwd<float>(x, dy, w, wt, sc, dz, part_ln, part_dw, dx, dw, dsc, dlb,
                                     B, H, W, C, rows_per_chunk, st);
}

// The bfloat16 tensor-core route (the wrapper's ROUTE_MMA; C a multiple of
// 32 up to 512).  Inputs and outputs as ssa_patch_merge_bwd; scratch: dn
// and n (M, 4C) bfloat16, part_dw (chunks, 4C, 2C) and part_cs
// (ceil(M / 16), 2, 4C) float32.
extern "C" int ssa_patch_merge_bwd_mma(const void* x, const void* dy, const void* sc,
                                       const void* lb, const void* wt, void* dn, void* n,
                                       void* part_dw, void* part_cs, void* dx, void* dw,
                                       void* dsc, void* dlb, int B, int H, int W, int C,
                                       int rows_per_chunk, int dtype, void* stream) {
  if (dtype != ssa::kBF16) return (int)cudaErrorInvalidValue;
  using ssa::bf16;
  return (int)ssa::merge_bwd_mma(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const float*>(sc),
      static_cast<const float*>(lb), static_cast<const bf16*>(wt), static_cast<bf16*>(dn),
      static_cast<bf16*>(n), static_cast<float*>(part_dw), static_cast<float*>(part_cs),
      static_cast<bf16*>(dx), static_cast<float*>(dw), static_cast<float*>(dsc),
      static_cast<float*>(dlb), B, H, W, C, rows_per_chunk, static_cast<cudaStream_t>(stream));
}

// The bfloat16 tensor-core route (C/2 in 96, 128, 192, 256, 384, 512).
// Inputs and outputs as ssa_patch_expand_bwd; scratch: dz (M, 2C)
// bfloat16, part_ln (4 * ceil(M / BM), 2, C/2) with BM 128 up to C/2 = 128,
// 64 up to 256 and 32 above (DzTile), part_dw (chunks, C, 2C) float32.
extern "C" int ssa_patch_expand_bwd_mma(const void* x, const void* dy, const void* w,
                                        const void* wt, const void* sc, void* dz, void* part_ln,
                                        void* part_dw, void* dx, void* dw, void* dsc, void* dlb,
                                        int B, int H, int W, int C, int rows_per_chunk,
                                        int dtype, void* stream) {
  if (dtype != ssa::kBF16) return (int)cudaErrorInvalidValue;
  using ssa::bf16;
  return (int)ssa::expand_bwd_mma(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<const bf16*>(wt), static_cast<const float*>(sc), static_cast<bf16*>(dz),
      static_cast<float*>(part_ln), static_cast<float*>(part_dw), static_cast<bf16*>(dx),
      static_cast<float*>(dw), static_cast<float*>(dsc), static_cast<float*>(dlb), B, H, W, C,
      rows_per_chunk, static_cast<cudaStream_t>(stream));
}
