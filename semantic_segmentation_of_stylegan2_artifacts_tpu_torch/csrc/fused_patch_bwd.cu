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
// Design: simple and deterministic.  The row-wise LN backward needs row
// means over all K columns of dn, which one 32-row product block cannot
// hold, so merge runs the dn product into device memory, then one warp per
// row for the LN backward and the scatter; expand's groups are C/2 wide,
// so its dz kernel keeps the forward's register tile and does the LN
// backward in the epilogue.  The weight gradient sums over every row: each
// block of the split-K product writes a float32 partial for its chunk of
// rows, and a second pass adds the partials in a fixed order (as the
// refine head's dW and the attention's dbias), so repeated runs give equal
// bits; dscale/dbias likewise.  Products run on the CUDA cores in float32;
// tensor cores are later work.
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
