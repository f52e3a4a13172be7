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
// 128/256/512 and Swin-T's 96/192/384 among them).  These kernels run the
// products on the CUDA cores in float32: the float32 route (the parity type)
// and the widths the tensor-core route does not take.
//
// bfloat16 at merge C a multiple of 32 up to 512 and expand C/2 in 96, 128,
// 192, 256, 384, 512 (every width of Swin-B and Swin-T; the wrapper's
// merge_route / expand_route) takes the tensor cores instead: two CUDA
// launches a call, the product on `mma_ab_round` (the backwards' product
// core, fused_patch_bwd.cu) and a row pass over 16-byte chunks.
//  * Merge: the row pass writes n = round(LN(gather_2x2(x)) * sc + lb)
//    (M x 4C, the wrapper's scratch), then out = round(n W).  Building n
//    inside the product kernel doubled that kernel in the backward.
//  * Expand: z = round(x W) (M x 2C, the wrapper's scratch), then the row
//    pass takes each (row, group)'s LN stats and stores the group at
//    (b, 2h+p1, 2w+p2, :).
// Both row passes move their bytes once (read x or z, write n or out); the
// products are ~8.6 GFLOP a Swin-B launch.
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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: the row passes around `mma_ab_round`.
// ---------------------------------------------------------------------------

// Merge row pass: n (M, 4C) = round(LN(merged row) * sc + lb), kMergeRows
// merged rows a block.  The rows' four runs of C are staged in shared memory
// by 16-byte cp.async (base from merge_row_base: one division a row); a warp
// a row takes the float32 fast-variance stats; then a thread a 16-byte
// chunk (sc, lb in registers) walks the rows with 16-byte stores.  C a
// multiple of 32 up to 512, so 4C/8 <= 256 chunks a row and every address
// is 16-byte aligned.
static __global__ void __launch_bounds__(mma::kThreads)
merge_ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ sc,
                     const float* __restrict__ lb, bf16* __restrict__ nrm, int W, int C, int M) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float stat[kMergeRows][2];  // mean, rstd
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = 4 * C, NCH = K / 8;
  const int m0 = blockIdx.x * kMergeRows;
  const long long wc = (long long)W * C;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  for (int r = warp; r < kMergeRows; r += mma::kThreads / 32) {
    const int m = m0 + r;
    const bool ok = m < M;
    const long long base = ok ? merge_row_base(m, W, C) : 0;
    for (int j = lane; j < NCH; j += 32) {
      const int k = 8 * j, q = (k >= C) + (k >= 2 * C) + (k >= 3 * C);  // quarter x0..x3
      const long long xo = base + (q & 1) * wc + (q >> 1) * C + (k - q * C);
      cp_async16(smem_u32(xs + r * K + k), x + (ok ? xo : 0), ok);
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
    if (lane == 0) {
      const float mean = s / K;
      stat[r][0] = mean;
      stat[r][1] = 1.0f / sqrtf(fmaxf(s2 / K - mean * mean, 0.0f) + kLnEps);
    }
  }
  __syncthreads();

  const int G = mma::kThreads / NCH;  // row groups
  const int grp = tid / NCH, j = tid - grp * NCH;
  if (grp >= G) return;
  float scv[8], lbv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    scv[e] = sc[8 * j + e];
    lbv[e] = lb[8 * j + e];
  }
  for (int r = grp; r < kMergeRows && m0 + r < M; r += G) {
    const float mean = stat[r][0], rstd = stat[r][1];
    const uint4 v = *reinterpret_cast<const uint4*>(xs + r * K + 8 * j);
    const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
    uint32_t no[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = unpack2(vv[q]);
      no[q] = pack2((f.x - mean) * rstd * scv[2 * q] + lbv[2 * q],
                    (f.y - mean) * rstd * scv[2 * q + 1] + lbv[2 * q + 1]);
    }
    st_global16(nrm + (long long)(m0 + r) * K + 8 * j, no[0], no[1], no[2], no[3]);
  }
}

// Expand row pass: for each (row m, group g = 2*p1+p2) of z (M, 2C), the
// group's NG = C/2 values (CPR = NG/8 16-byte chunks) normalised with their
// float32 fast-variance stats, * sc + lb, rounded and stored at
// (b, 2h+p1, 2w+p2, :) of out (B, 2H, 2W, NG).  LPR lanes a (row, group)
// segment (16 up to 16 chunks, else 32), chunks sub and sub + LPR of it a
// lane, the sums by shuffles within those lanes; loads and stores go
// straight between registers and device memory, two segments' loads in
// flight a lane (the pass is bound by bytes).  sc and lb are staged in
// shared memory once a block.  NG a multiple of 32 up to 512.
constexpr int kExpandRows = 8;  // rows a block: 32 (row, group) segments

static __global__ void __launch_bounds__(mma::kThreads)
expand_ln_rows_kernel(const bf16* __restrict__ z, const float* __restrict__ sc,
                      const float* __restrict__ lb, bf16* __restrict__ out, int W, int NG,
                      int M) {
  __shared__ __align__(16) float prm[2][512];  // sc, lb
  const int CPR = NG / 8, LPR = CPR <= 16 ? 16 : 32;
  const int tid = threadIdx.x, sub = tid & (LPR - 1);
  const int segs = mma::kThreads / LPR;  // segments a lane group covers at once
  for (int i = tid; i < NG; i += mma::kThreads) {
    prm[0][i] = sc[i];
    prm[1][i] = lb[i];
  }
  __syncthreads();
  auto lanes_sum = [LPR](float v) {
    for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  // 32 segments a block, 2 * segs a pass (16 or 32): every lane runs every
  // pass, as the shuffles need the whole warp; rows past M load nothing and
  // store nothing
  const int seg1 = (blockIdx.x + 1) * 4 * kExpandRows;
  for (int seg0 = blockIdx.x * 4 * kExpandRows + tid / LPR; seg0 < seg1; seg0 += 2 * segs) {
    uint4 v[2][2];
    float s[2], s2[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int seg = seg0 + u * segs, m = seg >> 2;
      const bf16* zr = z + (long long)seg * NG;  // row m's 2C = 4 NG values, group seg & 3
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ch = sub + c * LPR;
        v[u][c] = make_uint4(0u, 0u, 0u, 0u);
        if (m < M && ch < CPR) v[u][c] = *reinterpret_cast<const uint4*>(zr + ch * 8);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      s[u] = s2[u] = 0.0f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t vv[4] = {v[u][c].x, v[u][c].y, v[u][c].z, v[u][c].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = unpack2(vv[q]);
          s[u] += f.x + f.y;
          s2[u] += f.x * f.x + f.y * f.y;
        }
      }
      s[u] = lanes_sum(s[u]);
      s2[u] = lanes_sum(s2[u]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int seg = seg0 + u * segs, m = seg >> 2, g = seg & 3;
      if (m >= M) continue;
      const float mean = s[u] / NG;
      const float rstd = 1.0f / sqrtf(fmaxf(s2[u] / NG - mean * mean, 0.0f) + kLnEps);
      // m = q * W + w with q = b * H + h: the output row is 2q + p1, the column 2w + p2
      const int qh = m / W, wv = m - qh * W;
      bf16* o = out + ((long long)(2 * qh + (g >> 1)) * (2 * W) + 2 * wv + (g & 1)) * NG;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ch = sub + c * LPR;
        if (ch >= CPR) continue;
        const float4 s0 = *reinterpret_cast<const float4*>(&prm[0][ch * 8]);
        const float4 s1 = *reinterpret_cast<const float4*>(&prm[0][ch * 8 + 4]);
        const float4 l0 = *reinterpret_cast<const float4*>(&prm[1][ch * 8]);
        const float4 l1 = *reinterpret_cast<const float4*>(&prm[1][ch * 8 + 4]);
        const float scv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float lbv[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
        const uint32_t vv[4] = {v[u][c].x, v[u][c].y, v[u][c].z, v[u][c].w};
        uint32_t no[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = unpack2(vv[q]);
          no[q] = pack2((f.x - mean) * rstd * scv[2 * q] + lbv[2 * q],
                        (f.y - mean) * rstd * scv[2 * q + 1] + lbv[2 * q + 1]);
        }
        st_global16(o + ch * 8, no[0], no[1], no[2], no[3]);
      }
    }
  }
}

// Two CUDA launches: the row pass writing n; out = round(n W).
static cudaError_t merge_fwd_mma(const bf16* x, const float* sc, const float* lb, const bf16* w,
                                 bf16* nrm, bf16* out, int B, int H, int W, int C,
                                 cudaStream_t st) {
  const int M = B * (H / 2) * (W / 2), K = 4 * C;
  if (C % 32 || C > 512 || H % 2 || W % 2) return cudaErrorInvalidValue;
  const int smem = kMergeRows * K * 2;
  cudaError_t e = cudaFuncSetAttribute(merge_ln_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  merge_ln_rows_kernel<<<(M + kMergeRows - 1) / kMergeRows, mma::kThreads, smem, st>>>(
      x, sc, lb, nrm, W, C, M);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return mma_ab_round(nrm, w, out, M, K, 2 * C, st);
}

// Two CUDA launches: z = round(x W); the row pass (group LN, scatter).
static cudaError_t expand_fwd_mma(const bf16* x, const bf16* w, const float* sc, const float* lb,
                                  bf16* z, bf16* out, int B, int H, int W, int C,
                                  cudaStream_t st) {
  const int M = B * H * W, NG = C / 2;
  if (C % 64 || NG > 512) return cudaErrorInvalidValue;
  cudaError_t e = mma_ab_round(x, w, z, M, C, 2 * C, st);
  if (e != cudaSuccess) return e;
  expand_ln_rows_kernel<<<(M + kExpandRows - 1) / kExpandRows, mma::kThreads, 0, st>>>(
      z, sc, lb, out, W, NG, M);
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

// The bfloat16 tensor-core route (the wrapper's ROUTE_MMA; C a multiple of
// 32 up to 512).  Inputs and outputs as ssa_patch_merge_fwd; scratch: n
// (M, 4C) bfloat16, M = B*H/2*W/2.
extern "C" int ssa_patch_merge_fwd_mma(const void* x, const void* sc, const void* lb,
                                       const void* w, void* n, void* out, int B, int H, int W,
                                       int C, int dtype, void* stream) {
  if (dtype != ssa::kBF16) return (int)cudaErrorInvalidValue;
  using ssa::bf16;
  return (int)ssa::merge_fwd_mma(static_cast<const bf16*>(x), static_cast<const float*>(sc),
                                 static_cast<const float*>(lb), static_cast<const bf16*>(w),
                                 static_cast<bf16*>(n), static_cast<bf16*>(out), B, H, W, C,
                                 static_cast<cudaStream_t>(stream));
}

// The bfloat16 tensor-core route (C/2 in 96, 128, 192, 256, 384, 512).
// Inputs and outputs as ssa_patch_expand_fwd; scratch: z (M, 2C) bfloat16,
// M = B*H*W.
extern "C" int ssa_patch_expand_fwd_mma(const void* x, const void* w, const void* sc,
                                        const void* lb, void* z, void* out, int B, int H, int W,
                                        int C, int dtype, void* stream) {
  if (dtype != ssa::kBF16) return (int)cudaErrorInvalidValue;
  using ssa::bf16;
  return (int)ssa::expand_fwd_mma(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                                  static_cast<const float*>(sc), static_cast<const float*>(lb),
                                  static_cast<bf16*>(z), static_cast<bf16*>(out), B, H, W, C,
                                  static_cast<cudaStream_t>(stream));
}
