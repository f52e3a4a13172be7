// Shifted-window attention over windows of more than 64 tokens (window 12:
// 144 tokens; 22: 484; 24: 576), forward and backward: the tiled kernels.
//
// Replaces: the Pallas kernels `_fwd_kernel` (launcher `_fwd_pallas`) and
// `_bwd_kernel` (launcher `_bwd_pallas`) of
// semantic_segmentation_of_stylegan2_artifacts_tpu/ops/fused_window_attention.py,
// over the part of their domain (windows of up to 512 tokens there) that the
// kernels of fused_window_attention.cu (up to 64 tokens) do not take.  Same
// contract and the same rounding: the probabilities are normalised in
// float32 and then rounded to the storage type before P.v, dS is rounded
// before dq and dk, the rounded P gives dv, and the bias gradient is summed
// from the float32 dS.  Two families, chosen by the wrapper
// (ops/fused_window_attention.py::kernel_route): the tensor-core kernels of
// the deployment type (bfloat16, head widths a multiple of 16) in the second
// half of this file, the CUDA-core kernels of float32 and of the remaining
// widths in the first.  The entry points are fused_window_attention.cu's.
#include "fused_window_attention.cuh"

namespace ssa {

// ===========================================================================
// float32 (the parity type) and bfloat16 at head widths that are not a
// multiple of 16 (`kRouteTiled`), on the CUDA cores.
//
// Same contract and the same rounding as the tensor-core kernels below; one
// source of truth for the float32 parity checks at every window size.
//
// Bound on the H100: bytes on paper (at window 12 and head width 32 a window
// and head is ~2.7 MFLOP forward against ~37 KB of bf16 qkv and context); in
// practice these kernels are bound by the CUDA cores: every product is
// float32 FMAs over 64 x 64 tiles in shared memory, 16 x 16 threads each
// owning a 4 x 4 block of rows ty + 16a and columns tx + 16b.  A window no
// longer fits one block as an N x N score block, so queries and keys go
// through in tiles of 64 tokens.  Tensor cores and TMA are later work.
//
// Forward: one block per (query tile, window, head, image) and two passes
// over the key tiles.  The first takes each row's max and sum of
// exponentials (running per thread, merged over the 16 threads of a row);
// the second recomputes the logits, forms P = exp(x - max) / sum, rounds it
// and adds P.v.  A one-pass online softmax would multiply unnormalised,
// rounded values and not match the plain version's rounding.
//
// Backward: one block per (group of `plan` windows, head).  Per window:
// (1) each query row's max, sum and rowsum(dP * P), three passes over the
// key tiles per query tile; (2) key tiles outer, query tiles inner: P and dS
// of the tile pair, rounded, through shared memory; dk and dv of the key
// tile in registers, written once; dq of the tile's queries added into the
// block's float32 scratch, the float32 dS into the block's bias-gradient
// partial; (3) dq from the scratch.  Each element of the scratch and of the
// partial is read and written by one thread only (the one that owns its row
// and column in a tile), in a fixed order, so no atomics are needed and a
// repeated launch gives the same bits; `dbias_sum_kernel` adds the partials
// in a fixed order.  The scratch of a block and head is N rows of N + hd + 3
// floats: the bias-gradient partial, dq, and the row's max, sum and rowsum.
// ===========================================================================
constexpr int kTile = 64;            // query rows and keys of a tile
constexpr int kTiledThreads = 256;   // 16 x 16
constexpr int kPStride = kTile + 1;  // a P or dS tile row, padded against bank conflicts

struct TiledGeom {
  int B, Hp, Wp, C, heads, wh, ww, sh, sw;
  int n, hd, ld, nww, nwin;  // ld: row stride of an operand tile (odd: no bank conflicts)
  float scale;
};

static TiledGeom tiled_geom(int B, int Hp, int Wp, int C, int heads, int wh, int ww, int sh,
                            int sw) {
  TiledGeom g;
  g.B = B;
  g.Hp = Hp;
  g.Wp = Wp;
  g.C = C;
  g.heads = heads;
  g.wh = wh;
  g.ww = ww;
  g.sh = sh;
  g.sw = sw;
  g.n = wh * ww;
  g.hd = C / heads;
  g.ld = g.hd | 1;
  g.nww = Wp / ww;
  g.nwin = (Hp / wh) * g.nww;
  g.scale = (float)pow((double)g.hd, -0.5);
  return g;
}

// Row of token t of window (b, wr, wc) in the (B, Hp, Wp) grid.
__device__ __forceinline__ long long tiled_tok(const TiledGeom& g, int b, int wr, int wc, int t) {
  const int r = t / g.ww;
  return ((long long)b * g.Hp + wr * g.wh + r) * g.Wp + wc * g.ww + (t - r * g.ww);
}

// Region id of token t of window (wr, wc) in the rolled, padded grid (3 row
// regions x 3 column regions, ops/window_attention.py shifted_window_mask).
__device__ __forceinline__ int tiled_region(const TiledGeom& g, int wr, int wc, int t) {
  const int r = wr * g.wh + t / g.ww, c = wc * g.ww + t % g.ww;
  return 3 * ((r >= g.Hp - g.wh) + (r >= g.Hp - g.sh)) + (c >= g.Wp - g.ww) + (c >= g.Wp - g.sw);
}

// Tokens t0 .. t0 + 63 of window (b, wr, wc) into a float32 tile with rows
// ld apart: channels [off, off + hd) of `src` rows `stride` values long;
// tokens past N give zero rows.
template <typename T>
__device__ __forceinline__ void tiled_load(float* dst, const T* __restrict__ src,
                                           long long stride, int off, const TiledGeom& g, int b,
                                           int wr, int wc, int t0) {
  for (int e = threadIdx.x; e < kTile * g.hd; e += kTiledThreads) {
    const int r = e / g.hd, d = e - r * g.hd, t = t0 + r;
    dst[r * g.ld + d] = t < g.n ? to_f(src[tiled_tok(g, b, wr, wc, t) * stride + off + d]) : 0.0f;
  }
}

// acc[a][b] = x[ty + 16a] . y[tx + 16b] over the hd columns of two tiles.
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* x, const float* y,
                                         int hd, int ld, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    float xa[4], yb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xa[a] = x[(ty + 16 * a) * ld + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) yb[b] = y[(tx + 16 * b) * ld + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xa[a], yb[b], acc[a][b]);
  }
}

// Raw scores of query rows i0 + ty + 16a and keys j0 + tx + 16b -> logits:
// scaled, + bias, + the -100 shift mask; keys past N -inf.  Rows past N stay
// finite (no bias, no mask) and are never stored.
__device__ __forceinline__ void tiled_logits(float (&s)[4][4], const TiledGeom& g,
                                             const float* __restrict__ bias_h, int i0, int j0,
                                             int wr, int wc, int ty, int tx) {
  const bool masked = (g.sh | g.sw) != 0;
  int gj[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = j0 + tx + 16 * b;
    gj[b] = masked && j < g.n ? tiled_region(g, wr, wc, j) : 0;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    const bool iv = i < g.n;
    const int gi = masked && iv ? tiled_region(g, wr, wc, i) : 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + 16 * b;
      float x = s[a][b] * g.scale;
      if (iv && j < g.n) {
        x += __ldg(bias_h + (long long)i * g.n + j);
        if (masked && gi != gj[b]) x += -100.0f;
      }
      s[a][b] = j < g.n ? x : -INFINITY;
    }
  }
}

// Over the 16 threads of a row (lanes tx of one half-warp), in a fixed order.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A thread's running max m and sum l of exp(x - m) over its logits of rows a.
__device__ __forceinline__ void tiled_running(float (&m)[4], float (&l)[4],
                                              const float (&s)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
    const float mn = fmaxf(m[a], mx);
    if (mn == -INFINITY) continue;  // no key of this thread yet
    float sum = l[a] * expf(m[a] - mn);
#pragma unroll
    for (int b = 0; b < 4; ++b) sum += expf(s[a][b] - mn);
    m[a] = mn;
    l[a] = sum;
  }
}

// The rows' max and sum of exponentials from the 16 threads' running ones.
__device__ __forceinline__ void tiled_merge(float (&m)[4], float (&l)[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float mr = row_max16(m[a]);  // finite: key 0 is in every row
    l[a] = row_sum16(m[a] == -INFINITY ? 0.0f : l[a] * expf(m[a] - mr));
    m[a] = mr;
  }
}

// Max and sum of exponentials of query rows i0 + ty + 16a (q tile in `qs`)
// over every key tile of head channels [off, off + hd), loaded into `ks`.
template <typename T>
__device__ __forceinline__ void tiled_row_stats(float (&m)[4], float (&l)[4], const float* qs,
                                                float* ks, const T* __restrict__ qkv,
                                                const float* __restrict__ bias_h,
                                                const TiledGeom& g, int off, int b, int wr, int wc,
                                                int i0, int ty, int tx) {
  const int tiles = (g.n + kTile - 1) / kTile;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
  }
  for (int kt = 0; kt < tiles; ++kt) {
    __syncthreads();  // the tile before is done with ks; qs has landed
    tiled_load<T>(ks, qkv, 3LL * g.C, g.C + off, g, b, wr, wc, kt * kTile);
    __syncthreads();
    float s[4][4];
    tile_dot(s, qs, ks, g.hd, g.ld, ty, tx);
    tiled_logits(s, g, bias_h, i0, kt * kTile, wr, wc, ty, tx);
    tiled_running(m, l, s);
  }
  tiled_merge(m, l);
}

// grid (windows * query tiles, heads, images); the head is blockIdx.y.
template <typename T, int OC>
__global__ void __launch_bounds__(kTiledThreads)
window_attention_fwd_tiled_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                                  T* __restrict__ out, const TiledGeom g) {
  const int tiles = (g.n + kTile - 1) / kTile;
  const int win = blockIdx.x / tiles, qt = blockIdx.x - win * tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int wr = win / g.nww, wc = win - wr * g.nww;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  extern __shared__ float smem[];
  float* qs = smem;                // [64][ld] queries
  float* ks = qs + kTile * g.ld;   // [64][ld] keys
  float* vs = ks + kTile * g.ld;   // [64][ld] values
  float* ps = vs + kTile * g.ld;   // [64][65] rounded probabilities
  const long long c3 = 3LL * g.C;
  const int off = h * g.hd, i0 = qt * kTile;
  const float* bias_h = bias + (long long)h * g.n * g.n;

  tiled_load<T>(qs, qkv, c3, off, g, b, wr, wc, i0);
  float m[4], l[4];
  tiled_row_stats<T>(m, l, qs, ks, qkv, bias_h, g, off, b, wr, wc, i0, ty, tx);

  float o[4][OC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < OC; ++c) o[a][c] = 0.0f;
  for (int kt = 0; kt < tiles; ++kt) {
    const int j0 = kt * kTile;
    __syncthreads();  // the tile before is done with ks, vs and ps
    tiled_load<T>(ks, qkv, c3, g.C + off, g, b, wr, wc, j0);
    tiled_load<T>(vs, qkv, c3, 2 * g.C + off, g, b, wr, wc, j0);
    __syncthreads();
    float s[4][4];
    tile_dot(s, qs, ks, g.hd, g.ld, ty, tx);
    tiled_logits(s, g, bias_h, i0, j0, wr, wc, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        ps[(ty + 16 * a) * kPStride + tx + 16 * bb] = round_to<T>(expf(s[a][bb] - m[a]) / l[a]);
    __syncthreads();
    const int jn = min(kTile, g.n - j0);
    for (int j = 0; j < jn; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * kPStride + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int d = tx + 16 * c;
        const float v = d < g.hd ? vs[j * g.ld + d] : 0.0f;
#pragma unroll
        for (int a = 0; a < 4; ++a) o[a][c] = fmaf(pa[a], v, o[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= g.n) continue;
    T* dst = out + tiled_tok(g, b, wr, wc, i) * g.C + off;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = tx + 16 * c;
      if (d < g.hd) dst[d] = from_f<T>(o[a][c]);
    }
  }
}

// grid (blocks of `group` windows, heads).
template <typename T, int OC>
__global__ void __launch_bounds__(kTiledThreads)
window_attention_bwd_tiled_kernel(const T* __restrict__ qkv, const T* __restrict__ dctx,
                                  const float* __restrict__ bias, T* __restrict__ dqkv,
                                  float* __restrict__ part, const TiledGeom g, int group) {
  const int tiles = (g.n + kTile - 1) / kTile;
  const int h = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  extern __shared__ float smem[];
  float* qs = smem;                  // [64][ld] queries
  float* dcs = qs + kTile * g.ld;    // [64][ld] the queries' dctx
  float* ks = dcs + kTile * g.ld;    // [64][ld] keys
  float* vs = ks + kTile * g.ld;     // [64][ld] values
  float* ps = vs + kTile * g.ld;     // [64][65] rounded P
  float* dss = ps + kTile * kPStride;  // [64][65] rounded dS
  const long long c3 = 3LL * g.C;
  const int off = h * g.hd;
  const float* bias_h = bias + (long long)h * g.n * g.n;
  // the block's scratch rows: bias-gradient partial [0, N), dq [N, N + hd),
  // the row's max, sum and rowsum(dP * P) at N + hd, +1, +2
  const int lds = g.n + g.hd + 3;
  float* pb = part + ((long long)blockIdx.x * g.heads + h) * g.n * lds;
  float* stats = pb + g.n + g.hd;

  for (int k = 0; k < group; ++k) {
    const int gw = blockIdx.x * group + k;
    if (gw >= g.B * g.nwin) break;
    const int b = gw / g.nwin, win = gw - b * g.nwin;
    const int wr = win / g.nww, wc = win - wr * g.nww;

    // (1) the rows' statistics
    for (int qt = 0; qt < tiles; ++qt) {
      const int i0 = qt * kTile;
      __syncthreads();  // the window or tile before is done with qs and dcs
      tiled_load<T>(qs, qkv, c3, off, g, b, wr, wc, i0);
      tiled_load<T>(dcs, dctx, g.C, off, g, b, wr, wc, i0);
      float m[4], l[4], rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      tiled_row_stats<T>(m, l, qs, ks, qkv, bias_h, g, off, b, wr, wc, i0, ty, tx);
      for (int kt = 0; kt < tiles; ++kt) {
        const int j0 = kt * kTile;
        __syncthreads();
        tiled_load<T>(ks, qkv, c3, g.C + off, g, b, wr, wc, j0);
        tiled_load<T>(vs, qkv, c3, 2 * g.C + off, g, b, wr, wc, j0);
        __syncthreads();
        float s[4][4], dp[4][4];
        tile_dot(s, qs, ks, g.hd, g.ld, ty, tx);
        tile_dot(dp, dcs, vs, g.hd, g.ld, ty, tx);
        tiled_logits(s, g, bias_h, i0, j0, wr, wc, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) rs[a] += expf(s[a][bb] - m[a]) / l[a] * dp[a][bb];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        rs[a] = row_sum16(rs[a]);
        const int i = i0 + ty + 16 * a;
        if (tx == 0 && i < g.n) {
          stats[(long long)i * lds] = m[a];
          stats[(long long)i * lds + 1] = l[a];
          stats[(long long)i * lds + 2] = rs[a];
        }
      }
    }

    // (2) key tiles outer, query tiles inner
    for (int kt = 0; kt < tiles; ++kt) {
      const int j0 = kt * kTile;
      __syncthreads();  // the statistics are written; the tile before is done with ks, vs
      tiled_load<T>(ks, qkv, c3, g.C + off, g, b, wr, wc, j0);
      tiled_load<T>(vs, qkv, c3, 2 * g.C + off, g, b, wr, wc, j0);
      float dk[4][OC], dv[4][OC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < OC; ++c) dk[a][c] = dv[a][c] = 0.0f;
      for (int qt = 0; qt < tiles; ++qt) {
        const int i0 = qt * kTile;
        __syncthreads();  // the query tile before is done with qs, dcs, ps, dss
        tiled_load<T>(qs, qkv, c3, off, g, b, wr, wc, i0);
        tiled_load<T>(dcs, dctx, g.C, off, g, b, wr, wc, i0);
        __syncthreads();
        float s[4][4], dp[4][4];
        tile_dot(s, qs, ks, g.hd, g.ld, ty, tx);
        tile_dot(dp, dcs, vs, g.hd, g.ld, ty, tx);
        tiled_logits(s, g, bias_h, i0, j0, wr, wc, ty, tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          const bool iv = i < g.n;
          const float* st = stats + (long long)(iv ? i : 0) * lds;
          const float mi = st[0], li = st[1], di = st[2];
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int j = j0 + tx + 16 * bb;
            float p = 0.0f, ds = 0.0f;
            if (iv && j < g.n) {
              p = expf(s[a][bb] - mi) / li;
              ds = p * (dp[a][bb] - di);
              float* acc = pb + (long long)i * lds + j;
              *acc = k == 0 ? ds : *acc + ds;
            }
            ps[(ty + 16 * a) * kPStride + tx + 16 * bb] = round_to<T>(p);
            dss[(ty + 16 * a) * kPStride + tx + 16 * bb] = round_to<T>(ds);
          }
        }
        __syncthreads();
        // dk = dS^T.q, dv = P^T.dctx of keys j0 + ty + 16a
        const int in = min(kTile, g.n - i0);
        for (int i = 0; i < in; ++i) {
          float pa[4], da[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            pa[a] = ps[i * kPStride + ty + 16 * a];
            da[a] = dss[i * kPStride + ty + 16 * a];
          }
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            const int d = tx + 16 * c;
            const float qv = d < g.hd ? qs[i * g.ld + d] : 0.0f;
            const float cv = d < g.hd ? dcs[i * g.ld + d] : 0.0f;
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              dk[a][c] = fmaf(da[a], qv, dk[a][c]);
              dv[a][c] = fmaf(pa[a], cv, dv[a][c]);
            }
          }
        }
        // dq += dS.k of queries i0 + ty + 16a, into the scratch
        float dq[4][OC];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < OC; ++c) dq[a][c] = 0.0f;
        const int jn = min(kTile, g.n - j0);
        for (int j = 0; j < jn; ++j) {
          float da[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) da[a] = dss[(ty + 16 * a) * kPStride + j];
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            const int d = tx + 16 * c;
            const float kv = d < g.hd ? ks[j * g.ld + d] : 0.0f;
#pragma unroll
            for (int a = 0; a < 4; ++a) dq[a][c] = fmaf(da[a], kv, dq[a][c]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
          if (i >= g.n) continue;
          float* acc = pb + (long long)i * lds + g.n;
#pragma unroll
          for (int c = 0; c < OC; ++c) {
            const int d = tx + 16 * c;
            if (d < g.hd) acc[d] = kt == 0 ? dq[a][c] : acc[d] + dq[a][c];
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + ty + 16 * a;
        if (j >= g.n) continue;
        T* dst = dqkv + tiled_tok(g, b, wr, wc, j) * c3 + off;
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const int d = tx + 16 * c;
          if (d < g.hd) {
            dst[g.C + d] = from_f<T>(dk[a][c] * g.scale);
            dst[2 * g.C + d] = from_f<T>(dv[a][c]);
          }
        }
      }
    }

    // (3) dq, from this thread's own elements of the scratch
    for (int qt = 0; qt < tiles; ++qt) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = qt * kTile + ty + 16 * a;
        if (i >= g.n) continue;
        const float* acc = pb + (long long)i * lds + g.n;
        T* dst = dqkv + tiled_tok(g, b, wr, wc, i) * c3 + off;
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const int d = tx + 16 * c;
          if (d < g.hd) dst[d] = from_f<T>(acc[d] * g.scale);
        }
      }
    }
  }
}

template <typename T, int OC>
static cudaError_t launch_fwd_tiled(const void* qkv, const void* bias, void* out,
                                    const TiledGeom& g, cudaStream_t st) {
  const int smem = (int)sizeof(float) * (3 * kTile * g.ld + kTile * kPStride);
  auto kern = window_attention_fwd_tiled_kernel<T, OC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.nwin * ((g.n + kTile - 1) / kTile), g.heads, g.B);
  kern<<<grid, kTiledThreads, smem, st>>>(static_cast<const T*>(qkv),
                                           static_cast<const float*>(bias), static_cast<T*>(out),
                                           g);
  return cudaGetLastError();
}

template <typename T, int OC>
static cudaError_t launch_bwd_tiled(const void* qkv, const void* dctx, const void* bias,
                                    void* dqkv, void* part, void* dbias, const TiledGeom& g,
                                    int group, cudaStream_t st) {
  const int smem = (int)sizeof(float) * (4 * kTile * g.ld + 2 * kTile * kPStride);
  auto kern = window_attention_bwd_tiled_kernel<T, OC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nblk = (g.B * g.nwin + group - 1) / group;
  kern<<<dim3(nblk, g.heads), kTiledThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dctx), static_cast<const float*>(bias),
      static_cast<T*>(dqkv), static_cast<float*>(part), g, group);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dbias_sum_kernel<<<(g.heads * g.n * g.n + 31) / 32, dim3(32, 8), 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dbias), nblk, g.heads * g.n, g.n,
      g.n + g.hd + 3);
  return cudaGetLastError();
}

// Storage type and per-thread output columns (a thread owns columns tx + 16c,
// c < OC) are template parameters: OC 1, 2, 4, 8 up to head width 16, 32,
// 64, 128.
template <int OC>
static cudaError_t fwd_tiled_oc(const void* qkv, const void* bias, void* out, const TiledGeom& g,
                                int dtype, cudaStream_t st) {
  return dtype == kBF16 ? launch_fwd_tiled<__nv_bfloat16, OC>(qkv, bias, out, g, st)
                        : launch_fwd_tiled<float, OC>(qkv, bias, out, g, st);
}
template <int OC>
static cudaError_t bwd_tiled_oc(const void* qkv, const void* dctx, const void* bias, void* dqkv,
                                void* part, void* dbias, const TiledGeom& g, int group, int dtype,
                                cudaStream_t st) {
  return dtype == kBF16
             ? launch_bwd_tiled<__nv_bfloat16, OC>(qkv, dctx, bias, dqkv, part, dbias, g, group,
                                                   st)
             : launch_bwd_tiled<float, OC>(qkv, dctx, bias, dqkv, part, dbias, g, group, st);
}
static cudaError_t fwd_tiled_hd(const void* qkv, const void* bias, void* out, const TiledGeom& g,
                                int dtype, cudaStream_t st) {
  if (g.hd <= 16) return fwd_tiled_oc<1>(qkv, bias, out, g, dtype, st);
  if (g.hd <= 32) return fwd_tiled_oc<2>(qkv, bias, out, g, dtype, st);
  if (g.hd <= 64) return fwd_tiled_oc<4>(qkv, bias, out, g, dtype, st);
  return fwd_tiled_oc<8>(qkv, bias, out, g, dtype, st);
}
static cudaError_t bwd_tiled_hd(const void* qkv, const void* dctx, const void* bias, void* dqkv,
                                void* part, void* dbias, const TiledGeom& g, int group, int dtype,
                                cudaStream_t st) {
  if (g.hd <= 16) return bwd_tiled_oc<1>(qkv, dctx, bias, dqkv, part, dbias, g, group, dtype, st);
  if (g.hd <= 32) return bwd_tiled_oc<2>(qkv, dctx, bias, dqkv, part, dbias, g, group, dtype, st);
  if (g.hd <= 64) return bwd_tiled_oc<4>(qkv, dctx, bias, dqkv, part, dbias, g, group, dtype, st);
  return bwd_tiled_oc<8>(qkv, dctx, bias, dqkv, part, dbias, g, group, dtype, st);
}

cudaError_t tiled_fwd(const void* qkv, const void* bias, void* out, int B, int Hp, int Wp, int C,
                      int heads, int wh, int ww, int sh, int sw, int dtype, cudaStream_t st) {
  return fwd_tiled_hd(qkv, bias, out, tiled_geom(B, Hp, Wp, C, heads, wh, ww, sh, sw), dtype, st);
}
cudaError_t tiled_bwd(const void* qkv, const void* dctx, const void* bias, void* dqkv, void* part,
                      void* dbias, int B, int Hp, int Wp, int C, int heads, int wh, int ww, int sh,
                      int sw, int plan, int dtype, cudaStream_t st) {
  return bwd_tiled_hd(qkv, dctx, bias, dqkv, part, dbias,
                      tiled_geom(B, Hp, Wp, C, heads, wh, ww, sh, sw), plan, dtype, st);
}

// ===========================================================================
// bfloat16 at head widths that are a multiple of 16 up to 128
// (`kRouteTiledMma`), on the tensor cores: `mma.sync.m16n8k16` with float32
// accumulators, as the kernels of the main path (fused_window_attention.cu)
// at windows of up to 64 tokens.
//
// Bound on the H100: bytes.  At window 12 and head width 32 a window and
// head is ~2.7 MFLOP forward and ~6.6 backward against 37 KB and 64 KB of
// bf16 operands (~72 and ~100 FLOP a byte, under the card's ~295), so the
// bound is the bytes of qkv, dctx and dqkv: 0.990 ms a Swin-B window-12
// 512^2 b8 forward and 1.437 ms a step's backward.  What the CUDA-core
// kernels above spend beyond it (float32 FMAs, element loads, every score
// computed two or three times, global scratch in the inner loop) is what
// this design removes:
//
// * Windows of up to 144 tokens (window 12, 9 bands of 16 rows, 18 key
//   tiles of 8), the one-block kernels: one warp a 16-row band; a block owns
//   one head and walks a balanced run of windows (`plan` blocks a head, one
//   wave), the head's bias (prescaled by log2(e), -inf past N) in shared
//   memory for the whole run, and the next window's operands arrive by
//   `cp.async` while this one computes.  A band's whole score row is 72
//   floats a lane, so the forward takes one pass: the scores on the tensor
//   cores, the exact row max and sum over the four lanes of a row, P
//   normalised in float32, rounded to bf16 straight into A fragments, P.v on
//   the tensor cores.  No score exists outside registers.
// * Their backward (head widths 16 and 32) keeps q, k, v and dctx of a window
//   on chip, two stages of q and dctx (the next window's arrive during the
//   whole window, its k and v during the key bands): per band warp S, P and
//   rowsum(dP*P), then dP again tile by tile for dS = P*(dP - rowsum) in
//   float32; the rounded P and dS go to two N x N bf16 tiles in shared
//   memory (`stmatrix`), and dq = dS.k leaves from registers.  After a
//   barrier warp w takes key band w: dk = dS^T.q and dv = P^T.dctx over
//   every query band by `ldmatrix.trans`, no cross-warp sum.  The bias
//   gradient stays in the band warp's registers over the whole run (the band
//   of a warp is fixed) and leaves as one float32 partial a block.  Nine
//   warps cap a thread at 168 registers (three warps on one SM sub-partition):
//   the score row and the bias gradient take 144 of them, and ptxas spills
//   ~0.3 KB a thread.
// * Larger windows (484 and 576 tokens; and the backward at head widths
//   above 32, whose operands and tiles outgrow shared memory), the split
//   kernels, 64-token chunks of 4 bands: the forward takes one block a
//   (window, query chunk, head) and two passes over the key chunks on the
//   tensor cores, the rows' max and sum, then P.v with the same rounding (a
//   one-pass online softmax would multiply unnormalised values and not match
//   the plain version's rounding).  The backward splits a window's keys over
//   blocks: a statistics launch writes each row's max, 1/sum and
//   rowsum(dP*P); one block a (group of windows, key chunk, head) walks the
//   query chunks with its keys' k and v on chip, forms P and dS of the chunk
//   pair, adds dS into the group's bias-gradient partial and writes dq of
//   its keys as a float32 partial; dk and dv of its keys stay in registers.
//   A third launch sums the dq partials over the key chunks in a fixed order.
// * No float atomics anywhere: every partial element has one owning thread,
//   and `dbias_sum_kernel` adds the partials in a fixed order, so a repeated
//   launch gives the same bits.
// ===========================================================================
constexpr int kTmChunk = 144;              // tokens a one-block window holds
constexpr int kTmNT = kTmChunk / 8;        // n8 key tiles of a band's score row
constexpr int kTmThreads = 2 * kTmChunk;   // one warp a 16-row band
constexpr int kTmBS = kTmChunk + 8;        // bias row, floats: rows 24 banks apart
constexpr int kTmPS = 2 * kTmChunk + 16;   // P / dS row, bytes: 8 rows hit 8 bank groups
constexpr int kTmBwdMaxHd = 32;            // head widths of the one-block backward
constexpr int kTsChunk = 64;               // tokens of a chunk of the split kernels
constexpr int kTsNT = kTsChunk / 8;
constexpr int kTsThreads = 2 * kTsChunk;
constexpr int kTsPS = 2 * kTsChunk + 16;
constexpr int kMaxSmem = 232448;           // dynamic shared memory a block may use
constexpr float kMasked = -100.0f * kLog2e;

struct TmGeom {
  int B, Hp, Wp, C, heads, wh, ww, sh, sw;
  int n, hd, nww, nwin, total;  // total: windows of all images
  int plan, nk;                 // nk: 64-token chunks of a window
  float scale, scale_log2;
};

static TmGeom tm_geom(int B, int Hp, int Wp, int C, int heads, int wh, int ww, int sh, int sw,
                      int plan) {
  TmGeom g;
  g.B = B;
  g.Hp = Hp;
  g.Wp = Wp;
  g.C = C;
  g.heads = heads;
  g.wh = wh;
  g.ww = ww;
  g.sh = sh;
  g.sw = sw;
  g.n = wh * ww;
  g.hd = C / heads;
  g.nww = Wp / ww;
  g.nwin = (Hp / wh) * g.nww;
  g.total = B * g.nwin;
  g.plan = plan;
  g.nk = (g.n + kTsChunk - 1) / kTsChunk;
  const double scale = pow((double)g.hd, -0.5);
  g.scale = (float)scale;
  g.scale_log2 = (float)(scale * 1.4426950408889634);
  return g;
}

// The one-block kernels take the window (the backward: and the head width):
// the one place this is decided, for the launch and for the backward's
// scratch (ssa_window_attention_bwd_scratch).
static bool tm_one_block(int n, int hd, bool bwd) {
  return n <= kTmChunk && (!bwd || hd <= kTmBwdMaxHd);
}

__device__ __forceinline__ long long tm_tok0(const TmGeom& g, int w) {
  const int b = w / g.nwin, win = w - b * g.nwin;
  const int wr = win / g.nww, wc = win - wr * g.nww;
  return ((long long)b * g.Hp + wr * g.wh) * g.Wp + wc * g.ww;
}

// The shift mask of window w.  The region ids of
// ops/window_attention.py::shifted_window_mask differ between two tokens of
// one window only where one token lies at or past the shift line (row
// Hp - sh, column Wp - sw) and the other does not: every token of a window
// shares its last-window-row and last-window-column terms.  `thr_r` /
// `thr_c`: the line in the window's own rows and columns; `on`: it cuts the
// window.
struct TmMask {
  int thr_r, thr_c;
  bool on;
};
__device__ __forceinline__ TmMask tm_mask(const TmGeom& g, int w) {
  const int win = w % g.nwin, wr = win / g.nww, wc = win - wr * g.nww;
  TmMask m;
  m.thr_r = g.Hp - g.sh - wr * g.wh;
  m.thr_c = g.Wp - g.sw - wc * g.ww;
  m.on = (m.thr_r > 0 && m.thr_r < g.wh) || (m.thr_c > 0 && m.thr_c < g.ww);
  return m;
}
__device__ __forceinline__ int tm_code(int tr, int tc, const TmMask& m) {
  return (tr >= m.thr_r ? 1 : 0) | (tc >= m.thr_c ? 2 : 0);
}
__device__ __forceinline__ int tm_code_of(int t, const TmGeom& g, const TmMask& m) {
  const int tr = t / g.ww;
  return tm_code(tr, t - tr * g.ww, m);
}

// This lane's two rows of a 16-row band that starts at row r0 - (lane >> 2):
// rows of the window, whether they exist, their token offsets from the
// window's first token.
struct TmRows {
  int r_lo, r_hi, t_lo, t_hi;
  bool v_lo, v_hi;
};
__device__ __forceinline__ TmRows tm_rows(const TmGeom& g, int r_lo) {
  TmRows r;
  r.r_lo = r_lo;
  r.r_hi = r_lo + 8;
  r.v_lo = r.r_lo < g.n;
  r.v_hi = r.r_hi < g.n;
  r.t_lo = r.v_lo ? (r.r_lo / g.ww) * g.Wp + r.r_lo % g.ww : 0;
  r.t_hi = r.v_hi ? (r.r_hi / g.ww) * g.Wp + r.r_hi % g.ww : 0;
  return r;
}

// Swizzle of row r of an operand tile (rows of 2*HD bytes): the 16-byte
// chunk index is XORed with a function of r mod 8, so the 8 rows an
// `ldmatrix` reads at one chunk hit 8 distinct bank groups.
template <int HD>
__device__ __forceinline__ int tm_swz(int r) {
  if constexpr (HD == 16) return (r >> 2) & 1;
  else if constexpr (HD == 32) return (r >> 1) & 3;
  else return r & 7;
}

// Per-lane fragment offsets in an operand tile: `a_off` for x4 loads of 16
// rows x 2 chunks (A fragments of a band, transposed B fragments of 16
// rows), `b_off` for 8 rows x 4 chunks (B fragments of a [key][HD] tile).
template <int HD>
__device__ __forceinline__ uint32_t tm_a_off(int lane) {
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  return (uint32_t)(r * 2 * HD + (((lane >> 4) ^ tm_swz<HD>(r)) << 4));
}
template <int HD>
__device__ __forceinline__ uint32_t tm_b_off(int lane) {
  const int r = lane & 7, c = (lane >> 3) & (HD == 16 ? 1 : 3);
  return (uint32_t)(r * 2 * HD + ((c ^ tm_swz<HD>(r)) << 4));
}

// Tokens t0 .. t0 + rows - 1 of a window into `nops` swizzled tiles
// `op_bytes` apart: tile k gets channels [k * op_stride, + hd) of `src` (the
// head slice of the window's first token, `stride` elements a token).
// Tokens at or past N and chunks past hd arrive as zeros.
template <int HD>
__device__ __forceinline__ void tm_copy(uint32_t dst_u32, int op_bytes, int nops,
                                        const bf16* __restrict__ src, int stride, int op_stride,
                                        int t0, int rows, const TmGeom& g) {
  constexpr int CH = HD / 8;
  for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
    const int r = e / CH, c = e % CH, t = t0 + r;
    const bool ok = t < g.n && 8 * c < g.hd;
    const int tr = t / g.ww;
    const bf16* s = src + (ok ? ((long long)tr * g.Wp + (t - tr * g.ww)) * stride + 8 * c : 0);
    const uint32_t d = dst_u32 + r * 2 * HD + ((c ^ tm_swz<HD>(r)) << 4);
    for (int k = 0; k < nops; ++k) cp_async16(d + k * op_bytes, s + k * op_stride, ok);
  }
}

// The band's 16 x HD A fragments from `band_u32` (the tile plus 16 rows a band).
template <int HD>
__device__ __forceinline__ void tm_band(uint32_t (&a)[HD / 16][4], uint32_t band_u32,
                                        uint32_t a_off) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm4(a[kk], band_u32 + (a_off ^ (uint32_t)(kk << 5)));
}

// acc (16 rows x 8 keys) += A . B^T, B the 8 rows of a [key][HD] tile at `tile_u32`.
template <int HD>
__device__ __forceinline__ void tm_key_tile(float (&acc)[4], const uint32_t (&a)[HD / 16][4],
                                            uint32_t tile_u32, uint32_t b_off) {
  if constexpr (HD == 16) {
    uint32_t b0, b1;
    ldsm2(b0, b1, tile_u32 + b_off);
    mma_bf16_16816(acc, a[0], b0, b1);
  } else {
#pragma unroll
    for (int kk = 0; kk < HD / 16; kk += 2) {
      uint32_t b[4];
      ldsm4(b, tile_u32 + (b_off ^ (uint32_t)(kk << 5)));
      mma_bf16_16816(acc, a[kk], b[0], b[1]);
      mma_bf16_16816(acc, a[kk + 1], b[2], b[3]);
    }
  }
}

// o (16 rows x HD) += A (one k16 step of packed bf16 fragments) . B, B the 16
// rows of a [row][HD] tile at `rows_u32` (v or k for the queries' products, q
// or dctx for the keys').
template <int HD>
__device__ __forceinline__ void tm_frag_rows(float (&o)[HD / 8][4], const uint32_t (&a)[4],
                                             uint32_t rows_u32, uint32_t a_off) {
#pragma unroll
  for (int c0 = 0; c0 < HD / 8; c0 += 2) {
    uint32_t b[4];
    ldsm4_trans(b, rows_u32 + (a_off ^ (uint32_t)(c0 << 4)));
    mma_bf16_16816(o[c0], a, b[0], b[1]);
    mma_bf16_16816(o[c0 + 1], a, b[2], b[3]);
  }
}

// Two key tiles of a band (accumulator layout) rounded to one k16 step's A
// fragments.
__device__ __forceinline__ void tm_pack(uint32_t (&a)[4], const float (&x)[4],
                                        const float (&y)[4]) {
  a[0] = pack2(x[0], x[1]);
  a[1] = pack2(x[2], x[3]);
  a[2] = pack2(y[0], y[1]);
  a[3] = pack2(y[2], y[3]);
}

template <int NT>
__device__ __forceinline__ void tm_zero(float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
}

// A warp's 16 x HD band (accumulator layout: rows lo / hi, columns 8c + 2q,
// +1) times `mul`, rounded to bf16 and stored 16 bytes a lane at the head
// slices `row_lo` / `row_hi` of its two rows; pieces past hd are skipped.
template <int HD>
__device__ __forceinline__ void tm_store(const float (&o)[HD / 8][4], float mul, bf16* row_lo,
                                         bf16* row_hi, bool v_lo, bool v_hi, int q, int hd) {
  if constexpr (HD == 16) {
    uint32_t v[4] = {pack2(o[0][0] * mul, o[0][1] * mul), pack2(o[1][0] * mul, o[1][1] * mul),
                     pack2(o[0][2] * mul, o[0][3] * mul), pack2(o[1][2] * mul, o[1][3] * mul)};
    quad_transpose(v, q);  // lane q: tile q & 1 of row half q >> 1
    bf16* dst = (q >> 1) ? row_hi : row_lo;
    if ((q >> 1) ? v_hi : v_lo) st_global16(dst + (q & 1) * 8, v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int g4 = 0; g4 < HD / 32; ++g4) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = pack2(o[4 * g4 + i][0] * mul, o[4 * g4 + i][1] * mul);
        hi[i] = pack2(o[4 * g4 + i][2] * mul, o[4 * g4 + i][3] * mul);
      }
      quad_transpose(lo, q);  // lane q: tile 4 g4 + q
      quad_transpose(hi, q);
      if (8 * (4 * g4 + q) < hd) {
        if (v_lo) st_global16(row_lo + (4 * g4 + q) * 8, lo[0], lo[1], lo[2], lo[3]);
        if (v_hi) st_global16(row_hi + (4 * g4 + q) * 8, hi[0], hi[1], hi[2], hi[3]);
      }
    }
  }
}

// Scores -> logits in log2 units, fma(S, scale*log2e, bias*log2e), from the
// bias rows in shared memory (`b_lo` / `b_hi`: prescaled, -inf past N, at
// column 2q).
template <int NT>
__device__ __forceinline__ void tm_logits_smem(float (&s)[NT][4], const float* b_lo,
                                               const float* b_hi, float scale_log2) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bl = *reinterpret_cast<const float2*>(b_lo + 8 * j);
    const float2 bh = *reinterpret_cast<const float2*>(b_hi + 8 * j);
    s[j][0] = fmaf(s[j][0], scale_log2, bl.x);
    s[j][1] = fmaf(s[j][1], scale_log2, bl.y);
    s[j][2] = fmaf(s[j][2], scale_log2, bh.x);
    s[j][3] = fmaf(s[j][3], scale_log2, bh.y);
  }
}

// The same from the bias in device memory: `b_lo` / `b_hi` point at the
// rows' column `key0` (this lane's first key), keys past N give -inf.
template <int NT>
__device__ __forceinline__ void tm_logits_global(float (&s)[NT][4], const float* __restrict__ b_lo,
                                                 const float* __restrict__ b_hi, int key0, int n,
                                                 float scale_log2) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool ok = key0 + 8 * j + u < n;
      s[j][u] = ok ? fmaf(s[j][u], scale_log2, __ldg(b_lo + 8 * j + u) * kLog2e) : -INFINITY;
      s[j][2 + u] = ok ? fmaf(s[j][2 + u], scale_log2, __ldg(b_hi + 8 * j + u) * kLog2e)
                       : -INFINITY;
    }
}

// + the shift mask where a key's code differs from its row's (`c_lo` /
// `c_hi`); `key_code(t)` gives key t's code.
template <int NT, typename F>
__device__ __forceinline__ void tm_apply_mask(float (&s)[NT][4], int c_lo, int c_hi, int key0,
                                              F key_code) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = key_code(key0 + 8 * j + u);
      if (c != c_lo) s[j][u] += kMasked;
      if (c != c_hi) s[j][2 + u] += kMasked;
    }
}

// In place: logits of a band's whole rows -> float32 probabilities (the
// exact row max and sum over the four lanes of a row; -inf gives 0).
template <int NT>
__device__ __forceinline__ void tm_softmax(float (&s)[NT][4]) {
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

// One key chunk of a running row max m and sum l of exp2(x - m) (m and l
// are the same on the four lanes of a row; l sums this lane's keys only).
template <int NT>
__device__ __forceinline__ void tm_running(const float (&s)[NT][4], float& m_lo, float& m_hi,
                                           float& l_lo, float& l_hi) {
  float c_lo = fmaxf(s[0][0], s[0][1]), c_hi = fmaxf(s[0][2], s[0][3]);
#pragma unroll
  for (int j = 1; j < NT; ++j) {
    c_lo = fmaxf(c_lo, fmaxf(s[j][0], s[j][1]));
    c_hi = fmaxf(c_hi, fmaxf(s[j][2], s[j][3]));
  }
  const float n_lo = fmaxf(m_lo, quad_max(c_lo)), n_hi = fmaxf(m_hi, quad_max(c_hi));
  float a_lo = 0.0f, a_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    a_lo += ex2(s[j][0] - n_lo) + ex2(s[j][1] - n_lo);
    a_hi += ex2(s[j][2] - n_hi) + ex2(s[j][3] - n_hi);
  }
  l_lo = l_lo * ex2(m_lo - n_lo) + a_lo;  // the first chunk: ex2(-inf) = 0
  l_hi = l_hi * ex2(m_hi - n_hi) + a_hi;
  m_lo = n_lo;
  m_hi = n_hi;
}

// In place: logits -> exp2(x - m) / l, the probabilities of rows whose max
// and 1/sum are known.
template <int NT>
__device__ __forceinline__ void tm_probs(float (&s)[NT][4], float m_lo, float m_hi, float i_lo,
                                         float i_hi) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = ex2(s[j][0] - m_lo) * i_lo;
    s[j][1] = ex2(s[j][1] - m_lo) * i_lo;
    s[j][2] = ex2(s[j][2] - m_hi) * i_hi;
    s[j][3] = ex2(s[j][3] - m_hi) * i_hi;
  }
}

// Shared memory of the one-block kernels (byte offsets): the operand tiles
// (forward: `stages` x q, k, v; backward: k, v, then two stages of q and
// dctx), in the backward the rounded P and dS tiles, the bias (N rows of
// kTmBS floats) and the tokens' (row << 16 | column) in the window.
template <int HD>
struct TmLayout {
  static constexpr int OPB = kTmChunk * 2 * HD;  // one operand tile
  int tiles, bias, toks, total;
  __host__ __device__ constexpr TmLayout(int n, bool bwd, int stages)
      : tiles((bwd ? 6 : 3 * stages) * OPB),
        bias(tiles + (bwd ? 2 * kTmChunk * kTmPS : 0)),
        toks(bias + n * kTmBS * 4),
        total(toks + 4 * kTmChunk) {}
};
static_assert(TmLayout<128>(kTmChunk, false, 1).total <= kMaxSmem, "one-block forward");
static_assert(TmLayout<kTmBwdMaxHd>(kTmChunk, true, 1).total <= kMaxSmem, "one-block backward");

// Block set-up of the one-block kernels: the tokens' (row, column) and the
// head's bias, every thread's loads in flight before its stores.
__device__ __forceinline__ void tm_setup(float* bias_s, int* tok_s, const float* __restrict__ bias_h,
                                         const TmGeom& g) {
  for (int t = threadIdx.x; t < kTmChunk; t += blockDim.x)
    tok_s[t] = t < g.n ? ((t / g.ww) << 16) | (t % g.ww) : 0;
  const int count = g.n * kTmChunk;
  for (int e0 = threadIdx.x; e0 < count; e0 += 8 * blockDim.x) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x, i = e / kTmChunk, j = e - i * kTmChunk;
      v[u] = (e < count && j < g.n) ? __ldg(bias_h + i * g.n + j) * kLog2e : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x, i = e / kTmChunk, j = e - i * kTmChunk;
      if (e < count) bias_s[i * kTmBS + j] = v[u];
    }
  }
}

// The block's head and run of windows [w_begin, w_end): block = chunk *
// heads + head, runs a balanced split of all B * nW windows over `plan`.
__device__ __forceinline__ int tm_run(const TmGeom& g, int& h, int& w_end) {
  h = blockIdx.x % g.heads;
  const long long chunk = blockIdx.x / g.heads;
  w_end = (int)((chunk + 1) * g.total / g.plan);
  return (int)(chunk * g.total / g.plan);
}

// One-block forward: grid plan * heads, one warp a band, one block an SM.
template <int HD>
__global__ void __launch_bounds__(kTmThreads, 1)
window_attention_fwd_tm_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                               bf16* __restrict__ out, const TmGeom g, int stages) {
  constexpr int RB = 2 * HD, OPB = TmLayout<HD>::OPB;
  const TmLayout<HD> l(g.n, false, stages);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  float* bias_s = reinterpret_cast<float*>(smem_raw + l.bias);
  int* tok_s = reinterpret_cast<int*>(smem_raw + l.toks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  int h, w_end;
  const int w_begin = tm_run(g, h, w_end);
  const int c3 = 3 * g.C;
  const bf16* src = qkv + h * g.hd;

  if (w_begin < w_end)  // in flight while the block sets up
    tm_copy<HD>(ring, OPB, 3, src + tm_tok0(g, w_begin) * c3, c3, g.C, 0, kTmChunk, g);
  cp_async_commit();
  tm_setup(bias_s, tok_s, bias + (long long)h * g.n * g.n, g);
  const TmRows rw = tm_rows(g, warp * 16 + (lane >> 2));
  const uint32_t a_off = tm_a_off<HD>(lane), b_off = tm_b_off<HD>(lane);
  // rows past N read row 0: finite, and never stored
  const float* b_lo = bias_s + (rw.v_lo ? rw.r_lo : 0) * kTmBS + 2 * q;
  const float* b_hi = bias_s + (rw.v_hi ? rw.r_hi : 0) * kTmBS + 2 * q;

  int stage = 0;
  for (int w = w_begin; w < w_end; ++w) {
    cp_async_wait<0>();
    __syncthreads();  // window w has landed; every warp is done with the stage it replaces
    if (stages == 2 && w + 1 < w_end)
      tm_copy<HD>(ring + (stage ^ 1) * 3 * OPB, OPB, 3, src + tm_tok0(g, w + 1) * c3, c3, g.C, 0,
                  kTmChunk, g);
    cp_async_commit();
    const uint32_t sq = ring + stage * 3 * OPB, sk = sq + OPB, sv = sk + OPB;
    float s[kTmNT][4];
    tm_zero(s);
    {
      uint32_t a[HD / 16][4];
      tm_band<HD>(a, sq + warp * 16 * RB, a_off);
#pragma unroll
      for (int j = 0; j < kTmNT; ++j) tm_key_tile<HD>(s[j], a, sk + j * 8 * RB, b_off);
    }
    tm_logits_smem(s, b_lo, b_hi, g.scale_log2);
    const TmMask m = tm_mask(g, w);
    if (m.on) {
      auto code = [&](int t) { return tm_code(tok_s[t] >> 16, tok_s[t] & 0xffff, m); };
      tm_apply_mask(s, code(rw.r_lo), code(rw.r_hi), 2 * q, code);
    }
    tm_softmax(s);
    float o[HD / 8][4];
    tm_zero(o);
#pragma unroll
    for (int ks = 0; ks < kTmNT / 2; ++ks) {
      uint32_t pa[4];
      tm_pack(pa, s[2 * ks], s[2 * ks + 1]);
      tm_frag_rows<HD>(o, pa, sv + ks * 16 * RB, a_off);
    }
    bf16* base = out + tm_tok0(g, w) * g.C + h * g.hd;
    tm_store<HD>(o, 1.0f, base + (long long)rw.t_lo * g.C, base + (long long)rw.t_hi * g.C,
                 rw.v_lo, rw.v_hi, q, g.hd);
    if (stages == 2) {
      stage ^= 1;
    } else {
      __syncthreads();  // every warp is done with the one stage
      if (w + 1 < w_end)
        tm_copy<HD>(ring, OPB, 3, src + tm_tok0(g, w + 1) * c3, c3, g.C, 0, kTmChunk, g);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// One-block backward (head widths 16 and 32): grid plan * heads, one warp a
// band, one block an SM; `part` (plan * heads, N, kTmChunk) float32.
template <int HD>
__global__ void __launch_bounds__(kTmThreads, 1)
window_attention_bwd_tm_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                               const float* __restrict__ bias, bf16* __restrict__ dqkv,
                               float* __restrict__ part, const TmGeom g) {
  constexpr int RB = 2 * HD, OPB = TmLayout<HD>::OPB;
  const TmLayout<HD> l(g.n, true, 1);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sk = smem_u32(smem_raw), sv = sk + OPB, sqd = sv + OPB;
  const uint32_t p_u32 = sk + l.tiles, ds_u32 = p_u32 + kTmChunk * kTmPS;
  float* bias_s = reinterpret_cast<float*>(smem_raw + l.bias);
  int* tok_s = reinterpret_cast<int*>(smem_raw + l.toks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int bands = blockDim.x >> 5;
  int h, w_end;
  const int w_begin = tm_run(g, h, w_end);
  const int c3 = 3 * g.C;
  const bf16* src = qkv + h * g.hd;
  const bf16* dsrc = dctx + h * g.hd;
  // window w's q and dctx into stage `st`; its k and v
  auto load_qd = [&](int w, int st) {
    const long long t0 = tm_tok0(g, w);
    const uint32_t sq = sqd + st * 2 * OPB;
    tm_copy<HD>(sq, OPB, 1, src + t0 * c3, c3, 0, 0, kTmChunk, g);
    tm_copy<HD>(sq + OPB, OPB, 1, dsrc + t0 * g.C, g.C, 0, 0, kTmChunk, g);
  };
  auto load_kv = [&](int w) {
    tm_copy<HD>(sk, OPB, 2, src + tm_tok0(g, w) * c3 + g.C, c3, g.C, 0, kTmChunk, g);
  };

  if (w_begin < w_end) {
    load_qd(w_begin, 0);
    load_kv(w_begin);
  }
  cp_async_commit();
  tm_setup(bias_s, tok_s, bias + (long long)h * g.n * g.n, g);
  const TmRows rw = tm_rows(g, warp * 16 + (lane >> 2));
  const uint32_t a_off = tm_a_off<HD>(lane), b_off = tm_b_off<HD>(lane);
  const float* b_lo = bias_s + (rw.v_lo ? rw.r_lo : 0) * kTmBS + 2 * q;
  const float* b_hi = bias_s + (rw.v_hi ? rw.r_hi : 0) * kTmBS + 2 * q;
  // P / dS tiles: where this lane's `stmatrix` rows of band `warp` go, and
  // where its transposed loads of key band `warp` start
  const int l7 = lane & 7, mi = lane >> 3;
  const uint32_t pt_st = (uint32_t)((warp * 16 + l7 + (mi & 1) * 8) * kTmPS + (mi >> 1) * 16);
  const uint32_t pt_ld = (uint32_t)((l7 + (mi >> 1) * 8) * kTmPS + (warp * 16 + (mi & 1) * 8) * 2);

  float db[kTmNT][4];  // the run's bias-gradient sum of the band's rows
  tm_zero(db);
  int st = 0;
  for (int w = w_begin; w < w_end; ++w) {
    cp_async_wait<0>();
    __syncthreads();  // window w has landed; the window before is done with the tiles
    if (w + 1 < w_end) load_qd(w + 1, st ^ 1);  // the other stage, free since the barrier
    cp_async_commit();
    const uint32_t sq = sqd + st * 2 * OPB, sd = sq + OPB;
    bf16* base = dqkv + tm_tok0(g, w) * c3 + h * g.hd;
    bf16* row_lo = base + (long long)rw.t_lo * c3;
    bf16* row_hi = base + (long long)rw.t_hi * c3;
    {  // query band `warp`: P, rowsum(dP*P), dS, the bias gradient, dq
      float s[kTmNT][4];
      tm_zero(s);
      uint32_t a[HD / 16][4];
      tm_band<HD>(a, sq + warp * 16 * RB, a_off);
#pragma unroll
      for (int j = 0; j < kTmNT; ++j) tm_key_tile<HD>(s[j], a, sk + j * 8 * RB, b_off);
      tm_logits_smem(s, b_lo, b_hi, g.scale_log2);
      const TmMask m = tm_mask(g, w);
      if (m.on) {
        auto code = [&](int t) { return tm_code(tok_s[t] >> 16, tok_s[t] & 0xffff, m); };
        tm_apply_mask(s, code(rw.r_lo), code(rw.r_hi), 2 * q, code);
      }
      tm_softmax(s);
      tm_band<HD>(a, sd + warp * 16 * RB, a_off);  // the band's dctx
      float d_lo = 0.0f, d_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < kTmNT; ++j) {
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tm_key_tile<HD>(dp, a, sv + j * 8 * RB, b_off);
        d_lo += s[j][0] * dp[0] + s[j][1] * dp[1];
        d_hi += s[j][2] * dp[2] + s[j][3] * dp[3];
      }
      d_lo = quad_sum(d_lo);
      d_hi = quad_sum(d_hi);
#pragma unroll
      for (int j = 0; j < kTmNT; ++j) {  // rows past N: P (and so dS) zero
        if (!rw.v_lo) s[j][0] = s[j][1] = 0.0f;
        if (!rw.v_hi) s[j][2] = s[j][3] = 0.0f;
      }
      float dq[HD / 8][4];
      tm_zero(dq);
#pragma unroll
      for (int ks = 0; ks < kTmNT / 2; ++ks) {
        float ds[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = 2 * ks + u;
          float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          tm_key_tile<HD>(dp, a, sv + j * 8 * RB, b_off);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ds[u][e] = s[j][e] * (dp[e] - (e < 2 ? d_lo : d_hi));
            db[j][e] += ds[u][e];
          }
        }
        uint32_t pa[4], da[4];
        tm_pack(pa, s[2 * ks], s[2 * ks + 1]);
        tm_pack(da, ds[0], ds[1]);
        stsm4(p_u32 + pt_st + ks * 32, pa);
        stsm4(ds_u32 + pt_st + ks * 32, da);
        tm_frag_rows<HD>(dq, da, sk + ks * 16 * RB, a_off);
      }
      tm_store<HD>(dq, g.scale, row_lo, row_hi, rw.v_lo, rw.v_hi, q, g.hd);
    }
    __syncthreads();  // every band of P and dS is in its tile; k and v are free
    if (w + 1 < w_end) load_kv(w + 1);
    cp_async_commit();
    {  // key band `warp`: dk = dS^T.q, dv = P^T.dctx over every query band
      float dk[HD / 8][4], dv[HD / 8][4];
      tm_zero(dk);
      tm_zero(dv);
      for (int i = 0; i < bands; ++i) {
        uint32_t a[4];
        ldsm4_trans(a, ds_u32 + pt_ld + i * 16 * kTmPS);
        tm_frag_rows<HD>(dk, a, sq + i * 16 * RB, a_off);
        ldsm4_trans(a, p_u32 + pt_ld + i * 16 * kTmPS);
        tm_frag_rows<HD>(dv, a, sd + i * 16 * RB, a_off);
      }
      tm_store<HD>(dk, g.scale, row_lo + g.C, row_hi + g.C, rw.v_lo, rw.v_hi, q, g.hd);
      tm_store<HD>(dv, 1.0f, row_lo + 2 * g.C, row_hi + 2 * g.C, rw.v_lo, rw.v_hi, q, g.hd);
    }
    st ^= 1;
  }
  cp_async_wait<0>();
  // the run's partial: the band's rows, kTmChunk columns (zeros past N)
  float* dst = part + (long long)blockIdx.x * g.n * kTmChunk + 2 * q;
#pragma unroll
  for (int j = 0; j < kTmNT; ++j) {
    if (rw.v_lo) st_global8(dst + rw.r_lo * kTmChunk + 8 * j, db[j][0], db[j][1]);
    if (rw.v_hi) st_global8(dst + rw.r_hi * kTmChunk + 8 * j, db[j][2], db[j][3]);
  }
}

// Split row pass, grid (B * nW * nk, heads): one block a (window, 64-row query
// chunk) and head, one warp a band, two passes over the key chunks.  The
// forward (kStats false) writes the context; the statistics launch of the
// split backward writes each row's max, 1/sum and rowsum(dP*P) to `stats`
// (B * nW, heads, N, 4).
template <int HD, bool kStats>
__global__ void __launch_bounds__(kTsThreads)
window_attention_rows_ts_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                                const float* __restrict__ bias, bf16* __restrict__ out,
                                float* __restrict__ stats, const TmGeom g) {
  constexpr int RB = 2 * HD, OPB = kTsChunk * RB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sq = smem_u32(smem_raw), sk = sq + OPB, sv = sk + OPB, sd = sv + OPB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int w = blockIdx.x / g.nk, qc = blockIdx.x - w * g.nk, h = blockIdx.y;
  const int c3 = 3 * g.C;
  const long long tok0 = tm_tok0(g, w);
  const bf16* src = qkv + tok0 * c3 + h * g.hd;
  tm_copy<HD>(sq, OPB, 1, src, c3, 0, qc * kTsChunk, kTsChunk, g);
  if (kStats) tm_copy<HD>(sd, OPB, 1, dctx + tok0 * g.C + h * g.hd, g.C, 0, qc * kTsChunk,
                          kTsChunk, g);
  const TmRows rw = tm_rows(g, qc * kTsChunk + warp * 16 + (lane >> 2));
  const uint32_t a_off = tm_a_off<HD>(lane), b_off = tm_b_off<HD>(lane);
  const float* bias_h = bias + (long long)h * g.n * g.n;
  const float* b_lo = bias_h + (long long)(rw.v_lo ? rw.r_lo : 0) * g.n + 2 * q;
  const float* b_hi = bias_h + (long long)(rw.v_hi ? rw.r_hi : 0) * g.n + 2 * q;
  const TmMask m = tm_mask(g, w);
  auto code = [&](int t) { return tm_code_of(t, g, m); };
  const int c_lo = code(rw.v_lo ? rw.r_lo : 0), c_hi = code(rw.v_hi ? rw.r_hi : 0);
  // the logits of key chunk kc (its k in `sk`)
  auto logits = [&](float (&s)[kTsNT][4], const uint32_t (&a)[HD / 16][4], int kc) {
    tm_zero(s);
#pragma unroll
    for (int j = 0; j < kTsNT; ++j) tm_key_tile<HD>(s[j], a, sk + j * 8 * RB, b_off);
    const int key0 = kc * kTsChunk + 2 * q;
    tm_logits_global(s, b_lo + kc * kTsChunk, b_hi + kc * kTsChunk, key0, g.n, g.scale_log2);
    if (m.on) tm_apply_mask(s, c_lo, c_hi, key0, code);
  };

  uint32_t qa[HD / 16][4];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
  for (int kc = 0; kc < g.nk; ++kc) {  // the rows' max and sum
    __syncthreads();  // every warp is done with the chunk before
    tm_copy<HD>(sk, OPB, 1, src + g.C, c3, 0, kc * kTsChunk, kTsChunk, g);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (kc == 0) tm_band<HD>(qa, sq + warp * 16 * RB, a_off);
    float s[kTsNT][4];
    logits(s, qa, kc);
    tm_running(s, m_lo, m_hi, l_lo, l_hi);
  }
  const float i_lo = __fdividef(1.0f, quad_sum(l_lo)), i_hi = __fdividef(1.0f, quad_sum(l_hi));

  float o[HD / 8][4];
  tm_zero(o);
  uint32_t da[HD / 16][4];
  float d_lo = 0.0f, d_hi = 0.0f;
  for (int kc = 0; kc < g.nk; ++kc) {  // P, then P.v or rowsum(dP*P)
    __syncthreads();
    tm_copy<HD>(sk, OPB, 2, src + g.C, c3, g.C, kc * kTsChunk, kTsChunk, g);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[kTsNT][4];
    logits(s, qa, kc);
    tm_probs(s, m_lo, m_hi, i_lo, i_hi);
    if constexpr (kStats) {
      if (kc == 0) tm_band<HD>(da, sd + warp * 16 * RB, a_off);
#pragma unroll
      for (int j = 0; j < kTsNT; ++j) {
        float dp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tm_key_tile<HD>(dp, da, sv + j * 8 * RB, b_off);
        d_lo += s[j][0] * dp[0] + s[j][1] * dp[1];
        d_hi += s[j][2] * dp[2] + s[j][3] * dp[3];
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kTsNT / 2; ++ks) {
        uint32_t pa[4];
        tm_pack(pa, s[2 * ks], s[2 * ks + 1]);
        tm_frag_rows<HD>(o, pa, sv + ks * 16 * RB, a_off);
      }
    }
  }
  if constexpr (kStats) {
    d_lo = quad_sum(d_lo);
    d_hi = quad_sum(d_hi);
    float* dst = stats + ((long long)w * g.heads + h) * g.n * 4;
    if (q == 0 && rw.v_lo) {
      dst[rw.r_lo * 4] = m_lo;
      dst[rw.r_lo * 4 + 1] = i_lo;
      dst[rw.r_lo * 4 + 2] = d_lo;
    }
    if (q == 0 && rw.v_hi) {
      dst[rw.r_hi * 4] = m_hi;
      dst[rw.r_hi * 4 + 1] = i_hi;
      dst[rw.r_hi * 4 + 2] = d_hi;
    }
  } else {
    bf16* base = out + tok0 * g.C + h * g.hd;
    tm_store<HD>(o, 1.0f, base + (long long)rw.t_lo * g.C, base + (long long)rw.t_hi * g.C,
                 rw.v_lo, rw.v_hi, q, g.hd);
  }
}

// Split backward, grid (groups * nk, heads): one block a (group of `plan`
// windows, 64-key chunk kc) and head.  Per window, over the query chunks:
// P and dS of the chunk pair from the statistics; dS added into the group's
// bias-gradient partial `dbp` (groups, heads, N, N); P and dS rounded into
// two tiles; dq of the chunk's queries against these keys into the float32
// partial `dqp` (nk, B, Hp, Wp, C); then dk and dv of the keys.
template <int HD>
__global__ void __launch_bounds__(kTsThreads)
window_attention_bwd_ts_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dctx,
                               const float* __restrict__ bias, bf16* __restrict__ dqkv,
                               float* __restrict__ dbp, const float* __restrict__ stats,
                               float* __restrict__ dqp, const TmGeom g) {
  constexpr int RB = 2 * HD, OPB = kTsChunk * RB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sk = smem_u32(smem_raw), sv = sk + OPB, sq = sv + OPB, sd = sq + OPB;
  const uint32_t p_u32 = sd + OPB, ds_u32 = p_u32 + kTsChunk * kTsPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int grp = blockIdx.x / g.nk, kc = blockIdx.x - grp * g.nk, h = blockIdx.y;
  const int w_begin = grp * g.plan, w_end = min(w_begin + g.plan, g.total);
  const int c3 = 3 * g.C, k0 = kc * kTsChunk;
  const uint32_t a_off = tm_a_off<HD>(lane), b_off = tm_b_off<HD>(lane);
  const float* bias_h = bias + (long long)h * g.n * g.n;
  float* dbp_h = dbp + ((long long)grp * g.heads + h) * g.n * g.n;
  const long long tokens = (long long)g.total * g.n;
  float* dqp_k = dqp + (long long)kc * tokens * g.C + h * g.hd;
  const TmRows kr = tm_rows(g, k0 + warp * 16 + (lane >> 2));  // key band `warp`
  const int l7 = lane & 7, mi = lane >> 3;
  const uint32_t pt_st = (uint32_t)((warp * 16 + l7 + (mi & 1) * 8) * kTsPS + (mi >> 1) * 16);
  const uint32_t pt_ld = (uint32_t)((l7 + (mi >> 1) * 8) * kTsPS + (warp * 16 + (mi & 1) * 8) * 2);

  for (int w = w_begin; w < w_end; ++w) {
    const long long tok0 = tm_tok0(g, w);
    const bf16* src = qkv + tok0 * c3 + h * g.hd;
    const bf16* dsrc = dctx + tok0 * g.C + h * g.hd;
    const float* st_w = stats + ((long long)w * g.heads + h) * g.n * 4;
    const TmMask m = tm_mask(g, w);
    auto code = [&](int t) { return tm_code_of(t, g, m); };
    __syncthreads();  // every warp is done with the window before
    tm_copy<HD>(sk, OPB, 2, src + g.C, c3, g.C, k0, kTsChunk, g);
    float dk[HD / 8][4], dv[HD / 8][4];
    tm_zero(dk);
    tm_zero(dv);
    for (int qc = 0; qc < g.nk; ++qc) {
      if (qc > 0) __syncthreads();  // every warp is done with the chunk before
      tm_copy<HD>(sq, OPB, 1, src, c3, 0, qc * kTsChunk, kTsChunk, g);
      tm_copy<HD>(sd, OPB, 1, dsrc, g.C, 0, qc * kTsChunk, kTsChunk, g);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      {  // query band `warp` of the chunk against the block's keys
        const TmRows rw = tm_rows(g, qc * kTsChunk + warp * 16 + (lane >> 2));
        const int r_lo = rw.v_lo ? rw.r_lo : 0, r_hi = rw.v_hi ? rw.r_hi : 0;
        float s[kTsNT][4], dp[kTsNT][4];
        tm_zero(s);
        tm_zero(dp);
        {
          uint32_t a[HD / 16][4];
          tm_band<HD>(a, sq + warp * 16 * RB, a_off);
#pragma unroll
          for (int j = 0; j < kTsNT; ++j) tm_key_tile<HD>(s[j], a, sk + j * 8 * RB, b_off);
          tm_band<HD>(a, sd + warp * 16 * RB, a_off);
#pragma unroll
          for (int j = 0; j < kTsNT; ++j) tm_key_tile<HD>(dp[j], a, sv + j * 8 * RB, b_off);
        }
        const int key0 = k0 + 2 * q;
        tm_logits_global(s, bias_h + (long long)r_lo * g.n + key0,
                         bias_h + (long long)r_hi * g.n + key0, key0, g.n, g.scale_log2);
        if (m.on) tm_apply_mask(s, code(r_lo), code(r_hi), key0, code);
        tm_probs(s, __ldg(st_w + r_lo * 4), __ldg(st_w + r_hi * 4), __ldg(st_w + r_lo * 4 + 1),
                 __ldg(st_w + r_hi * 4 + 1));
        const float d_lo = __ldg(st_w + r_lo * 4 + 2), d_hi = __ldg(st_w + r_hi * 4 + 2);
#pragma unroll
        for (int j = 0; j < kTsNT; ++j) {
          if (!rw.v_lo) s[j][0] = s[j][1] = 0.0f;
          if (!rw.v_hi) s[j][2] = s[j][3] = 0.0f;
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - (e < 2 ? d_lo : d_hi));
        }
        // the group's partial: one owning thread an element, windows in order
#pragma unroll
        for (int j = 0; j < kTsNT; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (key0 + 8 * j + u >= g.n) continue;
            float* p_lo = dbp_h + (long long)rw.r_lo * g.n + key0 + 8 * j + u;
            float* p_hi = dbp_h + (long long)rw.r_hi * g.n + key0 + 8 * j + u;
            if (rw.v_lo) *p_lo = (w == w_begin ? 0.0f : *p_lo) + dp[j][u];
            if (rw.v_hi) *p_hi = (w == w_begin ? 0.0f : *p_hi) + dp[j][2 + u];
          }
        float dq[HD / 8][4];
        tm_zero(dq);
#pragma unroll
        for (int ks = 0; ks < kTsNT / 2; ++ks) {
          uint32_t pa[4], da[4];
          tm_pack(pa, s[2 * ks], s[2 * ks + 1]);
          tm_pack(da, dp[2 * ks], dp[2 * ks + 1]);
          stsm4(p_u32 + pt_st + ks * 32, pa);
          stsm4(ds_u32 + pt_st + ks * 32, da);
          tm_frag_rows<HD>(dq, da, sk + ks * 16 * RB, a_off);
        }
        float* d_lo_p = dqp_k + (tok0 + rw.t_lo) * g.C + 2 * q;
        float* d_hi_p = dqp_k + (tok0 + rw.t_hi) * g.C + 2 * q;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          if (8 * c >= g.hd) continue;
          if (rw.v_lo) st_global8(d_lo_p + 8 * c, dq[c][0], dq[c][1]);
          if (rw.v_hi) st_global8(d_hi_p + 8 * c, dq[c][2], dq[c][3]);
        }
      }
      __syncthreads();  // P and dS of the chunk pair are whole
#pragma unroll
      for (int i = 0; i < kTsChunk / 16; ++i) {  // key band `warp`
        uint32_t a[4];
        ldsm4_trans(a, ds_u32 + pt_ld + i * 16 * kTsPS);
        tm_frag_rows<HD>(dk, a, sq + i * 16 * RB, a_off);
        ldsm4_trans(a, p_u32 + pt_ld + i * 16 * kTsPS);
        tm_frag_rows<HD>(dv, a, sd + i * 16 * RB, a_off);
      }
    }
    bf16* base = dqkv + tok0 * c3 + h * g.hd;
    tm_store<HD>(dk, g.scale, base + (long long)kr.t_lo * c3 + g.C,
                 base + (long long)kr.t_hi * c3 + g.C, kr.v_lo, kr.v_hi, q, g.hd);
    tm_store<HD>(dv, 1.0f, base + (long long)kr.t_lo * c3 + 2 * g.C,
                 base + (long long)kr.t_hi * c3 + 2 * g.C, kr.v_lo, kr.v_hi, q, g.hd);
  }
}

// dq = scale * the sum of the split backward's partials over the key chunks,
// in order, into the q slices of dqkv.
static __global__ void __launch_bounds__(256)
tm_dq_sum_kernel(const float* __restrict__ dqp, bf16* __restrict__ dqkv, long long tokens, int C,
                 int nk, float scale) {
  const long long count = tokens * C;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int kc = 0; kc < nk; ++kc) acc += dqp[kc * count + e];
    const long long tok = e / C;
    dqkv[tok * 3 * C + (e - tok * C)] = __float2bfloat16_rn(acc * scale);
  }
}

template <typename K>
static cudaError_t tm_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
static cudaError_t tm_fwd(const void* qkv, const void* bias, void* out, const TmGeom& g,
                          cudaStream_t st) {
  cudaError_t e;
  if (tm_one_block(g.n, g.hd, false)) {
    // one stage where two do not fit (head widths above 64): 2.3-2.7 times
    // faster than the split forward there (window 12, batch 8; PERF.md)
    const int stages = TmLayout<HD>(g.n, false, 2).total <= kMaxSmem ? 2 : 1;
    const int smem = TmLayout<HD>(g.n, false, stages).total;
    auto kern = window_attention_fwd_tm_kernel<HD>;
    if ((e = tm_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<g.plan * g.heads, 32 * ((g.n + 15) / 16), smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const float*>(bias), static_cast<bf16*>(out),
        g, stages);
  } else {
    const int smem = 3 * kTsChunk * 2 * HD;
    auto kern = window_attention_rows_ts_kernel<HD, false>;
    if ((e = tm_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<dim3(g.total * g.nk, g.heads), kTsThreads, smem, st>>>(
        static_cast<const bf16*>(qkv), nullptr, static_cast<const float*>(bias),
        static_cast<bf16*>(out), nullptr, g);
  }
  return cudaGetLastError();
}

// The backward's float32 scratch `part`, offsets in floats.  One-block: the
// bias-gradient partials (plan, heads, N, kTmChunk).  Split: the groups'
// bias-gradient partials (groups, heads, N, N) padded to 4, the row
// statistics (B * nW, heads, N, 4), the dq partials (nk, B, Hp, Wp, C).
struct TmScratch {
  long long stats, dq, total;
};
static TmScratch tm_scratch(const TmGeom& g) {
  TmScratch s;
  if (tm_one_block(g.n, g.hd, true)) {
    s.stats = s.dq = s.total = (long long)g.plan * g.heads * g.n * kTmChunk;
    return s;
  }
  const long long groups = (g.total + g.plan - 1) / g.plan;
  s.stats = (groups * g.heads * g.n * g.n + 3) & ~3LL;
  s.dq = s.stats + (long long)g.total * g.heads * g.n * 4;
  s.total = s.dq + (long long)g.nk * g.total * g.n * g.C;
  return s;
}

template <int HD>
static cudaError_t tm_bwd(const void* qkv, const void* dctx, const void* bias, void* dqkv,
                          void* part, void* dbias, const TmGeom& g, cudaStream_t st) {
  cudaError_t e;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dctx);
  const float* b = static_cast<const float*>(bias);
  bf16* dq = static_cast<bf16*>(dqkv);
  float* p = static_cast<float*>(part);
  if constexpr (HD <= kTmBwdMaxHd) {
    if (tm_one_block(g.n, g.hd, true)) {
      const int smem = TmLayout<HD>(g.n, true, 1).total;
      auto kern = window_attention_bwd_tm_kernel<HD>;
      if ((e = tm_smem(kern, smem)) != cudaSuccess) return e;
      kern<<<g.plan * g.heads, 32 * ((g.n + 15) / 16), smem, st>>>(q, d, b, dq, p, g);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      dbias_sum_kernel<<<(g.heads * g.n * g.n + 31) / 32, dim3(32, 8), 0, st>>>(
          p, static_cast<float*>(dbias), g.plan, g.heads * g.n, g.n, kTmChunk);
      return cudaGetLastError();
    }
  }
  const int groups = (g.total + g.plan - 1) / g.plan;
  const TmScratch sc = tm_scratch(g);
  float* dbp = p;
  float* stats = p + sc.stats;
  float* dqp = p + sc.dq;
  {
    const int smem = 4 * kTsChunk * 2 * HD;
    auto kern = window_attention_rows_ts_kernel<HD, true>;
    if ((e = tm_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<dim3(g.total * g.nk, g.heads), kTsThreads, smem, st>>>(q, d, b, nullptr, stats, g);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  {
    const int smem = 4 * kTsChunk * 2 * HD + 2 * kTsChunk * kTsPS;
    auto kern = window_attention_bwd_ts_kernel<HD>;
    if ((e = tm_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<dim3(groups * g.nk, g.heads), kTsThreads, smem, st>>>(q, d, b, dq, dbp, stats, dqp, g);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const long long tokens = (long long)g.total * g.n;
  const long long blocks = (tokens * g.C + 255) / 256;
  tm_dq_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(dqp, dq, tokens, g.C,
                                                                       g.nk, g.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dbias_sum_kernel<<<(g.heads * g.n * g.n + 31) / 32, dim3(32, 8), 0, st>>>(
      dbp, static_cast<float*>(dbias), groups, g.heads * g.n, g.n, g.n);
  return cudaGetLastError();
}

// Head widths go to the template of the next of 16, 32, 64, 128; the
// columns past hd are zeros in shared memory and never stored.
cudaError_t tiled_mma_fwd(const void* qkv, const void* bias, void* out, int B, int Hp, int Wp,
                          int C, int heads, int wh, int ww, int sh, int sw, int plan,
                          cudaStream_t st) {
  const TmGeom g = tm_geom(B, Hp, Wp, C, heads, wh, ww, sh, sw, plan);
  if (g.hd <= 16) return tm_fwd<16>(qkv, bias, out, g, st);
  if (g.hd <= 32) return tm_fwd<32>(qkv, bias, out, g, st);
  if (g.hd <= 64) return tm_fwd<64>(qkv, bias, out, g, st);
  return tm_fwd<128>(qkv, bias, out, g, st);
}
cudaError_t tiled_mma_bwd(const void* qkv, const void* dctx, const void* bias, void* dqkv,
                          void* part, void* dbias, int B, int Hp, int Wp, int C, int heads, int wh,
                          int ww, int sh, int sw, int plan, cudaStream_t st) {
  const TmGeom g = tm_geom(B, Hp, Wp, C, heads, wh, ww, sh, sw, plan);
  if (g.hd <= 16) return tm_bwd<16>(qkv, dctx, bias, dqkv, part, dbias, g, st);
  if (g.hd <= 32) return tm_bwd<32>(qkv, dctx, bias, dqkv, part, dbias, g, st);
  if (g.hd <= 64) return tm_bwd<64>(qkv, dctx, bias, dqkv, part, dbias, g, st);
  return tm_bwd<128>(qkv, dctx, bias, dqkv, part, dbias, g, st);
}
long long tiled_mma_bwd_scratch(int B, int Hp, int Wp, int C, int heads, int wh, int ww,
                                int plan) {
  return tm_scratch(tm_geom(B, Hp, Wp, C, heads, wh, ww, 0, 0, plan)).total;
}

}  // namespace ssa
