// GroupNorm(G) + ReLU on NHWC float32, forward and backward (kernels D-G).
//
// Replaces the TPU kernels of dorpatch_tpu/ops/fused_gn.py:
//   D  _fwd_kernel (:115), launched by _pallas_fwd (:237)
//   E  _fwd_stats_kernel (:159) + _fwd_apply_kernel (:179), _pallas_fwd_tiled (:191)
//   F  _bwd_kernel (:135), launched by _pallas_bwd (:387)
//   G  _bwd_stats_kernel (:278) + _bwd_dx_kernel (:313), _pallas_bwd_tiled (:330)
//
// Forward, per sample n and group g over x [N, HW, C] (channels of a group
// contiguous, cg = C / G of them):
//   mean = E[x], var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps)
//   y    = max((x - mean) * (rstd * scale) + bias, 0)
// and the [N, G] mean and rstd are written for the backward.
// Backward, with xhat = (x - mean) * rstd and dyr = dy where xhat*scale+bias > 0:
//   db_c = sum_hw dyr, ds_c = sum_hw dyr*xhat             (per sample, channel)
//   a_g = sum_{c in g} scale_c*db_c, b_g = sum_{c in g} scale_c*ds_c
//   dx  = rstd * (dyr*scale - (a_g + xhat*b_g) / (HW*cg))
//   dscale = sum_n ds_c, dbias = sum_n db_c                 (only when asked)
//
// What bounds it on this card: bytes. Each direction does a few flops per
// element; the forward must read x and write y, the backward read x and dy and
// write dx. The TPU kernels keep a whole [HW, C] slab in VMEM (or carry sums
// across a sequential grid of HW tiles); a per-sample slab of RN50 reaches
// 56*56*256 floats = 3.2 MB, far above a block's 227 KB of shared memory, and
// CUDA blocks carry nothing between them. So both directions are split, the
// normal route on this card:
//   1. a statistics pass, grid (sample, HW tile of kTileRows rows, chunk of
//      up to 256 channels): each thread owns one float4 column (four channels),
//      sums its rows in f32, the block adds its thread rows in a fixed order
//      and writes per-channel partial sums [N, T, C];
//   2. a combine pass, one warp per (sample, group): adds the partials over
//      tiles and channels in a fixed order, in float64, to the group
//      statistics (forward) or to db_c, ds_c, a_g, b_g (backward);
//   3. an elementwise pass over NHWC, 16 bytes a thread: y (forward) or dx
//      (backward), recomputing xhat and the ReLU gate from the saved [N, G]
//      statistics.
// The forward reads x twice and the backward x and dy twice: one slab pass
// more than the bound, the price of the split. No float atomics anywhere, so
// every result is the same from run to run.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;     // HW rows per statistics block
constexpr int kMaxCols4 = 64;     // float4 columns (256 channels) per stats block
constexpr int kMaxGrid = 65535;
constexpr int kWarps = kThreads / 32;   // (sample, group) pairs per combine block

__device__ __forceinline__ float4 f4(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// --------------------------------------------------------------- forward

// Per-channel partial sums of x and x*x over one HW tile of one sample.
__global__ void __launch_bounds__(kThreads)
gn_fwd_stats(const float* __restrict__ x, float* __restrict__ p1,
             float* __restrict__ p2, int HW, int C) {
  __shared__ float4 sh1[kThreads];
  __shared__ float4 sh2[kThreads];
  const int C4 = C / 4;
  const int n = blockIdx.x;
  const int t = blockIdx.y;
  const int c4 = blockIdx.z * blockDim.x + threadIdx.x;
  const int r0 = t * kTileRows;
  const int r1 = min(HW, r0 + kTileRows);
  float4 a1 = f4(0.f), a2 = f4(0.f);
  if (c4 < C4) {
    const float4* xs = reinterpret_cast<const float4*>(x + (size_t)n * HW * C) + c4;
#pragma unroll 4
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const float4 v = __ldg(xs + (size_t)r * C4);
      a1 = add4(a1, v);
      a2.x = fmaf(v.x, v.x, a2.x);
      a2.y = fmaf(v.y, v.y, a2.y);
      a2.z = fmaf(v.z, v.z, a2.z);
      a2.w = fmaf(v.w, v.w, a2.w);
    }
  }
  const int slot = threadIdx.y * blockDim.x + threadIdx.x;
  sh1[slot] = a1;
  sh2[slot] = a2;
  __syncthreads();
  if (threadIdx.y == 0 && c4 < C4) {
    float4 s1 = sh1[threadIdx.x], s2 = sh2[threadIdx.x];
    for (int j = 1; j < blockDim.y; ++j) {
      s1 = add4(s1, sh1[j * blockDim.x + threadIdx.x]);
      s2 = add4(s2, sh2[j * blockDim.x + threadIdx.x]);
    }
    const size_t o = ((size_t)n * gridDim.y + t) * C4 + c4;
    reinterpret_cast<float4*>(p1)[o] = s1;
    reinterpret_cast<float4*>(p2)[o] = s2;
  }
}

// Sum of a double over the 32 lanes of a warp, in a fixed butterfly order.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One warp per (sample, group): the group's mean and rstd. The lanes stride
// over the group's T*cg partials, then add their sums in a fixed order.
__global__ void __launch_bounds__(kThreads)
gn_fwd_combine(const float* __restrict__ p1, const float* __restrict__ p2,
               float* __restrict__ mean, float* __restrict__ rstd, int N,
               int T, int HW, int C, int G, float eps) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N * G) return;   // whole warps
  const int n = i / G;
  const int g = i - n * G;
  const int cg = C / G;
  double s1 = 0.0, s2 = 0.0;
  for (int k = lane; k < T * cg; k += 32) {
    const int t = k / cg;
    const size_t o = ((size_t)n * T + t) * C + (size_t)g * cg + (k - t * cg);
    s1 += (double)p1[o];
    s2 += (double)p2[o];
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const double cnt = (double)HW * cg;
    const double m = s1 / cnt;
    const double var = fmax(s2 / cnt - m * m, 0.0);
    mean[i] = (float)m;
    rstd[i] = (float)(1.0 / sqrt(var + (double)eps));
  }
}

__device__ __forceinline__ float gn_relu1(float v, float m, float rs, float s,
                                          float b) {
  return fmaxf((v - m) * (rs * s) + b, 0.f);
}

// y = relu((x - mean) * (rstd * scale) + bias), 16 bytes a thread.
__global__ void __launch_bounds__(kThreads)
gn_fwd_apply(const float* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, const float* __restrict__ mean,
             const float* __restrict__ rstd, float* __restrict__ y, int HW,
             int C, int G) {
  const int n = blockIdx.y;
  const int C4 = C / 4;
  const int cg = C / G;
  const size_t per = (size_t)HW * C4;
  const float4* xs = reinterpret_cast<const float4*>(x + (size_t)n * HW * C);
  float4* ys = reinterpret_cast<float4*>(y + (size_t)n * HW * C);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* b4 = reinterpret_cast<const float4*>(bias);
  const float* mn = mean + (size_t)n * G;
  const float* rs = rstd + (size_t)n * G;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < per;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c4 = (int)(i % C4);
    const int c = 4 * c4;
    const float4 v = __ldg(xs + i);
    const float4 s = __ldg(s4 + c4);
    const float4 b = __ldg(b4 + c4);
    const int g0 = c / cg, g1 = (c + 1) / cg, g2 = (c + 2) / cg, g3 = (c + 3) / cg;
    float4 o;
    o.x = gn_relu1(v.x, __ldg(mn + g0), __ldg(rs + g0), s.x, b.x);
    o.y = gn_relu1(v.y, __ldg(mn + g1), __ldg(rs + g1), s.y, b.y);
    o.z = gn_relu1(v.z, __ldg(mn + g2), __ldg(rs + g2), s.z, b.z);
    o.w = gn_relu1(v.w, __ldg(mn + g3), __ldg(rs + g3), s.w, b.w);
    ys[i] = o;
  }
}

// -------------------------------------------------------------- backward

struct Col4 {   // one float4 column's statistics and affine parameters
  float4 m, r, s, b;
};

__device__ __forceinline__ Col4 load_col(const float* mn, const float* rs,
                                         const float* scale, const float* bias,
                                         int c4, int cg) {
  const int c = 4 * c4;
  const int g0 = c / cg, g1 = (c + 1) / cg, g2 = (c + 2) / cg, g3 = (c + 3) / cg;
  Col4 col;
  col.m = make_float4(__ldg(mn + g0), __ldg(mn + g1), __ldg(mn + g2), __ldg(mn + g3));
  col.r = make_float4(__ldg(rs + g0), __ldg(rs + g1), __ldg(rs + g2), __ldg(rs + g3));
  col.s = __ldg(reinterpret_cast<const float4*>(scale) + c4);
  col.b = __ldg(reinterpret_cast<const float4*>(bias) + c4);
  return col;
}

// xhat and the gated cotangent of one element.
__device__ __forceinline__ void gate1(float v, float d, float m, float r, float s,
                                      float b, float& xh, float& dr) {
  xh = (v - m) * r;
  dr = (xh * s + b > 0.f) ? d : 0.f;
}

// Per-channel partial sums of dyr and dyr*xhat over one HW tile of one sample.
__global__ void __launch_bounds__(kThreads)
gn_bwd_stats(const float* __restrict__ x, const float* __restrict__ dy,
             const float* __restrict__ scale, const float* __restrict__ bias,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             float* __restrict__ pdb, float* __restrict__ pds, int HW, int C,
             int G) {
  __shared__ float4 sh1[kThreads];
  __shared__ float4 sh2[kThreads];
  const int C4 = C / 4;
  const int n = blockIdx.x;
  const int t = blockIdx.y;
  const int c4 = blockIdx.z * blockDim.x + threadIdx.x;
  const int r0 = t * kTileRows;
  const int r1 = min(HW, r0 + kTileRows);
  float4 adb = f4(0.f), ads = f4(0.f);
  if (c4 < C4) {
    const Col4 col = load_col(mean + (size_t)n * G, rstd + (size_t)n * G, scale,
                              bias, c4, C / G);
    const size_t off = (size_t)n * HW * C;
    const float4* xs = reinterpret_cast<const float4*>(x + off) + c4;
    const float4* ds = reinterpret_cast<const float4*>(dy + off) + c4;
#pragma unroll 4
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const float4 v = __ldg(xs + (size_t)r * C4);
      const float4 d = __ldg(ds + (size_t)r * C4);
      float xh, dr;
      gate1(v.x, d.x, col.m.x, col.r.x, col.s.x, col.b.x, xh, dr);
      adb.x += dr;
      ads.x = fmaf(dr, xh, ads.x);
      gate1(v.y, d.y, col.m.y, col.r.y, col.s.y, col.b.y, xh, dr);
      adb.y += dr;
      ads.y = fmaf(dr, xh, ads.y);
      gate1(v.z, d.z, col.m.z, col.r.z, col.s.z, col.b.z, xh, dr);
      adb.z += dr;
      ads.z = fmaf(dr, xh, ads.z);
      gate1(v.w, d.w, col.m.w, col.r.w, col.s.w, col.b.w, xh, dr);
      adb.w += dr;
      ads.w = fmaf(dr, xh, ads.w);
    }
  }
  const int slot = threadIdx.y * blockDim.x + threadIdx.x;
  sh1[slot] = adb;
  sh2[slot] = ads;
  __syncthreads();
  if (threadIdx.y == 0 && c4 < C4) {
    float4 s1 = sh1[threadIdx.x], s2 = sh2[threadIdx.x];
    for (int j = 1; j < blockDim.y; ++j) {
      s1 = add4(s1, sh1[j * blockDim.x + threadIdx.x]);
      s2 = add4(s2, sh2[j * blockDim.x + threadIdx.x]);
    }
    const size_t o = ((size_t)n * gridDim.y + t) * C4 + c4;
    reinterpret_cast<float4*>(pdb)[o] = s1;
    reinterpret_cast<float4*>(pds)[o] = s2;
  }
}

// One warp per (sample, group): each lane sums its channels' partials over
// the tiles to db_c, ds_c, then the lanes add scale_c*db_c and scale_c*ds_c
// in a fixed order to a_g, b_g.
__global__ void __launch_bounds__(kThreads)
gn_bwd_combine(const float* __restrict__ pdb, const float* __restrict__ pds,
               const float* __restrict__ scale, float* __restrict__ dbc,
               float* __restrict__ dsc, float* __restrict__ ag,
               float* __restrict__ bg, int N, int T, int C, int G) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= N * G) return;   // whole warps
  const int n = i / G;
  const int g = i - n * G;
  const int cg = C / G;
  double a = 0.0, b = 0.0;
  for (int j = lane; j < cg; j += 32) {
    const int c = g * cg + j;
    double db = 0.0, ds = 0.0;
    for (int t = 0; t < T; ++t) {
      const size_t o = ((size_t)n * T + t) * C + c;
      db += (double)pdb[o];
      ds += (double)pds[o];
    }
    dbc[(size_t)n * C + c] = (float)db;
    dsc[(size_t)n * C + c] = (float)ds;
    const double s = (double)scale[c];
    a += s * db;
    b += s * ds;
  }
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    ag[i] = (float)a;
    bg[i] = (float)b;
  }
}

__device__ __forceinline__ float dx1(float v, float d, float m, float r, float s,
                                     float b, float a_g, float b_g, float cnt) {
  float xh, dr;
  gate1(v, d, m, r, s, b, xh, dr);
  return r * (dr * s - (a_g + xh * b_g) / cnt);
}

// dx, 16 bytes a thread.
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx(const float* __restrict__ x, const float* __restrict__ dy,
          const float* __restrict__ scale, const float* __restrict__ bias,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float* __restrict__ ag, const float* __restrict__ bg,
          float* __restrict__ dx, int HW, int C, int G) {
  const int n = blockIdx.y;
  const int C4 = C / 4;
  const int cg = C / G;
  const float cnt = (float)HW * (float)cg;
  const size_t per = (size_t)HW * C4;
  const size_t off = (size_t)n * HW * C;
  const float4* xs = reinterpret_cast<const float4*>(x + off);
  const float4* ds = reinterpret_cast<const float4*>(dy + off);
  float4* out = reinterpret_cast<float4*>(dx + off);
  const float* mn = mean + (size_t)n * G;
  const float* rs = rstd + (size_t)n * G;
  const float* an = ag + (size_t)n * G;
  const float* bn = bg + (size_t)n * G;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < per;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c4 = (int)(i % C4);
    const int c = 4 * c4;
    const Col4 col = load_col(mn, rs, scale, bias, c4, cg);
    const int g0 = c / cg, g1 = (c + 1) / cg, g2 = (c + 2) / cg, g3 = (c + 3) / cg;
    const float4 v = __ldg(xs + i);
    const float4 d = __ldg(ds + i);
    float4 o;
    o.x = dx1(v.x, d.x, col.m.x, col.r.x, col.s.x, col.b.x, __ldg(an + g0), __ldg(bn + g0), cnt);
    o.y = dx1(v.y, d.y, col.m.y, col.r.y, col.s.y, col.b.y, __ldg(an + g1), __ldg(bn + g1), cnt);
    o.z = dx1(v.z, d.z, col.m.z, col.r.z, col.s.z, col.b.z, __ldg(an + g2), __ldg(bn + g2), cnt);
    o.w = dx1(v.w, d.w, col.m.w, col.r.w, col.s.w, col.b.w, __ldg(an + g3), __ldg(bn + g3), cnt);
    out[i] = o;
  }
}

// dscale = sum_n ds_c, dbias = sum_n db_c, one thread per channel, in order.
__global__ void gn_param_sums(const float* __restrict__ dsc,
                              const float* __restrict__ dbc,
                              float* __restrict__ dscale,
                              float* __restrict__ dbias, int N, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double s = 0.0, b = 0.0;
  for (int n = 0; n < N; ++n) {
    s += (double)dsc[(size_t)n * C + c];
    b += (double)dbc[(size_t)n * C + c];
  }
  dscale[c] = (float)s;
  dbias[c] = (float)b;
}

// Launch shapes shared by both directions.
struct Shape {
  dim3 stats_grid, stats_block, apply_grid;
  int tiles;
};

int tiles_of(int HW) { return (HW + kTileRows - 1) / kTileRows; }

bool plan(int N, int HW, int C, int G, Shape* sh) {
  if (N < 1 || HW < 1 || C < 4 || C % 4 || G < 1 || C % G) return false;
  const int C4 = C / 4;
  const int cols4 = C4 < kMaxCols4 ? C4 : kMaxCols4;
  const int tiles = tiles_of(HW);
  const int chunks = (C4 + cols4 - 1) / cols4;
  if (N > kMaxGrid || tiles > kMaxGrid) return false;
  const size_t per = (size_t)HW * C4;
  size_t blocks = (per + kThreads - 1) / kThreads;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  sh->stats_grid = dim3(N, tiles, chunks);
  sh->stats_block = dim3(cols4, kThreads / cols4);
  sh->apply_grid = dim3((unsigned)blocks, N);
  sh->tiles = tiles;
  return true;
}

}  // namespace

extern "C" {

// T, the HW-tile count that sizes the [N,T,C] scratch of both directions.
int dp_gn_tiles(int HW) { return HW < 1 ? 0 : tiles_of(HW); }

// Forward. x, y [N,HW,C]; scale, bias [C]; mean, rstd [N,G]; p1, p2 scratch
// [N,T,C] with T = dp_gn_tiles(HW). All f32, contiguous, on the current
// device; C a multiple of 4 and of G, pointers 16-byte aligned (the caller
// checks).
int dp_gn_relu_fwd(const float* x, const float* scale, const float* bias,
                   float* y, float* mean, float* rstd, float* p1, float* p2,
                   int N, int HW, int C, int G, float eps, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  Shape sh;
  if (!plan(N, HW, C, G, &sh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  gn_fwd_stats<<<sh.stats_grid, sh.stats_block, 0, st>>>(x, p1, p2, HW, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ng = N * G;
  gn_fwd_combine<<<(ng + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      p1, p2, mean, rstd, N, sh.tiles, HW, C, G, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_fwd_apply<<<sh.apply_grid, kThreads, 0, st>>>(x, scale, bias, mean, rstd,
                                                   y, HW, C, G);
  return (int)cudaGetLastError();
}

// Backward. x, dy, dx [N,HW,C]; mean, rstd [N,G] from the forward; scratch
// pdb, pds [N,T,C], dbc, dsc [N,C], ag, bg [N,G]; dscale, dbias [C] or both
// null (then the parameter cotangents are not summed).
int dp_gn_relu_bwd(const float* x, const float* dy, const float* scale,
                   const float* bias, const float* mean, const float* rstd,
                   float* dx, float* pdb, float* pds, float* dbc, float* dsc,
                   float* ag, float* bg, float* dscale, float* dbias, int N,
                   int HW, int C, int G, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  Shape sh;
  if (!plan(N, HW, C, G, &sh)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  gn_bwd_stats<<<sh.stats_grid, sh.stats_block, 0, st>>>(
      x, dy, scale, bias, mean, rstd, pdb, pds, HW, C, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int ng = N * G;
  gn_bwd_combine<<<(ng + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      pdb, pds, scale, dbc, dsc, ag, bg, N, sh.tiles, C, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_dx<<<sh.apply_grid, kThreads, 0, st>>>(x, dy, scale, bias, mean, rstd,
                                                ag, bg, dx, HW, C, G);
  err = cudaGetLastError();
  if (err != cudaSuccess || dscale == nullptr || dbias == nullptr)
    return (int)err;
  gn_param_sums<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      dsc, dbc, dscale, dbias, N, C);
  return (int)cudaGetLastError();
}

}  // extern "C"
