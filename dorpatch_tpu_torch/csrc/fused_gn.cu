// GroupNorm(G) + ReLU on NHWC float32 or bf16, forward and backward
// (kernels D-G).
//
// Replaces the TPU kernels of dorpatch_tpu/ops/fused_gn.py:
//   one-pass route (whole groups staged on chip, each slab read once):
//     D  _fwd_kernel (:115), launched by _pallas_fwd (:237)
//     F  _bwd_kernel (:135), launched by _pallas_bwd (:387)
//   split route (slabs whose chunk does not fit, the JAX package's tiled
//   plan):
//     E  _fwd_stats_kernel (:159) + _fwd_apply_kernel (:179), _pallas_fwd_tiled (:191)
//     G  _bwd_stats_kernel (:278) + _bwd_dx_kernel (:313), _pallas_bwd_tiled (:330)
// ops/fused_gn.py `gn_plan` picks the route from the shape and passes it in.
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
// What bounds it on this card: bytes, in both directions. Each does a few
// flops per element; the forward must read x and write y (2 slabs), the
// backward read x and dy and write dx (3 slabs). A group's statistics need
// both passes over its elements, so a design that cannot hold a group on
// chip reads its slabs twice.
//
// One-pass route (the normal route: every RN50 shape at 224 takes it, and
// at 480 px all but the backward of the 14400-row stage-1 slabs). A
// per-sample slab (3.2 MB at 56*56*256) exceeds a block's 227 KB, but one
// group's [HW, cg] columns do not: a block stages a chunk of whole groups,
// `W` channels of one sample ([HW, W] of x, and of dy in the backward), in
// shared memory, so each slab is read from device memory once and written
// once, in one launch:
//   - grid (cluster * C/W, N); each thread copies its 16-byte pieces of the
//     chunk with cp.async in kStages commit groups and reduces each group
//     of pieces as it lands, while the later ones are still in flight. A
//     thread's pieces all lie in one float4 column (four channels), so its
//     partial sums need no barrier until the block adds them;
//   - the block adds the threads' f32 partials per channel in float64, in
//     a fixed order (a warp per channel and a fixed butterfly, or a thread
//     per channel when a column has few threads), then the
//     channels per group: the forward's sum x and sum x^2, the backward's
//     db_c, ds_c, a_g and b_g;
//   - the same thread then writes y (or dx) of its pieces from shared
//     memory, 16 bytes a store, and rank 0 writes the [N, G] mean/rstd
//     (forward) or the [N, C] db_c/ds_c (backward, only when the parameter
//     cotangents are asked for);
//   - a chunk too tall for one block is split over its HW rows between the
//     CTAs of a thread-block cluster (up to kMaxCluster); each CTA stages
//     its rows and the CTAs add their float64 channel partials through
//     distributed shared memory, in rank order, so every CTA holds the same
//     totals.
//   `W` (ops/fused_gn.py one_pass_width) takes whole groups, rows of at
//   least 32 bytes (C = 64 has cg = 2, so 4 groups a chunk), widened toward
//   256-byte rows while one CTA still fits: an L2 line is 128 bytes, and a
//   narrow row costs a request per few bytes. The backward keeps two CTAs
//   an SM (its [3136, 256] chunk of one group, 200 KB of x and dy, over a
//   cluster of two); the forward takes one wide chunk an SM. With the
//   parameter cotangents, gn_param_sums adds db_c and ds_c over N in a
//   second, small launch.
// Split route, for slabs whose chunk fits no cluster (RN50 at 480 px: the
// backward at [N, 14400, 64/128/256], 11 of the 49 calls). Both directions
// take a statistics pass over thread-block clusters that also adds the
// sums up (no partial-sum scratch and no combine launch), then write their
// output by piece column, each thread with its column's coefficients in
// registers:
//   forward (E; see gn_fwd_split below): the group mean and rstd, then y
//   in the same launch, each CTA reading its rows again;
//   backward (G; see gn_bwd_stats below): db_c, ds_c and the [N, G] group
//   sums a_g, b_g, then dx.
// Both read x (and dy) twice: one slab pass more than the bound.
// No float atomics on either route, so every result is the same from run
// to run.
//
// bf16 (the bf16 attack's and the bf16 certify bank's RN50 activations):
// the kernels of both routes that touch activations are templated on their
// type (`Piece`). A 16-byte piece then holds 8 channels, so a thread owns
// an 8-channel column and a chunk row of W channels is W/8 pieces; the
// staged slab is half the bytes, and `gn_plan` widens chunks by the element
// size. Statistics, affine parameters, mean/rstd and the parameter
// cotangents stay float32 (float64 where they are
// added up, as above), and the ReLU gate is taken on the float32
// pre-activation; y and dx are normalized in float32 and rounded to bf16
// once, at their store, on either route, so the two routes compute the
// same function.

#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 65535;

__device__ __forceinline__ float4 f4(float v) { return make_float4(v, v, v, v); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

// The element types. A 16-byte piece holds P channels of one row: 4 floats,
// or 8 bf16 values. A thread's values, partial sums and per-channel
// parameters of its piece column are a vector V of P floats: float4, or
// float8 (two float4s) for bf16, whose operations are the float4 ones
// twice, so the float32 kernels are the float4 code they were before bf16.
// Pieces are widened to V in registers as they are read; every sum,
// statistic and output value is float32 (float64 where blocks' sums are
// added), and a bf16 output is rounded once, at its store
// (__float2bfloat16, to nearest).
struct float8 {
  float4 lo, hi;
};

__device__ __forceinline__ float8 add4(float8 a, float8 b) {
  return {add4(a.lo, b.lo), add4(a.hi, b.hi)};
}
__device__ __forceinline__ float8 fma4(float8 a, float8 b, float8 c) {
  return {fma4(a.lo, b.lo, c.lo), fma4(a.hi, b.hi, c.hi)};
}
__device__ __forceinline__ float8 mul4(float8 a, float8 b) {
  return {mul4(a.lo, b.lo), mul4(a.hi, b.hi)};
}

template <typename T> struct Piece;
template <> struct Piece<float> {
  using V = float4;
  static constexpr int P = 4;
  __device__ static __forceinline__ V zero() { return f4(0.f); }
  __device__ static __forceinline__ V widen(float4 v) { return v; }
  __device__ static __forceinline__ float4 narrow(V v) { return v; }
};
template <> struct Piece<__nv_bfloat16> {
  using V = float8;
  static constexpr int P = 8;
  __device__ static __forceinline__ V zero() { return {f4(0.f), f4(0.f)}; }
  __device__ static __forceinline__ V widen(float4 v) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
    return {make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                        __bfloat162float(h[2]), __bfloat162float(h[3])),
            make_float4(__bfloat162float(h[4]), __bfloat162float(h[5]),
                        __bfloat162float(h[6]), __bfloat162float(h[7]))};
  }
  __device__ static __forceinline__ float4 narrow(V v) {
    float4 o;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&o);
    h[0] = __float2bfloat16(v.lo.x);
    h[1] = __float2bfloat16(v.lo.y);
    h[2] = __float2bfloat16(v.lo.z);
    h[3] = __float2bfloat16(v.lo.w);
    h[4] = __float2bfloat16(v.hi.x);
    h[5] = __float2bfloat16(v.hi.y);
    h[6] = __float2bfloat16(v.hi.z);
    h[7] = __float2bfloat16(v.hi.w);
    return o;
  }
};

// A column's P parameters from a [C] float32 array, 16 bytes a load.
__device__ __forceinline__ void load_vec(const float* p, int col, float4& v) {
  v = __ldg(reinterpret_cast<const float4*>(p) + col);
}
__device__ __forceinline__ void load_vec(const float* p, int col, float8& v) {
  load_vec(p, 2 * col, v.lo);
  load_vec(p, 2 * col + 1, v.hi);
}

// base[g] of the groups of channels c, c+1, ... (cg channels a group).
__device__ __forceinline__ void gather(const float* base, int c, int cg,
                                       float4& v) {
  const int g0 = c / cg, g1 = (c + 1) / cg, g2 = (c + 2) / cg, g3 = (c + 3) / cg;
  v = make_float4(base[g0], base[g1], base[g2], base[g3]);
}
__device__ __forceinline__ void gather(const float* base, int c, int cg,
                                       float8& v) {
  gather(base, c, cg, v.lo);
  gather(base, c + 4, cg, v.hi);
}

// Sum of a double over the 32 lanes of a warp, in a fixed butterfly order.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// One piece column's statistics and affine parameters (Col4 for float4).
struct Col8 {
  Col4 lo, hi;
};

__device__ __forceinline__ void load_colv(const float* mn, const float* rs,
                                          const float* scale, const float* bias,
                                          int cp, int cg, Col4& col) {
  col = load_col(mn, rs, scale, bias, cp, cg);
}
__device__ __forceinline__ void load_colv(const float* mn, const float* rs,
                                          const float* scale, const float* bias,
                                          int cp, int cg, Col8& col) {
  col.lo = load_col(mn, rs, scale, bias, 2 * cp, cg);
  col.hi = load_col(mn, rs, scale, bias, 2 * cp + 1, cg);
}

template <typename V> struct ColOf;
template <> struct ColOf<float4> { using type = Col4; };
template <> struct ColOf<float8> { using type = Col8; };

// The backward's gated sums of one piece: db += dyr, ds += dyr * xhat.
__device__ __forceinline__ void gate_acc(float4 v, float4 d, const Col4& col,
                                         float4& adb, float4& ads) {
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
__device__ __forceinline__ void gate_acc(float8 v, float8 d, const Col8& col,
                                         float8& adb, float8& ads) {
  gate_acc(v.lo, d.lo, col.lo, adb.lo, ads.lo);
  gate_acc(v.hi, d.hi, col.hi, adb.hi, ads.hi);
}

// dx of one element with a_g and b_g already divided by the count (one
// division per group instead of one per element).
__device__ __forceinline__ float dx_scaled(float v, float d, float m, float r,
                                           float s, float b, float a_n,
                                           float b_n) {
  float xh, dr;
  gate1(v, d, m, r, s, b, xh, dr);
  return r * (dr * s - (a_n + xh * b_n));
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

// ------------------------------------------------ one-pass route (D, F)

namespace coop = cooperative_groups;

constexpr int kOneThreads = 256;
constexpr int kStages = 4;        // cp.async groups of a thread's pieces
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxSmem = 232448;  // dynamic shared memory of a block
constexpr int kSerialSum = 16;    // threads a column at most for a serial sum

// relu((v - m) * mul + b), the forward's output.
__device__ __forceinline__ float4 relu_affine(float4 v, float4 m, float4 mul,
                                              float4 b) {
  float4 o;
  o.x = fmaxf((v.x - m.x) * mul.x + b.x, 0.f);
  o.y = fmaxf((v.y - m.y) * mul.y + b.y, 0.f);
  o.z = fmaxf((v.z - m.z) * mul.z + b.z, 0.f);
  o.w = fmaxf((v.w - m.w) * mul.w + b.w, 0.f);
  return o;
}
__device__ __forceinline__ float8 relu_affine(float8 v, float8 m, float8 mul,
                                              float8 b) {
  return {relu_affine(v.lo, m.lo, mul.lo, b.lo),
          relu_affine(v.hi, m.hi, mul.hi, b.hi)};
}

// dx of one piece, a_g and b_g already divided by the count.
__device__ __forceinline__ float4 dx_vec(float4 v, float4 d, const Col4& col,
                                         float4 ag, float4 bg) {
  float4 o;
  o.x = dx_scaled(v.x, d.x, col.m.x, col.r.x, col.s.x, col.b.x, ag.x, bg.x);
  o.y = dx_scaled(v.y, d.y, col.m.y, col.r.y, col.s.y, col.b.y, ag.y, bg.y);
  o.z = dx_scaled(v.z, d.z, col.m.z, col.r.z, col.s.z, col.b.z, ag.z, bg.z);
  o.w = dx_scaled(v.w, d.w, col.m.w, col.r.w, col.s.w, col.b.w, ag.w, bg.w);
  return o;
}
__device__ __forceinline__ float8 dx_vec(float8 v, float8 d, const Col8& col,
                                         float8 ag, float8 bg) {
  return {dx_vec(v.lo, d.lo, col.lo, ag.lo, bg.lo),
          dx_vec(v.hi, d.hi, col.hi, ag.hi, bg.hi)};
}

// A 16-byte copy to shared memory that leaves L1 alone and asks L2 to fetch
// the whole 128-byte line: a narrow chunk's row is a part of a line whose
// other parts the neighbouring chunks' CTAs read at about the same time.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Where a CTA's chunk lies and which pieces its thread owns. Piece p of the
// CTA's [rows, W] block is row p / WP, piece column p % WP (WP = W / P
// pieces a row); thread t owns p = t + j * active for j < count, all in
// column t % WP (active is a multiple of WP).
struct Chunk {
  int n, chunk, rank, rows, r0, WP, active, col, count;
};

template <int P>
__device__ __forceinline__ Chunk chunk_of(int HW, int W, int cl) {
  Chunk k;
  k.WP = W / P;
  k.active = (kOneThreads / k.WP) * k.WP;
  k.rank = blockIdx.x % cl;
  k.chunk = blockIdx.x / cl;
  k.n = blockIdx.y;
  k.rows = (HW + cl - 1) / cl;
  k.r0 = min(HW, k.rank * k.rows);
  const int pieces = (min(HW, k.r0 + k.rows) - k.r0) * k.WP;
  const int t = threadIdx.x;
  k.col = t % k.WP;
  k.count = (t < k.active && t < pieces) ? (pieces - 1 - t) / k.active + 1 : 0;
  return k;
}

__device__ __forceinline__ int stage_begin(const Chunk& k, int s) {
  return s * k.count / kStages;
}

// Issues this thread's pieces of stage s from src (the chunk's first row in
// device memory, CP pieces a row) to dst (the staged slab).
__device__ __forceinline__ void issue_stage(const Chunk& k, int s, float4* dst,
                                            const float4* src, int CP) {
  for (int j = stage_begin(k, s); j < stage_begin(k, s + 1); ++j) {
    const int p = threadIdx.x + j * k.active;
    cp_async16(dst + p, src + (size_t)(p / k.WP) * CP + k.col);
  }
}

// Dynamic shared memory of a one-pass CTA (ops/fused_gn.py one_pass_smem):
// the staged slabs, the threads' partials (two V of P floats), the channel
// sums of this CTA and of the chunk (float64), the per-group values.
__host__ __device__ inline size_t onepass_smem(int HW, int W, int cl, int slabs,
                                               int P) {
  const size_t rows = (size_t)(HW + cl - 1) / cl;
  return rows * W * (16 / P) * slabs + (size_t)kOneThreads * 8 * P +
         (size_t)W * 40;
}

template <typename V>
struct Smem {
  float4* stage;   // [slabs][rows * WP]
  V* red;          // [kOneThreads][2]
  double* chan;    // [2][W]
  double* tot;     // [2][W]
  float* grp;      // [2][W / cg]
};

template <typename V>
__device__ __forceinline__ Smem<V> carve(unsigned char* base, const Chunk& k,
                                         int W, int slabs) {
  Smem<V> s;
  s.stage = reinterpret_cast<float4*>(base);
  s.red = reinterpret_cast<V*>(s.stage + (size_t)slabs * k.rows * k.WP);
  s.chan = reinterpret_cast<double*>(s.red + 2 * kOneThreads);
  s.tot = s.chan + 2 * W;
  s.grp = reinterpret_cast<float*>(s.tot + 2 * W);
  return s;
}

// The chunk's per-channel sums of two per-thread partials (a, b), in
// float64 and a fixed order, into sm.tot[0, W) and sm.tot[W, 2W). With a
// cluster, every CTA adds the CTAs' sums in rank order, so all hold the same
// totals. Ends with the block (and cluster) synchronized.
template <typename V, int P>
__device__ __forceinline__ void channel_sums(const Chunk& k, int W, int cl,
                                             V a, V b, const Smem<V>& sm) {
  sm.red[2 * threadIdx.x] = a;
  sm.red[2 * threadIdx.x + 1] = b;
  __syncthreads();
  const int per = k.active / k.WP;   // threads per piece column
  double* own = cl == 1 ? sm.tot : sm.chan;
  // channel j's partials are component j % P of threads j / P + m * WP
  constexpr int kShift = P == 4 ? 2 : 3;
  auto part = [&](int j, int m, int which) {
    return (double)reinterpret_cast<const float*>(
        sm.red + 2 * ((j >> kShift) + m * k.WP) + which)[j & (P - 1)];
  };
  if (per <= kSerialSum) {   // wide chunk: a thread per channel
    for (int j = threadIdx.x; j < W; j += kOneThreads) {
      double s1 = 0.0, s2 = 0.0;
      for (int m = 0; m < per; ++m) {
        s1 += part(j, m, 0);
        s2 += part(j, m, 1);
      }
      own[j] = s1;
      own[W + j] = s2;
    }
  } else {                   // narrow chunk: a warp per channel
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = warp; j < W; j += kOneThreads / 32) {
      double s1 = 0.0, s2 = 0.0;
      for (int m = lane; m < per; m += 32) {
        s1 += part(j, m, 0);
        s2 += part(j, m, 1);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        own[j] = s1;
        own[W + j] = s2;
      }
    }
  }
  if (cl == 1) {
    __syncthreads();
    return;
  }
  coop::cluster_group cluster = coop::this_cluster();
  cluster.sync();
  for (int i = threadIdx.x; i < 2 * W; i += kOneThreads) {
    double s = 0.0;
    for (int r = 0; r < cl; ++r) s += cluster.map_shared_rank(sm.chan, r)[i];
    sm.tot[i] = s;
  }
  cluster.sync();   // no CTA leaves while another still reads its sums
}

// Forward, one CTA per (chunk of W channels, cluster rank, sample). T is
// the type of x and y; scale, bias, mean and rstd are float32.
template <typename T>
__global__ void __launch_bounds__(kOneThreads)
gn_fwd_onepass(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ y,
               float* __restrict__ mean, float* __restrict__ rstd, int HW,
               int C, int G, int W, int cl, float eps) {
  using Pc = Piece<T>;
  using V = typename Pc::V;
  constexpr int P = Pc::P;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk k = chunk_of<P>(HW, W, cl);
  const Smem<V> sm = carve<V>(smem, k, W, 1);
  const int CP = C / P;
  const int c0 = k.chunk * W;
  const size_t base = ((size_t)k.n * HW + k.r0) * CP + c0 / P;
  const float4* xs = reinterpret_cast<const float4*>(x) + base;
  for (int s = 0; s < kStages; ++s) {
    issue_stage(k, s, sm.stage, xs, CP);
    cp_async_commit();
  }
  V a1 = Pc::zero(), a2 = Pc::zero();
  for (int s = 0; s < kStages; ++s) {
    cp_async_wait(kStages - 1 - s);
    for (int j = stage_begin(k, s); j < stage_begin(k, s + 1); ++j) {
      const V v = Pc::widen(sm.stage[threadIdx.x + j * k.active]);
      a1 = add4(a1, v);
      a2 = fma4(v, v, a2);
    }
  }
  channel_sums<V, P>(k, W, cl, a1, a2, sm);

  const int cg = C / G, kg = W / cg;
  for (int g = threadIdx.x; g < kg; g += kOneThreads) {
    double s1 = 0.0, s2 = 0.0;
    for (int i = 0; i < cg; ++i) {
      s1 += sm.tot[g * cg + i];
      s2 += sm.tot[W + g * cg + i];
    }
    const double cnt = (double)HW * cg;
    const double m = s1 / cnt;
    const double var = fmax(s2 / cnt - m * m, 0.0);
    const float mf = (float)m;
    const float rf = (float)(1.0 / sqrt(var + (double)eps));
    sm.grp[g] = mf;
    sm.grp[kg + g] = rf;
    if (k.rank == 0) {
      const size_t o = (size_t)k.n * G + c0 / cg + g;
      mean[o] = mf;
      rstd[o] = rf;
    }
  }
  __syncthreads();
  if (k.count == 0) return;

  const int c = P * k.col;   // first channel of the thread's column, in the chunk
  V s4, b4, m4, r4;
  load_vec(scale + c0, k.col, s4);
  load_vec(bias + c0, k.col, b4);
  gather(sm.grp, c, cg, m4);
  gather(sm.grp + kg, c, cg, r4);
  const V mul = mul4(r4, s4);
  float4* ys = reinterpret_cast<float4*>(y) + base;
  for (int j = 0; j < k.count; ++j) {
    const int p = threadIdx.x + j * k.active;
    const V v = Pc::widen(sm.stage[p]);
    ys[(size_t)(p / k.WP) * CP + k.col] = Pc::narrow(relu_affine(v, m4, mul, b4));
  }
}

// Backward, one CTA per (chunk of W channels, cluster rank, sample); dbc and
// dsc null unless the parameter cotangents are asked for. T is the type of
// x, dy and dx; the rest is float32.
template <typename T>
__global__ void __launch_bounds__(kOneThreads)
gn_bwd_onepass(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ scale, const float* __restrict__ bias,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               T* __restrict__ dx, float* __restrict__ dbc,
               float* __restrict__ dsc, int HW, int C, int G, int W, int cl) {
  using Pc = Piece<T>;
  using V = typename Pc::V;
  constexpr int P = Pc::P;
  extern __shared__ __align__(16) unsigned char smem[];
  const Chunk k = chunk_of<P>(HW, W, cl);
  const Smem<V> sm = carve<V>(smem, k, W, 2);
  float4* sx = sm.stage;
  float4* sd = sm.stage + (size_t)k.rows * k.WP;
  const int CP = C / P;
  const int c0 = k.chunk * W;
  const size_t base = ((size_t)k.n * HW + k.r0) * CP + c0 / P;
  const float4* xs = reinterpret_cast<const float4*>(x) + base;
  const float4* ds = reinterpret_cast<const float4*>(dy) + base;
  for (int s = 0; s < kStages; ++s) {
    issue_stage(k, s, sx, xs, CP);
    issue_stage(k, s, sd, ds, CP);
    cp_async_commit();
  }
  const int cg = C / G, kg = W / cg;
  typename ColOf<V>::type col;
  load_colv(mean + (size_t)k.n * G, rstd + (size_t)k.n * G, scale, bias,
            c0 / P + k.col, cg, col);
  V adb = Pc::zero(), ads = Pc::zero();
  for (int s = 0; s < kStages; ++s) {
    cp_async_wait(kStages - 1 - s);
    for (int j = stage_begin(k, s); j < stage_begin(k, s + 1); ++j) {
      const int p = threadIdx.x + j * k.active;
      gate_acc(Pc::widen(sx[p]), Pc::widen(sd[p]), col, adb, ads);
    }
  }
  channel_sums<V, P>(k, W, cl, adb, ads, sm);

  if (dbc != nullptr && k.rank == 0) {
    for (int i = threadIdx.x; i < W; i += kOneThreads) {
      dbc[(size_t)k.n * C + c0 + i] = (float)sm.tot[i];
      dsc[(size_t)k.n * C + c0 + i] = (float)sm.tot[W + i];
    }
  }
  // a_g / (HW*cg) and b_g / (HW*cg), divided once per group in float64
  const double cnt = (double)HW * cg;
  for (int g = threadIdx.x; g < kg; g += kOneThreads) {
    double a = 0.0, b = 0.0;
    for (int i = 0; i < cg; ++i) {
      const double s = (double)scale[c0 + g * cg + i];
      a += s * sm.tot[g * cg + i];
      b += s * sm.tot[W + g * cg + i];
    }
    sm.grp[g] = (float)(a / cnt);
    sm.grp[kg + g] = (float)(b / cnt);
  }
  __syncthreads();
  if (k.count == 0) return;

  const int c = P * k.col;
  V ag, bg;
  gather(sm.grp, c, cg, ag);
  gather(sm.grp + kg, c, cg, bg);
  float4* out = reinterpret_cast<float4*>(dx) + base;
  for (int j = 0; j < k.count; ++j) {
    const int p = threadIdx.x + j * k.active;
    out[(size_t)(p / k.WP) * CP + k.col] =
        Pc::narrow(dx_vec(Pc::widen(sx[p]), Pc::widen(sd[p]), col, ag, bg));
  }
}

// ------------------------------------ split route, backward (kernel G)
//
// Two launches, no scratch but the [N, G] group sums:
//   1. gn_bwd_stats, grid (cl * C/W, N) in clusters of cl CTAs: a cluster
//      takes one sample's chunk of W channels (whole groups) and its CTAs
//      split the HW rows. A thread owns one piece column and every
//      (kSplitThreads / (W/P))-th row of its CTA's share; it keeps
//      kSplitUnroll rows of x and dy in flight and sums dyr and dyr*xhat in
//      float32 over kSplitFlush x kSplitUnroll rows at most before it adds
//      them to its float64 sums. The CTA adds its threads' sums per channel
//      in a fixed order, the cluster's rank 0 adds the CTAs' through
//      distributed shared memory in rank order, then writes db_c, ds_c (only
//      when the parameter cotangents are asked for) and a_g / (HW*cg),
//      b_g / (HW*cg), divided once per group in float64.
//   2. gn_bwd_dx, grid (row blocks, piece-column blocks, N): a thread keeps
//      one piece column, loads its channels' mean, rstd, scale, bias and
//      the two group sums once, and streams kDxRows rows of it, 16 bytes a
//      load and a store, with the one-pass route's dx formula (`dx_vec`).
// ops/fused_gn.py `split_plan` picks W and cl from the shape so that
// the statistics pass has enough CTAs to keep the card's memory busy.

constexpr int kSplitThreads = 256;     // threads of a G block
constexpr int kSplitMaxW = 256;        // channels of a statistics chunk
constexpr int kSplitMaxCluster = 16;   // CTAs of a cluster (non-portable)
constexpr int kSplitUnroll = 4;        // rows of x and dy in flight a thread
constexpr int kSplitFlush = 4;         // unrolled steps summed in float32
constexpr int kDxRows = 16;            // rows a dx thread

struct dsum4 {
  double x, y, z, w;
};
struct dsum8 {
  dsum4 lo, hi;
};
__device__ __forceinline__ void dadd(dsum4& a, float4 v) {
  a.x += (double)v.x;
  a.y += (double)v.y;
  a.z += (double)v.z;
  a.w += (double)v.w;
}
__device__ __forceinline__ void dadd(dsum8& a, float8 v) {
  dadd(a.lo, v.lo);
  dadd(a.hi, v.hi);
}
template <typename V> struct DSumOf;
template <> struct DSumOf<float4> { using type = dsum4; };
template <> struct DSumOf<float8> { using type = dsum8; };

// The statistics pass of the backward split route, with the combine.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
gn_bwd_stats(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ scale, const float* __restrict__ bias,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             float* __restrict__ dbc, float* __restrict__ dsc,
             float* __restrict__ an, float* __restrict__ bn, int HW, int C,
             int G, int W, int cl) {
  using Pc = Piece<T>;
  using V = typename Pc::V;
  using D = typename DSumOf<V>::type;
  constexpr int P = Pc::P;
  __shared__ D red[2][kSplitThreads];
  __shared__ double chan[2 * kSplitMaxW];
  __shared__ double tot[2 * kSplitMaxW];
  const int rank = blockIdx.x % cl;
  const int c0 = (blockIdx.x / cl) * W;
  const int n = blockIdx.y;
  const int CP = C / P, WP = W / P, cg = C / G;
  const int per = kSplitThreads / WP;   // row lanes of a piece column
  const int active = per * WP;
  const int rows = (HW + cl - 1) / cl;
  const int r1 = min(HW, (rank + 1) * rows);
  D db64 = {}, ds64 = {};
  if (threadIdx.x < active) {
    const int col = threadIdx.x % WP;
    typename ColOf<V>::type cv;
    load_colv(mean + (size_t)n * G, rstd + (size_t)n * G, scale, bias,
              c0 / P + col, cg, cv);
    const size_t off = (size_t)n * HW * CP + c0 / P + col;
    const float4* xs = reinterpret_cast<const float4*>(x) + off;
    const float4* ds = reinterpret_cast<const float4*>(dy) + off;
    int r = rank * rows + threadIdx.x / WP;
    while (r < r1) {
      V adb = Pc::zero(), ads = Pc::zero();
      for (int f = 0; f < kSplitFlush && r < r1; ++f) {
        if (r + (kSplitUnroll - 1) * per < r1) {
          float4 a[kSplitUnroll], d[kSplitUnroll];
#pragma unroll
          for (int u = 0; u < kSplitUnroll; ++u) {
            a[u] = __ldg(xs + (size_t)(r + u * per) * CP);
            d[u] = __ldg(ds + (size_t)(r + u * per) * CP);
          }
#pragma unroll
          for (int u = 0; u < kSplitUnroll; ++u)
            gate_acc(Pc::widen(a[u]), Pc::widen(d[u]), cv, adb, ads);
          r += kSplitUnroll * per;
        } else {
          gate_acc(Pc::widen(__ldg(xs + (size_t)r * CP)),
                   Pc::widen(__ldg(ds + (size_t)r * CP)), cv, adb, ads);
          r += per;
        }
      }
      dadd(db64, adb);
      dadd(ds64, ads);
    }
  }
  red[0][threadIdx.x] = db64;
  red[1][threadIdx.x] = ds64;
  __syncthreads();
  // channel j's sums are component j % P of threads j / P + m * WP, m < per
  auto part = [&](int which, int j, int m) {
    return reinterpret_cast<const double*>(&red[which][j / P + m * WP])[j % P];
  };
  double* own = cl == 1 ? tot : chan;
  if (per <= kSerialSum) {   // a thread a channel
    for (int j = threadIdx.x; j < W; j += kSplitThreads) {
      double s1 = 0.0, s2 = 0.0;
      for (int m = 0; m < per; ++m) {
        s1 += part(0, j, m);
        s2 += part(1, j, m);
      }
      own[j] = s1;
      own[W + j] = s2;
    }
  } else {                   // a warp a channel, a fixed butterfly
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = warp; j < W; j += kSplitThreads / 32) {
      double s1 = 0.0, s2 = 0.0;
      for (int m = lane; m < per; m += 32) {
        s1 += part(0, j, m);
        s2 += part(1, j, m);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        own[j] = s1;
        own[W + j] = s2;
      }
    }
  }
  if (cl > 1) {
    coop::cluster_group cluster = coop::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int i = threadIdx.x; i < 2 * W; i += kSplitThreads) {
        double s = 0.0;
        for (int q = 0; q < cl; ++q) s += cluster.map_shared_rank(chan, q)[i];
        tot[i] = s;
      }
    }
    cluster.sync();   // no CTA leaves while rank 0 still reads its sums
  }
  if (rank != 0) return;
  __syncthreads();
  if (dbc != nullptr) {
    for (int i = threadIdx.x; i < W; i += kSplitThreads) {
      dbc[(size_t)n * C + c0 + i] = (float)tot[i];
      dsc[(size_t)n * C + c0 + i] = (float)tot[W + i];
    }
  }
  const double cnt = (double)HW * cg;
  for (int g = threadIdx.x; g < W / cg; g += kSplitThreads) {
    double a = 0.0, b = 0.0;
    for (int i = 0; i < cg; ++i) {
      const double s = (double)scale[c0 + g * cg + i];
      a += s * tot[g * cg + i];
      b += s * tot[W + g * cg + i];
    }
    const size_t o = (size_t)n * G + c0 / cg + g;
    an[o] = (float)(a / cnt);
    bn[o] = (float)(b / cnt);
  }
}

// dx of the backward split route: block (cols, kSplitThreads / cols) over
// grid (row blocks of blockDim.y * kDxRows rows, piece-column blocks, N).
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
          const float* __restrict__ scale, const float* __restrict__ bias,
          const float* __restrict__ mean, const float* __restrict__ rstd,
          const float* __restrict__ an, const float* __restrict__ bn,
          T* __restrict__ dx, int HW, int C, int G) {
  using Pc = Piece<T>;
  using V = typename Pc::V;
  constexpr int P = Pc::P;
  const int CP = C / P, cg = C / G;
  const int n = blockIdx.z;
  const int cp = blockIdx.y * blockDim.x + threadIdx.x;
  if (cp >= CP) return;
  typename ColOf<V>::type cv;
  load_colv(mean + (size_t)n * G, rstd + (size_t)n * G, scale, bias, cp, cg,
            cv);
  V ag, bg;
  gather(an + (size_t)n * G, P * cp, cg, ag);
  gather(bn + (size_t)n * G, P * cp, cg, bg);
  const size_t off = (size_t)n * HW * CP + cp;
  const float4* xs = reinterpret_cast<const float4*>(x) + off;
  const float4* ds = reinterpret_cast<const float4*>(dy) + off;
  float4* out = reinterpret_cast<float4*>(dx) + off;
  const int r0 = blockIdx.x * blockDim.y * kDxRows + threadIdx.y;
#pragma unroll
  for (int k0 = 0; k0 < kDxRows; k0 += kSplitUnroll) {
    float4 a[kSplitUnroll], d[kSplitUnroll];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int r = r0 + (k0 + u) * blockDim.y;
      if (r < HW) {
        a[u] = __ldg(xs + (size_t)r * CP);
        d[u] = __ldg(ds + (size_t)r * CP);
      }
    }
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int r = r0 + (k0 + u) * blockDim.y;
      if (r < HW)
        out[(size_t)r * CP] =
            Pc::narrow(dx_vec(Pc::widen(a[u]), Pc::widen(d[u]), cv, ag, bg));
    }
  }
}

// ------------------------------------- split route, forward (kernel E)
//
// One launch, no scratch: gn_fwd_split, grid (cl * C/W, N) in clusters of
// cl CTAs. A cluster takes one sample's chunk of W channels (whole groups)
// and its CTAs split the HW rows. A thread owns one piece column and every
// (kFwdThreads / (W/P))-th row of its CTA's share; it keeps kFwdUnroll rows
// in flight and sums x and x*x in float32 over at most kFwdFlush x
// kFwdUnroll rows before it adds them to its float64 sums. The CTA adds
// its threads' sums per channel in a fixed order; every CTA of the cluster
// adds the CTAs' sums through distributed shared memory in rank order (so
// all hold the same totals) and takes the group mean and rstd in float64;
// rank 0 writes them. Each thread then reads its rows again, the last
// first (the rows its CTA read last are the likeliest still in L2), and
// writes y, the one-pass route's `relu_affine` of the same statistics, so
// the routes differ only in the order their sums are taken. Loads of that
// second read and the stores of y are evict-first: neither is read again
// by this launch.
// What holds it (`gn_bench.py --split --sweep`, PERF.md): a CTA takes a
// whole SM (512 threads of up to 128 registers), and the card holds only
// 7 clusters of 10 to 16 CTAs at once (15 of 7 or 8), so a slab of few
// samples (the [4, 65536, 64] split slab: 8 clusters of 8) keeps only 64
// SMs busy, each streaming at the rate its loads in flight allow; more or
// larger clusters ran in a second wave, which was slower. A second launch
// for y (by piece column, as gn_bwd_dx) was slower at every measured
// shape, and so was a first-to-last re-read with plain loads and stores.

constexpr int kFwdThreads = 512;  // threads of a CTA
constexpr int kFwdUnroll = 16;    // rows of x in flight a thread
constexpr int kFwdFlush = 2;      // unrolled steps summed in float32

__device__ __forceinline__ void stats_acc(float4 v, float4& a1, float4& a2) {
  a1 = add4(a1, v);
  a2 = fma4(v, v, a2);
}
__device__ __forceinline__ void stats_acc(float8 v, float8& a1, float8& a2) {
  stats_acc(v.lo, a1.lo, a2.lo);
  stats_acc(v.hi, a1.hi, a2.hi);
}

// Dynamic shared memory of a CTA of gn_fwd_split at P channels a piece: the threads' two float64 partials (P doubles each), the channel
// sums of this CTA and of the chunk (float64) and the per-group values.
__host__ __device__ constexpr size_t fwd_split_smem(int P) {
  return (size_t)kFwdThreads * 16 * P + (size_t)kSplitMaxW * 40;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
gn_fwd_split(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, T* __restrict__ y,
             float* __restrict__ mean, float* __restrict__ rstd, int HW,
             int C, int G, int W, int cl, float eps) {
  using Pc = Piece<T>;
  using V = typename Pc::V;
  using D = typename DSumOf<V>::type;
  constexpr int P = Pc::P;
  constexpr int U = kFwdUnroll;
  extern __shared__ __align__(16) unsigned char smem[];
  D* red[2] = {reinterpret_cast<D*>(smem),
               reinterpret_cast<D*>(smem) + kFwdThreads};
  double* chan = reinterpret_cast<double*>(red[1] + kFwdThreads);
  double* tot = chan + 2 * kSplitMaxW;
  float* grp = reinterpret_cast<float*>(tot + 2 * kSplitMaxW);
  const int rank = blockIdx.x % cl;
  const int c0 = (blockIdx.x / cl) * W;
  const int n = blockIdx.y;
  const int CP = C / P, WP = W / P, cg = C / G, kg = W / cg;
  const int per = kFwdThreads / WP;   // row lanes of a piece column
  const int active = per * WP;
  const int rows = (HW + cl - 1) / cl;
  const int r0 = min(HW, rank * rows) + threadIdx.x / WP;
  const int r1 = min(HW, (rank + 1) * rows);
  // this thread's rows: r0 + k * per, k < count
  const int count =
      (threadIdx.x < active && r0 < r1) ? (r1 - 1 - r0) / per + 1 : 0;
  const int col = threadIdx.x % WP;
  const size_t off = (size_t)n * HW * CP + c0 / P + col;
  const float4* xs = reinterpret_cast<const float4*>(x) + off;
  D s1 = {}, s2 = {};
  int k = 0;
  while (k < count) {
    V a1 = Pc::zero(), a2 = Pc::zero();
    for (int f = 0; f < kFwdFlush && k < count; ++f) {
      if (k + U <= count) {
        float4 a[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          a[u] = __ldg(xs + (size_t)(r0 + (k + u) * per) * CP);
#pragma unroll
        for (int u = 0; u < U; ++u) stats_acc(Pc::widen(a[u]), a1, a2);
        k += U;
      } else {
        stats_acc(Pc::widen(__ldg(xs + (size_t)(r0 + k * per) * CP)), a1, a2);
        ++k;
      }
    }
    dadd(s1, a1);
    dadd(s2, a2);
  }
  red[0][threadIdx.x] = s1;
  red[1][threadIdx.x] = s2;
  __syncthreads();
  // channel j's sums are component j % P of threads j / P + m * WP, m < per
  auto part = [&](int which, int j, int m) {
    return reinterpret_cast<const double*>(&red[which][j / P + m * WP])[j % P];
  };
  double* own = cl == 1 ? tot : chan;
  if (per <= kSerialSum) {   // a thread a channel
    for (int j = threadIdx.x; j < W; j += kFwdThreads) {
      double t1 = 0.0, t2 = 0.0;
      for (int m = 0; m < per; ++m) {
        t1 += part(0, j, m);
        t2 += part(1, j, m);
      }
      own[j] = t1;
      own[W + j] = t2;
    }
  } else {                   // a warp a channel, a fixed butterfly
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = warp; j < W; j += kFwdThreads / 32) {
      double t1 = 0.0, t2 = 0.0;
      for (int m = lane; m < per; m += 32) {
        t1 += part(0, j, m);
        t2 += part(1, j, m);
      }
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      if (lane == 0) {
        own[j] = t1;
        own[W + j] = t2;
      }
    }
  }
  if (cl > 1) {
    coop::cluster_group cluster = coop::this_cluster();
    cluster.sync();
    for (int i = threadIdx.x; i < 2 * W; i += kFwdThreads) {
      double v[kSplitMaxCluster];   // every rank's load in flight at once
#pragma unroll
      for (int q = 0; q < kSplitMaxCluster; ++q)
        if (q < cl) v[q] = cluster.map_shared_rank(chan, q)[i];
      double t = 0.0;
#pragma unroll
      for (int q = 0; q < kSplitMaxCluster; ++q)
        if (q < cl) t += v[q];
      tot[i] = t;
    }
    cluster.sync();   // no CTA leaves while another still reads its sums
  } else {
    __syncthreads();
  }
  for (int g = threadIdx.x; g < kg; g += kFwdThreads) {
    double t1 = 0.0, t2 = 0.0;
    for (int i = 0; i < cg; ++i) {
      t1 += tot[g * cg + i];
      t2 += tot[W + g * cg + i];
    }
    const double cnt = (double)HW * cg;
    const double m = t1 / cnt;
    const double var = fmax(t2 / cnt - m * m, 0.0);
    const float mf = (float)m;
    const float rf = (float)(1.0 / sqrt(var + (double)eps));
    grp[g] = mf;
    grp[kg + g] = rf;
    if (rank == 0) {
      const size_t o = (size_t)n * G + c0 / cg + g;
      mean[o] = mf;
      rstd[o] = rf;
    }
  }
  __syncthreads();
  if (count == 0) return;
  V s4, b4, m4, r4;
  load_vec(scale + c0, col, s4);
  load_vec(bias + c0, col, b4);
  gather(grp, P * col, cg, m4);
  gather(grp + kg, P * col, cg, r4);
  const V mul = mul4(r4, s4);
  float4* ys = reinterpret_cast<float4*>(y) + off;
  k = count;
  while (k > 0) {
    const int u0 = k >= U ? k - U : 0;
    float4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u0 + u < k) a[u] = __ldcs(xs + (size_t)(r0 + (u0 + u) * per) * CP);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u0 + u < k)
        __stcs(ys + (size_t)(r0 + (u0 + u) * per) * CP,
               Pc::narrow(relu_affine(Pc::widen(a[u]), m4, mul, b4)));
    k = u0;
  }
}

bool shape_ok(int N, int HW, int C, int G) {
  return N >= 1 && N <= kMaxGrid && HW >= 1 && C >= 4 && C % 4 == 0 &&
         G >= 1 && C % G == 0;
}

// A one-pass plan the kernels take: W whole groups and a multiple of P
// (the channels of a 16-byte piece), at most one piece column a thread, a
// cluster of at most kMaxCluster, and smem at least what the CTA carves and
// at most a block's limit.
bool onepass_ok(int N, int HW, int C, int G, int W, int cl, int smem, int slabs,
                int P) {
  if (!shape_ok(N, HW, C, G) || C % P != 0) return false;
  const int cg = C / G;
  return W >= P && W % P == 0 && W % cg == 0 && C % W == 0 &&
         W / P <= kOneThreads && cl >= 1 && cl <= kMaxCluster &&
         (size_t)smem >= onepass_smem(HW, W, cl, slabs, P) && smem <= kMaxSmem;
}

// Launches a one-pass kernel on grid (cl * C/W, N), with a cluster of cl
// CTAs along x when cl > 1, after raising its dynamic shared-memory limit.
template <typename... Params, typename... Args>
int launch_onepass(void (*kernel)(Params...), int* raised, int N, int C,
                   int W, int cl, int smem, cudaStream_t st, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cl * (C / W)), (unsigned)N, 1);
  cfg.blockDim = dim3(kOneThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int fwd_raised[64] = {0};
int bwd_raised[64] = {0};
int fwd_bf16_raised[64] = {0};
int bwd_bf16_raised[64] = {0};

// A split plan the kernels take: W whole groups, a multiple of P channels
// and at most kSplitMaxW of them, dividing C; a cluster of 1 to
// kSplitMaxCluster CTAs, no more than the rows.
bool split_ok(int N, int HW, int C, int G, int W, int cl, int P) {
  if (!shape_ok(N, HW, C, G) || C % P != 0) return false;
  const int cg = C / G;
  return W >= P && W % P == 0 && W % cg == 0 && C % W == 0 &&
         W <= kSplitMaxW && W / P <= kSplitThreads && cl >= 1 &&
         cl <= kSplitMaxCluster && cl <= HW &&
         (long long)cl * (C / W) <= 0x7fffffffLL;
}

// Launches a split-route statistics kernel of `threads` threads and `smem`
// bytes of dynamic shared memory a CTA on grid (cl * C/W, N), in clusters
// of cl CTAs along x when cl > 1; `ready` records that the kernel's
// attributes are set: clusters above the portable 8, and the shared memory.
template <typename... Params, typename... Args>
int launch_split_stats(void (*kernel)(Params...), bool& ready, int threads,
                       int smem, int N, int C, int W, int cl, cudaStream_t st,
                       Args... args) {
  cudaError_t err;
  if (!ready) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    if (smem > 0) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cl * (C / W)), (unsigned)N, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of cl CTAs of gn_fwd_split<T> the current device holds
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
template <typename T>
int fwd_split_clusters(int cl) {
  if (cl < 1 || cl > kSplitMaxCluster) return -(int)cudaErrorInvalidValue;
  const int bytes = (int)fwd_split_smem(Piece<T>::P);
  cudaError_t err = cudaFuncSetAttribute(
      gn_fwd_split<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        gn_fwd_split<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cl, 1, 1);
  cfg.blockDim = dim3(kFwdThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gn_fwd_split<T>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// The forward on activations of type T, either route (the arguments of
// dp_gn_relu_fwd).
template <typename T>
int relu_fwd(const T* x, const float* scale, const float* bias, T* y,
             float* mean, float* rstd, int N, int HW, int C, int G, float eps,
             int split, int W, int cl, int smem, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  constexpr int P = Piece<T>::P;
  if (!split) {
    if (!onepass_ok(N, HW, C, G, W, cl, smem, 1, P))
      return (int)cudaErrorInvalidValue;
    return launch_onepass(gn_fwd_onepass<T>,
                          P == 4 ? fwd_raised : fwd_bf16_raised, N, C, W, cl,
                          smem, st, x, scale, bias, y, mean, rstd, HW, C, G,
                          W, cl, eps);
  }
  static bool ready = false;
  if (!split_ok(N, HW, C, G, W, cl, P)) return (int)cudaErrorInvalidValue;
  return launch_split_stats(gn_fwd_split<T>, ready, kFwdThreads,
                            (int)fwd_split_smem(P), N, C, W, cl, st, x, scale,
                            bias, y, mean, rstd, HW, C, G, W, cl, eps);
}

// The backward split route's two launches (the arguments of relu_bwd).
template <typename T>
int split_bwd(const T* x, const T* dy, const float* scale, const float* bias,
              const float* mean, const float* rstd, T* dx, float* dbc,
              float* dsc, float* an, float* bn, int N, int HW, int C, int G,
              int W, int cl, cudaStream_t st) {
  constexpr int P = Piece<T>::P;
  static bool ready = false;
  const int err = launch_split_stats(gn_bwd_stats<T>, ready, kSplitThreads, 0,
                                     N, C, W, cl, st, x, dy, scale, bias, mean,
                                     rstd, dbc, dsc, an, bn, HW, C, G, W, cl);
  if (err != 0) return err;
  const int CP = C / P;
  const int cols = CP < 64 ? CP : 64;
  const dim3 block(cols, kSplitThreads / cols);
  const int rows = (int)block.y * kDxRows;
  const dim3 grid((HW + rows - 1) / rows, (CP + cols - 1) / cols, N);
  if (grid.y > (unsigned)kMaxGrid) return (int)cudaErrorInvalidValue;
  gn_bwd_dx<T><<<grid, block, 0, st>>>(x, dy, scale, bias, mean, rstd, an, bn,
                                       dx, HW, C, G);
  return (int)cudaGetLastError();
}

// The backward on activations of type T, either route (the arguments of
// dp_gn_relu_bwd).
template <typename T>
int relu_bwd(const T* x, const T* dy, const float* scale, const float* bias,
             const float* mean, const float* rstd, T* dx, float* dbc,
             float* dsc, float* an, float* bn, float* dscale, float* dbias,
             int N, int HW, int C, int G, int split, int W, int cl, int smem,
             void* stream) {
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  constexpr int P = Piece<T>::P;
  const bool params = dscale != nullptr && dbias != nullptr;
  if (params && (dbc == nullptr || dsc == nullptr)) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (!split) {
    if (!onepass_ok(N, HW, C, G, W, cl, smem, 2, P))
      return (int)cudaErrorInvalidValue;
    err = launch_onepass(gn_bwd_onepass<T>,
                         P == 4 ? bwd_raised : bwd_bf16_raised, N, C, W, cl,
                         smem, st, x, dy, scale, bias, mean, rstd, dx,
                         params ? dbc : nullptr, params ? dsc : nullptr, HW,
                         C, G, W, cl);
  } else {
    if (!split_ok(N, HW, C, G, W, cl, P) || an == nullptr || bn == nullptr)
      return (int)cudaErrorInvalidValue;
    err = split_bwd(x, dy, scale, bias, mean, rstd, dx,
                    params ? dbc : nullptr, params ? dsc : nullptr, an, bn, N,
                    HW, C, G, W, cl, st);
  }
  if (err != 0 || !params) return err;
  gn_param_sums<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      dsc, dbc, dscale, dbias, N, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of a one-pass CTA: HW rows split over cl CTAs, W
// channels, slabs 1 (forward) or 2 (backward).
long long dp_gn_onepass_smem(int HW, int W, int cl, int slabs) {
  if (HW < 1 || W < 1 || cl < 1 || slabs < 1) return -1;
  return (long long)onepass_smem(HW, W, cl, slabs, Piece<float>::P);
}

// The same for the bf16 kernels (8 channels a 16-byte piece).
long long dp_gn_onepass_smem_bf16(int HW, int W, int cl, int slabs) {
  if (HW < 1 || W < 1 || cl < 1 || slabs < 1) return -1;
  return (long long)onepass_smem(HW, W, cl, slabs, Piece<__nv_bfloat16>::P);
}

// Clusters of cl CTAs of kernel E (float32, or bf16 when bf16 != 0) the
// current device holds at once; minus a CUDA error code on failure.
int dp_gn_fwd_split_clusters(int cl, int bf16) {
  return bf16 ? fwd_split_clusters<__nv_bfloat16>(cl)
              : fwd_split_clusters<float>(cl);
}

// Forward. x, y [N,HW,C]; scale, bias [C]; mean, rstd [N,G]. All f32,
// contiguous, on the current device; C a multiple of 4 and of G, pointers
// 16-byte aligned (the caller checks). The plan (ops/fused_gn.py gn_plan):
// split 0 takes the one-pass route with chunks of W channels, cl CTAs a
// chunk and smem bytes a CTA; split 1 the split route with chunks of W
// channels over clusters of cl CTAs (ops/fused_gn.py split_plan; smem
// unused).
int dp_gn_relu_fwd(const float* x, const float* scale, const float* bias,
                   float* y, float* mean, float* rstd, int N, int HW, int C,
                   int G, float eps, int split, int W, int cl, int smem,
                   void* stream) {
  return relu_fwd(x, scale, bias, y, mean, rstd, N, HW, C, G, eps, split, W,
                  cl, smem, stream);
}

// Backward. x, dy, dx [N,HW,C]; mean, rstd [N,G] from the forward;
// dscale, dbias [C] or both null (then the parameter cotangents are not
// summed), and then dbc, dsc [N,C] scratch, else may be null. split 0 takes
// the one-pass route with the plan as for the forward; split 1 the split
// route with statistics chunks of W channels over clusters of cl CTAs
// (ops/fused_gn.py split_plan; smem unused) and float32 scratch an, bn
// [N,G] for the group sums.
int dp_gn_relu_bwd(const float* x, const float* dy, const float* scale,
                   const float* bias, const float* mean, const float* rstd,
                   float* dx, float* dbc, float* dsc, float* an, float* bn,
                   float* dscale, float* dbias, int N, int HW, int C, int G,
                   int split, int W, int cl, int smem, void* stream) {
  return relu_bwd(x, dy, scale, bias, mean, rstd, dx, dbc, dsc, an, bn,
                  dscale, dbias, N, HW, C, G, split, W, cl, smem, stream);
}

// Forward on bf16 activations (kernels D and E in bf16): x, y [N,HW,C]
// bf16; scale, bias [C] and mean, rstd [N,G] float32. C a multiple of 8
// and of G, x and y 16-byte aligned; the plan as for dp_gn_relu_fwd
// (chunk widths a multiple of 8).
int dp_gn_relu_fwd_bf16(const void* x, const float* scale, const float* bias,
                        void* y, float* mean, float* rstd, int N, int HW,
                        int C, int G, float eps, int split, int W, int cl,
                        int smem, void* stream) {
  using bf = __nv_bfloat16;
  return relu_fwd(static_cast<const bf*>(x), scale, bias, static_cast<bf*>(y),
                  mean, rstd, N, HW, C, G, eps, split, W, cl, smem, stream);
}

// Backward on bf16 activations (kernels F and G in bf16): x, dy, dx
// [N,HW,C] bf16; everything else float32 and as for dp_gn_relu_bwd.
int dp_gn_relu_bwd_bf16(const void* x, const void* dy, const float* scale,
                        const float* bias, const float* mean,
                        const float* rstd, void* dx, float* dbc, float* dsc,
                        float* an, float* bn, float* dscale, float* dbias,
                        int N, int HW, int C, int G, int split, int W, int cl,
                        int smem, void* stream) {
  using bf = __nv_bfloat16;
  return relu_bwd(static_cast<const bf*>(x), static_cast<const bf*>(dy),
                  scale, bias, mean, rstd, static_cast<bf*>(dx), dbc, dsc, an,
                  bn, dscale, dbias, N, HW, C, G, split, W, cl, smem, stream);
}

}  // extern "C"
