// Fused rasterize + occlusion fill, forward (kernel A) and backward (kernel B).
//
// Replaces the TPU kernels of dorpatch_tpu/ops/masked_fill.py:
//   A  _fwd_kernel (:53), launched by _pallas_fwd (:87)
//   B  _bwd_kernel (:66), launched by _pallas_bwd (:107)
//
// Both are bound by bytes; neither does a product. The launch geometry
// (masks per block, lanes per block, store policy, and the grid itself)
// comes from the wrapper's plan, `ops/masked_fill.fwd_plan` / `bwd_plan`
// and `fwd_grid` / `bwd_grid`: the entries below launch exactly that grid
// and refuse one that does not cover the work once.
//
// Indexing. A lane is V = 4 consecutive floats of one image (16 bytes) when
// a row of W*C floats is a multiple of 4 and the buffers are 16-byte
// aligned, so no lane straddles two rows; else V = 1 (the scalar route).
// Kernel A also takes bf16 images (the bf16 certify bank fills bf16
// images): `fill_fwd16` below, a 16-byte lane then holds V = 8 values.
// The fill is an exact select, so the bf16 form moves the values as raw
// 16-bit patterns and does no arithmetic on them; the fill value is
// rounded to bf16 once, on the host (__float2bfloat16).
// A thread works out its lane's row and the pixel column of each of its V
// floats once, with one division by W*C and V by C, and reuses them for
// every mask. Mask s occludes (row, col) when some rectangle k has
// r0 <= row < r1 and c0 <= col < c1: on a row, the K rectangles are K
// column intervals (empty where the row misses a rectangle).
//
// A: out[b, s] = where(occluded by rects[s], fill, imgs[b]) for every image
//    b and mask s: [B,H,W,C] x [S,K,4] -> [B,S,H,W,C]. Its bound is the
//    output, written once (B*S*H*W*C floats, 154 MB at the 224 attack
//    step), and the images, read once. One block per (image, mask), each
//    thread a chain of 16-byte load, two divisions and a store, is
//    latency-bound at 28% of the bound. Instead a block owns a tile
//    of one image (256 threads x 4 lanes, 16 KB), loads it into registers
//    once, then walks a group of masks whose rectangles it staged in
//    shared memory: per mask it writes the tile with the occluded floats
//    replaced, each warp storing contiguous 512-byte runs of one [b, s]
//    slab, many stores in flight. The image is read once per (tile, mask
//    group) instead of once per mask, and the indexing is paid once per
//    tile. The grid is tiles x 16 mask groups x images (16 groups were the
//    fastest at every main-path shape). When the output outgrows the 50 MB
//    L2, stores are evict-first (`st.global.cs`), since nothing reads them
//    back before they reach device memory; below that they are plain, so
//    the next convolution finds them in L2.
//
// B: dx[b] = sum_s keep[s] * g[b, s]: [B,S,H,W,C] -> [B,H,W,C]. Its bound is
//    the one read of g. The TPU kernel carries the sum over s across
//    sequential grid steps; CUDA blocks run in no order and nothing carries
//    between them, so each block owns `cols` 16-byte lanes of dx (32 at
//    224 px, 16 at 32 px: two blocks an SM or more) and its 256 / `cols`
//    thread rows split the masks: row ty sums masks ty, ty + split, ... in
//    order, four 16-byte loads in flight (one 4-byte load left it at a
//    third of its bound), read evict-first (`ld.global.cs`: g is read once), a load
//    skipped where the whole lane is occluded; then row 0 adds the
//    partials in row order. The sums run in float64, in a fixed order,
//    without atomics: the f32 result is the sum of the f32 terms up to
//    float64 rounding, rounded once, and a repeated call gives the same
//    bits. The rectangles stream through shared memory in tiles of
//    kTileMasks masks.

#include <stdint.h>
#include <string.h>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using dorpatch::kMaxRects;

constexpr int kThreads = 256;
constexpr int kLanes = 4;        // A: lanes a thread holds
constexpr int kMaxGroup = 32;    // A: masks a block walks
constexpr int kTileMasks = 128;  // B: masks staged at once
constexpr int kUnroll = 4;       // B: loads in flight a thread

// A lane of V elements of type E: 16 bytes (float4: 4 floats; uint4: 8 bf16
// bit patterns) or one element (the scalar route).
template <typename E, int V> struct Lane;
template <> struct Lane<float, 4> { using T = float4; };
template <> struct Lane<float, 1> { using T = float; };
template <> struct Lane<uint16_t, 8> { using T = uint4; };
template <> struct Lane<uint16_t, 1> { using T = unsigned short; };

template <typename E, int V>
__device__ __forceinline__ E& elem(typename Lane<E, V>::T& v, int t) {
  return reinterpret_cast<E*>(&v)[t];
}

template <bool kStream, typename T>
__device__ __forceinline__ void put(T* p, const T& v) {
  if (kStream) __stcs(p, v); else *p = v;
}

// Row and the pixel column of each of the V floats of lane `lane` of an
// image whose rows hold wc = W*C floats (wc % V == 0).
template <int V>
__device__ __forceinline__ int lane_coords(int lane, int wc, int C,
                                           int (&col)[V]) {
  const int e = lane * V;
  const int row = e / wc;
  const int e0 = e - row * wc;
#pragma unroll
  for (int t = 0; t < V; ++t) col[t] = (e0 + t) / C;
  return row;
}

// Adds to occ[t] whether rectangle q = (r0, r1, c0, c1) occludes (row,
// col[t]): the column interval it cuts from the row, empty off its rows.
template <int V>
__device__ __forceinline__ void occlude(const int* q, int row,
                                        const int (&col)[V], bool (&occ)[V]) {
  const bool in = (row >= q[0]) & (row < q[1]);
  const int lo = in ? q[2] : 0;
  const int hi = in ? q[3] : 0;
#pragma unroll
  for (int t = 0; t < V; ++t) occ[t] |= (col[t] >= lo) & (col[t] < hi);
}

// grid (tiles of an image, mask groups, images); E float, or uint16_t for
// the bits of bf16 values
template <typename E, int V, bool kStream>
__global__ void __launch_bounds__(kThreads)
fill_fwd(const E* __restrict__ imgs, const int* __restrict__ rects,
         E* __restrict__ out, int S, int K, int H, int W, int C,
         E fill, int group) {
  using Vec = typename Lane<E, V>::T;
  __shared__ int r[kMaxGroup * 4 * kMaxRects];
  const int wc = W * C;
  const int nl = H * wc / V;                         // lanes of one image
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * group;
  const int gs = min(group, S - s0);
  const int base = blockIdx.x * kThreads * kLanes + threadIdx.x;
  for (int i = threadIdx.x; i < gs * 4 * K; i += kThreads)
    r[i] = rects[(size_t)s0 * 4 * K + i];

  const Vec* src = reinterpret_cast<const Vec*>(imgs) + (size_t)b * nl;
  Vec v[kLanes];
  int row[kLanes];
  int col[kLanes][V];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const int lane = base + l * kThreads;
    row[l] = -1;                                     // no lane
#pragma unroll
    for (int t = 0; t < V; ++t) col[l][t] = 0;
    if (lane < nl) {
      v[l] = __ldg(src + lane);
      row[l] = lane_coords<V>(lane, wc, C, col[l]);
    }
  }
  __syncthreads();

  Vec* dst = reinterpret_cast<Vec*>(out) + ((size_t)b * S + s0) * nl + base;
  for (int m = 0; m < gs; ++m, dst += nl) {
    bool occ[kLanes][V];
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
#pragma unroll
      for (int t = 0; t < V; ++t) occ[l][t] = false;
    const int* q = r + m * 4 * K;
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
        occlude<V>(q + 4 * k, row[l], col[l], occ[l]);
    }
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      if (row[l] < 0) continue;
      Vec o = v[l];
#pragma unroll
      for (int t = 0; t < V; ++t)
        if (occ[l][t]) elem<E, V>(o, t) = fill;
      put<kStream>(dst + l * kThreads, o);
    }
  }
}

// grid (lane blocks of an image, images); block cols x (kThreads / cols)
template <int V>
__global__ void __launch_bounds__(kThreads)
fill_bwd(const float* __restrict__ g, const int* __restrict__ rects,
         float* __restrict__ dx, int S, int K, int H, int W, int C, int cols) {
  using Vec = typename Lane<float, V>::T;
  __shared__ int r[kTileMasks * 4 * kMaxRects];
  __shared__ double part[kThreads][V];
  const int wc = W * C;
  const int nl = H * wc / V;
  const int split = kThreads / cols;
  const int tx = threadIdx.x % cols;
  const int ty = threadIdx.x / cols;
  const int lane = blockIdx.x * cols + tx;
  const int b = blockIdx.y;
  const bool live = lane < nl;
  int col[V];
  const int row = lane_coords<V>(live ? lane : 0, wc, C, col);
  const Vec* gb = reinterpret_cast<const Vec*>(g) + (size_t)b * S * nl
                  + (live ? lane : 0);
  double acc[V];
#pragma unroll
  for (int t = 0; t < V; ++t) acc[t] = 0.0;
  for (int s0 = 0; s0 < S; s0 += kTileMasks) {
    const int ts = min(kTileMasks, S - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < ts * 4 * K; i += kThreads)
      r[i] = rects[(size_t)s0 * 4 * K + i];
    __syncthreads();
    if (!live) continue;
    for (int t0 = ty; t0 < ts; t0 += kUnroll * split) {
      Vec x[kUnroll];
      bool keep[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int m = t0 + u * split;
        bool occ[V];
#pragma unroll
        for (int t = 0; t < V; ++t) occ[t] = m >= ts;
        if (m < ts) {
          const int* q = r + m * 4 * K;
          for (int k = 0; k < K; ++k) occlude<V>(q + 4 * k, row, col, occ);
        }
        bool any = false;
#pragma unroll
        for (int t = 0; t < V; ++t) {
          keep[u][t] = !occ[t];
          any |= keep[u][t];
          elem<float, V>(x[u], t) = 0.0f;
        }
        if (any) x[u] = __ldcs(gb + (size_t)(s0 + m) * nl);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int t = 0; t < V; ++t)
          if (keep[u][t]) acc[t] += (double)elem<float, V>(x[u], t);
    }
  }
#pragma unroll
  for (int t = 0; t < V; ++t) part[threadIdx.x][t] = acc[t];
  __syncthreads();
  if (ty == 0 && live) {
    Vec o;
#pragma unroll
    for (int t = 0; t < V; ++t) {
      double sum = part[tx][t];
      for (int j = 1; j < split; ++j) sum += part[j * cols + tx][t];
      elem<float, V>(o, t) = (float)sum;
    }
    reinterpret_cast<Vec*>(dx)[(size_t)b * nl + lane] = o;
  }
}

// A grid of `blocks` along an axis of n items, `per` a block, covers each
// item exactly once.
bool covers(long long blocks, long long per, long long n) {
  return blocks >= 1 && (blocks - 1) * per < n && n <= blocks * per;
}

template <typename E, int V, bool kStream>
cudaError_t launch_fwd(const E* imgs, const int* rects, E* out, int B,
                       int S, int K, int H, int W, int C, E fill,
                       int group, dim3 grid, cudaStream_t st) {
  fill_fwd<E, V, kStream><<<grid, kThreads, 0, st>>>(imgs, rects, out, S, K,
                                                     H, W, C, fill, group);
  return cudaGetLastError();
}

// Kernel A for either element type: V-element 16-byte lanes when vec != 0
// (else the scalar route); checks the plan and the grid as the entries
// document.
template <typename E, int V>
int fill_fwd_entry(const E* imgs, const int* rects, E* out, int B, int S,
                   int K, int H, int W, int C, E fill, int vec, int group,
                   int stream_stores, int tiles, int groups, void* stream) {
  if (K < 1 || K > kMaxRects || group < 1 || group > kMaxGroup ||
      (vec && (W * C) % V != 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H * W * C == 0) return (int)cudaSuccess;
  const long long nl = (long long)H * W * C / (vec ? V : 1);
  if (!covers(tiles, (long long)kThreads * kLanes, nl) ||
      !covers(groups, group, S) || groups > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, (unsigned)groups, (unsigned)B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (vec)
    e = stream_stores
        ? launch_fwd<E, V, true>(imgs, rects, out, B, S, K, H, W, C, fill,
                                 group, grid, st)
        : launch_fwd<E, V, false>(imgs, rects, out, B, S, K, H, W, C, fill,
                                  group, grid, st);
  else
    e = stream_stores
        ? launch_fwd<E, 1, true>(imgs, rects, out, B, S, K, H, W, C, fill,
                                 group, grid, st)
        : launch_fwd<E, 1, false>(imgs, rects, out, B, S, K, H, W, C, fill,
                                  group, grid, st);
  return (int)e;
}

// ---------------------------------------------------------------- A, bf16
//
// fill_fwd16: kernel A on bf16 images (the bf16 certify bank's fill, S 36
// and 63 masks a chunk). A block pays fixed costs (the image tile's load,
// the rectangles' staging and a barrier) over the masks it walks, and the
// bank's chunks have few masks, so the per-mask work has to be small:
//   - a rectangle's occluded values on a row are one interval of the row's
//     elements, [c0 * C, c1 * C): staged so once a block, it cuts an
//     8-bit mask from a lane's 8 values with two subtractions and two
//     clamps, and a lane no rectangle touches is stored as loaded;
//   - a thread holds `lanes` (1-8) lanes and a block walks `group` (up to
//     64: a whole chunk) masks, so the plan sets the per-block cost against
//     the blocks the card needs (`ops/masked_fill.py` `fwd_plan16`).
// The fill is an exact select of 16-bit patterns.

constexpr int kMaxGroup16 = 64;
constexpr int kMaxLanes16 = 8;

// The V-bit mask of lane values [e0, e0 + V) that fall in [lo, hi).
template <int V>
__device__ __forceinline__ uint32_t cut(int lo, int hi, int e0) {
  lo = min(max(lo - e0, 0), V);
  hi = min(max(hi - e0, 0), V);
  return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// Replace the values of a lane whose bit is set by the fill (both halves
// of `fill2` hold its bits).
__device__ __forceinline__ void patch(uint4& v, uint32_t bits, uint32_t fill2) {
  uint32_t* wv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 0u - ((bits >> (2 * i)) & 1u);
    const uint32_t hi = 0u - ((bits >> (2 * i + 1)) & 1u);
    const uint32_t m = __byte_perm(lo, hi, 0x7610);
    wv[i] = (wv[i] & ~m) | (fill2 & m);
  }
}
__device__ __forceinline__ void patch(unsigned short& v, uint32_t bits,
                                      uint32_t fill2) {
  if (bits) v = (unsigned short)fill2;
}

// grid (tiles of lanes * kThreads lanes, mask groups, images)
template <int V, bool kStream>
__global__ void __launch_bounds__(kThreads)
fill_fwd16(const uint16_t* __restrict__ imgs, const int* __restrict__ rects,
           uint16_t* __restrict__ out, int S, int K, int H, int W, int C,
           uint32_t fill2, int group, int lanes) {
  using Vec = typename Lane<uint16_t, V>::T;
  __shared__ int r[kMaxGroup16 * kMaxRects * 4];   // r0, r1, c0 * C, c1 * C
  const int wc = W * C;
  const int nl = H * wc / V;
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * group;
  const int gs = min(group, S - s0);
  const int base = blockIdx.x * kThreads * lanes + threadIdx.x;
  for (int i = threadIdx.x; i < gs * K * 4; i += kThreads) {
    const int v = rects[(size_t)s0 * K * 4 + i];
    r[i] = (i & 2) ? v * C : v;
  }

  const Vec* src = reinterpret_cast<const Vec*>(imgs) + (size_t)b * nl;
  Vec v[kMaxLanes16];
  int row[kMaxLanes16], e0[kMaxLanes16];
#pragma unroll
  for (int l = 0; l < kMaxLanes16; ++l) {
    const int lane = base + l * kThreads;
    row[l] = -1;                                     // no lane
    e0[l] = 0;
    if (l < lanes && lane < nl) {
      v[l] = __ldg(src + lane);
      row[l] = lane * V / wc;
      e0[l] = lane * V - row[l] * wc;
    }
  }
  __syncthreads();

  Vec* dst = reinterpret_cast<Vec*>(out) + ((size_t)b * S + s0) * nl + base;
  for (int m = 0; m < gs; ++m, dst += nl) {
    const int* q = r + m * K * 4;
#pragma unroll
    for (int l = 0; l < kMaxLanes16; ++l) {
      if (row[l] < 0) continue;
      uint32_t bits = 0;
      for (int k = 0; k < K; ++k) {
        const int* p = q + 4 * k;
        if (row[l] >= p[0] && row[l] < p[1]) bits |= cut<V>(p[2], p[3], e0[l]);
      }
      Vec o = v[l];
      if (bits) patch(o, bits, fill2);
      put<kStream>(dst + l * kThreads, o);
    }
  }
}

template <int V, bool kStream>
cudaError_t launch_fwd16(const uint16_t* imgs, const int* rects,
                         uint16_t* out, int S, int K, int H, int W, int C,
                         uint32_t fill2, int group, int lanes, dim3 grid,
                         cudaStream_t st) {
  fill_fwd16<V, kStream><<<grid, kThreads, 0, st>>>(imgs, rects, out, S, K,
                                                    H, W, C, fill2, group,
                                                    lanes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A. imgs [B,H,W,C] f32, rects [S,K,4] int32, out [B,S,H,W,C] f32;
// all contiguous on the current device. vec4 != 0 selects 16-byte lanes
// (the caller checks W*C % 4 == 0 and 16-byte alignment); group (1..32)
// masks per block, stream != 0 evict-first stores; the grid is (tiles,
// groups, B), tiles of kThreads * kLanes lanes: `ops/masked_fill.fwd_plan`,
// `fwd_grid`.
int dp_masked_fill_fwd(const float* imgs, const int* rects, float* out, int B,
                       int S, int K, int H, int W, int C, float fill, int vec4,
                       int group, int stream_stores, int tiles, int groups,
                       void* stream) {
  return fill_fwd_entry<float, 4>(imgs, rects, out, B, S, K, H, W, C, fill,
                                  vec4, group, stream_stores, tiles, groups,
                                  stream);
}

// Kernel A on bf16 images: imgs [B,H,W,C] and out [B,S,H,W,C] bf16, the
// rest as for dp_masked_fill_fwd; vec8 != 0 selects 16-byte lanes of 8
// values (W*C % 8 == 0, 16-byte aligned); `fill` is rounded to bf16; group
// (1..64) masks and lanes (1..8) lanes a thread, the grid (tiles, groups,
// B) with tiles of 256 * lanes lanes: `ops/masked_fill.fwd_plan`, `fwd_grid`.
int dp_masked_fill_fwd_bf16(const void* imgs, const int* rects, void* out,
                            int B, int S, int K, int H, int W, int C,
                            float fill, int vec8, int group,
                            int stream_stores, int lanes, int tiles,
                            int groups, void* stream) {
  if (K < 1 || K > kMaxRects || group < 1 || group > kMaxGroup16 ||
      lanes < 1 || lanes > kMaxLanes16 || (vec8 && (W * C) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H * W * C == 0) return (int)cudaSuccess;
  const long long nl = (long long)H * W * C / (vec8 ? 8 : 1);
  if (!covers(tiles, (long long)kThreads * lanes, nl) ||
      !covers(groups, group, S) || groups > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const __nv_bfloat16 fb = __float2bfloat16(fill);
  uint16_t bits;
  memcpy(&bits, &fb, sizeof bits);
  const uint32_t fill2 = (uint32_t)bits * 0x10001u;
  const dim3 grid((unsigned)tiles, (unsigned)groups, (unsigned)B);
  const uint16_t* x = static_cast<const uint16_t*>(imgs);
  uint16_t* y = static_cast<uint16_t*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (vec8)
    e = stream_stores
        ? launch_fwd16<8, true>(x, rects, y, S, K, H, W, C, fill2, group,
                                lanes, grid, st)
        : launch_fwd16<8, false>(x, rects, y, S, K, H, W, C, fill2, group,
                                 lanes, grid, st);
  else
    e = stream_stores
        ? launch_fwd16<1, true>(x, rects, y, S, K, H, W, C, fill2, group,
                                lanes, grid, st)
        : launch_fwd16<1, false>(x, rects, y, S, K, H, W, C, fill2, group,
                                 lanes, grid, st);
  return (int)e;
}

// Kernel B. g [B,S,H,W,C] f32, rects [S,K,4] int32, dx [B,H,W,C] f32.
// vec4 as for kernel A; cols (a divisor of 256) lanes per block, the other
// 256 / cols thread rows splitting the masks; the grid is (blocks, B):
// `ops/masked_fill.bwd_plan`, `bwd_grid`.
int dp_masked_fill_bwd(const float* g, const int* rects, float* dx, int B,
                       int S, int K, int H, int W, int C, int vec4, int cols,
                       int blocks, void* stream) {
  if (K < 1 || K > kMaxRects || cols < 1 || cols > kThreads ||
      kThreads % cols != 0 || (vec4 && (W * C) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)H * W * C;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  if (!covers(blocks, cols, vec4 ? n / 4 : n) || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec4)
    fill_bwd<4><<<grid, kThreads, 0, st>>>(g, rects, dx, S, K, H, W, C, cols);
  else
    fill_bwd<1><<<grid, kThreads, 0, st>>>(g, rects, dx, S, K, H, W, C, cols);
  return (int)cudaGetLastError();
}

const char* dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
