// Fused rasterize + occlusion fill, forward (kernel A) and backward (kernel B).
//
// Replaces the TPU kernels of dorpatch_tpu/ops/masked_fill.py:
//   A  _fwd_kernel (:53), launched by _pallas_fwd (:87)
//   B  _bwd_kernel (:66), launched by _pallas_bwd (:107)
//
// A: out[b, s] = where(occluded by rects[s], fill, imgs[b]) for every image b
//    and mask s: [B,H,W,C] x [S,K,4] -> [B,S,H,W,C]. A pure select, so it is
//    bound by bytes: the output (B*S*H*W*C floats) is written once, each image
//    is read once from device memory. Design: one block per (image, mask) with
//    the mask index on gridDim.x, the fastest-varying block index, so the S
//    blocks of one image run together and its H*W*C floats stay in L2 after
//    the first read. Each block loads its own K rectangles into shared memory
//    (no scalar prefetch on this card) and rasterizes them per element; no
//    mask tensor exists in memory. Threads move 16 bytes each when H*W*C is a
//    multiple of 4 and both buffers are 16-byte aligned, else 4 bytes.
//
// B: dx[b] = sum_s g[b, s] * keep[s]: [B,S,H,W,C] -> [B,H,W,C]. Bound by the
//    one read of g. The TPU kernel carries the sum over s across sequential
//    grid steps; CUDA blocks run in no order and nothing carries between
//    them, so each block owns kBwdCols output elements and sums over s
//    itself: its kBwdSplit thread rows take every kBwdSplit-th mask, then
//    row 0 adds the kBwdSplit partial sums in row order. No atomics, a fixed
//    order, a deterministic result. Splitting s across a block's rows gives
//    the attack step's 8 x 3072 outputs 768 blocks of 256 threads, enough
//    loads in flight to cover memory latency (one thread per element left
//    the card latency-bound at 6 warps per SM). The sums run in float64
//    (S adds per element, far below the card's FP64 rate), so the f32
//    result is the sum of the f32 terms up to float64 rounding, rounded
//    once, whatever the order of a reference's summation. A warp's threads
//    own consecutive elements, so every read of g is coalesced along
//    (h, w, c). The rectangles stream through shared memory in tiles of
//    kTileMasks masks.

#include <stdint.h>

#include "common.cuh"

namespace {

using dorpatch::kMaxRects;
using dorpatch::occluded;

constexpr int kFwdThreads = 256;
constexpr int kBwdCols = 32;    // output elements per block (one warp wide)
constexpr int kBwdSplit = 8;    // thread rows sharing the sum over masks
constexpr int kBwdThreads = kBwdCols * kBwdSplit;
constexpr int kTileMasks = 128;

__global__ void __launch_bounds__(kFwdThreads)
fill_fwd_vec4(const float* __restrict__ imgs, const int* __restrict__ rects,
              float* __restrict__ out, int S, int K, int H, int W, int C,
              float fill) {
  __shared__ int r[4 * kMaxRects];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  if (threadIdx.x < 4 * K) r[threadIdx.x] = rects[(size_t)s * 4 * K + threadIdx.x];
  __syncthreads();
  const int wc = W * C;
  const int n4 = H * wc / 4;
  const float4* src = reinterpret_cast<const float4*>(imgs + (size_t)b * H * wc);
  float4* dst = reinterpret_cast<float4*>(out + ((size_t)b * S + s) * H * wc);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    float4 v = __ldg(src + i);
    float* pv = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = 4 * i + j;
      const int row = e / wc;
      const int col = (e - row * wc) / C;
      if (occluded(r, K, row, col)) pv[j] = fill;
    }
    dst[i] = v;
  }
}

__global__ void __launch_bounds__(kFwdThreads)
fill_fwd_scalar(const float* __restrict__ imgs, const int* __restrict__ rects,
                float* __restrict__ out, int S, int K, int H, int W, int C,
                float fill) {
  __shared__ int r[4 * kMaxRects];
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  if (threadIdx.x < 4 * K) r[threadIdx.x] = rects[(size_t)s * 4 * K + threadIdx.x];
  __syncthreads();
  const int wc = W * C;
  const int n = H * wc;
  const float* src = imgs + (size_t)b * n;
  float* dst = out + ((size_t)b * S + s) * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int row = e / wc;
    const int col = (e - row * wc) / C;
    dst[e] = occluded(r, K, row, col) ? fill : __ldg(src + e);
  }
}

__global__ void __launch_bounds__(kBwdThreads)
fill_bwd(const float* __restrict__ g, const int* __restrict__ rects,
         float* __restrict__ dx, int S, int K, int H, int W, int C) {
  __shared__ int r[kTileMasks * 4 * kMaxRects];
  __shared__ double part[kBwdSplit][kBwdCols];
  const int wc = W * C;
  const int n = H * wc;
  const int b = blockIdx.y;
  const int tx = threadIdx.x % kBwdCols;
  const int ty = threadIdx.x / kBwdCols;
  const int e = blockIdx.x * kBwdCols + tx;
  const bool live = e < n;
  const int row = live ? e / wc : 0;
  const int col = live ? (e - row * wc) / C : 0;
  const float* gb = g + (size_t)b * S * n + (live ? e : 0);
  double acc = 0.0;
  for (int s0 = 0; s0 < S; s0 += kTileMasks) {
    const int ts = min(kTileMasks, S - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < ts * 4 * K; i += blockDim.x)
      r[i] = rects[(size_t)s0 * 4 * K + i];
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int t = ty; t < ts; t += kBwdSplit) {
        const float v = __ldg(gb + (size_t)(s0 + t) * n);
        if (!occluded(r + t * 4 * K, K, row, col)) acc += (double)v;
      }
    }
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && live) {
    double sum = part[0][tx];
#pragma unroll
    for (int j = 1; j < kBwdSplit; ++j) sum += part[j][tx];
    dx[(size_t)b * n + e] = (float)sum;
  }
}

}  // namespace

extern "C" {

// Kernel A. imgs [B,H,W,C] f32, rects [S,K,4] int32, out [B,S,H,W,C] f32;
// all contiguous on the current device. vec4 != 0 selects the 16-byte path
// (the caller checks H*W*C % 4 == 0 and 16-byte alignment).
int dp_masked_fill_fwd(const float* imgs, const int* rects, float* out, int B,
                       int S, int K, int H, int W, int C, float fill, int vec4,
                       void* stream) {
  if (K < 1 || K > kMaxRects) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const dim3 grid(S, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec4)
    fill_fwd_vec4<<<grid, kFwdThreads, 0, st>>>(imgs, rects, out, S, K, H, W, C, fill);
  else
    fill_fwd_scalar<<<grid, kFwdThreads, 0, st>>>(imgs, rects, out, S, K, H, W, C, fill);
  return (int)cudaGetLastError();
}

// Kernel B. g [B,S,H,W,C] f32, rects [S,K,4] int32, dx [B,H,W,C] f32.
int dp_masked_fill_bwd(const float* g, const int* rects, float* dx, int B,
                       int S, int K, int H, int W, int C, void* stream) {
  if (K < 1 || K > kMaxRects) return (int)cudaErrorInvalidValue;
  const int n = H * W * C;
  if (B == 0 || n == 0) return (int)cudaSuccess;
  const dim3 grid((n + kBwdCols - 1) / kBwdCols, B);
  fill_bwd<<<grid, kBwdThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      g, rects, dx, S, K, H, W, C);
  return (int)cudaGetLastError();
}

const char* dp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
