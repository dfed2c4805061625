// Masked-stem fold (kernel C): occlusion masks applied in post-stem space.
//
// Replaces the TPU kernel dorpatch_tpu/ops/stem_fold.py _fold_kernel (:214),
// launched by fold_masked_stem_kernel (:227).
//
// For image b and mask n of a family with the uniform window plan
// (geo[n] = (o0, oc0, i0, ic0), enlarged window [IH, IW], outputs [OH, OW]):
//   win   = up[b, i0:i0+IH, ic0:ic0+IW, :] * occ[n]        (fill delta, masked)
//   delta = VALID k x k conv of win with the stem kernel (stride s)
//   out[b, n] = clean[b] + delta scattered at (o0, oc0)
// with up = pad(norm_scale * (fill - img)), clean the clean stem activation
// [h, w, c] and kernel [k, k, Cin, c] (HWIO).
//
// What bounds it on this card: bytes. The broadcast write of the clean cache
// is B*N*h*w*c floats (6.3 MB per CIFAR chunk of 3 masks for 8 images); the
// delta conv is 2*k*k*Cin FLOPs per output of the OH x OW window only. Design:
// one block per (mask, image, two output rows), mask index on gridDim.x so an
// image's blocks run together and its clean slab stays in L2; 384 blocks for
// the CIFAR chunk. Every thread owns four channels of one pixel: it reads
// clean as one float4, adds the delta where the pixel lies in the mask's
// window and writes 16 bytes. The delta reads the window of the fill delta
// `up`, the occlusion indicator and the stem kernel straight from global
// memory: the 16 threads of a pixel read the same k*k*Cin inputs and every
// block reads the same small kernel, so these reads hit L1/L2, and no block
// waits on shared-memory staging. The delta accumulates in f32 in the order
// dr, dc, Cin, as the plain version and the TPU kernel do. The per-mask
// window and delta never reach device memory.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 2;

__global__ void __launch_bounds__(kThreads)
stem_fold(const int* __restrict__ geo, const float* __restrict__ up,
          const float* __restrict__ occ, const float* __restrict__ clean,
          const float* __restrict__ kern, float* __restrict__ out, int N,
          int Hp, int Wp, int Cin, int IH, int IW, int OH, int OW, int h,
          int w, int c, int k, int s) {
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int o0 = __ldg(geo + 4 * n + 0);
  const int oc0 = __ldg(geo + 4 * n + 1);
  const int i0 = __ldg(geo + 4 * n + 2);
  const int ic0 = __ldg(geo + 4 * n + 3);
  const int c4 = c / 4;
  const int y0 = blockIdx.z * kRowsPerBlock;
  const int y1 = min(h, y0 + kRowsPerBlock);
  const float4* cl = reinterpret_cast<const float4*>(clean + (size_t)b * h * w * c);
  float4* dst = reinterpret_cast<float4*>(out + ((size_t)b * N + n) * h * w * c);
  const float4* ker4 = reinterpret_cast<const float4*>(kern);
  const float* upb = up + (size_t)b * Hp * Wp * Cin;
  const float* occn = occ + (size_t)n * IH * IW;
  for (int i = y0 * w * c4 + threadIdx.x; i < y1 * w * c4; i += blockDim.x) {
    const int co4 = i % c4;
    const int x = (i / c4) % w;
    const int y = i / (c4 * w);
    float4 v = __ldg(cl + i);
    const int dy = y - o0;
    const int dx = x - oc0;
    if (dy >= 0 && dy < OH && dx >= 0 && dx < OW) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int dr = 0; dr < k; ++dr) {
        for (int dc = 0; dc < k; ++dc) {
          const int r = dy * s + dr;
          const int q = dx * s + dc;
          const float m = __ldg(occn + r * IW + q);
          const float* wp = upb + ((size_t)(i0 + r) * Wp + ic0 + q) * Cin;
          const float4* kp = ker4 + (size_t)(dr * k + dc) * Cin * c4 + co4;
          for (int ci = 0; ci < Cin; ++ci) {
            const float a = __ldg(wp + ci) * m;
            const float4 kk = __ldg(kp + (size_t)ci * c4);
            acc.x = fmaf(a, kk.x, acc.x);
            acc.y = fmaf(a, kk.y, acc.y);
            acc.z = fmaf(a, kk.z, acc.z);
            acc.w = fmaf(a, kk.w, acc.w);
          }
        }
      }
      v.x += acc.x;
      v.y += acc.y;
      v.z += acc.z;
      v.w += acc.w;
    }
    dst[i] = v;
  }
}

}  // namespace

extern "C" {

// Kernel C. geo [N,4] int32, up [B,Hp,Wp,Cin], occ [N,IH,IW], clean [B,h,w,c],
// kern [k,k,Cin,c], out [B,N,h,w,c]; all f32 except geo, contiguous on the
// current device; c a multiple of 4 and clean, kern, out 16-byte aligned
// (the caller checks both).
int dp_stem_fold(const int* geo, const float* up, const float* occ,
                 const float* clean, const float* kern, float* out, int B, int N,
                 int Hp, int Wp, int Cin, int IH, int IW, int OH, int OW, int h,
                 int w, int c, int k, int s, void* stream) {
  if (c % 4 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid(N, B, (h + kRowsPerBlock - 1) / kRowsPerBlock);
  stem_fold<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      geo, up, occ, clean, kern, out, N, Hp, Wp, Cin, IH, IW, OH, OW, h, w, c,
      k, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
