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
// What bounds it on this card: bytes, with the operations close behind. The
// broadcast write of the clean cache is B*N*h*w*c floats (77 MB for RN50's
// chunk of 12 masks on 2 images at 224: 0.023 ms at 3.35 TB/s); the delta is
// 2*k*k*Cin flops per output of the OH x OW window only (1.3 GFLOP there,
// 0.019 ms on the FFMA pipes). So the copy and the conv have to overlap, and
// the conv has to run near the FMA rate, which reading every tap's input,
// occlusion and kernel value from L1 (three loads for four FMAs) cannot.
//
// Design:
//   - One block per (mask, image, 4 output rows), the mask index on
//     gridDim.x so that an image's blocks run together and its clean slab
//     stays in L2. Every block writes its rows of clean with 16-byte loads
//     and stores, leaving out the pixels of the mask's window; a block whose
//     rows miss the window does only that, a short block, so the scheduler
//     balances the long window blocks against many short ones.
//   - A block whose rows meet the window stages, in shared memory, the stem
//     kernel [k*k*Cin, c] (37.6 KB at RN50) and the masked window's input
//     rows for its output rows, with up * occ multiplied once at staging.
//   - The delta is an implicit GEMM [window pixels] x [k*k*Cin] x [c] on the
//     FFMA pipes: each thread owns 8 consecutive pixels of one output row and
//     8 channels (two quads, c/2 apart, so that 8 neighbouring lanes store one
//     contiguous 128-byte line), 64 accumulators. A tap costs two 16-byte
//     kernel reads (a quarter warp reads 128 distinct bytes) and 8 window
//     reads for 64 FMAs. The taps are summed in the order dr, dc, Cin, as the
//     plain version and the TPU kernel sum them. It writes clean + delta with
//     16-byte stores. The per-mask window and delta never reach device memory.
//   - One launch per call.
//   - bf16 (the bf16 certify bank): the same kernel templated on the
//     element type. The clean copy moves 16 bytes (8 values) at a time; the
//     stem kernel and the masked window are widened to float32 as they are
//     staged (exactly: a bf16 value is a float32 with a short mantissa), so
//     the products of two bf16 operands are exact and the delta accumulates
//     in float32 in the same order; the epilogue rounds the delta to bf16
//     and adds it to clean with one more rounding, as the plain version's
//     `out += delta.to(bf16)` does (and the JAX kernel's `clean +
//     delta.astype(out.dtype)`).

#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;   // output rows per block
constexpr int kPix = 8;    // consecutive output pixels per thread

// Input rows and (zero-padded) input columns of the window a block stages.
__host__ __device__ inline int win_rows(int k, int s) { return (kRows - 1) * s + k; }
__host__ __device__ inline int win_cols(int OW, int k, int s) {
  return ((OW + kPix - 1) / kPix * kPix - 1) * s + k;
}

// A read-only element load, widened to float32.
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// out[q] = clean[q] + delta for the quad q of 4 channels: in float32 for
// float, and for bf16 the delta rounded to bf16 before a rounded add.
__device__ __forceinline__ void add_store(const float* cl, float* dst,
                                          size_t q, const float (&d)[4]) {
  float4 v = __ldg(reinterpret_cast<const float4*>(cl) + q);
  v.x += d[0];
  v.y += d[1];
  v.z += d[2];
  v.w += d[3];
  reinterpret_cast<float4*>(dst)[q] = v;
}
__device__ __forceinline__ void add_store(const __nv_bfloat16* cl,
                                          __nv_bfloat16* dst, size_t q,
                                          const float (&d)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(cl) + q);
  const __nv_bfloat16* cv = reinterpret_cast<const __nv_bfloat16*>(&raw);
  uint2 o;
  __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ov[i] = __float2bfloat16(__bfloat162float(cv[i]) +
                             __bfloat162float(__float2bfloat16(d[i])));
  reinterpret_cast<uint2*>(dst)[q] = o;
}

// Q quads of 4 channels per thread: 2 when c is a multiple of 8, else 1.
// T is the element type of up, occ, clean, kern and out (float or bf16).
template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
stem_fold(const int* __restrict__ geo, const T* __restrict__ up,
          const T* __restrict__ occ, const T* __restrict__ clean,
          const T* __restrict__ kern, T* __restrict__ out, int N,
          int Hp, int Wp, int Cin, int IH, int IW, int OH, int OW, int h,
          int w, int c, int k, int s) {
  extern __shared__ __align__(16) float smem[];
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int o0 = __ldg(geo + 4 * n + 0);
  const int oc0 = __ldg(geo + 4 * n + 1);
  const int i0 = __ldg(geo + 4 * n + 2);
  const int ic0 = __ldg(geo + 4 * n + 3);
  const int c4 = c / 4;
  const int cv = c * (int)sizeof(T) / 16;   // 16-byte vectors a pixel
  const int y0 = blockIdx.z * kRows;
  const int y1 = min(h, y0 + kRows);
  // the block's output rows inside the window, relative to the window
  const int wy0 = max(y0, o0) - o0;
  const int wy1 = min(y1, o0 + OH) - o0;
  const T* cl = clean + (size_t)b * h * w * c;
  T* dst = out + ((size_t)b * N + n) * h * w * c;

  // 1. the clean cache, outside the window
  const float4* cl16 = reinterpret_cast<const float4*>(cl);
  float4* dst16 = reinterpret_cast<float4*>(dst);
  for (int i = y0 * w * cv + threadIdx.x; i < y1 * w * cv; i += kThreads) {
    const int x = (i / cv) % w;
    const int y = i / (cv * w);
    if (y - o0 >= 0 && y - o0 < OH && x - oc0 >= 0 && x - oc0 < OW) continue;
    dst16[i] = __ldg(cl16 + i);
  }
  if (wy0 >= wy1) return;   // block-uniform: no row of the window

  // 2. stage the stem kernel and the masked window rows of outputs [wy0, wy1)
  const int taps = k * k * Cin;
  const int WC = win_cols(OW, k, s);
  float* ks = smem;                          // [taps, c]
  float* ws = smem + (size_t)taps * c;       // [WR, WC * Cin]
  if constexpr (sizeof(T) == 4) {
    for (int i = threadIdx.x; i < taps * c4; i += kThreads)
      reinterpret_cast<float4*>(ks)[i] = __ldg(reinterpret_cast<const float4*>(kern) + i);
  } else {
    for (int i = threadIdx.x; i < taps * c; i += kThreads)
      ks[i] = load(kern + i);
  }
  const int r_lo = wy0 * s;                  // first window input row staged
  const int nr = (wy1 - 1 - wy0) * s + k;
  const T* upb = up + (size_t)b * Hp * Wp * Cin;
  const T* occn = occ + (size_t)n * IH * IW;
  for (int i = threadIdx.x; i < nr * WC * Cin; i += kThreads) {
    const int ci = i % Cin;
    const int qc = (i / Cin) % WC;
    const int r = i / (Cin * WC);
    float v = 0.f;
    if (qc < IW)
      v = load(upb + ((size_t)(i0 + r_lo + r) * Wp + ic0 + qc) * Cin + ci) *
          load(occn + (r_lo + r) * IW + qc);
    ws[(size_t)r * WC * Cin + qc * Cin + ci] = v;
  }
  __syncthreads();

  // 3. the delta: (row, 8-pixel group, channel group) per thread
  const int cg_n = c4 / Q;
  const int pg_n = (OW + kPix - 1) / kPix;
  const int tasks = (wy1 - wy0) * pg_n * cg_n;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int cg = task % cg_n;
    const int pg = (task / cg_n) % pg_n;
    const int dy = wy0 + task / (cg_n * pg_n);
    const int dx0 = pg * kPix;
    float acc[kPix][Q][4];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
      for (int m = 0; m < Q; ++m)
        acc[p][m][0] = acc[p][m][1] = acc[p][m][2] = acc[p][m][3] = 0.f;
    const float* wrow = ws + (size_t)(dy * s - r_lo) * WC * Cin + dx0 * s * Cin;
    const float4* krow = reinterpret_cast<const float4*>(ks) + cg;
    for (int dr = 0; dr < k; ++dr) {
      for (int dc = 0; dc < k; ++dc) {
        const float* wp = wrow + ((size_t)dr * WC + dc) * Cin;
        const float4* kp = krow + (size_t)(dr * k + dc) * Cin * c4;
        for (int ci = 0; ci < Cin; ++ci) {
          float4 kv[Q];
#pragma unroll
          for (int m = 0; m < Q; ++m) kv[m] = kp[(size_t)ci * c4 + m * cg_n];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const float a = wp[p * s * Cin + ci];
#pragma unroll
            for (int m = 0; m < Q; ++m) {
              acc[p][m][0] = fmaf(a, kv[m].x, acc[p][m][0]);
              acc[p][m][1] = fmaf(a, kv[m].y, acc[p][m][1]);
              acc[p][m][2] = fmaf(a, kv[m].z, acc[p][m][2]);
              acc[p][m][3] = fmaf(a, kv[m].w, acc[p][m][3]);
            }
          }
        }
      }
    }
    const int y = o0 + dy;
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      if (dx0 + p < OW) {
        const size_t px = ((size_t)y * w + oc0 + dx0 + p) * c4;
#pragma unroll
        for (int m = 0; m < Q; ++m) add_store(cl, dst, px + cg + m * cg_n, acc[p][m]);
      }
    }
  }
}

inline size_t smem_bytes(int Cin, int OW, int c, int k, int s) {
  return 4 * ((size_t)k * k * Cin * c + (size_t)win_rows(k, s) * win_cols(OW, k, s) * Cin);
}

template <typename T, int Q>
int launch(const int* geo, const T* up, const T* occ, const T* clean,
           const T* kern, T* out, int B, int N, int Hp, int Wp, int Cin,
           int IH, int IW, int OH, int OW, int h, int w, int c, int k, int s,
           cudaStream_t st) {
  const size_t bytes = smem_bytes(Cin, OW, c, k, s);
  static size_t raised = 48 * 1024;   // the default dynamic limit
  if (bytes > raised) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_fold<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    raised = bytes;
  }
  const dim3 grid(N, B, (h + kRows - 1) / kRows);
  stem_fold<T, Q><<<grid, kThreads, bytes, st>>>(geo, up, occ, clean, kern,
                                                 out, N, Hp, Wp, Cin, IH, IW,
                                                 OH, OW, h, w, c, k, s);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const int* geo, const T* up, const T* occ, const T* clean,
          const T* kern, T* out, int B, int N, int Hp, int Wp, int Cin, int IH,
          int IW, int OH, int OW, int h, int w, int c, int k, int s,
          void* stream) {
  if (c * (int)sizeof(T) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (c % 8 == 0)
    return launch<T, 2>(geo, up, occ, clean, kern, out, B, N, Hp, Wp, Cin, IH,
                        IW, OH, OW, h, w, c, k, s, st);
  return launch<T, 1>(geo, up, occ, clean, kern, out, B, N, Hp, Wp, Cin, IH,
                      IW, OH, OW, h, w, c, k, s, st);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of kernel C takes (the wrapper
// checks it against the card's 227 KB before launching).
long long dp_stem_fold_smem(int Cin, int OW, int c, int k, int s) {
  return (long long)smem_bytes(Cin, OW, c, k, s);
}

// Kernel C. geo [N,4] int32, up [B,Hp,Wp,Cin], occ [N,IH,IW], clean [B,h,w,c],
// kern [k,k,Cin,c], out [B,N,h,w,c]; all f32 except geo, contiguous on the
// current device; c a multiple of 4 and clean, kern, out 16-byte aligned
// (the caller checks both).
int dp_stem_fold(const int* geo, const float* up, const float* occ,
                 const float* clean, const float* kern, float* out, int B, int N,
                 int Hp, int Wp, int Cin, int IH, int IW, int OH, int OW, int h,
                 int w, int c, int k, int s, void* stream) {
  return entry<float>(geo, up, occ, clean, kern, out, B, N, Hp, Wp, Cin, IH,
                      IW, OH, OW, h, w, c, k, s, stream);
}

// Kernel C on bf16 operands: up, occ, clean, kern and out bf16 (geo int32),
// the rest as for dp_stem_fold; c a multiple of 8 and clean, out 16-byte
// aligned (the caller checks both). Accumulates in float32.
int dp_stem_fold_bf16(const int* geo, const void* up, const void* occ,
                      const void* clean, const void* kern, void* out, int B,
                      int N, int Hp, int Wp, int Cin, int IH, int IW, int OH,
                      int OW, int h, int w, int c, int k, int s, void* stream) {
  using bf = __nv_bfloat16;
  return entry<bf>(geo, static_cast<const bf*>(up), static_cast<const bf*>(occ),
                   static_cast<const bf*>(clean), static_cast<const bf*>(kern),
                   static_cast<bf*>(out), B, N, Hp, Wp, Cin, IH, IW, OH, OW, h,
                   w, c, k, s, stream);
}

}  // extern "C"
