// Two-group masked-KV attention of the token-pruned ViT engine (kernel H).
//
// Replaces the TPU kernel of dorpatch_tpu/ops/masked_kv_attn.py:
//   H  _attn_kernel (:56), launched by masked_kv_attention (:81)
//
// For each (image b, mask entry c, head h), S dirty queries q [S, f]
// (pre-scaled) attend to the concatenation of two key/value groups:
//   - the image's clean cache kc/vc [T, f] (T = patch tokens + 1), shared by
//     every entry of the image, with clean_bias [T] (-1e9 on the stale rows
//     at the entry's dirty positions);
//   - the entry's fresh kd/vd [S, f], with dirty_bias [S] (-1e9 on duplicate
//     padding slots).
// Per query row: the max over both groups, the exp-sum, the exp-weighted sum
// of the values, divided once; out [S, f]. No logit or probability tensor
// reaches device memory. Layouts are the JAX package's: q/kd/vd/out
// [B,C,S,H,f], kc/vc [B,T,H,f], clean_bias [B,C,T], dirty_bias [B,C,S], f32.
//
// Bound: operations. A (entry, head) pair does 4*S*(T+S)*f flops on
// float32 FMAs (no tensor cores: the port runs float32 without TF32) and
// moves 16*S*f bytes of q, kd, vd and out; at ViT-B/16's phase 1 (T 197,
// S 50, f 64) that is about 60 flops a byte, three times the card's 20
// float32 flops per byte of device memory. Inside the SM the limit is
// shared memory: it serves 32 floats a clock against 128 FMAs, so every
// float read from it has to feed four FMAs or more.
//
// Design: one block of 16 warps per (group of G entries, head, image). The
// block stages the head's clean K and V rows in shared memory once and
// keeps them for its G entries, as the TPU kernel keeps the clean cache in
// VMEM across the mask axis; for each entry it appends the S dirty rows
// behind them (keys padded to a multiple of 32 with zero rows and bias
// -1e9), so one pass runs over the T+S keys as the reference's
// concatenation does. The queries go in chunks of 16 rows:
//   1. logits: a lane owns one key and takes it through 8 query rows at
//      once (32 independent sums): for each 4 features, one 16-byte read of
//      its key row (rows padded to f+4 floats, so that the lanes of a
//      16-byte access hit distinct banks) and 8 warp-wide broadcast reads of
//      the queries feed 128 FMAs. The biased logits go to a [16, keys]
//      buffer in shared memory;
//   2. softmax: a warp per row takes the max and the exp-sum by a fixed
//      xor butterfly and leaves exp(logit - max) in the buffer;
//   3. weighted values: a warp per (8 rows, one of 8 key slices); a lane
//      owns the features lane, lane+32, ... of its 8 rows and walks its
//      slice's keys in order, four keys per broadcast read of each row's
//      weights;
//   4. the 8 slices' partial sums are added in order and divided by the
//      row's exp-sum.
// Every sum has one fixed order, so the result is the same from run to run.
//
// Precondition: every row has an unmasked key. The engine never masks dirty
// slot 0 (the cls query's own fresh row), so the max is finite and the
// exp-sum is at least 1.
//
// Not yet: stacking the rows into 64-row tiles for the tensor cores (wgmma,
// with a 3xTF32 split to keep float32 accuracy) and TMA staging of the
// clean group.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;       // query rows per chunk
constexpr int kRowGroup = 8;    // rows a warp takes per key row, and per tile
constexpr int kSlices = 8;      // key slices of the weighted sum
static_assert((kRows / kRowGroup) * kSlices == kWarps,
              "one weighted-sum tile per warp");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 232448;   // a block's most on Hopper

inline int padded_keys(int T, int S) { return (T + S + 31) / 32 * 32; }

// Floats of dynamic shared memory a block takes: K rows padded to f+4, V
// rows and one bias per padded key, the chunk's queries, its logits, row
// sums, and the weighted sum's per-slice partials.
inline size_t smem_floats(int T, int S, int f) {
  const size_t np = padded_keys(T, S);
  return np * (f + 4) + np * f + np + (size_t)kRows * f + (size_t)kRows * np +
         kRows + (size_t)kSlices * kRows * f;
}

template <int F>
__global__ void __launch_bounds__(kThreads, 1)
masked_kv_attn(const float* __restrict__ q, const float* __restrict__ kd,
               const float* __restrict__ vd, const float* __restrict__ kc,
               const float* __restrict__ vc, const float* __restrict__ cb,
               const float* __restrict__ db, float* __restrict__ out, int C,
               int S, int H, int T, int G) {
  constexpr int FP = F + 4;
  constexpr int F4 = F / 4;
  constexpr int FL = F / 32;   // features a lane owns in the weighted sum
  extern __shared__ __align__(16) float smem[];
  const int N = T + S;
  const int NP = (N + 31) / 32 * 32;
  float* ks = smem;                           // [NP, FP] clean, dirty, zero
  float* vs = ks + (size_t)NP * FP;           // [NP, F]
  float* bs = vs + (size_t)NP * F;            // [NP] clean, dirty, -1e9
  float* qs = bs + NP;                        // [kRows, F]
  float* ls = qs + kRows * F;                 // [kRows, NP] logits, weights
  float* rsum = ls + (size_t)kRows * NP;      // [kRows]
  float* part = rsum + kRows;                 // [kSlices, kRows, F]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = (int)blockIdx.x * G;
  const int c_end = min(C, c0 + G);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // the clean group, once for all of the block's entries, and the padding
  for (int i = threadIdx.x; i < T * F4; i += kThreads) {
    const int t = i / F4, d4 = i % F4;
    const size_t g = (((size_t)b * T + t) * H + h) * F + 4 * d4;
    *reinterpret_cast<float4*>(ks + (size_t)t * FP + 4 * d4) =
        __ldg(reinterpret_cast<const float4*>(kc + g));
    *reinterpret_cast<float4*>(vs + (size_t)t * F + 4 * d4) =
        __ldg(reinterpret_cast<const float4*>(vc + g));
  }
  for (int i = threadIdx.x; i < (NP - N) * F4; i += kThreads) {
    const int t = N + i / F4, d4 = i % F4;
    *reinterpret_cast<float4*>(ks + (size_t)t * FP + 4 * d4) = zero4;
    *reinterpret_cast<float4*>(vs + (size_t)t * F + 4 * d4) = zero4;
  }
  for (int t = N + threadIdx.x; t < NP; t += kThreads) bs[t] = -1e9f;

  for (int c = c0; c < c_end; ++c) {
    const size_t e = (size_t)b * C + c;
    __syncthreads();   // the previous entry's weighted sums are done with V
    for (int i = threadIdx.x; i < S * F4; i += kThreads) {
      const int s = i / F4, d4 = i % F4;
      const size_t g = ((e * S + s) * H + h) * F + 4 * d4;
      *reinterpret_cast<float4*>(ks + (size_t)(T + s) * FP + 4 * d4) =
          __ldg(reinterpret_cast<const float4*>(kd + g));
      *reinterpret_cast<float4*>(vs + (size_t)(T + s) * F + 4 * d4) =
          __ldg(reinterpret_cast<const float4*>(vd + g));
    }
    for (int t = threadIdx.x; t < T; t += kThreads) bs[t] = __ldg(cb + e * T + t);
    for (int s = threadIdx.x; s < S; s += kThreads)
      bs[T + s] = __ldg(db + e * S + s);

    for (int r0 = 0; r0 < S; r0 += kRows) {
      const int rc = min(kRows, S - r0);
      for (int i = threadIdx.x; i < kRows * F4; i += kThreads) {
        const int r = i / F4, d4 = i % F4;
        float4 v = zero4;
        if (r < rc)
          v = __ldg(reinterpret_cast<const float4*>(
                        q + ((e * S + r0 + r) * H + h) * F) + d4);
        *reinterpret_cast<float4*>(qs + r * F + 4 * d4) = v;
      }
      __syncthreads();   // the queries (and the entry's rows) are staged

      // 1. logits: (32-key chunk, 8-row group) per warp task; a lane's key
      //    row goes through the 8 rows at once, 32 independent sums
      const int nkc = NP / 32;
      for (int task = warp; task < nkc * (kRows / kRowGroup);
           task += kWarps) {
        const int j = (task % nkc) * 32 + lane;
        const int r_lo = (task / nkc) * kRowGroup;
        if (r_lo >= rc) continue;   // warp-uniform
        const float4* krow =
            reinterpret_cast<const float4*>(ks + (size_t)j * FP);
        const float4* qr = reinterpret_cast<const float4*>(qs + r_lo * F);
        float acc[kRowGroup][4];
#pragma unroll
        for (int rr = 0; rr < kRowGroup; ++rr)
          acc[rr][0] = acc[rr][1] = acc[rr][2] = acc[rr][3] = 0.f;
#pragma unroll 4
        for (int d4 = 0; d4 < F4; ++d4) {
          const float4 kv = krow[d4];
#pragma unroll
          for (int rr = 0; rr < kRowGroup; ++rr) {
            const float4 qv = qr[rr * F4 + d4];   // broadcast
            acc[rr][0] = fmaf(qv.x, kv.x, acc[rr][0]);
            acc[rr][1] = fmaf(qv.y, kv.y, acc[rr][1]);
            acc[rr][2] = fmaf(qv.z, kv.z, acc[rr][2]);
            acc[rr][3] = fmaf(qv.w, kv.w, acc[rr][3]);
          }
        }
        const float bj = bs[j];
#pragma unroll
        for (int rr = 0; rr < kRowGroup; ++rr)
          if (r_lo + rr < rc)
            ls[(size_t)(r_lo + rr) * NP + j] =
                ((acc[rr][0] + acc[rr][1]) + (acc[rr][2] + acc[rr][3])) + bj;
      }
      __syncthreads();

      // 2. softmax numerators and row sums: a warp per row
      for (int r = warp; r < rc; r += kWarps) {
        float* lr = ls + (size_t)r * NP;
        float m = __int_as_float((int)0xff800000u);   // -inf
        for (int j = lane; j < NP; j += 32) m = fmaxf(m, lr[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
        float sum = 0.f;
        for (int j = lane; j < NP; j += 32) {
          const float p = expf(lr[j] - m);
          lr[j] = p;
          sum += p;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        if (lane == 0) rsum[r] = sum;
      }
      __syncthreads();

      // 3. weighted values: (8-row tile, key slice) per warp
      {
        const int r_lo = (warp / kSlices) * kRowGroup;
        const int sl = warp % kSlices;
        const int len = NP / kSlices;   // a multiple of 4
        float acc[kRowGroup][FL];
#pragma unroll
        for (int rr = 0; rr < kRowGroup; ++rr)
#pragma unroll
          for (int k = 0; k < FL; ++k) acc[rr][k] = 0.f;
        if (r_lo < rc) {
          for (int j = sl * len; j < (sl + 1) * len; j += 4) {
            float v[4][FL];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int k = 0; k < FL; ++k)
                v[u][k] = vs[(size_t)(j + u) * F + lane + 32 * k];
#pragma unroll
            for (int rr = 0; rr < kRowGroup; ++rr) {
              const float4 p = *reinterpret_cast<const float4*>(
                  ls + (size_t)(r_lo + rr) * NP + j);
#pragma unroll
              for (int k = 0; k < FL; ++k) {
                float a = acc[rr][k];
                a = fmaf(p.x, v[0][k], a);
                a = fmaf(p.y, v[1][k], a);
                a = fmaf(p.z, v[2][k], a);
                a = fmaf(p.w, v[3][k], a);
                acc[rr][k] = a;
              }
            }
          }
#pragma unroll
          for (int rr = 0; rr < kRowGroup; ++rr)
#pragma unroll
            for (int k = 0; k < FL; ++k)
              part[((size_t)sl * kRows + r_lo + rr) * F + lane + 32 * k] =
                  acc[rr][k];
        }
      }
      __syncthreads();

      // 4. the slices in order, divided by the row's exp-sum
      for (int i = threadIdx.x; i < rc * F; i += kThreads) {
        const int r = i / F, d = i % F;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kSlices; ++k) s += part[((size_t)k * kRows + r) * F + d];
        out[((e * S + r0 + r) * H + h) * F + d] = s / rsum[r];
      }
    }
  }
}

// The block's dynamic shared-memory limit raised to the card's 227 KB and
// the SM count, once per head width (so that a launch captured into a CUDA
// graph makes no attribute calls).
template <int F>
cudaError_t setup(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_kv_attn<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    int dev = 0, n = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    cached = n;
  }
  *sms = cached;
  return cudaSuccess;
}

template <int F>
int launch(const float* q, const float* kd, const float* vd, const float* kc,
           const float* vc, const float* cb, const float* db, float* out,
           int B, int C, int S, int H, int T, cudaStream_t st) {
  const size_t bytes = 4 * smem_floats(T, S, F);
  if (bytes > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = setup<F>(&sms);
  if (err != cudaSuccess) return (int)err;
  // entries per block: one block fits an SM, so choose G for the fewest
  // waves of blocks times the entries each takes, with a tenth of an entry
  // for staging the clean group
  int G = 1;
  double best = 0.0;
  for (int g = 1; g <= C; ++g) {
    const long long blocks = (long long)((C + g - 1) / g) * B * H;
    const double cost = (double)((blocks + sms - 1) / sms) * (g + 0.1);
    if (g == 1 || cost < best) {
      best = cost;
      G = g;
    }
  }
  const dim3 grid((C + G - 1) / G, H, B);
  masked_kv_attn<F><<<grid, kThreads, bytes, st>>>(q, kd, vd, kc, vc, cb, db,
                                                   out, C, S, H, T, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs (the wrapper checks it
// against the card's 227 KB before launching).
long long dp_masked_kv_attn_smem(int T, int S, int f) {
  return (long long)(4 * smem_floats(T, S, f));
}

// Kernel H. q/kd/vd/out [B,C,S,H,f], kc/vc [B,T,H,f], cb [B,C,T], db [B,C,S];
// float32, contiguous, 16-byte aligned, on the current device. f is 32 or
// 64.
int dp_masked_kv_attn(const float* q, const float* kd, const float* vd,
                      const float* kc, const float* vc, const float* cb,
                      const float* db, float* out, int B, int C, int S, int H,
                      int f, int T, void* stream) {
  if (B == 0 || C == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (f) {
    case 32: return launch<32>(q, kd, vd, kc, vc, cb, db, out, B, C, S, H, T, st);
    case 64: return launch<64>(q, kd, vd, kc, vc, cb, db, out, B, C, S, H, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
