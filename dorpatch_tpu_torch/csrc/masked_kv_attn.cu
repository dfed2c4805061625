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
// Per query row: one max-stabilized softmax over both groups and the
// weighted sum of the values; out [S, f]. No logit or probability tensor
// reaches device memory. Layouts are the JAX package's: q/kd/vd/out
// [B,C,S,H,f], kc/vc [B,T,H,f], clean_bias [B,C,T], dirty_bias [B,C,S], f32.
//
// What bounds it on this card: operations, and behind them the latency of
// the reads. An (entry, head) pair does 4*S*(T+S)*f flops against 16*S*f
// bytes of q, kd, vd and out (about 60 flops a byte at ViT-B/16's phase 1:
// T 197, S 50, f 64). On the FFMA pipes shared-memory reads would bound it
// before the FMAs do, so both products, Q.K^T and P.V, over both groups,
// run on the tensor cores (mma.sync.m16n8k8 tf32) in
// 3xTF32: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and a*b is
// taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (the lo*lo term is below
// float32's rounding). No product runs on FFMA. The tensor cores truncate
// as they accumulate, so each k8 slice's three MMAs start from zero and the
// slice is added into a float32 register with a rounding add: a running MMA
// accumulator was several times less accurate than float32 FMAs.
//
// Design:
//   - One block of 8 warps per (group of G entries, head, image). It splits
//     the head's clean K and V ([T, f]) into hi/lo once and stages them in
//     shared memory (218 KB at T 197, f 64: one block an SM), and keeps them
//     for its G entries, as the TPU kernel keeps the clean cache in VMEM
//     across the mask axis. The layout gives a lane its whole split B
//     fragment (hi and lo of two features, or of two keys' values) in one
//     16-byte read, and the row strides put a quarter warp's reads on 8
//     distinct 16-byte bank slots. Split at staging, the clean fragments
//     cost no instructions but their reads and MMAs in the warps.
//   - A work item is 16 query rows of one entry (the MMA's M); the block's
//     G * ceil(S/16) items go round its warps. A warp holds its 16 query rows
//     as split A fragments in registers for the whole item.
//   - No logit row in shared memory: the warp walks the keys in tiles of 32
//     (the clean group, then the entry's dirty group, one fixed order) with a
//     running row max and exp-sum in registers (online softmax); the output
//     accumulator [16, f] stays in registers and is divided once at the end.
//     A tile has no branch: keys past the end of a group read its last row
//     and take the bias -1e9 (weight 0 exactly), so the compiler can overlap
//     its independent MMA chains.
//   - The MMA's k index is permuted so that no lane exchange is needed: in
//     Q.K^T the k slots (t, t+4) of lane t take features (2t, 2t+1); in P.V
//     they take keys (2t, 2t+1), which is where the Q.K^T accumulator already
//     holds them, so the probabilities go from the accumulator to the A
//     fragment without a shuffle or a trip through shared memory.
//   - The dirty K and V rows of an entry (a fifth to a third of the keys)
//     are read from device memory and split in registers: the clean group
//     leaves no shared memory for them. Their reads, not the MMAs, set the
//     time of a round of items (a variant without the clean keys was not
//     faster on the card).
//   - G is chosen at launch from the rounds of items on the busiest SM and
//     the number of waves (see `launch`).
//   - Where T is too long for the split clean group to fit a block, the
//     clean group is read from device memory like the dirty group.
// Every sum has one fixed order and no atomics are used, so the result is
// the same from run to run.
//
// Precondition: every row has an unmasked key. The engine never masks dirty
// slot 0 (the cls query's own fresh row), so the final max is finite and the
// exp-sum is at least 1. Masked keys (-1e9) that come before the first live
// key of a row are rescaled by exp(-1e9 - max) = 0 when it arrives.
//
// Not yet: wgmma tiles of 64 rows stacked across entries, TMA staging, and
// the dirty group staged in shared memory.
//
// A bf16 form (masked_kv_attn_bf16, below) serves the bf16 certify bank; it
// stages both groups.

#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;       // query rows per work item (MMA M)
constexpr int kTile = 4;        // 8-key MMA tiles per softmax step
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 232448;   // a block's most on Hopper
constexpr float kMasked = -1e9f;        // the engine's bias of a masked key

// The staged clean group. K row r: for each 8 features and each t < 4 the
// float4 (hi f0, hi f1, lo f0, lo f1) of features f0, f1 = 8kk+2t, +1: one
// 16-byte read is a lane's split B fragment. V pair row u (keys 2u, 2u+1):
// for each feature d the float4 (hi, hi, lo, lo) of the two keys. The row
// strides put the 8 lanes of a quarter warp on 8 distinct 16-byte slots.
template <int F> struct Staged {
  static constexpr int KS = 2 * F + 16;   // = 16 (mod 32) floats
  static constexpr int VS = 4 * F + 8;    // = 8 (mod 32) floats
  static size_t floats(int T) { return (size_t)T * KS + (size_t)(T + 1) / 2 * VS; }
};

// TF32 rounding to nearest (ties away), as cvt.rna.tf32.f32 without its
// NaN/inf handling: add half a TF32 ulp to the bits and cut the 13 low ones
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a*b of one k8 slice in 3xTF32, the small terms first, from zero; b is
// (hi b0, hi b1, lo b0, lo b1). The tensor cores add into their accumulator
// with truncation; a long chain of MMAs into one running sum would gather
// about an ulp of it per MMA, so every caller adds d into its float32 sum
// with a rounding add instead.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma(d, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma(d, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

// (hi x, hi y, lo x, lo y) as floats holding TF32 bits
__device__ __forceinline__ float4 split2(float x, float y) {
  uint32_t hx, lx, hy, ly;
  split(x, hx, lx);
  split(y, hy, ly);
  return make_float4(__uint_as_float(hx), __uint_as_float(hy),
                     __uint_as_float(lx), __uint_as_float(ly));
}

// One warp's running state over one work item: rows g and g+8 of the tile
// (g = lane / 4), the four lanes of a row each holding two of every 8 keys'
// logits and two of every 8 features' outputs.
template <int F>
struct Item {
  static constexpr int KK = F / 8;
  uint32_t qh[KK][4], ql[KK][4];   // split query A fragments, per 8 features
  float o[KK][4];                  // output accumulator, per 8 features
  float m[2], l[2];                // running max, this lane's exp-sum share
};

// A group of keys: `valid` rows with their biases bp[key]. Staged: the clean
// group split in shared memory (`Staged` layout at kp, vp). Otherwise rows
// in device memory, K(key, f) = kp[key * stride + f] and V likewise, split
// in registers as they are read.
struct Group {
  const float* kp;
  const float* vp;
  const float* bp;
  int stride;
  int valid;
};

// One softmax step over the kTile 8-key MMA tiles from key n0 of a group.
// Keys at or past `valid` read the group's last row and take the bias -1e9,
// so that their weight is exp(-1e9 - max) = 0 exactly and they add exact
// zeros: the step has no branch, and its kTile x KK MMA chains are
// independent.
template <int F, bool kStaged>
__device__ __forceinline__ void step(Item<F>& it, const Group& gr, int n0,
                                     int g, int t) {
  constexpr int KK = F / 8;
  float s[kTile][4];
  // logits: lane (g, t) gives key n0+8j+g's features (2t, 2t+1) of each 8;
  // the KK slices are independent MMA chains, summed in order
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int key = min(n0 + 8 * j + g, gr.valid - 1);
    float d[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      float4 kv;
      if (kStaged) {
        kv = *reinterpret_cast<const float4*>(gr.kp + key * Staged<F>::KS +
                                              16 * kk + 4 * t);
      } else {
        const float2 x = __ldg(reinterpret_cast<const float2*>(
            gr.kp + (size_t)key * gr.stride + 8 * kk + 2 * t));
        kv = split2(x.x, x.y);
      }
      mma3(d[kk], it.qh[kk], it.ql[kk], kv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = d[0][i];
#pragma unroll
      for (int kk = 1; kk < KK; ++kk) v += d[kk][i];
      s[j][i] = v;
    }
  }
  // biases and the tile's row max (the four lanes of a row by a fixed xor)
  float mx0 = it.m[0], mx1 = it.m[1];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int key = n0 + 8 * j + 2 * t;
    const float b0 = key < gr.valid ? __ldg(gr.bp + key) : kMasked;
    const float b1 = key + 1 < gr.valid ? __ldg(gr.bp + key + 1) : kMasked;
    s[j][0] += b0;
    s[j][1] += b1;
    s[j][2] += b0;
    s[j][3] += b1;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
  }
  const float sc0 = expf(it.m[0] - mx0);   // 0 on the first step (-inf)
  const float sc1 = expf(it.m[1] - mx1);
  it.m[0] = mx0;
  it.m[1] = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    s[j][0] = expf(s[j][0] - mx0);
    s[j][1] = expf(s[j][1] - mx0);
    s[j][2] = expf(s[j][2] - mx1);
    s[j][3] = expf(s[j][3] - mx1);
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  it.l[0] = it.l[0] * sc0 + sum0;
  it.l[1] = it.l[1] * sc1 + sum1;
#pragma unroll
  for (int jf = 0; jf < KK; ++jf) {
    it.o[jf][0] *= sc0;
    it.o[jf][1] *= sc0;
    it.o[jf][2] *= sc1;
    it.o[jf][3] *= sc1;
  }
  // weighted values: k slots (t, t+4) of the A fragment are keys (2t, 2t+1)
  // of the 8-key tile, the accumulator's own columns
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    uint32_t ph[4], pl[4];
    split(s[j][0], ph[0], pl[0]);
    split(s[j][2], ph[1], pl[1]);
    split(s[j][1], ph[2], pl[2]);
    split(s[j][3], ph[3], pl[3]);
    const int key = n0 + 8 * j + 2 * t;
    const float* v0r;
    const float* v1r;
    if (kStaged) {
      v0r = gr.vp + (size_t)min(key / 2, (gr.valid - 1) / 2) * Staged<F>::VS + 4 * g;
      v1r = v0r;
    } else {
      v0r = gr.vp + (size_t)min(key, gr.valid - 1) * gr.stride + g;
      v1r = gr.vp + (size_t)min(key + 1, gr.valid - 1) * gr.stride + g;
    }
#pragma unroll
    for (int jf = 0; jf < KK; ++jf) {
      const float4 vv =
          kStaged ? *reinterpret_cast<const float4*>(v0r + 32 * jf)
                  : split2(__ldg(v0r + 8 * jf), __ldg(v1r + 8 * jf));
      float pv[4];
      mma3(pv, ph, pl, vv);
      it.o[jf][0] += pv[0];
      it.o[jf][1] += pv[1];
      it.o[jf][2] += pv[2];
      it.o[jf][3] += pv[3];
    }
  }
}

// The split query A fragments of rows r0+g and r0+g+8 of entry e (zero past
// S): k slots (t, t+4) of each 8 features are features (2t, 2t+1).
template <int F>
__device__ __forceinline__ void load_queries(Item<F>& it, const float* q,
                                             size_t e, int r0, int S, int H,
                                             int h, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < F / 8; ++kk) {
    float2 a = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
    if (r0 + g < S)
      a = __ldg(reinterpret_cast<const float2*>(
          q + ((e * S + r0 + g) * H + h) * F + 8 * kk + 2 * t));
    if (r0 + g + 8 < S)
      b = __ldg(reinterpret_cast<const float2*>(
          q + ((e * S + r0 + g + 8) * H + h) * F + 8 * kk + 2 * t));
    split(a.x, it.qh[kk][0], it.ql[kk][0]);
    split(b.x, it.qh[kk][1], it.ql[kk][1]);
    split(a.y, it.qh[kk][2], it.ql[kk][2]);
    split(b.y, it.qh[kk][3], it.ql[kk][3]);
  }
}

// kStaged: the clean group split into shared memory once per block (T rows
// that fit); otherwise read from device memory like the dirty group.
template <int F, bool kStaged>
__global__ void __launch_bounds__(kThreads)
masked_kv_attn(const float* __restrict__ q, const float* __restrict__ kd,
               const float* __restrict__ vd, const float* __restrict__ kc,
               const float* __restrict__ vc, const float* __restrict__ cb,
               const float* __restrict__ db, float* __restrict__ out, int C,
               int S, int H, int T, int G) {
  constexpr int KK = F / 8;
  using L = Staged<F>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [T, L::KS] clean K, split
  float* vs = ks + (size_t)T * L::KS;  // [(T+1)/2, L::VS] clean V, split
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = (int)blockIdx.x * G;
  const int tiles = (S + kRows - 1) / kRows;
  const int items = (min(C, c0 + G) - c0) * tiles;

  Item<F> it;
  int item = warp;
  size_t e = (size_t)b * C + c0 + item / tiles;
  int r0 = (item % tiles) * kRows;
  if (item < items) load_queries<F>(it, q, e, r0, S, H, h, g, t);

  if (kStaged) {
    // the clean group, split once for all of the block's entries
    const float* kcb = kc + ((size_t)b * T * H + h) * F;
    const float* vcb = vc + ((size_t)b * T * H + h) * F;
    for (int i = threadIdx.x; i < T * (F / 4); i += kThreads) {
      const int r = i / (F / 4), f4 = i % (F / 4);
      const float4 x = __ldg(reinterpret_cast<const float4*>(
          kcb + (size_t)r * H * F + 4 * f4));
      // features 4f4, +1 are pair t = (2f4) % 4 of slice kk = f4 / 2
      float* dst = ks + r * L::KS + 16 * (f4 / 2) + 4 * ((2 * f4) % 4);
      *reinterpret_cast<float4*>(dst) = split2(x.x, x.y);
      *reinterpret_cast<float4*>(dst + 4) = split2(x.z, x.w);
    }
    for (int i = threadIdx.x; i < (T + 1) / 2 * (F / 4); i += kThreads) {
      const int u = i / (F / 4), f4 = i % (F / 4);
      const float4 x0 = __ldg(reinterpret_cast<const float4*>(
          vcb + (size_t)(2 * u) * H * F + 4 * f4));
      float4 x1 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (2 * u + 1 < T)
        x1 = __ldg(reinterpret_cast<const float4*>(
            vcb + (size_t)(2 * u + 1) * H * F + 4 * f4));
      float4* dst = reinterpret_cast<float4*>(vs + u * L::VS + 16 * f4);
      dst[0] = split2(x0.x, x1.x);
      dst[1] = split2(x0.y, x1.y);
      dst[2] = split2(x0.z, x1.z);
      dst[3] = split2(x0.w, x1.w);
    }
    __syncthreads();
  }

  for (; item < items; item += kWarps) {
    if (item != warp) {
      e = (size_t)b * C + c0 + item / tiles;
      r0 = (item % tiles) * kRows;
      load_queries<F>(it, q, e, r0, S, H, h, g, t);
    }
    it.m[0] = it.m[1] = __int_as_float((int)0xff800000u);   // -inf
    it.l[0] = it.l[1] = 0.f;
#pragma unroll
    for (int jf = 0; jf < KK; ++jf)
      it.o[jf][0] = it.o[jf][1] = it.o[jf][2] = it.o[jf][3] = 0.f;
    // the clean keys, then the dirty keys, 32 at a time
    if (kStaged) {
      const Group clean{ks, vs, cb + e * T, 0, T};
      for (int n0 = 0; n0 < T; n0 += 8 * kTile) step<F, true>(it, clean, n0, g, t);
    } else {
      const Group clean{kc + ((size_t)b * T * H + h) * F,
                        vc + ((size_t)b * T * H + h) * F, cb + e * T, H * F, T};
      for (int n0 = 0; n0 < T; n0 += 8 * kTile) step<F, false>(it, clean, n0, g, t);
    }
    const Group dirty{kd + (e * S * H + h) * F, vd + (e * S * H + h) * F,
                      db + e * S, H * F, S};
    for (int n0 = 0; n0 < S; n0 += 8 * kTile) step<F, false>(it, dirty, n0, g, t);
    // the row's exp-sum over its four lanes, then one division
    float l0 = it.l[0], l1 = it.l[1];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, o);
      l1 += __shfl_xor_sync(kFull, l1, o);
    }
#pragma unroll
    for (int jf = 0; jf < KK; ++jf) {
      const int d = 8 * jf + 2 * t;
      if (r0 + g < S)
        *reinterpret_cast<float2*>(out + ((e * S + r0 + g) * H + h) * F + d) =
            make_float2(it.o[jf][0] / l0, it.o[jf][1] / l0);
      if (r0 + g + 8 < S)
        *reinterpret_cast<float2*>(out + ((e * S + r0 + g + 8) * H + h) * F + d) =
            make_float2(it.o[jf][2] / l1, it.o[jf][3] / l1);
    }
  }
}

// The staged kernel's dynamic shared-memory limit raised to the card's
// 227 KB and the SM count, once per head width (so that a launch captured
// into a CUDA graph makes no attribute calls).
template <int F>
cudaError_t setup(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_kv_attn<F, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  int sms = 0;
  cudaError_t err = setup<F>(&sms);
  if (err != cudaSuccess) return (int)err;
  // entries per block. A block takes an SM (its shared memory), and a
  // "round" is one work item on each of its warps, so an SM runs
  // waves x ceil(G * tiles / kWarps) rounds: choose G for the fewest, and
  // among those the fewest waves that are still two or more (on the card,
  // at the ViT-B/16 shapes, one wave of long blocks was slower than two
  // waves with the same rounds)
  const int tiles = (S + kRows - 1) / kRows;
  int G = 1;
  long long best = -1, best_waves = 0;
  for (int g = 1; g <= C; ++g) {
    const long long blocks = (long long)((C + g - 1) / g) * B * H;
    const long long waves = (blocks + sms - 1) / sms;
    const long long cost = waves * ((g * tiles + kWarps - 1) / kWarps);
    const bool fewer_waves =
        waves >= 2 && (best_waves < 2 || waves < best_waves);
    if (best < 0 || cost < best || (cost == best && fewer_waves)) {
      best = cost;
      best_waves = waves;
      G = g;
    }
  }
  const dim3 grid((C + G - 1) / G, H, B);
  const size_t bytes = 4 * Staged<F>::floats(T);
  if (bytes <= (size_t)kMaxSmemBytes)
    masked_kv_attn<F, true><<<grid, kThreads, bytes, st>>>(
        q, kd, vd, kc, vc, cb, db, out, C, S, H, T, G);
  else
    masked_kv_attn<F, false><<<grid, kThreads, 0, st>>>(
        q, kd, vd, kc, vc, cb, db, out, C, S, H, T, G);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------ bf16 form
//
// The bf16 certify bank's token engine hands kernel H bf16 q/kd/vd/kc/vc,
// bf16 biases and wants a bf16 output. Arithmetic (as the float32 form, with
// one bf16 tensor-core product in place of each 3xTF32 one):
//   - Q.K^T: mma.sync.m16n8k16 (bf16 in, float32 accumulation) per 8-key
//     tile and 16 features;
//   - the softmax in float32 (running max and exp-sum in registers, 32
//     keys a step: the clean group, then the entry's dirty group; exps as
//     2^x by ex2.approx, and the accumulator rescaled only where a row's
//     max moved);
//   - P.V: P rounded to bf16 (as flash attention does) and one m16n8k16 per
//     16 keys and 8 features: the accumulators of two 8-key logit tiles are
//     exactly the A fragment of their 16 keys, so P never leaves the
//     registers; the exp-sum adds the rounded weights, so the output is a
//     convex combination of the values;
//   - the output times the row's reciprocal exp-sum in float32, rounded to
//     bf16 at its store.
// What bounds it: at the ViT-B/16 pair audit (S 99 of T+S 296 keys) the
// dirty group is a third of the keys, and every one of an entry's
// ceil(S/16) work items reads all of it, so both groups live in shared
// memory; with them there, the issue of each step's instructions (about
// 14 warps an SM), which the choices below keep few:
//   - a block (1 to 8 warps) takes G entries of one (image, head); it
//     stages the clean K and V [T, f] once (a T too long for a block's
//     shared memory is read from device memory instead, K as 4-byte
//     pairs and V as 2-byte values, as the first bf16 form read the dirty
//     group), and the entries' dirty K and V
//     [S, f] E entries at a time (a "phase"), in two slots: the cp.async
//     copy of phase p+1 lands while phase p computes. A phase's
//     E * ceil(S/16) items go to the warps, one each when they fit
//     (E = 8 / ceil(S/16));
//   - every group is stored row-major, rows of f bf16 in 16-byte chunks
//     swizzled by row (chunk c of row r at c ^ (r mod 8), f 64; at
//     c ^ ((r / 2) mod 4), f 32), so that the 8 rows of an ldmatrix phase
//     hit 8 distinct bank quads: K's B fragments come from ldmatrix.x4,
//     V's from ldmatrix.x4.trans (no transposed copy);
//   - each slot also holds its entries' clean and dirty biases, widened to
//     float32 and padded with -1e9 to whole 32-key steps: a lane reads its
//     two keys' biases of a tile in one 8-byte load, with no bounds check;
//   - keys past a group's end read its last row (the ldmatrix row address
//     is clamped, in the group's last step only) and take the bias -1e9,
//     so their weight is exactly 0; no K or V row is padded;
//   - a row's exp-sum is one more MMA per 16 keys: the rounded weights
//     times a column of ones, rescaled with the output accumulator.
// ops/masked_kv_attn.py `bf16_plan` chooses G, E and the warps from the
// shape and the SM count and passes them in with the shared memory, which
// fits two blocks an SM at the ViT-B/16 shapes (104 KB at T 197, S 99).

using bf16 = __nv_bfloat16;

constexpr int kMaxSlotPhases = 2;   // dirty slots (double buffer)

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ldg_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving a row address
// of matrix l / 8; .trans hands each lane a column pair instead of a row
// pair. Volatile, so that none is moved across the barriers between the
// phases that rewrite a slot; no "memory" clobber, so that the biases'
// device loads may be issued ahead of them.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The staged rows: row R (counted over the whole carve) of F bf16, its
// 16-byte chunk c at a swizzled place.
template <int F> struct RowsBf {
  static constexpr int CPR = F / 8;           // chunks a row
  static constexpr int SH = F == 64 ? 0 : 1;  // rows sharing a swizzle
  static constexpr int RB = 2 * F;            // bytes a row
  __device__ static __forceinline__ uint32_t addr(uint32_t base, int r, int c) {
    return base + (uint32_t)(r * RB + 16 * (c ^ ((r >> SH) & (CPR - 1))));
  }
};

// Keys of a group rounded up to whole 32-key steps: the length of its
// float32 bias row in shared memory (padded with -1e9).
__host__ __device__ inline int padded(int n) { return (n + 31) / 32 * 32; }

// Bytes of the carve: the clean K and V [T, F] rows (where `clean`), `slots`
// dirty slots of E entries' K and V [S, F] rows each, then per slot E
// entries' float32 biases, clean and dirty, each padded to whole steps.
template <int F>
__host__ __device__ inline size_t carve_bytes(int T, int S, int E, int slots,
                                              bool clean) {
  return (size_t)2 * F * (2 * (size_t)T * clean + 2 * (size_t)slots * E * S) +
         (size_t)4 * slots * E * (padded(T) + padded(S));
}

// Rows [R, R + n) of the carve from n rows of F bf16 `stride` elements
// apart at src, 16 bytes a cp.async.
template <int F>
__device__ __forceinline__ void stage_rows(uint32_t base, int R,
                                           const bf16* src, size_t stride,
                                           int n) {
  using L = RowsBf<F>;
  for (int i = threadIdx.x; i < n * L::CPR; i += blockDim.x) {
    const int r = i / L::CPR, c = i % L::CPR;
    cp_async16(L::addr(base, R + r, c), src + r * stride + 8 * c);
  }
}

template <int F>
struct ItemBf {
  static constexpr int K16 = F / 16, K8 = F / 8;
  uint32_t qa[K16][4];   // query A fragments, per 16 features
  float o[K8][4];        // output accumulator, per 8 features
  float l[4];            // exp-sums of rows g (l[0]) and g+8 (l[2])
  float m[2];            // running max
};

// A group of keys: `valid` keys with float32 biases bp[key] in shared
// memory (-1e9 past `valid`, to the end of the last step). Staged: K rows
// from carve row rk, V rows from rv. Otherwise (a clean group too long to
// stage) rows of `stride` elements at kg and vg in device memory.
struct GroupBf {
  int rk, rv, valid;
  const float* bp;
  const bf16* kg;
  const bf16* vg;
  int stride;
};

// Two bf16 values in one register, the first in the low half (the
// fragments' element order).
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// bf16 1.0 twice: the B fragment whose product with P adds its rows up.
constexpr uint32_t kOnes = 0x3f803f80u;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x, ex2.approx.ftz: within 2 ulp of float32, far below the bf16 rounding
// of the weights; 2^-inf and 2^x far below -126 are +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One softmax step over kTile 8-key tiles from key n0 (a multiple of 32).
// kTail: the group's last step, whose keys at or past `valid` read the
// group's last row and take the bias -1e9 (the padding of the bias rows),
// so their weight is exactly 0, as in the float32 form. A full step needs no clamp: the swizzle of its
// rows (key + 8j, key + 16jj) is the same for every tile, so each lane's
// ldmatrix addresses are one base and constant offsets. !kStaged: the
// group's B fragments are read from device memory, K as 4-byte pairs and V
// as 2-byte values.
template <int F, bool kTail, bool kStaged>
__device__ __forceinline__ void step_bf(ItemBf<F>& it, uint32_t base,
                                        const GroupBf& gr, int n0, int lane) {
  constexpr int K8 = F / 8, CPR = F / 8;
  using L = RowsBf<F>;
  const int g = lane >> 2, t = lane & 3, m = lane >> 3, i7 = lane & 7;
  const int last = gr.valid - 1;
  // the biases of this lane's keys (2t, 2t+1) of each tile
  float2 bias[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j)
    bias[j] = *reinterpret_cast<const float2*>(gr.bp + n0 + 8 * j + 2 * t);
  float s[kTile][4];
  // logits: matrix m of an x4 is chunk 4q + m of 8 keys, the B fragments
  // (b0, b1) of 16-feature slices 2q and 2q+1
  const int rk = gr.rk + n0 + i7;
  const int swk = (rk >> L::SH) & (CPR - 1);
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if (!kStaged) {
      const int key = kTail ? min(n0 + 8 * j + g, last) : n0 + 8 * j + g;
      const bf16* kr = gr.kg + (size_t)key * gr.stride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < F / 16; ++kk)
        mma_bf16(s[j], it.qa[kk], ldg_pair(kr + 16 * kk),
                 ldg_pair(kr + 16 * kk + 8));
      continue;
    }
    const int r = kTail ? gr.rk + min(n0 + 8 * j + i7, last) : rk + 8 * j;
    const int sw = kTail ? (r >> L::SH) & (CPR - 1) : swk;
#pragma unroll
    for (int q = 0; q < CPR / 4; ++q) {
      uint32_t b[4];
      ldsm4(b, base + r * L::RB + 16 * ((4 * q + m) ^ sw));
      mma_bf16(s[j], it.qa[2 * q], b[0], b[1]);
      mma_bf16(s[j], it.qa[2 * q + 1], b[2], b[3]);
    }
  }
  float mx0 = it.m[0], mx1 = it.m[1];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    s[j][0] += bias[j].x;
    s[j][1] += bias[j].y;
    s[j][2] += bias[j].x;
    s[j][3] += bias[j].y;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
  }
  // e^(x - max) as 2^((x - max) log2 e): the difference first, exact
  // enough where every key so far is masked (x and max near -1e9, whose
  // products with log2 e would round apart by up to 64); the scales are 0
  // on the first step (-inf) and exactly 1 where the max held
  const float sc0 = ex2((it.m[0] - mx0) * kLog2e);
  const float sc1 = ex2((it.m[1] - mx1) * kLog2e);
  it.m[0] = mx0;
  it.m[1] = mx1;
  // the weights, rounded to bf16 in pairs: lane (g, t) holds keys (2t,
  // 2t+1) of each 8-key tile for rows g (pw[j][0]) and g+8 (pw[j][1]), the
  // A fragment's own positions
  uint32_t pw[kTile][2];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(
        ex2((s[j][0] - mx0) * kLog2e), ex2((s[j][1] - mx0) * kLog2e));
    const __nv_bfloat162 p1 = __floats2bfloat162_rn(
        ex2((s[j][2] - mx1) * kLog2e), ex2((s[j][3] - mx1) * kLog2e));
    pw[j][0] = *reinterpret_cast<const uint32_t*>(&p0);
    pw[j][1] = *reinterpret_cast<const uint32_t*>(&p1);
  }
  if (__any_sync(kFull, sc0 != 1.f || sc1 != 1.f)) {
#pragma unroll
    for (int jf = 0; jf < K8; ++jf) {
      it.o[jf][0] *= sc0;
      it.o[jf][1] *= sc0;
      it.o[jf][2] *= sc1;
      it.o[jf][3] *= sc1;
    }
    it.l[0] *= sc0;
    it.l[1] *= sc0;
    it.l[2] *= sc1;
    it.l[3] *= sc1;
  }
  // weighted values, 16 keys an MMA: tiles 2jj and 2jj+1. Matrix m of an
  // x4.trans is keys 8(m & 1).. of feature chunk 2u + m/2: (b0, b1) of
  // 8-feature blocks 2u and 2u+1
  const int rv = gr.rv + n0 + 8 * (m & 1) + i7;
  const int swv = (rv >> L::SH) & (CPR - 1);
#pragma unroll
  for (int jj = 0; jj < kTile / 2; ++jj) {
    const uint32_t pa[4] = {pw[2 * jj][0], pw[2 * jj][1], pw[2 * jj + 1][0],
                            pw[2 * jj + 1][1]};
    if (kStaged) {
      const int r = kTail ? gr.rv + min(n0 + 16 * jj + 8 * (m & 1) + i7, last)
                          : rv + 16 * jj;
      const int sw = kTail ? (r >> L::SH) & (CPR - 1) : swv;
#pragma unroll
      for (int u = 0; u < CPR / 2; ++u) {
        uint32_t b[4];
        ldsm4t(b, base + r * L::RB + 16 * ((2 * u + (m >> 1)) ^ sw));
        mma_bf16(it.o[2 * u], pa, b[0], b[1]);
        mma_bf16(it.o[2 * u + 1], pa, b[2], b[3]);
      }
    } else {
      // b0: keys k0, k0+1 of feature 8jf + g; b1: keys k0+8, k0+9
      const int k0 = n0 + 16 * jj + 2 * t;
      const bf16* vc = gr.vg + g;
      auto at = [&](int k) {
        return vc[(size_t)(kTail ? min(k, last) : k) * gr.stride];
      };
#pragma unroll
      for (int jf = 0; jf < K8; ++jf, vc += 8)
        mma_bf16(it.o[jf], pa, pack_bf16(at(k0), at(k0 + 1)),
                 pack_bf16(at(k0 + 8), at(k0 + 9)));
    }
    // the exp-sums: the same rounded weights times a column of ones
    mma_bf16(it.l, pa, kOnes, kOnes);
  }
}

// A group's softmax steps: full steps of 32 keys, then its last, clamped.
template <int F, bool kStaged>
__device__ __forceinline__ void steps_bf(ItemBf<F>& it, uint32_t base,
                                         const GroupBf& gr, int lane) {
  int n0 = 0;
  for (; n0 + 8 * kTile <= gr.valid; n0 += 8 * kTile)
    step_bf<F, false, kStaged>(it, base, gr, n0, lane);
  if (n0 < gr.valid) step_bf<F, true, kStaged>(it, base, gr, n0, lane);
}

// The query A fragments of rows r0+g and r0+g+8 of entry e (zero past S).
template <int F>
__device__ __forceinline__ void load_queries_bf(ItemBf<F>& it, const bf16* q,
                                                size_t e, int r0, int S, int H,
                                                int h, int g, int t) {
  const bf16* ra = q + ((e * S + r0 + g) * H + h) * F;
  const bf16* rb = q + ((e * S + r0 + g + 8) * H + h) * F;
  const bool va = r0 + g < S, vb = r0 + g + 8 < S;
#pragma unroll
  for (int kk = 0; kk < F / 16; ++kk) {
    it.qa[kk][0] = va ? ldg_pair(ra + 16 * kk + 2 * t) : 0u;
    it.qa[kk][1] = vb ? ldg_pair(rb + 16 * kk + 2 * t) : 0u;
    it.qa[kk][2] = va ? ldg_pair(ra + 16 * kk + 8 + 2 * t) : 0u;
    it.qa[kk][3] = vb ? ldg_pair(rb + 16 * kk + 8 + 2 * t) : 0u;
  }
}

// One block per (group of G entries, head, image), blockDim.x / 32 warps;
// phases of E entries (see the notes above). kClean: the clean group staged
// (else read from device memory, for a T too long to stage).
template <int F, bool kClean>
__global__ void __launch_bounds__(kThreads, 2)
masked_kv_attn_bf16(const bf16* __restrict__ q, const bf16* __restrict__ kd,
                    const bf16* __restrict__ vd, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, const bf16* __restrict__ cb,
                    const bf16* __restrict__ db, bf16* __restrict__ out, int C,
                    int S, int H, int T, int G, int E) {
  constexpr int K8 = F / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = (int)blockIdx.x * G;
  const int entries = min(C, c0 + G) - c0;
  const int phases = (entries + E - 1) / E;
  const int tiles = (S + kRows - 1) / kRows;
  const int slot_rows = 2 * E * S;   // K rows, then V rows, of E entries
  const int slots = min(kMaxSlotPhases, (min(G, C) + E - 1) / E);
  const int Tp = padded(T), Sp = padded(S);
  const int R0 = kClean ? 2 * T : 0;   // the first dirty slot's row
  float* const sbias = reinterpret_cast<float*>(
      smem_raw + (size_t)RowsBf<F>::RB * (R0 + slots * slot_rows));
  const size_t stride = (size_t)H * F;
  // phase p's dirty K and V into slot p % 2 (carve rows from R0), by
  // cp.async; its entries' biases, widened and padded, by the threads
  auto stage_phase = [&](int p) {
    const int ne = min(E, entries - p * E);
    const int R = R0 + (p & 1) * slot_rows;
    const size_t e0 = (size_t)b * C + c0 + p * E;
    const size_t off = (e0 * S * H + h) * F;
    stage_rows<F>(base, R, kd + off, stride, ne * S);
    stage_rows<F>(base, R + E * S, vd + off, stride, ne * S);
    float* sb = sbias + (p & 1) * E * (Tp + Sp);
    for (int i = threadIdx.x; i < ne * (Tp + Sp); i += blockDim.x) {
      const size_t e = e0 + i / (Tp + Sp);
      const int k = i % (Tp + Sp);
      float v = kMasked;
      if (k < T)
        v = __bfloat162float(cb[e * T + k]);
      else if (k >= Tp && k - Tp < S)
        v = __bfloat162float(db[e * S + k - Tp]);
      sb[i] = v;
    }
  };
  const size_t coff = ((size_t)b * T * H + h) * F;
  if (kClean) {
    stage_rows<F>(base, 0, kc + coff, stride, T);
    stage_rows<F>(base, T, vc + coff, stride, T);
  }
  stage_phase(0);
  cp_async_commit();
  if (phases > 1) stage_phase(1);
  cp_async_commit();

  ItemBf<F> it;
  for (int p = 0; p < phases; ++p) {
    cp_async_wait1();   // this thread's copies of phase p (group p) landed
    __syncthreads();    // and everyone's, and the biases
    const int ne = min(E, entries - p * E);
    const int R = R0 + (p & 1) * slot_rows;
    const float* sb = sbias + (p & 1) * E * (Tp + Sp);
    for (int item = warp; item < ne * tiles; item += warps) {
      const int el = item / tiles;
      const size_t e = (size_t)b * C + c0 + p * E + el;
      const int r0 = (item % tiles) * kRows;
      load_queries_bf<F>(it, q, e, r0, S, H, h, g, t);
      it.m[0] = it.m[1] = __int_as_float((int)0xff800000u);   // -inf
      it.l[0] = it.l[1] = it.l[2] = it.l[3] = 0.f;
#pragma unroll
      for (int jf = 0; jf < K8; ++jf)
        it.o[jf][0] = it.o[jf][1] = it.o[jf][2] = it.o[jf][3] = 0.f;
      const float* eb = sb + el * (Tp + Sp);
      steps_bf<F, kClean>(it, base, GroupBf{0, T, T, eb, kc + coff,
                                            vc + coff, (int)stride}, lane);
      steps_bf<F, true>(it, base, GroupBf{R + el * S, R + E * S + el * S, S,
                                          eb + Tp, nullptr, nullptr, 0},
                        lane);
      // one division a row, then products (l >= 1: slot 0 is live)
      const float l0 = 1.f / it.l[0], l1 = 1.f / it.l[2];
#pragma unroll
      for (int jf = 0; jf < K8; ++jf) {
        const int d = 8 * jf + 2 * t;
        const __nv_bfloat162 y0 = __floats2bfloat162_rn(it.o[jf][0] * l0,
                                                        it.o[jf][1] * l0);
        const __nv_bfloat162 y1 = __floats2bfloat162_rn(it.o[jf][2] * l1,
                                                        it.o[jf][3] * l1);
        if (r0 + g < S)
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((e * S + r0 + g) * H + h) * F + d) = y0;
        if (r0 + g + 8 < S)
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((e * S + r0 + g + 8) * H + h) * F + d) = y1;
      }
    }
    __syncthreads();   // slot p % 2 is free
    if (p + 2 < phases) stage_phase(p + 2);
    cp_async_commit();
  }
}

// The dirty slots a block of G entries in phases of E carves.
inline int slots_of(int C, int G, int E) {
  const int phases = ((G < C ? G : C) + E - 1) / E;
  return phases < kMaxSlotPhases ? phases : kMaxSlotPhases;
}

template <int F, bool kClean>
int launch_bf16(const bf16* q, const bf16* kd, const bf16* vd, const bf16* kc,
                const bf16* vc, const bf16* cb, const bf16* db, bf16* out,
                int B, int C, int S, int H, int T, int G, int E, int warps,
                int smem, cudaStream_t st) {
  static bool raised = false;
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_kv_attn_bf16<F, kClean>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  if (G < 1 || E < 1 || warps < 1 || warps > kWarps || T < 1 || smem < 0 ||
      smem > kMaxSmemBytes ||
      (size_t)smem < carve_bytes<F>(T, S, E, slots_of(C, G, E), kClean))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + G - 1) / G, H, B);
  masked_kv_attn_bf16<F, kClean><<<grid, 32 * warps, smem, st>>>(
      q, kd, vd, kc, vc, cb, db, out, C, S, H, T, G, E);
  return (int)cudaGetLastError();
}

template <int F>
int launch_bf16(const bf16* q, const bf16* kd, const bf16* vd, const bf16* kc,
                const bf16* vc, const bf16* cb, const bf16* db, bf16* out,
                int B, int C, int S, int H, int T, int G, int E, int warps,
                int clean, int smem, cudaStream_t st) {
  return clean ? launch_bf16<F, true>(q, kd, vd, kc, vc, cb, db, out, B, C, S,
                                      H, T, G, E, warps, smem, st)
               : launch_bf16<F, false>(q, kd, vd, kc, vc, cb, db, out, B, C,
                                       S, H, T, G, E, warps, smem, st);
}

}  // namespace

extern "C" {

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

// Kernel H on bf16 operands: every tensor bf16 (the shapes of
// dp_masked_kv_attn), contiguous, 16-byte aligned; float32 accumulation
// and softmax. f is 32 or 64. The plan (ops/masked_kv_attn.py bf16_plan):
// G entries a block in phases of E, `warps` warps a block, the clean group
// staged (`clean` 1) or read from device memory (0), smem bytes of dynamic
// shared memory, at least dp_masked_kv_attn_bf16_smem's carve.
int dp_masked_kv_attn_bf16(const void* q, const void* kd, const void* vd,
                           const void* kc, const void* vc, const void* cb,
                           const void* db, void* out, int B, int C, int S,
                           int H, int f, int T, int G, int E, int warps,
                           int clean, int smem, void* stream) {
  if (B == 0 || C == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* a[7] = {static_cast<const bf16*>(q), static_cast<const bf16*>(kd),
                      static_cast<const bf16*>(vd), static_cast<const bf16*>(kc),
                      static_cast<const bf16*>(vc), static_cast<const bf16*>(cb),
                      static_cast<const bf16*>(db)};
  bf16* o = static_cast<bf16*>(out);
  switch (f) {
    case 32: return launch_bf16<32>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], o, B, C, S, H, T, G, E, warps, clean, smem, st);
    case 64: return launch_bf16<64>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], o, B, C, S, H, T, G, E, warps, clean, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bytes of shared memory kernel H's bf16 form carves for head width f:
// the clean K and V [T, f] (where `clean`), `slots` dirty slots of E
// entries' K and V [S, f], and their float32 biases padded to whole steps;
// -1 for an f it is not built for.
long long dp_masked_kv_attn_bf16_smem(int T, int S, int f, int E, int slots,
                                      int clean) {
  switch (f) {
    case 32: return (long long)carve_bytes<32>(T, S, E, slots, clean);
    case 64: return (long long)carve_bytes<64>(T, S, E, slots, clean);
    default: return -1;
  }
}

}  // extern "C"
