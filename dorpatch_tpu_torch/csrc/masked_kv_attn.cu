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
// A bf16 form (masked_kv_attn_bf16, below) serves the bf16 certify bank.

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
// bf16 biases and wants a bf16 output. The design follows the float32 one
// (work items of 16 query rows, 8 warps a block, G entries a block, online
// softmax over 32-key steps, the clean group staged once per block), with
// one bf16 tensor-core product in place of each 3xTF32 one:
//   - Q.K^T: mma.sync.m16n8k16 (bf16 in, float32 accumulation) per 8-key
//     tile and 16 features; the standard fragment layout already gives a
//     lane two neighbouring features of one row, so A and B fragments are
//     single 32-bit loads of q and of K rows;
//   - the softmax in float32 (running max and exp-sum in registers);
//   - P.V: P rounded to bf16 (as flash attention does) and one m16n8k16 per
//     16 keys and 8 features: the accumulators of two 8-key logit tiles are
//     exactly the A fragment of their 16 keys, so P never leaves the
//     registers; the exp-sum adds the rounded weights, so the output is a
//     convex combination of the values;
//   - the output divided once in float32 and rounded to bf16 at its store.
// The staged clean group is K [T, F+8] row-major and V transposed
// [F, Tp+8] (Tp = T rounded up to 32, the pad keys zero), so that a lane's
// B fragment of P.V (two neighbouring keys of one feature) is one 32-bit
// read too; the row strides put the 32 lanes of a warp on 32 distinct
// banks. At T 197, F 64 that is 58 KB: three blocks an SM. The dirty group
// is read from device memory, its V pairs as two 2-byte loads.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values in one register, the first in the low half (the
// fragments' element order).
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two neighbouring bf16 values (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int F> struct StagedBf {
  static constexpr int KS = F + 8;          // bf16 a K row: 4 (mod 32) words
  __host__ __device__ static int tp(int T) { return (T + 31) / 32 * 32; }
  __host__ __device__ static int vs(int T) { return tp(T) + 8; }   // bf16 a V^T row
  static size_t bytes(int T) {
    return 2 * ((size_t)T * KS + (size_t)F * vs(T));
  }
};

template <int F>
struct ItemBf {
  static constexpr int K16 = F / 16, K8 = F / 8;
  uint32_t qa[K16][4];   // query A fragments, per 16 features
  float o[K8][4];        // output accumulator, per 8 features
  float m[2], l[2];      // running max, this lane's exp-sum share
};

// A group of keys: `valid` rows with biases bp[key]. Staged: K rows of
// StagedBf::KS at kp and V^T rows of `vstride` at vp. Otherwise rows of
// `stride` elements in device memory, K(key, f) = kp[key * stride + f].
struct GroupBf {
  const bf16* kp;
  const bf16* vp;
  const bf16* bp;
  int stride;
  int vstride;
  int valid;
};

// One softmax step over kTile 8-key tiles from key n0 (a multiple of 32).
// Keys at or past `valid` read the group's last row and take the bias -1e9,
// so their weight is exactly 0, as in the float32 form.
template <int F, bool kStaged>
__device__ __forceinline__ void step_bf(ItemBf<F>& it, const GroupBf& gr,
                                        int n0, int g, int t) {
  constexpr int K16 = F / 16, K8 = F / 8;
  float s[kTile][4];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int key = min(n0 + 8 * j + g, gr.valid - 1);
    const bf16* kr = gr.kp + (size_t)key * (kStaged ? StagedBf<F>::KS : gr.stride);
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K16; ++kk) {
      const uint32_t b0 = kStaged ? ld_pair(kr + 16 * kk + 2 * t)
                                  : ldg_pair(kr + 16 * kk + 2 * t);
      const uint32_t b1 = kStaged ? ld_pair(kr + 16 * kk + 8 + 2 * t)
                                  : ldg_pair(kr + 16 * kk + 8 + 2 * t);
      mma_bf16(s[j], it.qa[kk], b0, b1);
    }
  }
  float mx0 = it.m[0], mx1 = it.m[1];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const int key = n0 + 8 * j + 2 * t;
    const float b0 = key < gr.valid ? __bfloat162float(gr.bp[key]) : kMasked;
    const float b1 = key + 1 < gr.valid ? __bfloat162float(gr.bp[key + 1]) : kMasked;
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
  // the weights, rounded to bf16: lane (g, t) holds keys (2t, 2t+1) of each
  // 8-key tile for rows g and g+8, the A fragment's own positions
  bf16 p[kTile][4];
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[j][i] = __float2bfloat16(expf(s[j][i] - (i < 2 ? mx0 : mx1)));
    sum0 += __bfloat162float(p[j][0]) + __bfloat162float(p[j][1]);
    sum1 += __bfloat162float(p[j][2]) + __bfloat162float(p[j][3]);
  }
  it.l[0] = it.l[0] * sc0 + sum0;
  it.l[1] = it.l[1] * sc1 + sum1;
#pragma unroll
  for (int jf = 0; jf < K8; ++jf) {
    it.o[jf][0] *= sc0;
    it.o[jf][1] *= sc0;
    it.o[jf][2] *= sc1;
    it.o[jf][3] *= sc1;
  }
  // weighted values, 16 keys an MMA: tiles 2jj and 2jj+1
#pragma unroll
  for (int jj = 0; jj < kTile / 2; ++jj) {
    const uint32_t pa[4] = {pack_bf16(p[2 * jj][0], p[2 * jj][1]),
                            pack_bf16(p[2 * jj][2], p[2 * jj][3]),
                            pack_bf16(p[2 * jj + 1][0], p[2 * jj + 1][1]),
                            pack_bf16(p[2 * jj + 1][2], p[2 * jj + 1][3])};
    const int k0 = n0 + 16 * jj + 2 * t;   // b0: keys k0, k0+1; b1: k0+8, k0+9
#pragma unroll
    for (int jf = 0; jf < K8; ++jf) {
      const int feat = 8 * jf + g;
      uint32_t b0, b1;
      if (kStaged) {
        const bf16* vr = gr.vp + (size_t)feat * gr.vstride + k0;
        b0 = ld_pair(vr);
        b1 = ld_pair(vr + 8);
      } else {
        const bf16* vc = gr.vp + feat;
        const int last = gr.valid - 1;
        b0 = pack_bf16(vc[(size_t)min(k0, last) * gr.stride],
                       vc[(size_t)min(k0 + 1, last) * gr.stride]);
        b1 = pack_bf16(vc[(size_t)min(k0 + 8, last) * gr.stride],
                       vc[(size_t)min(k0 + 9, last) * gr.stride]);
      }
      mma_bf16(it.o[jf], pa, b0, b1);
    }
  }
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

template <int F, bool kStaged>
__global__ void __launch_bounds__(kThreads)
masked_kv_attn_bf16(const bf16* __restrict__ q, const bf16* __restrict__ kd,
                    const bf16* __restrict__ vd, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc, const bf16* __restrict__ cb,
                    const bf16* __restrict__ db, bf16* __restrict__ out, int C,
                    int S, int H, int T, int G) {
  constexpr int K8 = F / 8;
  using L = StagedBf<F>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [T, KS] clean K
  bf16* vt = ks + (size_t)T * L::KS;              // [F, vs] clean V^T
  const int vstride = L::vs(T);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = (int)blockIdx.x * G;
  const int tiles = (S + kRows - 1) / kRows;
  const int items = (min(C, c0 + G) - c0) * tiles;

  if (kStaged) {
    const bf16* kcb = kc + ((size_t)b * T * H + h) * F;
    const bf16* vcb = vc + ((size_t)b * T * H + h) * F;
    for (int i = threadIdx.x; i < T * (F / 8); i += kThreads) {
      const int r = i / (F / 8), c8 = i % (F / 8);
      const uint4 kx = __ldg(reinterpret_cast<const uint4*>(
          kcb + (size_t)r * H * F + 8 * c8));
      *reinterpret_cast<uint4*>(ks + r * L::KS + 8 * c8) = kx;
      const uint4 vx = __ldg(reinterpret_cast<const uint4*>(
          vcb + (size_t)r * H * F + 8 * c8));
      const bf16* ve = reinterpret_cast<const bf16*>(&vx);
#pragma unroll
      for (int u = 0; u < 8; ++u) vt[(size_t)(8 * c8 + u) * vstride + r] = ve[u];
    }
    const int pad = L::tp(T) - T;
    for (int i = threadIdx.x; i < F * pad; i += kThreads)
      vt[(size_t)(i / pad) * vstride + T + i % pad] = __float2bfloat16(0.f);
    __syncthreads();
  }

  ItemBf<F> it;
  for (int item = warp; item < items; item += kWarps) {
    const size_t e = (size_t)b * C + c0 + item / tiles;
    const int r0 = (item % tiles) * kRows;
    load_queries_bf<F>(it, q, e, r0, S, H, h, g, t);
    it.m[0] = it.m[1] = __int_as_float((int)0xff800000u);   // -inf
    it.l[0] = it.l[1] = 0.f;
#pragma unroll
    for (int jf = 0; jf < K8; ++jf)
      it.o[jf][0] = it.o[jf][1] = it.o[jf][2] = it.o[jf][3] = 0.f;
    if (kStaged) {
      const GroupBf clean{ks, vt, cb + e * T, 0, vstride, T};
      for (int n0 = 0; n0 < T; n0 += 8 * kTile) step_bf<F, true>(it, clean, n0, g, t);
    } else {
      const GroupBf clean{kc + ((size_t)b * T * H + h) * F,
                          vc + ((size_t)b * T * H + h) * F, cb + e * T, H * F,
                          0, T};
      for (int n0 = 0; n0 < T; n0 += 8 * kTile) step_bf<F, false>(it, clean, n0, g, t);
    }
    const GroupBf dirty{kd + (e * S * H + h) * F, vd + (e * S * H + h) * F,
                        db + e * S, H * F, 0, S};
    for (int n0 = 0; n0 < S; n0 += 8 * kTile) step_bf<F, false>(it, dirty, n0, g, t);
    float l0 = it.l[0], l1 = it.l[1];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      l0 += __shfl_xor_sync(kFull, l0, o);
      l1 += __shfl_xor_sync(kFull, l1, o);
    }
#pragma unroll
    for (int jf = 0; jf < K8; ++jf) {
      const int d = 8 * jf + 2 * t;
      if (r0 + g < S)
        *reinterpret_cast<uint32_t*>(out + ((e * S + r0 + g) * H + h) * F + d) =
            pack_bf16(__float2bfloat16(it.o[jf][0] / l0),
                      __float2bfloat16(it.o[jf][1] / l0));
      if (r0 + g + 8 < S)
        *reinterpret_cast<uint32_t*>(out + ((e * S + r0 + g + 8) * H + h) * F + d) =
            pack_bf16(__float2bfloat16(it.o[jf][2] / l1),
                      __float2bfloat16(it.o[jf][3] / l1));
    }
  }
}

template <int F>
int launch_bf16(const bf16* q, const bf16* kd, const bf16* vd, const bf16* kc,
                const bf16* vc, const bf16* cb, const bf16* db, bf16* out,
                int B, int C, int S, int H, int T, cudaStream_t st) {
  static int sms = 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_kv_attn_bf16<F, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, n = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    sms = n;
  }
  const size_t bytes = StagedBf<F>::bytes(T);
  const bool staged = bytes <= (size_t)kMaxSmemBytes;
  // blocks an SM: its 228 KB (1 KB reserved a block) and 64 warps
  long long per_sm = staged ? 233472LL / (long long)(bytes + 1024) : 8;
  per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
  // entries per block, as for the float32 form, with per_sm blocks an SM
  const int tiles = (S + kRows - 1) / kRows;
  int G = 1;
  long long best = -1, best_waves = 0;
  for (int g = 1; g <= C; ++g) {
    const long long blocks = (long long)((C + g - 1) / g) * B * H;
    const long long waves = (blocks + sms * per_sm - 1) / (sms * per_sm);
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
  if (staged)
    masked_kv_attn_bf16<F, true><<<grid, kThreads, bytes, st>>>(
        q, kd, vd, kc, vc, cb, db, out, C, S, H, T, G);
  else
    masked_kv_attn_bf16<F, false><<<grid, kThreads, 0, st>>>(
        q, kd, vd, kc, vc, cb, db, out, C, S, H, T, G);
  return (int)cudaGetLastError();
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
// and softmax. f is 32 or 64.
int dp_masked_kv_attn_bf16(const void* q, const void* kd, const void* vd,
                           const void* kc, const void* vc, const void* cb,
                           const void* db, void* out, int B, int C, int S,
                           int H, int f, int T, void* stream) {
  if (B == 0 || C == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* a[7] = {static_cast<const bf16*>(q), static_cast<const bf16*>(kd),
                      static_cast<const bf16*>(vd), static_cast<const bf16*>(kc),
                      static_cast<const bf16*>(vc), static_cast<const bf16*>(cb),
                      static_cast<const bf16*>(db)};
  bf16* o = static_cast<bf16*>(out);
  switch (f) {
    case 32: return launch_bf16<32>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], o, B, C, S, H, T, st);
    case 64: return launch_bf16<64>(a[0], a[1], a[2], a[3], a[4], a[5], a[6], o, B, C, S, H, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
