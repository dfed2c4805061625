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

#include <stdint.h>

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

}  // extern "C"
