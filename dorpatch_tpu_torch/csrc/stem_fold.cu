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
//   - bf16 (the bf16 certify bank): `stem_fold_tc` below. At bf16 the
//     bytes halve while FFMA work on widened operands would not, so its
//     delta runs on the bf16 tensor cores, in blocks interleaved in one
//     grid with blocks of the copy.

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

// A read-only element load.
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

// out[q] = clean[q] + delta for the quad q of 4 channels.
__device__ __forceinline__ void add_store(const float* cl, float* dst,
                                          size_t q, const float (&d)[4]) {
  float4 v = __ldg(reinterpret_cast<const float4*>(cl) + q);
  v.x += d[0];
  v.y += d[1];
  v.z += d[2];
  v.w += d[3];
  reinterpret_cast<float4*>(dst)[q] = v;
}

// Q quads of 4 channels per thread: 2 when c is a multiple of 8, else 1.
// T is the element type of up, occ, clean, kern and out: float (the bf16
// form is stem_fold_tc below).
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
  for (int i = threadIdx.x; i < taps * c4; i += kThreads)
    reinterpret_cast<float4*>(ks)[i] = __ldg(reinterpret_cast<const float4*>(kern) + i);
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

int entry(const int* geo, const float* up, const float* occ,
          const float* clean, const float* kern, float* out, int B, int N,
          int Hp, int Wp, int Cin, int IH, int IW, int OH, int OW, int h,
          int w, int c, int k, int s, void* stream) {
  if (c % 4 != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (c % 8 == 0)
    return launch<float, 2>(geo, up, occ, clean, kern, out, B, N, Hp, Wp,
                            Cin, IH, IW, OH, OW, h, w, c, k, s, st);
  return launch<float, 1>(geo, up, occ, clean, kern, out, B, N, Hp, Wp, Cin,
                          IH, IW, OH, OW, h, w, c, k, s, st);
}

// ------------------------------------------------------------ bf16 form
//
// stem_fold_tc: kernel C on bf16 operands (the bf16 certify bank), the
// delta on the bf16 tensor cores. One launch of two kinds of block,
// interleaved in the grid so that the broadcast of clean (the bytes bound)
// runs beside the delta on every SM:
//   - a delta block: 128 or 256 pixels of one mask's window on one image
//     (8 warps x `mtiles` 16-pixel m-tiles), all channels. It stages the stem kernel
//     [taps][c] bf16 by cp.async (20 KB at RN50, 16-byte copies, the taps
//     zero-padded to a multiple of 16: 27 -> 32, 147 -> 160) and its window
//     input rows as bf16 with up * occ applied once (exact: occ is 0 or 1).
//     The delta is an implicit GEMM [pixels] x [taps] x [channels] on
//     mma.sync.m16n8k16 (bf16 in, float32 accumulation): a lane gathers its
//     A fragment from the window by a per-tap offset table (the im2col
//     matrix never exists), and the B fragments come by ldmatrix.trans from
//     the kernel rows, padded by 16 bytes so that the 8 rows of an
//     ldmatrix phase hit 8 distinct bank quads. The epilogue rounds the
//     float32 delta to bf16, stages it in shared memory and writes clean +
//     delta with one more rounding, 16 bytes a lane: the two roundings of
//     the plain version (`out += delta.to(bf16)`) and the JAX kernel
//     (`clean + delta.astype(out.dtype)`). The products of two bf16 values
//     are exact in float32, so only the order of the sum differs.
//   - a copy block: a tile of `lanes` x 256 16-byte chunks of one image's
//     clean map, loaded into registers once and stored to each mask of a
//     group of `group` masks, leaving out the pixels of the mask's window.
// Every element of the output is written once, by one block. Every load a
// thread makes is issued before the values are used, so that its latency
// is paid once a phase. The plan (lanes, group, m-tiles, store policy)
// comes from `ops/stem_fold.py` `bf16_plan`.

using bf16 = __nv_bfloat16;

constexpr int kMmaK = 16;                // depth of one mma.m16n8k16
constexpr int kWarps = kThreads / 32;
constexpr int kTilePix = kWarps * 16;    // window pixels of 8 warps' m-tiles
constexpr int kMaxMTiles = 2;            // m-tiles a warp of a delta block
constexpr int kSlice = 64;               // channels an accumulator pass
constexpr int kBsPad = 8;                // elements after each kernel row
constexpr int kDsPitch = kSlice + 8;     // elements a staged delta row
constexpr int kMaxCopyLanes = 4;
constexpr int kStage = 4;                // window pixels a thread in flight
constexpr int kMaxCin = 4;               // input channels of the bf16 form
constexpr int kEpi = 16 * (kSlice / 8) / 32;   // output chunks a lane

// The taps k*k*Cin zero-padded to the MMA depth.
__host__ __device__ inline int mma_taps(int k, int Cin) {
  return (k * k * Cin + kMmaK - 1) / kMmaK * kMmaK;
}

// Input rows a delta block of `pix` pixels stages: they span at most
// (OW + pix - 2) / OW + 1 output rows of the window.
__host__ __device__ inline int item_rows(int OW, int k, int s, int pix) {
  return (OW + pix - 2) / OW * s + k;
}

// Byte offsets of a delta block's shared memory: the stem kernel
// [kpad][c + 8] bf16 at 0, the tap offsets [kpad] int32, the window rows
// [item_rows][IW * Cin] bf16 and the staged deltas [8 warps][16][72] bf16.
struct TcSmem {
  size_t toff, ws, ds, total;
};
__host__ __device__ inline TcSmem tc_smem(int Cin, int OW, int c, int k,
                                          int s, int pix) {
  const int kpad = mma_taps(k, Cin);
  const size_t iw = (size_t)OW * s + k - 1;
  TcSmem m;
  m.toff = (size_t)kpad * (c + kBsPad) * 2;
  m.ws = m.toff + (size_t)kpad * 4;
  m.ds = m.ws + ((size_t)item_rows(OW, k, s, pix) * iw * Cin * 2 + 15) / 16 * 16;
  m.total = m.ds + (size_t)kWarps * 16 * kDsPitch * 2;
  return m;
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four (two) 8x8 bf16 matrices from shared memory, transposed, lane l
// giving a row address of matrix l / 8. The kernel rows are written before
// a barrier, so no "memory" clobber is needed.
__device__ __forceinline__ void ldsm_x4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2t(uint32_t& r0, uint32_t& r1,
                                         uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <bool kStream>
__device__ __forceinline__ void put16(uint4* p, const uint4& v) {
  if (kStream) __stcs(p, v); else *p = v;
}

// Eight channels of clean + eight of the bf16 delta, rounded once more.
__device__ __forceinline__ uint4 add8(const uint4& cl, const uint4& d) {
  const bf16* a = reinterpret_cast<const bf16*>(&cl);
  const bf16* b = reinterpret_cast<const bf16*>(&d);
  uint4 o;
  bf16* r = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r[i] = __float2bfloat16(__bfloat162float(a[i]) + __bfloat162float(b[i]));
  return o;
}

// a / d for 0 <= a < 2^22 by a float reciprocal (`inv` = 1.0f / d) and one
// correction each way: the estimate is within one of the quotient.
__device__ __forceinline__ int fdiv(int a, int d, float inv) {
  int q = (int)((float)a * inv);
  q -= q * d > a;
  q += (q + 1) * d <= a;
  return q;
}

// A lane's A fragment of one 16-tap step: taps (2t, 2t + 1), (2t + 8,
// 2t + 9) of its two pixels, at window offsets offs[] + to.
__device__ __forceinline__ void gather_a(uint32_t (&a)[4], const uint16_t* ws,
                                         const int (&offs)[2], const int4 to) {
  a[0] = ws[offs[0] + to.x] | (uint32_t)ws[offs[0] + to.y] << 16;
  a[1] = ws[offs[1] + to.x] | (uint32_t)ws[offs[1] + to.y] << 16;
  a[2] = ws[offs[0] + to.z] | (uint32_t)ws[offs[0] + to.w] << 16;
  a[3] = ws[offs[1] + to.z] | (uint32_t)ws[offs[1] + to.w] << 16;
}

// The window pixels [p0, p1) of mask n on image b.
template <bool kStream>
__device__ __forceinline__ void delta_block(
    const int* __restrict__ geo, const bf16* __restrict__ up,
    const bf16* __restrict__ occ, const bf16* __restrict__ clean,
    const bf16* __restrict__ kern, bf16* __restrict__ out, int b, int n,
    int p0, int pix, int N, int Hp, int Wp, int Cin, int IH, int IW, int OH,
    int OW, int h, int w, int c, int k, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcSmem lay = tc_smem(Cin, OW, c, k, s, pix);
  const int kpad = mma_taps(k, Cin);
  const int taps = k * k * Cin;
  const int bp = c + kBsPad;                       // kernel row pitch
  const int rowlen = IW * Cin;                     // window row, elements
  uint16_t* bs = reinterpret_cast<uint16_t*>(smem_raw);
  int* toff = reinterpret_cast<int*>(smem_raw + lay.toff);
  uint16_t* ws = reinterpret_cast<uint16_t*>(smem_raw + lay.ws);
  uint16_t* ds = reinterpret_cast<uint16_t*>(smem_raw + lay.ds);
  const int tid = threadIdx.x;
  const int cv = c / 8;
  const size_t map = (size_t)h * w * c;            // elements of a map
  const float inv_ow = 1.0f / OW;
  const int o0 = __ldg(geo + 4 * n), oc0 = __ldg(geo + 4 * n + 1);
  const int i0 = __ldg(geo + 4 * n + 2), ic0 = __ldg(geo + 4 * n + 3);
  const int p1 = min(OH * OW, p0 + pix);
  const int dy0 = fdiv(p0, OW, inv_ow);
  const int nr = (fdiv(p1 - 1, OW, inv_ow) - dy0) * s + k;
  const int r0 = dy0 * s;                          // first window row staged

  // 1. the stem kernel rows by cp.async, zero rows for the padded taps, and
  //    each tap's offset in the window, in the order a lane's A fragment
  //    takes them (a 16-tap step's taps 2t, 2t+1, 2t+8, 2t+9 for lane t of
  //    a quad); a padded tap reads the pixel's first tap, which meets a
  //    zero row of the kernel
  const uint32_t bs_base = (uint32_t)__cvta_generic_to_shared(bs);
  for (int i = tid; i < taps * cv; i += kThreads) {
    const int kk = i / cv;
    cp_async16(bs_base + (kk * bp + (i - kk * cv) * 8) * 2, kern + (size_t)i * 8);
  }
  for (int i = tid; i < (kpad - taps) * c; i += kThreads)
    bs[(taps + i / c) * bp + i % c] = 0;
  for (int i = tid; i < kpad; i += kThreads) {
    const int r = i % kMmaK;
    const int dr = i / (k * Cin);
    toff[(i / kMmaK * 4 + (r % 8) / 2) * 4 + (r / 8) * 2 + r % 2] =
        i < taps ? dr * rowlen + i - dr * k * Cin : 0;
  }

  // 2. the window rows: pixel (r, col) of the window, up[.., r, col, :] *
  //    occ[.., r, col], kStage pixels a thread in flight
  const bf16* upb = up + ((size_t)b * Hp + i0 + r0) * Wp * Cin +
                    (size_t)ic0 * Cin;
  const bf16* occn = occ + ((size_t)n * IH + r0) * IW;
  const float inv_iw = 1.0f / IW;
  for (int x0 = tid; x0 < nr * IW; x0 += kStage * kThreads) {
    bf16 ov[kStage], uv[kStage][kMaxCin];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int x = x0 + u * kThreads;
      if (x < nr * IW) {
        const int r = fdiv(x, IW, inv_iw);
        ov[u] = __ldg(occn + x);
        const bf16* src = upb + ((size_t)r * Wp + x - r * IW) * Cin;
#pragma unroll
        for (int ci = 0; ci < kMaxCin; ++ci)
          if (ci < Cin) uv[u][ci] = __ldg(src + ci);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int x = x0 + u * kThreads;
      if (x < nr * IW) {
        const float o = __bfloat162float(ov[u]);
#pragma unroll
        for (int ci = 0; ci < kMaxCin; ++ci)
          if (ci < Cin)
            ws[x * Cin + ci] = __bfloat16_as_ushort(
                __float2bfloat16(__bfloat162float(uv[u][ci]) * o));
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. the delta of the warp's m-tiles of 16 pixels, 64 channels a pass
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  // lane l addresses row l % 8 of matrix l / 8: taps ((l / 8) % 2) * 8 of a
  // 16-tap step, channels (l / 16) * 8 of a pair of n-tiles
  const uint32_t bs_lane =
      bs_base + ((((lane / 8) % 2) * 8 + lane % 8) * bp + (lane / 16) * 8) * 2;
  uint16_t* dsw = ds + warp * 16 * kDsPitch;
  for (int m0 = p0 + warp * 16; m0 < p1; m0 += kTilePix) {
    // the lane's two pixels (g, g + 8) for the A fragments, and its pixel
    // (lane % 16) of the epilogue: window offset and output offset
    int offs[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = m0 + g + 8 * i;
      const int dy = fdiv(p, OW, inv_ow);
      offs[i] = p < p1 ? ((dy - dy0) * s * IW + (p - dy * OW) * s) * Cin : 0;
    }
    const int pe = m0 + lane % 16;
    const int dye = fdiv(pe, OW, inv_ow);
    const size_t pix = ((size_t)(o0 + dye) * w + oc0 + pe - dye * OW) * c;
    for (int c0 = 0; c0 < c; c0 += kSlice) {
      const int nt = min(kSlice, c - c0) / 8;      // n-tiles of 8 channels
      // the epilogue's clean chunks, loaded ahead of the products: lane l
      // takes pixel l % 16 and chunks l / 16 + 2u of the pass
      uint4 cl[kEpi];
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        const int cc = lane / 16 + 2 * u;
        if (cc < nt && pe < p1)
          cl[u] = __ldg(reinterpret_cast<const uint4*>(
              clean + b * map + pix + c0 + cc * 8));
      }
      float acc[kSlice / 8][4] = {};
      const uint32_t bsl = bs_lane + c0 * 2;
      if (nt == kSlice / 8) {                      // a full pass: no guards
#pragma unroll 2
        for (int ks = 0; ks < kpad / kMmaK; ++ks) {
          uint32_t a[4];
          gather_a(a, ws, offs, reinterpret_cast<const int4*>(toff)[ks * 4 + t]);
#pragma unroll
          for (int jp = 0; jp < kSlice / 16; ++jp) {
            uint32_t r[4];
            ldsm_x4t(r, bsl + (ks * kMmaK * bp + jp * 16) * 2);
            mma16816(acc[2 * jp], a, r[0], r[1]);
            mma16816(acc[2 * jp + 1], a, r[2], r[3]);
          }
        }
      } else {
        for (int ks = 0; ks < kpad / kMmaK; ++ks) {
          uint32_t a[4];
          gather_a(a, ws, offs, reinterpret_cast<const int4*>(toff)[ks * 4 + t]);
#pragma unroll
          for (int jp = 0; jp < kSlice / 16; ++jp) {
            const uint32_t addr = bsl + (ks * kMmaK * bp + jp * 16) * 2;
            if (2 * jp + 1 < nt) {
              uint32_t r[4];
              ldsm_x4t(r, addr);
              mma16816(acc[2 * jp], a, r[0], r[1]);
              mma16816(acc[2 * jp + 1], a, r[2], r[3]);
            } else if (2 * jp < nt) {
              uint32_t r0, r1;
              ldsm_x2t(r0, r1, addr);
              mma16816(acc[2 * jp], a, r0, r1);
            }
          }
        }
      }
      // 4. the epilogue: bf16(delta) through shared memory, then clean +
      //    delta, 16 bytes a lane
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kSlice / 8; ++j) {
        if (j < nt) {
          *reinterpret_cast<__nv_bfloat162*>(dsw + g * kDsPitch + 8 * j +
                                             2 * t) =
              __floats2bfloat162_rn(acc[j][0], acc[j][1]);
          *reinterpret_cast<__nv_bfloat162*>(dsw + (g + 8) * kDsPitch + 8 * j +
                                             2 * t) =
              __floats2bfloat162_rn(acc[j][2], acc[j][3]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        const int px = lane % 16, cc = lane / 16 + 2 * u;
        if (cc < nt && m0 + px < p1)
          put16<kStream>(
              reinterpret_cast<uint4*>(out + ((size_t)b * N + n) * map + pix +
                                       c0 + cc * 8),
              add8(cl[u], *reinterpret_cast<const uint4*>(
                              dsw + px * kDsPitch + cc * 8)));
      }
      __syncwarp();
    }
  }
}

// Tile ti of image b's clean map to the masks [n0, n1), outside each mask's
// window.
template <bool kStream>
__device__ __forceinline__ void copy_block(
    const int* __restrict__ geo, const bf16* __restrict__ clean,
    bf16* __restrict__ out, int b, int ti, int n0, int n1, int N, int OH,
    int OW, int h, int w, int c, int lanes) {
  const int cv = c / 8;
  const int nl = h * w * cv;                       // chunks of a clean map
  const int q0 = ti * kThreads * lanes + threadIdx.x;
  const uint4* cl16 = reinterpret_cast<const uint4*>(clean) + (size_t)b * nl;
  uint4 v[kMaxCopyLanes];
  int py[kMaxCopyLanes], px[kMaxCopyLanes];
  bool live[kMaxCopyLanes];
#pragma unroll
  for (int l = 0; l < kMaxCopyLanes; ++l) {
    const int q = q0 + l * kThreads;
    live[l] = l < lanes && q < nl;
    v[l] = make_uint4(0, 0, 0, 0);
    py[l] = px[l] = 0;
    if (live[l]) {
      v[l] = __ldg(cl16 + q);
      const int pix = q / cv;
      py[l] = pix / w;
      px[l] = pix - py[l] * w;
    }
  }
  for (int n = n0; n < n1; ++n) {
    const int o0 = __ldg(geo + 4 * n), oc0 = __ldg(geo + 4 * n + 1);
    uint4* dst = reinterpret_cast<uint4*>(out) + ((size_t)b * N + n) * nl + q0;
#pragma unroll
    for (int l = 0; l < kMaxCopyLanes; ++l) {
      const bool inside = (unsigned)(py[l] - o0) < (unsigned)OH &&
                          (unsigned)(px[l] - oc0) < (unsigned)OW;
      if (live[l] && !inside) put16<kStream>(dst + l * kThreads, v[l]);
    }
  }
}

// grid: delta_items + copy_items blocks, the first 2 min(delta, copy)
// alternating delta (even) and copy (odd), then the rest of the larger kind
template <bool kStream>
__global__ void __launch_bounds__(kThreads, 3)
stem_fold_tc(const int* __restrict__ geo, const bf16* __restrict__ up,
             const bf16* __restrict__ occ, const bf16* __restrict__ clean,
             const bf16* __restrict__ kern, bf16* __restrict__ out, int N,
             int Hp, int Wp, int Cin, int IH, int IW, int OH, int OW, int h,
             int w, int c, int k, int s, int lanes, int group, int pix,
             int tiles, int groups, int pchunks, int delta_items,
             int copy_items) {
  const int it = blockIdx.x;
  const int mixed = 2 * min(delta_items, copy_items);
  const bool delta = it < mixed ? (it & 1) == 0 : delta_items > copy_items;
  const int idx = it < mixed ? it >> 1 : it - mixed / 2;
  if (delta) {
    const int pc = idx % pchunks;
    delta_block<kStream>(geo, up, occ, clean, kern, out, idx / (pchunks * N),
                         idx / pchunks % N, pc * pix, pix, N, Hp, Wp, Cin, IH,
                         IW, OH, OW, h, w, c, k, s);
  } else {
    const int gi = idx / tiles % groups;
    copy_block<kStream>(geo, clean, out, idx / (tiles * groups), idx % tiles,
                        gi * group, min(N, (gi + 1) * group), N, OH, OW, h, w,
                        c, lanes);
  }
}

template <bool kStream>
cudaError_t launch_tc(const int* geo, const bf16* up, const bf16* occ,
                      const bf16* clean, const bf16* kern, bf16* out, int N,
                      int Hp, int Wp, int Cin, int IH, int IW, int OH, int OW,
                      int h, int w, int c, int k, int s, int lanes, int group,
                      int pix, int tiles, int groups, int pchunks,
                      int delta_items, int copy_items, cudaStream_t st) {
  const size_t bytes = tc_smem(Cin, OW, c, k, s, pix).total;
  static size_t raised = 48 * 1024;   // the default dynamic limit
  if (bytes > raised) {
    cudaError_t err = cudaFuncSetAttribute(
        stem_fold_tc<kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    raised = bytes;
  }
  stem_fold_tc<kStream><<<delta_items + copy_items, kThreads, bytes, st>>>(
      geo, up, occ, clean, kern, out, N, Hp, Wp, Cin, IH, IW, OH, OW, h, w, c,
      k, s, lanes, group, pix, tiles, groups, pchunks, delta_items,
      copy_items);
  return cudaGetLastError();
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
  return entry(geo, up, occ, clean, kern, out, B, N, Hp, Wp, Cin, IH, IW, OH,
               OW, h, w, c, k, s, stream);
}

// Bytes of dynamic shared memory one block of kernel C's bf16 form takes
// with `mtiles` m-tiles a warp (`ops/stem_fold.py` `bf16_smem` computes the
// same).
long long dp_stem_fold_bf16_smem(int Cin, int OW, int c, int k, int s,
                                 int mtiles) {
  return (long long)tc_smem(Cin, OW, c, k, s, mtiles * kTilePix).total;
}

// Kernel C on bf16 operands: up, occ, clean, kern and out bf16 (geo int32),
// shapes as for dp_stem_fold; c a multiple of 8, Cin at most 4, and clean,
// kern, out 16-byte aligned (the caller checks both). Accumulates in float32
// on the tensor cores. The plan: `lanes` (1..4) 16-byte chunks a thread of
// a copy block, `group` masks a copy block, `mtiles` (1..2) 16-pixel
// m-tiles a warp of a delta block, evict-first stores when `stream_stores`
// (`ops/stem_fold.py` `bf16_plan`).
int dp_stem_fold_bf16(const int* geo, const void* up, const void* occ,
                      const void* clean, const void* kern, void* out, int B,
                      int N, int Hp, int Wp, int Cin, int IH, int IW, int OH,
                      int OW, int h, int w, int c, int k, int s, int lanes,
                      int group, int mtiles, int stream_stores, void* stream) {
  if (c % 8 != 0 || Cin > kMaxCin || lanes < 1 || lanes > kMaxCopyLanes ||
      group < 1 || mtiles < 1 || mtiles > kMaxMTiles || OH < 1 || OW < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const int pix = mtiles * kTilePix;
  const int pchunks = (OH * OW + pix - 1) / pix;
  const int nl = h * w * (c / 8);
  const int tiles = (nl + kThreads * lanes - 1) / (kThreads * lanes);
  const int groups = (N + group - 1) / group;
  const int delta_items = B * N * pchunks;
  const int copy_items = B * groups * tiles;
  const bf16* u = static_cast<const bf16*>(up);
  const bf16* o = static_cast<const bf16*>(occ);
  const bf16* cl = static_cast<const bf16*>(clean);
  const bf16* kr = static_cast<const bf16*>(kern);
  bf16* y = static_cast<bf16*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(stream_stores
      ? launch_tc<true>(geo, u, o, cl, kr, y, N, Hp, Wp, Cin, IH, IW, OH, OW,
                        h, w, c, k, s, lanes, group, pix, tiles, groups,
                        pchunks, delta_items, copy_items, st)
      : launch_tc<false>(geo, u, o, cl, kr, y, N, Hp, Wp, Cin, IH, IW, OH, OW,
                         h, w, c, k, s, lanes, group, pix, tiles, groups,
                         pchunks, delta_items, copy_items, st));
}

}  // extern "C"
