// Shared helpers of the port's kernels (built for sm_90a, see ops/_build.py).
#pragma once

#include <cuda_runtime.h>

namespace dorpatch {

// Most occlusion rectangles one mask may carry (K of the [S, K, 4] table).
constexpr int kMaxRects = 8;

// True when (row, col) lies inside any of the K half-open rectangles
// r[4*i .. 4*i+3] = (r0, r1, c0, c1). Empty (0,0,0,0) rows match nothing.
__device__ __forceinline__ bool occluded(const int* r, int k, int row, int col) {
  bool occ = false;
  for (int i = 0; i < k; ++i) {
    const int* q = r + 4 * i;
    occ |= (row >= q[0]) & (row < q[1]) & (col >= q[2]) & (col < q[3]);
  }
  return occ;
}

}  // namespace dorpatch
