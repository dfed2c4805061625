// Shared helpers of the port's kernels (built for sm_90a, see ops/_build.py).
#pragma once

#include <cuda_runtime.h>

namespace dorpatch {

// Most occlusion rectangles one mask may carry (K of the [S, K, 4] table).
constexpr int kMaxRects = 8;

}  // namespace dorpatch
