// Constants and selection helpers shared by the scan kernels
// (scan_topk.cu, scan_topk_mma.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cqs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;  // grouped extraction width
constexpr float kNeg = -3.0e38f;

// row kinds; the values are the ABI's `kind` argument
constexpr int kBf16 = 0;
constexpr int kI8 = 1;
constexpr int kI8Widen = 2;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Best (value, column) among the columns j = gt, gt+G, ... < L of s.
__device__ __forceinline__ void local_best(const float* s, int L, int gt, int G,
                                           float& v, int& i) {
  v = -INFINITY;
  i = 0x7fffffff;
  for (int j = gt; j < L; j += G) {
    if (better(s[j], j, v, i)) {
      v = s[j];
      i = j;
    }
  }
}

}  // namespace cqs
