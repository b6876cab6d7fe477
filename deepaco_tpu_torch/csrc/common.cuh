// Helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace deepaco {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float siluf_(float x) { return x / (1.0f + expf(-x)); }

// Warp-wide sum; every lane ends with the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Whether (v, i) comes before (bv, bi) in torch.argmax's order: NaN above
// every number, then the larger value; equal values (or two NaNs) go to the
// lower index.
__device__ __forceinline__ bool argmax_before(float v, int i, float bv, int bi) {
  const bool v_nan = isnan(v), b_nan = isnan(bv);
  if (v_nan != b_nan) return v_nan;
  return (v_nan || v == bv) ? i < bi : v > bv;
}

// Warp-wide lexicographic pick over (value, index): the smallest value when
// kMin, else the first in argmax_before's order; equal values go to the
// lowest index. The order is total, so the butterfly leaves every lane with
// the same pair.
template <bool kMin>
__device__ __forceinline__ void warp_pick(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(kFullMask, v, off);
    int oi = __shfl_xor_sync(kFullMask, i, off);
    const bool better = kMin ? (ov < v || (ov == v && oi < i)) : argmax_before(ov, oi, v, i);
    if (better) {
      v = ov;
      i = oi;
    }
  }
}

}  // namespace deepaco
