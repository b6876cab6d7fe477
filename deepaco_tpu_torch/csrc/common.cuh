// Helpers shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
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

// Philox4x32-10 (Salmon et al., SC'11; Random123's constants): the four
// 32-bit words for counter c under key k. K2 and K7c draw their noise here.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

// Columns c..c+3 of a row as f32: one vector load when kVec (N % 4 == 0
// and the scores aligned), else one load a column, clamped to the row.
template <bool kVec>
__device__ __forceinline__ void load_group(const __nv_bfloat16* row, int c, int N, float (&v)[4]) {
  if (kVec) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(row + c));
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xFFFF0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xFFFF0000u);
  } else {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __uint_as_float((uint32_t)__ldg(p + min(c + q, N - 1)) << 16);
  }
}
template <bool kVec>
__device__ __forceinline__ void load_group(const float* row, int c, int N, float (&v)[4]) {
  if (kVec) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(row + c));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __ldg(row + min(c + q, N - 1));
  }
}

// Word q of a Philox output: the draw of column 4 * (counter.x) + q.
__device__ __forceinline__ uint32_t philox_word(const uint4& r, int q) {
  return q == 0 ? r.x : q == 1 ? r.y : q == 2 ? r.z : r.w;
}

// A key whose unsigned order is torch.argmax's order of the values: every
// NaN above every number (and equal to each other), -0 equal to +0. With
// ties going to the lower column, the first maximum is the largest key.
__device__ __forceinline__ uint32_t order_key(float v) {
  if (isnan(v)) return 0xFFFFFFFFu;
  const uint32_t bits = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// Folds candidate (x, c) into a first maximum (best, bidx) whose columns all
// come before c: NaN above every number (x NaN passes the first test; once
// best is NaN, nothing does), ties to the earlier column.
__device__ __forceinline__ void fold_first_max(float x, int c, float& best, int& bidx) {
  if (!(x <= best) && best == best) {
    best = x;
    bidx = c;
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace deepaco
