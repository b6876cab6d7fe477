// K3: the main path's one pass over the search state after each
// construction: the Ant System update tau' = decay * tau + D + D^T (then
// max(tau', floor) when a floor is set), the cyclic tour costs, the
// best-so-far tour and cost, and the next iteration's score
// alpha * log(max(tau', 1e-30)) + log_heu in bf16 or f32.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:401 fused_tsp_update_pallas
// (Pallas kernel _fused_tsp_update_kernel, 369-398), which built D by
// one-hot MXU contractions per ant, and the XLA ops around it in the JAX
// loop (aco/batched_tsp.py:133-145 decay, transpose, floor and best
// tracking; :323-324 the score). Two kernels, in order on the stream:
//
//   cost_kernel, a block per (instance, chunk of C ants), about four blocks
//     an SM: the tours' edge distances, gathered through reads of the tour
//     rows (C ants contiguous) into shared memory, then a warp per ant sums
//     its tour's cost in double, rounded once; the neighbours (prev, next)
//     of every city, built in shared memory, are written as nbr[b, u, a]
//     (a row's ants contiguous);
//   row_kernel, persistent warps, a warp a row (b, u): the ants' (prev,
//     next) pairs and costs come in one coalesced read; each lane sums, in
//     ant order, the amounts q / cost that land on its own ant's two
//     columns, and writes the column's total into the warp's row of shared
//     memory; the row of tau and of log_heu is then streamed once as
//     float4, tau' written as float4 and the score as packed bf16 (or
//     float4); the touched columns are reset to 0 for the warp's next row.
//     The warp also finds the first cheapest ant and writes entry u of the
//     best tour: that ant's city u when it is strictly cheaper than the best
//     so far, else the old one (row 0 writes the best cost).
//
// That is the staged variant, for N <= 19,000: its cost pass holds an
// ant's 3 N words in shared memory, its row pass a warp's row of D + D^T.
// Past that (or when asked), the unstaged variant computes the same bits
// from device memory alone: cost_kernel_unstaged, a block per ant, adds
// each edge's distance straight from dist in the same fixed order and
// writes the neighbours into nbr over a fill of -1; row_kernel_unstaged
// streams the row with nothing deposited (decay * tau + 0, the clamp, the
// score), then, after a __syncwarp, rewrites the few columns that receive
// deposits with decay * tau + their total, which is what the staged row
// pass computes for every column. The row pass asserts there that no
// neighbour is -1, the staged cost pass's check.
//
// What bounds it: device-memory bytes, tau and log_heu read once, tau' and
// the score written once (350 MB at B=100, N=500 with a bf16 score). A
// block a row would spend a 2 KB row's time in a chain of latencies (the
// ants' positions, then their neighbours, then a serial sum between two
// barriers); here the row's deposits take a handful of shuffles on
// registers and the streams of many rows overlap on each SM. The cost pass
// is bound by its B*A*N random distance reads (a 32-byte sector each), so
// it spreads them over the whole card.
//
// Bit for bit the composition of the separate steps it replaces: each
// cost is a double sum in one fixed order (position i goes to partial
// p = i % 256 in order of i, each group of 32 partials is summed by a
// butterfly, the 8 group sums in order), each column's deposit adds the
// amounts in ant order, D's and D^T's parts apart and then together, and
// every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// FMA contraction), as separate PyTorch kernels round them; the score takes
// logf (no fast math), fmaxf for the clamp and __float2bfloat16_rn.
//
// Tours must be permutations of 0..N-1. The cost pass fills each ant's
// neighbours in shared memory over -1, so a tour that misses a city (and so
// repeats another) leaves a -1 there; that, or a city out of range, stops
// the kernel with a device-side assert before the row pass could read a
// neighbour that was never written.
#include <cassert>
#include <cuda_bf16.h>

#include "common.cuh"

namespace deepaco {
namespace {

constexpr int kCostThreads = 256;    // a cost block
constexpr int kCostBlocksPerSm = 4;  // cost blocks wanted on each SM
constexpr int kRowWarps = 8;         // warps of a row-pass block
constexpr int kRowBlocksPerSm = 4;   // the row pass's persistent grid
constexpr int kPrefetch = 4;         // float4 groups a lane loads ahead
constexpr int kStreamAhead = 8;      // columns a lane loads ahead (unstaged row pass)
constexpr int kNone = 0x7fffffff;    // no ant yet
constexpr size_t kSmemDefault = 48 * 1024;

// Whether (v, i) comes before (bv, bi) in torch.argmin's order: NaN first,
// then the smaller value; equal values (or two NaNs) go to the lower index;
// every ant comes before kNone.
__device__ __forceinline__ bool argmin_before(float v, int i, float bv, int bi) {
  if (i == kNone || bi == kNone) return bi == kNone && i != kNone;
  const bool v_nan = isnan(v), b_nan = isnan(bv);
  if (v_nan != b_nan) return v_nan;
  return (v_nan || v == bv) ? i < bi : v < bv;
}

// Phase 1 walks the chunk's (position, ant) pairs in the order of paths
// [N, A], so a warp reads whole runs of a tour row: each edge's distance
// goes to edge_s[i * ldc + k] in shared memory, each city's neighbours to
// prev_s / next_s[k * N + city] (over a fill of -1). Phase 2, a warp per
// ant, adds the staged distances in the fixed order; phase 3 writes the
// neighbours to nbr in runs of the chunk's ants, checking that every city
// was reached.
__global__ void __launch_bounds__(kCostThreads)
    cost_kernel(const int64_t* __restrict__ paths, const float* __restrict__ dist,
                float* __restrict__ costs, int2* __restrict__ nbr, int N, int A, int C) {
  extern __shared__ int smem_i[];
  const int ldc = C | 1;  // odd, so phase 2's column reads miss no bank twice
  const int chunks = (A + C - 1) / C;
  const long b = blockIdx.x / chunks;
  const int a0 = (blockIdx.x % chunks) * C, c = min(C, A - a0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* prev_s = smem_i;                                          // [C][N]
  int* next_s = prev_s + C * N;                                  // [C][N]
  float* edge_s = reinterpret_cast<float*>(next_s + C * N);     // [N][ldc]
  const int64_t* pb = paths + b * N * A;
  const float* d = dist + b * N * N;
  for (int e = threadIdx.x; e < c * N; e += blockDim.x) prev_s[e] = -1;
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < N * c; e += blockDim.x) {
    const int i = e / c, k = e - i * c, a = a0 + k;
    const long u = pb[(long)i * A + a];
    const long v = pb[(long)((i + N - 1) % N) * A + a];
    const long nx = pb[(long)((i + 1) % N) * A + a];
    assert(0 <= u && u < N && 0 <= v && v < N);
    edge_s[i * ldc + k] = d[u * N + v];
    prev_s[k * N + u] = (int)v;
    next_s[k * N + u] = (int)nx;
  }
  __syncthreads();
  for (int k = warp; k < c; k += blockDim.x / 32) {
    // acc[w] is partial 32 w + lane: positions i = 32 w + lane + 256 j
    double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int base = 0; base < N; base += 256) {
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const int i = base + 32 * w + lane;
        if (i < N) acc[w] += (double)edge_s[i * ldc + k];
      }
    }
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      double r = acc[w];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) r += __shfl_xor_sync(kFullMask, r, off);
      total += r;
    }
    if (lane == 0) costs[b * A + a0 + k] = (float)total;
  }
  for (int e = threadIdx.x; e < N * c; e += blockDim.x) {
    const int u = e / c, k = e - u * c;
    const int v = prev_s[k * N + u];
    assert(v >= 0);  // city u missing from the tour
    nbr[(b * N + u) * A + a0 + k] = make_int2(v, next_s[k * N + u]);
  }
}

// The unstaged cost pass: a block of 8 warps per ant (b, a); warp w owns
// cost_kernel's partials 32 w + lane (positions 32 w + lane + 256 j, in
// order of j) and adds each edge's distance straight from dist; the group
// sums are added in order of w, as cost_kernel adds them. Each city's
// neighbours go to nbr[b, u, a], which the caller filled with -1
// (row_kernel_unstaged checks that every city was reached).
__global__ void __launch_bounds__(kCostThreads)
    cost_kernel_unstaged(const int64_t* __restrict__ paths, const float* __restrict__ dist,
                         float* __restrict__ costs, int2* __restrict__ nbr, int N, int A) {
  __shared__ double group_s[kCostThreads / 32];
  const long ant = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long b = ant / A;
  const int a = (int)(ant - b * A);
  const int64_t* pb = paths + b * N * A;
  const float* d = dist + b * N * N;
  double acc = 0.0;
#pragma unroll 4
  for (int i = 32 * warp + lane; i < N; i += kCostThreads) {
    const long u = pb[(long)i * A + a];
    const long v = pb[(long)((i + N - 1) % N) * A + a];
    const long nx = pb[(long)((i + 1) % N) * A + a];
    assert(0 <= u && u < N && 0 <= v && v < N);
    acc += (double)d[u * N + v];
    nbr[(b * N + u) * A + a] = make_int2((int)v, (int)nx);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  if (lane == 0) group_s[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < kCostThreads / 32; ++w) total += group_s[w];
    costs[ant] = (float)total;
  }
}

template <typename S>
__device__ __forceinline__ void store_score4(S* dst, float s0, float s1, float s2, float s3);

template <>
__device__ __forceinline__ void store_score4<float>(float* dst, float s0, float s1, float s2,
                                                    float s3) {
  *reinterpret_cast<float4*>(dst) = make_float4(s0, s1, s2, s3);
}

template <>
__device__ __forceinline__ void store_score4<__nv_bfloat16>(__nv_bfloat16* dst, float s0, float s1,
                                                            float s2, float s3) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(s0), __float2bfloat16_rn(s1));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(s2), __float2bfloat16_rn(s3));
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned*>(&lo);
  packed.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

__device__ __forceinline__ void store_score1(float* dst, float s) { *dst = s; }
__device__ __forceinline__ void store_score1(__nv_bfloat16* dst, float s) {
  *dst = __float2bfloat16_rn(s);
}

struct RowArgs {
  const float* tau;
  const float* log_heu;
  const int64_t* paths;
  const int2* nbr;
  const float* costs;
  const float* best_cost;
  const int64_t* best_path;
  float* tau_out;
  void* score;
  float* best_cost_out;
  int64_t* best_path_out;
  long rows;
  int N, A;
  float decay, q, floor, alpha;
  int symmetric, use_floor;
};

// tau' of one entry, as decay * tau + (D + D^T) and the clamp
__device__ __forceinline__ float updated(float t, float add, float decay, bool use_floor,
                                         float floor) {
  const float o = __fadd_rn(__fmul_rn(t, decay), add);
  return use_floor ? fmaxf(o, floor) : o;
}

// the next score of one entry, as alpha * log(max(tau', 1e-30)) + log_heu
__device__ __forceinline__ float scored(float t, float lh, float alpha) {
  return __fadd_rn(__fmul_rn(logf(fmaxf(t, 1e-30f)), alpha), lh);
}

// One row (b, u) of D + D^T: each lane's ants' two columns get the sums
// over all ants, in ant order, of the amounts landing there through D (prev)
// and through D^T (next), handed to put(column, total) (lanes that share a
// column hand over the same total); on the way, each lane's first cheapest
// ant. nb is the row's (prev, next) of every ant, cost the instance's costs.
template <typename Put>
__device__ __forceinline__ void row_deposits(const int2* nb, const float* cost, int A, float q,
                                             bool symmetric, int lane, float& best_v,
                                             int& best_i, Put put) {
  for (int m = 0; m < A; m += 32) {
    const bool mine = m + lane < A;
    const int2 pn = mine ? nb[m + lane] : make_int2(-1, -1);
    assert(!mine || pn.x >= 0);  // city u missing from ant m + lane's tour
    float p_dd = 0.0f, p_dt = 0.0f, n_dd = 0.0f, n_dt = 0.0f;
    for (int k = 0; k < A; k += 32) {
      const bool in = k + lane < A;
      const int2 qn = in ? nb[k + lane] : make_int2(-1, -1);
      const float ck = in ? cost[k + lane] : 0.0f;
      const float w = in ? q / ck : 0.0f;
      if (m == 0 && in && argmin_before(ck, k + lane, best_v, best_i)) {
        best_v = ck;
        best_i = k + lane;
      }
      const int count = min(32, A - k);
      for (int j = 0; j < count; ++j) {
        const int qp = __shfl_sync(kFullMask, qn.x, j);
        const int qx = __shfl_sync(kFullMask, qn.y, j);
        const float wj = __shfl_sync(kFullMask, w, j);
        if (qp == pn.x) p_dd = __fadd_rn(p_dd, wj);
        if (qx == pn.x) p_dt = __fadd_rn(p_dt, wj);
        if (qp == pn.y) n_dd = __fadd_rn(n_dd, wj);
        if (qx == pn.y) n_dt = __fadd_rn(n_dt, wj);
      }
    }
    if (mine) {
      put(pn.x, symmetric ? __fadd_rn(p_dd, p_dt) : p_dd);
      if (symmetric) put(pn.y, __fadd_rn(n_dd, n_dt));
    }
  }
}

// The warp's first cheapest ant, then entry u of the best tour: that ant's
// city u when it is strictly cheaper than the best so far (a tie keeps the
// old tour), else the old one; row 0 of the instance writes the best cost.
__device__ __forceinline__ void write_best(const RowArgs& r, long row, long b, int lane,
                                           float best_v, int best_i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, best_v, off);
    const int oi = __shfl_xor_sync(kFullMask, best_i, off);
    if (argmin_before(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    const bool better = best_v < r.best_cost[b];
    r.best_path_out[row] = better ? r.paths[row * r.A + best_i] : r.best_path[row];
    if (row == b * r.N) r.best_cost_out[b] = better ? best_v : r.best_cost[b];
  }
}

// S: the score's type (float or __nv_bfloat16); kScore false writes none.
// kVec: N % 4 == 0, so every row starts on 16 bytes (8 for a bf16 score).
template <typename S, bool kScore, bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32, kRowBlocksPerSm) row_kernel(const RowArgs r) {
  extern __shared__ float add_s[];
  const int N = r.N, A = r.A;
  const float decay = r.decay, q = r.q, floor = r.floor, alpha = r.alpha;
  const bool symmetric = r.symmetric != 0, use_floor = r.use_floor != 0;
  const int lane = threadIdx.x % 32;
  float* add = add_s + (threadIdx.x / 32) * N;  // the warp's row of D + D^T
  for (int c = lane; c < N; c += 32) add[c] = 0.0f;
  __syncwarp();
  const long warps = (long)gridDim.x * (blockDim.x / 32);
  S* score = static_cast<S*>(r.score);
  const int groups = N / 4;
  for (long row = blockIdx.x * (long)(blockDim.x / 32) + threadIdx.x / 32; row < r.rows;
       row += warps) {
    const long b = row / N;
    const float* src = r.tau + row * N;
    const float* lh = r.log_heu + row * N;
    float4 t4[kPrefetch], h4[kPrefetch];
    if (kVec) {  // the row's first groups are in flight while the deposits are summed
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int g = lane + 32 * j;
        if (g < groups) {
          t4[j] = __ldcs(reinterpret_cast<const float4*>(src) + g);
          if (kScore) h4[j] = __ldcs(reinterpret_cast<const float4*>(lh) + g);
        }
      }
    }
    float best_v = 0.0f;
    int best_i = kNone;
    row_deposits(r.nbr + row * A, r.costs + b * A, A, q, symmetric, lane, best_v, best_i,
                 [&](int c, float total) { add[c] = total; });
    write_best(r, row, b, lane, best_v, best_i);
    __syncwarp();
    float* dst = r.tau_out + row * N;
    S* sc = kScore ? score + row * N : nullptr;
    if (kVec) {
      for (int g0 = 0; g0 < groups; g0 += 32 * kPrefetch) {
        if (g0 > 0) {
#pragma unroll
          for (int j = 0; j < kPrefetch; ++j) {
            const int g = g0 + lane + 32 * j;
            if (g < groups) {
              t4[j] = __ldcs(reinterpret_cast<const float4*>(src) + g);
              if (kScore) h4[j] = __ldcs(reinterpret_cast<const float4*>(lh) + g);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {
          const int g = g0 + lane + 32 * j;
          if (g < groups) {
            const float4 a4 = reinterpret_cast<const float4*>(add)[g];
            float4 o;
            o.x = updated(t4[j].x, a4.x, decay, use_floor, floor);
            o.y = updated(t4[j].y, a4.y, decay, use_floor, floor);
            o.z = updated(t4[j].z, a4.z, decay, use_floor, floor);
            o.w = updated(t4[j].w, a4.w, decay, use_floor, floor);
            __stcs(reinterpret_cast<float4*>(dst) + g, o);
            if (kScore) {
              store_score4<S>(sc + 4 * g, scored(o.x, h4[j].x, alpha),
                              scored(o.y, h4[j].y, alpha), scored(o.z, h4[j].z, alpha),
                              scored(o.w, h4[j].w, alpha));
            }
          }
        }
      }
    } else {
      for (int c = lane; c < N; c += 32) {
        const float o = updated(__ldcs(src + c), add[c], decay, use_floor, floor);
        __stcs(dst + c, o);
        if (kScore) store_score1(sc + c, scored(o, __ldcs(lh + c), alpha));
      }
    }
    __syncwarp();
    const int2* nb = r.nbr + row * A;
    for (int m = lane; m < A; m += 32) {  // reset the touched columns
      const int2 pn = nb[m];
      add[pn.x] = 0.0f;
      add[pn.y] = 0.0f;
    }
    __syncwarp();
  }
}

// The unstaged row pass, persistent warps, a warp a row: the row streamed
// with nothing deposited, then the columns that receive deposits rewritten
// with their totals (the __syncwarp orders the two writes of a column).
template <typename S, bool kScore>
__global__ void __launch_bounds__(kRowWarps * 32, kRowBlocksPerSm)
    row_kernel_unstaged(const RowArgs r) {
  const int N = r.N, A = r.A;
  const float decay = r.decay, q = r.q, floor = r.floor, alpha = r.alpha;
  const bool symmetric = r.symmetric != 0, use_floor = r.use_floor != 0;
  const int lane = threadIdx.x % 32;
  const long warps = (long)gridDim.x * (blockDim.x / 32);
  S* score = static_cast<S*>(r.score);
  for (long row = blockIdx.x * (long)(blockDim.x / 32) + threadIdx.x / 32; row < r.rows;
       row += warps) {
    const long b = row / N;
    const float* src = r.tau + row * N;
    const float* lh = r.log_heu + row * N;
    float* dst = r.tau_out + row * N;
    S* sc = kScore ? score + row * N : nullptr;
    for (int c0 = lane; c0 < N; c0 += 32 * kStreamAhead) {  // the loads first
      float t[kStreamAhead], h[kStreamAhead];
#pragma unroll
      for (int j = 0; j < kStreamAhead; ++j) {
        const int c = c0 + 32 * j;
        if (c < N) {
          t[j] = __ldcs(src + c);
          if (kScore) h[j] = __ldcs(lh + c);
        }
      }
#pragma unroll
      for (int j = 0; j < kStreamAhead; ++j) {
        const int c = c0 + 32 * j;
        if (c < N) {
          const float o = updated(t[j], 0.0f, decay, use_floor, floor);
          __stcs(dst + c, o);
          if (kScore) store_score1(sc + c, scored(o, h[j], alpha));
        }
      }
    }
    __syncwarp();
    float best_v = 0.0f;
    int best_i = kNone;
    row_deposits(r.nbr + row * A, r.costs + b * A, A, q, symmetric, lane, best_v, best_i,
                 [&](int c, float total) {
                   const float o = updated(src[c], total, decay, use_floor, floor);
                   dst[c] = o;
                   if (kScore) store_score1(sc + c, scored(o, lh[c], alpha));
                 });
    write_best(r, row, b, lane, best_v, best_i);
  }
}

template <typename S, bool kScore>
cudaError_t launch_rows(const RowArgs& r, int sms, cudaStream_t s) {
  const size_t row_bytes = (size_t)r.N * sizeof(float);
  int warps = kRowWarps;
  while (warps > 1 && warps * row_bytes > kSmemDefault) warps /= 2;
  const size_t smem = warps * row_bytes;
  const long cap = (long)sms * kRowBlocksPerSm * (kRowWarps / warps);
  const long want = (r.rows + warps - 1) / warps;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  if (r.N % 4 == 0) {
    auto kernel = row_kernel<S, kScore, true>;
    if (smem > kSmemDefault)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<grid, 32 * warps, smem, s>>>(r);
  } else {
    auto kernel = row_kernel<S, kScore, false>;
    if (smem > kSmemDefault)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kernel<<<grid, 32 * warps, smem, s>>>(r);
  }
  return cudaGetLastError();
}

template <typename S, bool kScore>
cudaError_t launch_rows_unstaged(const RowArgs& r, int sms, cudaStream_t s) {
  const long cap = (long)sms * kRowBlocksPerSm;
  const long want = (r.rows + kRowWarps - 1) / kRowWarps;
  row_kernel_unstaged<S, kScore><<<(unsigned)(want < cap ? want : cap), kRowWarps * 32, 0, s>>>(r);
  return cudaGetLastError();
}

}  // namespace
}  // namespace deepaco

// tau, dist, log_heu [B,N,N] f32; paths [B,N,A] int64 permutations;
// best_cost [B] f32 and best_path [B,N] int64, the best so far ->
// tau_out [B,N,N] f32, costs [B,A] f32, best_cost_out, best_path_out and,
// unless score_kind is 0, score [B,N,N] (1: bf16, 2: f32; log_heu is read
// only then). nbr [B,N,A] int2 is scratch. staged != 0 takes the staged
// variant, whose 3 N words must fit in shared memory (N <= 19,000); 0 the
// unstaged one, at any N.
extern "C" int deepaco_as_update(const float* tau, const int64_t* paths, const float* dist,
                                 const float* log_heu, const float* best_cost,
                                 const int64_t* best_path, float* tau_out, float* costs,
                                 void* score, float* best_cost_out, int64_t* best_path_out,
                                 void* nbr, int B, int N, int A, float decay, float q,
                                 int symmetric, int use_floor, float floor, float alpha,
                                 int score_kind, int staged, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int2* nb = static_cast<int2*>(nbr);
  cudaError_t err;
  if (staged) {
    // C ants a cost block: enough blocks for kCostBlocksPerSm an SM, and as
    // many ants as fit in the default 48 KB of shared memory, at least one
    auto cost_smem = [&](int c) { return (size_t)N * (2 * c + (c | 1)) * 4; };
    const long want = ((long)kCostBlocksPerSm * sms + B - 1) / B;  // blocks an instance
    int C = (int)((A + (want < A ? want : A) - 1) / (want < A ? want : A));
    while (C > 1 && cost_smem(C) > kSmemDefault) --C;
    const size_t smem = cost_smem(C);
    if (smem > kSmemDefault)
      cudaFuncSetAttribute(cost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const long blocks = (long)B * ((A + C - 1) / C);
    cost_kernel<<<(unsigned)blocks, kCostThreads, smem, s>>>(paths, dist, costs, nb, N, A, C);
  } else {
    const long ants = (long)B * A;
    err = cudaMemsetAsync(nb, 0xff, (size_t)ants * N * sizeof(int2), s);
    if (err != cudaSuccess) return err;
    cost_kernel_unstaged<<<(unsigned)ants, kCostThreads, 0, s>>>(paths, dist, costs, nb, N, A);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const RowArgs r{tau,     log_heu,       paths,         nb,     costs, best_cost,
                  best_path, tau_out,     score,         best_cost_out, best_path_out,
                  (long)B * N, N,         A,             decay,  q,     floor,
                  alpha,   symmetric,     use_floor};
  if (!staged) {
    if (score_kind == 1) return launch_rows_unstaged<__nv_bfloat16, true>(r, sms, s);
    if (score_kind == 2) return launch_rows_unstaged<float, true>(r, sms, s);
    return launch_rows_unstaged<float, false>(r, sms, s);
  }
  if (score_kind == 1) return launch_rows<__nv_bfloat16, true>(r, sms, s);
  if (score_kind == 2) return launch_rows<float, true>(r, sms, s);
  return launch_rows<float, false>(r, sms, s);
}
