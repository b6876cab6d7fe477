// K4 and K5: the best-improvement 2-opt descent and the neural-guided local
// search (NLS) of every ant, one thread block per (instance, ant).
//
// Replaces deepaco_tpu/ops/pallas_two_opt.py:
//   K4, two_opt_kernel: batched_two_opt_euclid (591; _two_opt_kernel
//       192-198, n <= 1024) and _tiled_two_opt_call (535;
//       _tiled_two_opt_kernel 458-473, n <= 4096);
//   K5, nls_kernel: batched_nls_euclid (631) through _nls_kernel (200-225,
//       n <= 1024) and _tiled_nls_kernel (476-532, n <= 2048).
// The TPU kernels rebuilt the tour-permuted distance matrix on every move
// with one-hot MXU products, and split into whole-matrix and tiled variants
// to fit VMEM. Here one design covers every size up to the caps. The block
// keeps its ant's state in shared memory, 16 bytes per city (64 KB at
// n = 4096): the tour t, the coordinates x, y in tour order and the edge
// costs c[k] = d(t[k-1], t[k]); entry n repeats entry 0 (it never moves:
// a move reverses t[i..j] with 1 <= i < j <= n-1), so c[n] is the closing
// edge.
//
// One move: warp w scans rows i = 1 + w, 1 + w + 16, ..., its lanes the
// columns j > i, each computing
//   delta = ((d(t[i-1], t[j]) + d(t[i], t[j+1])) - c[i]) - c[j+1]
// in that order, as deepaco_tpu/ops/two_opt.py:36-40 does. Each thread keeps
// its first minimum over its increasing flat indices i*n + j; a warp and a
// block reduction on (delta, flat index) then give the first flat argmin of
// the delta matrix, as jnp.argmin and torch.argmin take it. If the best delta
// is below -1e-6 the block reverses t, x, y over [i..j] and recomputes
// c[i..j+1]; otherwise, or after max_it scans, the descent ends.
// Euclidean distances are sqrt((dx*dx + dy*dy) + 1e-20) with every operation
// rounded on its own (no FMA contraction), bit-equal to distance_matrix. The
// perturbation metric is read as bf16 from device memory (it sits in L2):
// the row of t[i-1] and of t[i], gathered at t[j] and t[j+1].
//
// K5 runs the Euclidean descent, then t_nls rounds of a t_p-scan descent on
// the metric and a Euclidean descent, in one launch. The running tour carries
// across rounds; after each round its cost, c[n] + c[1] + ... + c[n-1] added
// one by one in f32 (the order of the plain version's _tour_lengths), replaces
// the best one when strictly lower, and the tour is copied to the output.
//
// What bounds it: operations. Each scan evaluates (n-1)(n-2)/2 pairs, two
// distances (one sqrt each) per pair; the inputs are read once. The blocks
// are independent, so a converged ant frees its SM slot at once.
#include <cassert>
#include <climits>
#include <cuda_bf16.h>

#include "common.cuh"

namespace deepaco {
namespace {

constexpr int kLsThreads = 512;
constexpr int kLsWarps = kLsThreads / 32;
constexpr float kImprove = -1e-6f;

// distance_matrix's formula, sqrt((dx*dx + dy*dy) + 1e-20), each step rounded.
__device__ __forceinline__ float euclid(float ax, float ay, float bx, float by) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by);
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 1e-20f));
}

struct Ant {
  int* t;    // [n + 1] tour, t[n] = t[0]
  float* x;  // [n + 1] coordinates in tour order
  float* y;
  float* c;  // [n + 1] c[k] = d(t[k-1], t[k]) for k >= 1
  int n;
  const __nv_bfloat16* metric;  // [n, n] the instance's perturbation metric, or null
};

__device__ Ant carve(void* smem, int n, const __nv_bfloat16* metric) {
  Ant s;
  s.t = static_cast<int*>(smem);
  s.x = reinterpret_cast<float*>(s.t + n + 1);
  s.y = s.x + n + 1;
  s.c = s.y + n + 1;
  s.n = n;
  s.metric = metric;
  return s;
}

// d(t[u], t[v]) from positions u, v: the metric, or the Euclidean distance
// with D[a, b]'s sign convention (coords[a] - coords[b]).
template <bool kMetric>
__device__ __forceinline__ float edge(const Ant& s, int u, int v) {
  if (kMetric) return __bfloat162float(s.metric[(size_t)s.t[u] * s.n + s.t[v]]);
  return euclid(s.x[u], s.y[u], s.x[v], s.y[v]);
}

template <bool kMetric>
__device__ void edge_costs(const Ant& s, int lo, int hi) {  // c[lo..hi]
  for (int k = lo + (int)threadIdx.x; k <= hi; k += blockDim.x) s.c[k] = edge<kMetric>(s, k - 1, k);
  __syncthreads();
}

__device__ void load_ant(const Ant& s, const float* coords, const int64_t* tour) {
  for (int k = threadIdx.x; k < s.n; k += blockDim.x) {
    const int64_t v = tour[k];
    assert(0 <= v && v < s.n);
    s.t[k] = (int)v;
    s.x[k] = coords[2 * v];
    s.y[k] = coords[2 * v + 1];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s.t[s.n] = s.t[0];
    s.x[s.n] = s.x[0];
    s.y[s.n] = s.y[0];
  }
  __syncthreads();
}

__device__ void store_ant(const Ant& s, int64_t* out) {
  for (int k = threadIdx.x; k < s.n; k += blockDim.x) out[k] = s.t[k];
}

// The first flat argmin (g, i*n + j) of the delta matrix over 1 <= i < j <= n-1,
// the same in every thread on return; (inf, INT_MAX) when n < 3.
template <bool kMetric>
__device__ void best_move(const Ant& s, float* red_v, int* red_i, float& g, int& flat) {
  const int n = s.n, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float best = INFINITY;
  int bidx = INT_MAX;
  for (int i = 1 + warp; i < n - 1; i += kLsWarps) {
    const float ci = s.c[i];
    if (kMetric) {
      const __nv_bfloat16* up = s.metric + (size_t)s.t[i - 1] * n;
      const __nv_bfloat16* right = s.metric + (size_t)s.t[i] * n;
      for (int j = i + 1 + lane; j < n; j += 32) {
        const float d_up = __bfloat162float(up[s.t[j]]);
        const float d_right = __bfloat162float(right[s.t[j + 1]]);
        const float delta = __fsub_rn(__fsub_rn(__fadd_rn(d_up, d_right), ci), s.c[j + 1]);
        if (delta < best) {
          best = delta;
          bidx = i * n + j;
        }
      }
    } else {
      const float xu = s.x[i - 1], yu = s.y[i - 1], xi = s.x[i], yi = s.y[i];
      for (int j = i + 1 + lane; j < n; j += 32) {
        const float d_up = euclid(xu, yu, s.x[j], s.y[j]);
        const float d_right = euclid(xi, yi, s.x[j + 1], s.y[j + 1]);
        const float delta = __fsub_rn(__fsub_rn(__fadd_rn(d_up, d_right), ci), s.c[j + 1]);
        if (delta < best) {
          best = delta;
          bidx = i * n + j;
        }
      }
    }
  }
  warp_pick<true>(best, bidx);
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kLsWarps ? red_v[lane] : INFINITY;
    bidx = lane < kLsWarps ? red_i[lane] : INT_MAX;
    warp_pick<true>(best, bidx);
    if (lane == 0) {
      red_v[kLsWarps] = best;
      red_i[kLsWarps] = bidx;
    }
  }
  __syncthreads();
  g = red_v[kLsWarps];
  flat = red_i[kLsWarps];
}

// Reverse positions [p..q] (1 <= p < q <= n-1) and recompute c[p..q+1].
template <bool kMetric>
__device__ void flip(const Ant& s, int p, int q) {
  const int half = (q - p + 1) >> 1;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const int u = p + k, v = q - k;
    const int tu = s.t[u];
    const float xu = s.x[u], yu = s.y[u];
    s.t[u] = s.t[v];
    s.x[u] = s.x[v];
    s.y[u] = s.y[v];
    s.t[v] = tu;
    s.x[v] = xu;
    s.y[v] = yu;
  }
  __syncthreads();
  edge_costs<kMetric>(s, p, q + 1);
}

// two_opt of deepaco_tpu/ops/two_opt.py:68-82: at most max_it scans, the
// last one included when it finds no move. c must hold this metric's costs.
template <bool kMetric>
__device__ void descent(const Ant& s, int max_it, float* red_v, int* red_i) {
  for (int it = 0; it < max_it; ++it) {
    float g;
    int flat;
    best_move<kMetric>(s, red_v, red_i, g, flat);
    if (!(g < kImprove)) return;  // g and flat are the same in every thread
    flip<kMetric>(s, flat / s.n, flat % s.n);
  }
}

// c[n] + c[1] + ... + c[n-1], one by one, from the Euclidean costs.
__device__ float tour_cost(const Ant& s, float* out) {
  if (threadIdx.x == 0) {
    float total = s.c[s.n];
    for (int k = 1; k < s.n; ++k) total = __fadd_rn(total, s.c[k]);
    *out = total;
  }
  __syncthreads();
  const float total = *out;
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kLsThreads)
    two_opt_kernel(const float* __restrict__ coords, const int64_t* __restrict__ tours,
                   int64_t* __restrict__ out, int A, int n, int max_it) {
  extern __shared__ int4 smem_two_opt[];
  __shared__ float red_v[kLsWarps + 1];
  __shared__ int red_i[kLsWarps + 1];
  const long ba = blockIdx.x;  // b * A + a
  const long b = ba / A;
  const Ant s = carve(smem_two_opt, n, nullptr);
  load_ant(s, coords + b * n * 2, tours + ba * n);
  edge_costs<false>(s, 1, n);
  descent<false>(s, max_it, red_v, red_i);
  store_ant(s, out + ba * n);
}

__global__ void __launch_bounds__(kLsThreads)
    nls_kernel(const float* __restrict__ coords, const __nv_bfloat16* __restrict__ metric,
               const int64_t* __restrict__ tours, int64_t* __restrict__ out, int A, int n,
               int max_it, int t_nls, int t_p) {
  extern __shared__ int4 smem_nls[];
  __shared__ float red_v[kLsWarps + 1];
  __shared__ int red_i[kLsWarps + 1];
  __shared__ float cost_slot;
  const long ba = blockIdx.x;
  const long b = ba / A;
  const Ant s = carve(smem_nls, n, metric + b * n * n);
  int64_t* best_tour = out + ba * n;
  load_ant(s, coords + b * n * 2, tours + ba * n);
  edge_costs<false>(s, 1, n);
  descent<false>(s, max_it, red_v, red_i);
  float best = tour_cost(s, &cost_slot);
  store_ant(s, best_tour);
  for (int r = 0; r < t_nls; ++r) {
    edge_costs<true>(s, 1, n);  // perturb toward the model
    descent<true>(s, t_p, red_v, red_i);
    edge_costs<false>(s, 1, n);  // re-optimise on the true distances
    descent<false>(s, max_it, red_v, red_i);
    const float cost = tour_cost(s, &cost_slot);
    if (cost < best) {
      best = cost;
      store_ant(s, best_tour);
    }
  }
}

size_t ant_smem(int n) { return 4 * ((size_t)n + 1) * sizeof(float); }

}  // namespace
}  // namespace deepaco

// coords [B,N,2] f32, tours [B,A,N] int64 permutations -> out [B,A,N] int64.
extern "C" int deepaco_two_opt(const float* coords, const int64_t* tours, int64_t* out, int B, int A,
                               int N, int max_it, void* stream) {
  using namespace deepaco;
  const size_t smem = ant_smem(N);
  cudaError_t err = cudaFuncSetAttribute(two_opt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  two_opt_kernel<<<(unsigned)((long)B * A), kLsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coords, tours, out, A, N, max_it);
  return cudaGetLastError();
}

// coords [B,N,2] f32, metric [B,N,N] bf16, tours [B,A,N] int64 -> out [B,A,N].
extern "C" int deepaco_nls(const float* coords, const void* metric, const int64_t* tours,
                           int64_t* out, int B, int A, int N, int max_it, int t_nls, int t_p,
                           void* stream) {
  using namespace deepaco;
  const size_t smem = ant_smem(N);
  cudaError_t err =
      cudaFuncSetAttribute(nls_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  nls_kernel<<<(unsigned)((long)B * A), kLsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coords, static_cast<const __nv_bfloat16*>(metric), tours, out, A, N, max_it, t_nls, t_p);
  return cudaGetLastError();
}
