// K3: the Ant System update of one iteration, tau' = decay * tau + D + D^T,
// and the cyclic tour costs.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:401 fused_tsp_update_pallas
// (Pallas kernel _fused_tsp_update_kernel, 369-398), which built D by
// one-hot MXU contractions per ant. Scatter-adds of q/cost onto tour edges
// would need atomics on the GPU, and their order would change the sums from
// run to run. Instead:
//   pass 1, one block per (instance, ant): the cost sum_i dist[u_i, u_{i-1}]
//           by a block reduction (in double, rounded once), and the inverse
//           permutation pos[u] = i;
//   pass 2, one block per (instance, row u): every ant adds q/cost at
//           prev(u) (its edge (u, prev) of D) and at next(u) (its edge
//           (next, u), the D^T part), in ant order, in shared memory; the
//           row of tau is then read once and written once.
// What bounds it: device-memory bandwidth, reading and writing tau
// (100 MB each at B=100, N=500). The result is deterministic.
//
// Tours must be permutations of 0..N-1. Pass 1 builds the inverse in shared
// memory over a fill of -1, so a tour that misses a city (and so repeats
// another) leaves a -1 there; that, or a city out of range, stops the kernel
// with a device-side assert before pass 2 could read out of bounds.
#include <cassert>

#include "common.cuh"

namespace deepaco {
namespace {

constexpr int kThreads = 256;

__global__ void tour_cost_kernel(const int64_t* __restrict__ paths, const float* __restrict__ dist,
                                 float* __restrict__ costs, int* __restrict__ pos, int N, int A) {
  __shared__ double part[kThreads / 32];
  extern __shared__ int inv[];  // [N], the inverse permutation
  const long ba = blockIdx.x;  // b * A + a
  const long b = ba / A;
  const int a = (int)(ba % A);
  const int64_t* p = paths + b * N * A + a;  // p[i * A] is city i of the tour
  const float* d = dist + b * N * N;
  for (int c = threadIdx.x; c < N; c += blockDim.x) inv[c] = -1;
  __syncthreads();
  double acc = 0.0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const long u = p[(long)i * A];
    const long v = p[(long)((i + N - 1) % N) * A];
    assert(0 <= u && u < N && 0 <= v && v < N);
    acc += (double)d[u * N + v];
    inv[u] = i;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) total += part[w];
    costs[ba] = (float)total;
  }
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    assert(inv[c] >= 0);  // city c missing from the tour
    pos[ba * N + c] = inv[c];
  }
}

__global__ void as_row_kernel(const float* __restrict__ tau, const int64_t* __restrict__ paths,
                              const int* __restrict__ pos, const float* __restrict__ costs,
                              float* __restrict__ tau_out, int N, int A, float decay, float q,
                              int symmetric) {
  extern __shared__ float smem[];
  float* dd = smem;       // D[u, :]
  float* dt = smem + N;   // D^T[u, :]
  float* amt = dt + N;    // [A]
  int* prev = (int*)(amt + A);
  int* next = prev + A;
  const long bu = blockIdx.x;  // b * N + u
  const long b = bu / N;
  const int u = (int)(bu % N);
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    dd[c] = 0.0f;
    dt[c] = 0.0f;
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const int i = pos[(b * A + a) * N + u];
    amt[a] = q / costs[b * A + a];
    prev[a] = (int)paths[(b * N + (i + N - 1) % N) * A + a];
    next[a] = (int)paths[(b * N + (i + 1) % N) * A + a];
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // ant order, no atomics: the sums are reproducible
    for (int a = 0; a < A; ++a) {
      dd[prev[a]] += amt[a];
      if (symmetric) dt[next[a]] += amt[a];
    }
  }
  __syncthreads();
  const float* src = tau + bu * N;
  float* dst = tau_out + bu * N;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    dst[c] = __fadd_rn(__fmul_rn(src[c], decay), __fadd_rn(dd[c], dt[c]));
  }
}

}  // namespace
}  // namespace deepaco

// tau, dist [B,N,N] f32; paths [B,N,A] int64 permutations -> tau_out
// [B,N,N] f32, costs [B,A] f32. pos [B,A,N] int32 is scratch.
extern "C" int deepaco_as_update(const float* tau, const int64_t* paths, const float* dist,
                                 float* tau_out, float* costs, int* pos, int B, int N, int A,
                                 float decay, float q, int symmetric, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tour_cost_kernel<<<(unsigned)((long)B * A), kThreads, (size_t)N * sizeof(int), s>>>(paths, dist, costs,
                                                                                     pos, N, A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (2 * (size_t)N + A) * sizeof(float) + 2 * (size_t)A * sizeof(int);
  as_row_kernel<<<(unsigned)((long)B * N), kThreads, smem, s>>>(tau, paths, pos, costs, tau_out, N,
                                                                A, decay, q, symmetric);
  return cudaGetLastError();
}
