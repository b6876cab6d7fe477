// K8: the all-ant pheromone deposit of one Ant System iteration,
//   D[b, u, v] = sum_a amounts[b, a] * #{l : (u, v) is edge l of ant a},
// over paths [B, L, A] int64 and amounts [B, A] f32, into D [B, n, n] f32.
// Cyclic paths have the L edges (path[i], path[i-1]); open paths the L-1
// edges (path[i], path[i+1]). A repeated edge deposits once per occurrence.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:340 tour_deposit_pallas (Pallas
// kernel _tour_deposit_kernel, 313-337), which built D by one one-hot MXU
// contraction per ant in VMEM. On the H100 the function is a scatter with
// heavy duplicates: a CVRP ant that has finished parks on the depot, so the
// self-loop (0, 0) repeats hundreds of times per ant. Global atomics would
// serialise there and sum the ants in an order that changes between runs.
//
// Design: one block per (instance, band of destination rows u). The band,
// rows x n floats, lives in shared memory. The block stages a group of its
// instance's ants (their path columns, as int32) in shared memory with
// coalesced loads, four in flight a thread, then walks the ants in order:
// every thread takes some of the ant's edges and adds amounts[a] with a
// shared-memory atomic where u falls in the band. Within one ant every
// addend is amounts[a], so the atomics give the same bits in any order; a
// __syncthreads between ants fixes the order across ants. The result is
// deterministic and equals a sequential scatter in ant-major, step-minor
// order (scatter_add_ on the CPU) bit for bit. The band is written out once.
//
// The parked tail of an open path (a CVRP ant's last few hundred steps on
// the depot) would be hundreds of atomics on one address, serialised. The
// block finds each ant's tail (the longest suffix on one node) by a max
// reduction, and one thread applies its self-loop adds in a register loop,
// still one rounded add at a time, committed by a compare-and-swap.
//
// What bounds it: bytes. At B=100, L=1001, A=20, n=501 the paths are 16 MB
// and D 100 MB: 0.035 ms at 3.35 TB/s. Every band re-reads its instance's
// paths (160 KB) from L2, not from device memory.
//
// An id outside [0, n) stops the kernel with a device-side assert while it
// is staged, before any add could write outside the band.
#include <cassert>

#include "common.cuh"

namespace deepaco {
namespace {

// One block an SM with nearly all its shared memory: the fewer the bands,
// the fewer times each instance's paths are staged.
constexpr int kThreads = 1024;
constexpr int kStageBytes = 32 * 1024;   // staged path columns
constexpr int kSmemBytes = 224 * 1024;   // band + stage + tails

// *addr <- *addr + w, r times, rounded after each add, as one atomic step.
// Any mix of these and atomicAdd(addr, w) leaves the same bits, since every
// step applies the same rounding function x -> fl(x + w).
__device__ void add_repeated(float* addr, float w, int r) {
  unsigned* bits = reinterpret_cast<unsigned*>(addr);
  unsigned old = *reinterpret_cast<volatile unsigned*>(bits), assumed;
  do {
    assumed = old;
    float x = __uint_as_float(assumed);
    for (int t = 0; t < r; ++t) x = __fadd_rn(x, w);
    old = atomicCAS(bits, assumed, __float_as_uint(x));
  } while (old != assumed);
}

__global__ void __launch_bounds__(kThreads)
tour_deposit_kernel(const int64_t* __restrict__ paths, const float* __restrict__ amounts,
                    float* __restrict__ out, int L, int A, int n, int cyclic, int rows,
                    int stage_ants) {
  extern __shared__ float smem[];
  float* band = smem;                                           // [rows, n]
  int* stage = reinterpret_cast<int*>(band + (long)rows * n);   // [stage_ants, L]
  int* tails = stage + (long)stage_ants * L;                    // [stage_ants]
  const long b = blockIdx.y;
  const int u0 = blockIdx.x * rows;
  const int nr = min(rows, n - u0);
  const int lane = threadIdx.x & 31;
  const int64_t* p = paths + b * L * A;             // p[i * A + a]: step i of ant a
  for (int t = threadIdx.x; t < nr * n; t += kThreads) band[t] = 0.0f;
  const int edges = cyclic ? L : L - 1;
  for (int a0 = 0; a0 < A; a0 += stage_ants) {
    const int na = min(stage_ants, A - a0);
    const int total = L * na;
    __syncthreads();  // the previous group's edges are added
    for (int t0 = threadIdx.x; t0 < total; t0 += 4 * kThreads) {
      int64_t c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // four loads in flight a thread
        const int t = t0 + q * kThreads;
        c[q] = t < total ? p[(long)(t / na) * A + a0 + t % na] : 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q * kThreads;
        if (t < total) {
          assert(0 <= c[q] && c[q] < n);
          stage[(t % na) * L + t / na] = (int)c[q];
        }
      }
    }
    for (int j = threadIdx.x; j < na; j += kThreads) tails[j] = 0;
    __syncthreads();
    if (!cyclic) {
      // an open path's parked tail: the longest suffix on one node, from
      // tails[j] on; its edges are self-loops on that node
      for (int j = 0; j < na; ++j) {
        const int* s = stage + j * L;
        const int last = s[L - 1];
        int from = 0;
        for (int i = threadIdx.x; i < L; i += kThreads)
          if (s[i] != last) from = max(from, i + 1);
        from = __reduce_max_sync(kFullMask, from);
        if (lane == 0 && from > 0) atomicMax(&tails[j], from);
      }
      __syncthreads();
    }
    for (int j = 0; j < na; ++j) {
      const float w = amounts[b * A + a0 + j];
      const int* s = stage + j * L;
      const int head = cyclic ? edges : min(tails[j], edges);
      for (int i = threadIdx.x; i < head; i += kThreads) {
        const int u = s[i] - u0;
        if (u >= 0 && u < nr) {
          const int v = cyclic ? s[i == 0 ? L - 1 : i - 1] : s[i + 1];
          atomicAdd(&band[u * n + v], w);
        }
      }
      const int last = s[L - 1] - u0;
      if (threadIdx.x == 0 && head < edges && last >= 0 && last < nr)
        add_repeated(&band[last * n + s[L - 1]], w, edges - head);
      __syncthreads();  // ant order
    }
  }
  float* o = out + (b * n + u0) * n;
  for (int t = threadIdx.x; t < nr * n; t += kThreads) o[t] = band[t];
}

}  // namespace
}  // namespace deepaco

// paths [B, L, A] int64 (ids in [0, n)), amounts [B, A] f32 -> out [B, n, n]
// f32. Returns cudaErrorInvalidValue when the shared memory cannot hold one
// row of the band beside the staged ants (n above about 49,000, or L + n
// above about 57,000).
extern "C" int deepaco_tour_deposit(const int64_t* paths, const float* amounts, float* out,
                                    int B, int L, int A, int n, int cyclic, void* stream) {
  using namespace deepaco;
  const int stage_ants = max(1, min(A, kStageBytes / (4 * L)));
  const long stage_bytes = 4L * (L + 1) * stage_ants;
  long rows = min((long)n, (kSmemBytes - stage_bytes) / (4L * n));
  if (rows < 1) return cudaErrorInvalidValue;
  const long bands = (n + rows - 1) / rows;
  rows = (n + bands - 1) / bands;  // bands of equal height
  const size_t smem = (size_t)(4L * rows * n + stage_bytes);
  cudaError_t err = cudaFuncSetAttribute(tour_deposit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bands, (unsigned)B);
  tour_deposit_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      paths, amounts, out, L, A, n, cyclic, (int)rows, stage_ants);
  return cudaGetLastError();
}
