// K2: one whole construction sweep of the ACO iteration, all N-1 steps.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:522 fused_step_pallas (Pallas
// kernel _fused_step_kernel, 442-505), which the JAX sweep launched once per
// step behind an XLA row gather (aco/batched_tsp.py:195-232). Here one warp
// walks one ant through every step: the ants of an iteration are
// independent, so warps never wait on each other and the sweep is a single
// launch. Each step reads the score row score[b, cur, :] straight from
// device memory or L2 (the row gather is fused in), applies the visited
// mask, adds Gumbel noise and takes the first maximum by a warp reduction on
// (value, index), NaN above every number as in torch.argmax. The visited set
// is a bitset in shared memory in plain packing: column c is bit c & 31 of
// word c >> 5.
//
// What bounds it: a chain of N-1 dependent steps per ant, each a row load
// whose latency the other resident warps have to hide; the score matrix
// itself (50 MB in bf16 at B=100, N=500) sits in the 50 MB L2.
//
// Noise: Philox4x32-10 keyed by the per-iteration seed, with the counter
// (column / 4, step, ant row, 0), so every (step, ant, column) has its own
// draw and no two streams overlap. bf16 scores follow the bf16 Gumbel law of
// the JAX sweep bit for bit: the 7 bits (bits >> 13) & 0x7F index a table of
// the 128 values g = bf16(-log(f32(bf16(-log u)))) that the wrapper computes
// with gumbel_bf16_from_bits, and noisy = f32(bf16(masked + g)). f32 scores
// take a full-width uniform u = ((bits >> 9) + 0.5) * 2^-23 and
// g = -log(-log u) in f32.
#include <cuda_bf16.h>

#include "common.cuh"

namespace deepaco {
namespace {

constexpr int kSweepWarps = 4;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, bool kStochastic>
__global__ void sweep_kernel(const T* __restrict__ score, const int64_t* __restrict__ start,
                             int64_t* __restrict__ paths, const int64_t* __restrict__ seed,
                             const float* __restrict__ gumbel_table, int B, int N, int A) {
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ uint32_t visited_all[];
  __shared__ float table[128];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = (N + 31) >> 5;
  if (kStochastic && kBf16) {
    for (int t = threadIdx.x; t < 128; t += blockDim.x) table[t] = gumbel_table[t];
  }
  __syncthreads();
  const long ant = (long)blockIdx.x * kSweepWarps + warp;  // b * A + a
  if (ant >= (long)B * A) return;  // only warp-level synchronisation below
  const int b = (int)(ant / A), a = (int)(ant % A);
  uint32_t* vis = visited_all + (size_t)warp * words;
  for (int i = lane; i < words; i += 32) vis[i] = 0u;
  __syncwarp();
  int cur = (int)start[ant];
  if (lane == 0) {
    vis[cur >> 5] |= 1u << (cur & 31);
    paths[(long)b * N * A + a] = cur;
  }
  __syncwarp();
  uint2 key = make_uint2(0u, 0u);
  if (kStochastic) {
    const uint64_t s = (uint64_t)seed[0];
    key = make_uint2((uint32_t)s, (uint32_t)(s >> 32));
  }
  const float masked = kBf16 ? round_bf16(kNegInf) : kNegInf;
  const T* inst = score + (size_t)b * N * N;
  for (int step = 0; step < N - 1; ++step) {
    const T* row = inst + (size_t)cur * N;
    float best = -INFINITY;
    int bidx = N;
    for (int c0 = 4 * lane; c0 < N; c0 += 128) {  // 4 adjacent columns per lane
      uint4 r4 = make_uint4(0u, 0u, 0u, 0u);
      if (kStochastic) r4 = philox4x32_10(make_uint4((uint32_t)(c0 >> 2), (uint32_t)step, (uint32_t)ant, 0u), key);
      const uint32_t bits[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + q;
        if (c < N) {
          const bool open = ((vis[c >> 5] >> (c & 31)) & 1u) == 0u;
          float v = open ? load_f32(row + c) : masked;
          if (kStochastic) {
            if (kBf16) {
              v = round_bf16(v + table[(bits[q] >> 13) & 0x7Fu]);
            } else {
              const float u = ((float)(bits[q] >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
              v = v - logf(-logf(u));
            }
          }
          // ascending c: the lane's first maximum, NaN above every number
          // (v NaN passes the first test; once best is NaN, nothing does)
          if (!(v <= best) && best == best) {
            best = v;
            bidx = c;
          }
        }
      }
    }
    warp_pick<false>(best, bidx);  // bidx < N: visited columns hold the finite mask
    cur = bidx;
    if (lane == 0) {
      vis[cur >> 5] |= 1u << (cur & 31);
      paths[((long)b * N + step + 1) * A + a] = cur;
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t launch(const void* score, const int64_t* start, int64_t* paths, const int64_t* seed,
                   const float* table, int B, int N, int A, int stochastic, cudaStream_t s) {
  const long ants = (long)B * A;
  const unsigned blocks = (unsigned)((ants + kSweepWarps - 1) / kSweepWarps);
  const size_t smem = (size_t)kSweepWarps * ((N + 31) / 32) * sizeof(uint32_t);
  const T* sc = static_cast<const T*>(score);
  if (stochastic) {
    sweep_kernel<T, true><<<blocks, kSweepWarps * 32, smem, s>>>(sc, start, paths, seed, table, B, N, A);
  } else {
    sweep_kernel<T, false><<<blocks, kSweepWarps * 32, smem, s>>>(sc, start, paths, seed, table, B, N, A);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace deepaco

// score [B,N,N] (bf16 when is_bf16, else f32), start [B,A] int64 ->
// paths [B,N,A] int64. seed: one int64 on the device; gumbel_table: the 128
// bf16 Gumbel values as f32 (read for stochastic bf16 sweeps only).
extern "C" int deepaco_sweep(const void* score, const int64_t* start, int64_t* paths,
                             const int64_t* seed, const float* gumbel_table, int B, int N, int A,
                             int is_bf16, int stochastic, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(score, start, paths, seed, gumbel_table, B, N, A, stochastic, s);
  return launch<float>(score, start, paths, seed, gumbel_table, B, N, A, stochastic, s);
}
