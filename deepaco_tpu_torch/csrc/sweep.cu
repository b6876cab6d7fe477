// K2: one whole construction sweep of the ACO iteration, all N-1 steps.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:522 fused_step_pallas (Pallas
// kernel _fused_step_kernel, 442-505), which the JAX sweep launched once per
// step behind an XLA row gather (aco/batched_tsp.py:195-232), and, at B=1
// through tsp_sweep_construct, :606 tsp_sweep_construct_pallas. The ants of
// an iteration are independent, so the sweep is a single launch in which W
// warps (1 to 4 at N = 500) walk one ant through every step. Each step
// reads the score row score[b, cur, :] straight from device memory or L2
// (the row gather is fused in), masks the visited columns, adds Gumbel noise
// and takes the first maximum, NaN above every number as in torch.argmax.
//
// What bounds it: not the bytes (the score matrix, 50 MB in bf16 at B=100,
// N=500, is read about once and sits in the 50 MB L2) but each ant's chain
// of N-1 dependent steps, and, once enough ants keep every SM busy, the
// instructions a step issues: one Philox4x32-10 per (4 columns, step, ant),
// about 58 SASS instructions, and about 13 more per column for the table
// lookup, the bf16 rounding, the mask and the running maximum. What the
// design does about it:
// - A thread owns whole groups of 4 columns, g = t + j * 32W, and W is
//   chosen from the launch: with few ants (row 9's B=1, the NLS path's 320)
//   most of the card would idle, and only a step's latency counts, so W = 4
//   (one group a thread at N = 500); with many ants (the main path's 2,000)
//   every warp an ant adds its own reduction and barrier to the issue, so
//   W = 1. W halves from 4 while the ants' warps exceed kWarpsPerSm per SM.
// - The hot loop has no branch, so the compiler interleaves its chains: a
//   visited column's value is the mask whatever its noise (|noise| < 17 is
//   far below half an ulp of 1e30 in f32 and in bf16), so the loop adds the
//   noise and then selects the mask, and the columns past N and the groups
//   a thread owns past the row count as visited, holding the mask at a
//   column above N - 1 so that they lose every tie to the start column.
// - The step's row loads are issued first, one 8-byte (bf16) or 16-byte
//   (f32) load a group when N % 4 == 0, and at G <= 4 the Philox words of
//   step s + 1 are drawn during step s, off the path from a pick to the next
//   row's load.
// - With noise, each group folds its own first maximum and the groups are
//   merged in column order, so that their chains overlap.
// - The visited set lives in registers, one bit per owned column; the owner
//   of the picked column sets its bit.
// - Across a warp the first maximum is a 32-bit key that orders the values
//   as argmax does (order_key) and two redux instructions (largest key, then
//   the lowest column holding it); W > 1 warps exchange one 64-bit slot each
//   through shared memory, double buffered so that one named barrier a step
//   is enough.
// - Blocks are instance-major, so an instance's ants run on neighbouring
//   blocks while its rows are in L2.
// W grows past 4 (up to 32) when a thread would own more than 8 groups; a
// thread owns at most 32 groups, so N <= 131072. The paths depend on the
// scores, the starts, the seed and the mode alone, never on W or G.
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

constexpr int kWarpsPerSm = 12;     // the ants' warps a streaming multiprocessor, at most
constexpr int kBlockThreads = 128;  // a block holds 128 / 32W ants while W <= 4
constexpr int kGroupsBeforeGrowing = 8;  // groups a thread before W grows past 4
constexpr int kMaxGroups = 32;           // groups a thread at W = 32
constexpr int kLoadChunk = 8;            // the most groups whose loads are in flight together
constexpr float kNegInf = -1e30f;
#ifdef DEEPACO_SWEEP_WARPS
static_assert(DEEPACO_SWEEP_WARPS == 1 || DEEPACO_SWEEP_WARPS == 2 || DEEPACO_SWEEP_WARPS == 4,
              "a block of 128 threads holds whole ants");
#endif

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One ant per 32 * warps threads, blockDim.x / (32 * warps) ants a block;
// G: groups a thread, the power of two at or above ceil(N / 4 / threads).
template <typename T, bool kStochastic, bool kVec, int G>
__global__ void __launch_bounds__(G <= 4 ? kBlockThreads : 1024)
    sweep_kernel(const T* __restrict__ score, const int64_t* __restrict__ start,
                 int64_t* __restrict__ paths, const int64_t* __restrict__ seed,
                 const float* __restrict__ gumbel_table, int B, int N, int A, int warps) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVisWords = (4 * G + 31) / 32;
  constexpr bool kAhead = G <= 4;  // draw a step ahead, in 4G registers
  constexpr int kChunk = G < kLoadChunk ? G : kLoadChunk;
  __shared__ float table[128];
  __shared__ unsigned long long slot[2][32];  // [step & 1][ant in block * warps + warp]
  const int threads = 32 * warps;
  const int shift = __ffs(threads) - 1;  // threads is a power of two
  const int local = threadIdx.x >> shift;
  const int t = threadIdx.x & (threads - 1);
  const int warp = t >> 5, lane = t & 31;
  if (kStochastic && kBf16) {
    for (int i = threadIdx.x; i < 128; i += blockDim.x) table[i] = gumbel_table[i];
  }
  __syncthreads();
  const long ant = (long)blockIdx.x * (blockDim.x >> shift) + local;  // b * A + a
  if (ant >= (long)B * A) return;  // only the ant's own threads synchronise below
  const int b = (int)(ant / A), a = (int)(ant % A);
  const int groups = (N + 3) >> 2;
  uint32_t vis[kVisWords];  // bit 4j + q: column 4 (t + j * threads) + q
#pragma unroll
  for (int w = 0; w < kVisWords; ++w) vis[w] = 0u;
#pragma unroll
  for (int bit = 0; bit < 4 * G; ++bit) {
    if (4 * (t + (bit >> 2) * threads) + (bit & 3) >= N) vis[bit >> 5] |= 1u << (bit & 31);
  }
  const auto mark = [&](int c) {
    const int g = c >> 2;
    if ((g & (threads - 1)) == t) {
      const int bit = 4 * (g >> shift) + (c & 3);
#pragma unroll
      for (int w = 0; w < kVisWords; ++w) {
        if (w == bit >> 5) vis[w] |= 1u << (bit & 31);
      }
    }
  };
  int cur = (int)start[ant];
  mark(cur);
  if (t == 0) paths[(long)b * N * A + a] = cur;
  uint2 key = make_uint2(0u, 0u);
  if (kStochastic) {
    const uint64_t s = (uint64_t)seed[0];
    key = make_uint2((uint32_t)s, (uint32_t)(s >> 32));
  }
  const auto draw = [&](int j, int step) {
    return philox4x32_10(make_uint4((uint32_t)(t + j * threads), (uint32_t)step, (uint32_t)ant, 0u),
                         key);
  };
  uint4 ahead[kAhead ? G : 1];
  if (kStochastic && kAhead) {
#pragma unroll
    for (int j = 0; j < G; ++j) ahead[j] = draw(j, 0);
  }
  const float masked = kBf16 ? round_bf16(kNegInf) : kNegInf;
  const T* inst = score + (size_t)b * N * N;
  unsigned long long* my_slots = &slot[0][0] + local * warps;
  for (int step = 0; step < N - 1; ++step) {
    const T* row = inst + (size_t)cur * N;
    float best = -INFINITY;
    int bidx = N;
#pragma unroll
    for (int j0 = 0; j0 < G; j0 += kChunk) {
      float v[kChunk][4];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {  // the loads first, all in flight together
        load_group<kVec>(row, 4 * min(t + (j0 + j) * threads, groups - 1), N, v[j]);
      }
      uint4 r4[kChunk];
      if (kStochastic) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if (kAhead) {
            r4[j] = ahead[j];
            ahead[j] = draw(j, step + 1);
          } else {
            r4[j] = draw(j0 + j, step);
          }
        }
      }
      // With noise, each group folds its own columns and the groups are
      // merged in column order after, so that their long chains from load to
      // value overlap; greedy values are ready at once and fold in one chain.
      float gbest[kChunk];
      int gidx[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        gbest[j] = kStochastic ? -INFINITY : best;
        gidx[j] = kStochastic ? N : bidx;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int bit = 4 * (j0 + j) + q;
          float x = v[j][q];
          if (kStochastic) {
            const uint32_t bits = philox_word(r4[j], q);
            if (kBf16) {
              x = round_bf16(x + table[(bits >> 13) & 0x7Fu]);
            } else {
              const float u = ((float)(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
              x = x - logf(-logf(u));
            }
          }
          x = (vis[bit >> 5] >> (bit & 31)) & 1u ? masked : x;
          fold_first_max(x, 4 * (t + (j0 + j) * threads) + q, gbest[j], gidx[j]);
        }
        if (!kStochastic) {
          best = gbest[j];
          bidx = gidx[j];
        }
      }
      if (kStochastic) {
#pragma unroll
        for (int span = 1; span < kChunk; span *= 2) {
#pragma unroll
          for (int j = 0; j + span < kChunk; j += 2 * span) {
            fold_first_max(gbest[j + span], gidx[j + span], gbest[j], gidx[j]);
          }
        }
        fold_first_max(gbest[0], gidx[0], best, bidx);
      }
    }
    // the warp's largest key, then the lowest column holding it
    const uint32_t k = order_key(best);
    const uint32_t wbest = __reduce_max_sync(kFullMask, k);
    const uint32_t widx = __reduce_min_sync(kFullMask, k == wbest ? (uint32_t)bidx : 0xFFFFFFFFu);
    if (warps == 1) {
      cur = (int)widx;
    } else {
      unsigned long long* s = my_slots + (step & 1) * 32;
      if (lane == 0) s[warp] = ((unsigned long long)wbest << 32) | (0xFFFFFFFFu - widx);
      named_barrier(1 + local, threads);
      unsigned long long m = s[0];
      for (int w = 1; w < warps; ++w) m = max(m, s[w]);
      cur = (int)(0xFFFFFFFFu - (uint32_t)m);
    }
    mark(cur);
    if (t == 0) paths[((long)b * N + step + 1) * A + a] = cur;
  }
}

template <typename T, bool kStochastic, bool kVec, int G>
cudaError_t launch_g(const T* score, const int64_t* start, int64_t* paths, const int64_t* seed,
                     const float* table, int B, int N, int A, int warps, cudaStream_t s) {
  const int per_block = warps < 4 ? kBlockThreads / (32 * warps) : 1;
  const long ants = (long)B * A;
  const unsigned blocks = (unsigned)((ants + per_block - 1) / per_block);
  sweep_kernel<T, kStochastic, kVec, G><<<blocks, 32 * warps * per_block, 0, s>>>(
      score, start, paths, seed, table, B, N, A, warps);
  return cudaGetLastError();
}

template <typename T, bool kStochastic, bool kVec>
cudaError_t launch_sized(const T* score, const int64_t* start, int64_t* paths,
                         const int64_t* seed, const float* table, int B, int N, int A,
                         cudaStream_t s) {
  const int groups = (N + 3) / 4;
#ifdef DEEPACO_SWEEP_WARPS
  int warps = DEEPACO_SWEEP_WARPS;  // a build that fixes W, to measure it
#else
  int device = 0, sms = 0;  // W from the ants per SM (the note at the top)
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int warps = 4;
  while (warps > 1 && (long)B * A * warps > (long)kWarpsPerSm * sms) warps /= 2;
#endif
  while (warps > 1 && 32 * (warps / 2) >= groups) warps /= 2;  // every warp owns columns
  while (warps < 32 && groups > 32 * warps * kGroupsBeforeGrowing) warps *= 2;
  const int per = (groups + 32 * warps - 1) / (32 * warps);
#define DEEPACO_SWEEP_G(g)                                                                        \
  if (per <= g)                                                                                   \
  return launch_g<T, kStochastic, kVec, g>(score, start, paths, seed, table, B, N, A, warps, s)
  DEEPACO_SWEEP_G(1);
  DEEPACO_SWEEP_G(2);
  DEEPACO_SWEEP_G(4);
  DEEPACO_SWEEP_G(8);
  DEEPACO_SWEEP_G(16);
  DEEPACO_SWEEP_G(kMaxGroups);
#undef DEEPACO_SWEEP_G
  return cudaErrorInvalidValue;  // N > 4 * kMaxGroups * 1024
}

template <typename T, bool kStochastic>
cudaError_t launch(const void* score, const int64_t* start, int64_t* paths, const int64_t* seed,
                   const float* table, int B, int N, int A, cudaStream_t s) {
  const T* sc = static_cast<const T*>(score);
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(score) % (4 * sizeof(T)) == 0) {
    return launch_sized<T, kStochastic, true>(sc, start, paths, seed, table, B, N, A, s);
  }
  return launch_sized<T, kStochastic, false>(sc, start, paths, seed, table, B, N, A, s);
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
  if (is_bf16) {
    return stochastic ? launch<__nv_bfloat16, true>(score, start, paths, seed, gumbel_table, B, N, A, s)
                      : launch<__nv_bfloat16, false>(score, start, paths, seed, gumbel_table, B, N, A, s);
  }
  return stochastic ? launch<float, true>(score, start, paths, seed, gumbel_table, B, N, A, s)
                    : launch<float, false>(score, start, paths, seed, gumbel_table, B, N, A, s);
}
