// K7c: the whole CVRP construction of one ACO iteration, all 2(N-1) steps of
// every ant, in one launch.
//
// Replaces, on the CVRP inference path, deepaco_tpu/ops/pallas_kernels.py:65
// fused_pick_pallas (its math is the step of the construction scan,
// deepaco_tpu/aco/engine.py:104-129, which the JAX package compiles into one
// lax.scan over deepaco_tpu/aco/problems/cvrp.py's plug-in). The port ran
// that scan as a host loop of 2(N-1) steps, each about 31 launches (row
// gathers, the masks, the noise, then K7): at CVRP500 the device sat 93.6%
// idle. Here one to four warps walk an ant through every step, as K2
// (csrc/sweep.cu) does for TSP, and keep the plug-in's state on the chip:
// - the visited customers are bits in registers, one a column the thread
//   owns; column 0's bit is the depot rule (closed right after a depot pick
//   while customers remain);
// - the load `used` and the count of customers left are registers, the same
//   in every thread of the ant, so the depot rule needs no scan;
// - the demands of the owned columns are registers, read once; the picked
//   column's demand comes from L1;
// - the row score[b, cur, :] (2 KB at N = 501) is read straight from L2:
//   blocks are instance-major, so an instance's score (1 MB) stays in the
//   50 MB L2 while its ants run.
// Each step: open = !bit && demand[c] <= capacity - used (f32, as the
// plug-in compares), logits = open ? score : -1e30, and the pick is the
// first maximum of logits + g, NaN above every number as torch.argmax has it.
// The loop is branch-free as K2's: the noise is added and then the mask is
// selected (|g| < 17 is far below half an ulp of 1e30), the columns past N
// count as visited at an index past every real one, and at G <= 4 the
// Philox words of step s + 1 are drawn during step s.
//
// The pick also says whether its column was visited: the running first
// maximum carries 2 * column + bit, so the warp's reduction hands every
// thread the pick and its bit, and `left` drops only for a customer not
// served before (a visited column wins only where an open score is below
// -1e30).
//
// An ant back at the depot with every customer served has only the depot
// open, so it picks the depot at every later step, whatever its noise,
// unless score[b, 0, 0] < -1e30 (then a masked column at -1e30 wins): where
// that score is not below -1e30, the kernel stops the ant's loop there and
// writes the remaining rows as 0. At CVRP500 and capacity 50 an ant needs
// about 550 of its 1,000 steps.
//
// What bounds it: not the bytes (100 MB of score at B=100, N=501, read about
// once) but each ant's chain of dependent steps and the instructions a step
// issues: a Philox4x32-10 a group of 4 columns (about 58 SASS instructions),
// two logarithms, the mask and the running maximum a column. On an H100 at
// CVRP500 (2,000 ants, W=1, G=4, 163 registers: 12 warps an SM) it takes
// about 2.0 ms against a 0.066 ms bound; capped at 128 registers, so that
// every ant runs in one wave, it was slower (PERF.md).
//
// Noise: Philox4x32-10 keyed by the per-call seed, counter (column / 4,
// step, b * A + a, 0), word column % 4; g = -log(-log u) with u = ((bits >>
// 9) + 0.5) * 2^-23, K2's f32 law. The paths depend on the scores, demands,
// capacity, seed and mode alone, never on W or G. N <= 4096: at most 8
// groups of 4 columns a thread, 4 warps an ant.
#include "common.cuh"

namespace deepaco {
namespace {

constexpr int kWarpsPerSm = 12;     // the ants' warps a streaming multiprocessor, at most
constexpr int kBlockThreads = 128;  // a block holds 128 / 32W ants
constexpr int kMaxWarps = 4;        // warps an ant
constexpr int kMaxGroups = 8;       // groups of 4 columns a thread: N <= 4 * 8 * 128
constexpr float kNegInf = -1e30f;

// One ant per 32 * warps threads; G: groups a thread, the power of two at
// or above ceil(N / 4 / threads).
template <bool kStochastic, bool kVec, int G>
__global__ void __launch_bounds__(kBlockThreads)
    cvrp_sweep_kernel(const float* __restrict__ score, const float* __restrict__ demand,
                      int64_t* __restrict__ paths, const int64_t* __restrict__ seed,
                      float capacity, int B, int N, int A, int warps) {
  constexpr int kBits = 4 * G;
  constexpr int kVisWords = (kBits + 31) / 32;
  constexpr bool kAhead = G <= 4;  // draw a step ahead, in 4G registers
  __shared__ unsigned long long slot[2][kBlockThreads / 32];  // [step & 1][ant in block * warps + warp]
  const int threads = 32 * warps;
  const int shift = __ffs(threads) - 1;  // threads is a power of two
  const int local = threadIdx.x >> shift;
  const int t = threadIdx.x & (threads - 1);
  const int warp = t >> 5, lane = t & 31;
  const long ant = (long)blockIdx.x * (blockDim.x >> shift) + local;  // b * A + a
  if (ant >= (long)B * A) return;  // only the ant's own threads synchronise below
  const int b = (int)(ant / A), a = (int)(ant % A);
  const int rows = 2 * (N - 1) + 1;
  const int groups = (N + 3) >> 2;
  const float* dem_row = demand + (size_t)b * N;
  const float* inst = score + (size_t)b * N * N;
  int64_t* out = paths + (size_t)b * rows * A + a;

  uint32_t vis[kVisWords];  // bit 4j + q: column 4 (t + j * threads) + q
  float dem[kBits];
#pragma unroll
  for (int w = 0; w < kVisWords; ++w) vis[w] = 0u;
#pragma unroll
  for (int bit = 0; bit < kBits; ++bit) {
    const int c = 4 * (t + (bit >> 2) * threads) + (bit & 3);
    if (c >= N) vis[bit >> 5] |= 1u << (bit & 31);
    dem[bit] = __ldg(dem_row + min(c, N - 1));
  }
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
  // the state after the start at the depot: the plug-in's init is a step
  // with action 0
  int cur = 0, left = N - 1;
  float used = __fadd_rn(0.0f, dem_row[0]);
  if (t == 0) {
    vis[0] |= (uint32_t)(left > 0);
    out[0] = 0;
  }
  const bool park = !(__ldg(inst) < kNegInf);  // score[b, 0, 0]: the depot wins once done
  unsigned long long* my_slots = &slot[0][0] + local * warps;
  int step = 0;
  for (; step < rows - 1; ++step) {
    if (park && cur == 0 && left == 0) break;  // the same in every thread of the ant
    const float* row = inst + (size_t)cur * N;
    const float remaining = __fsub_rn(capacity, used);
    float v[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j) {  // the loads first, all in flight together
      load_group<kVec>(row, 4 * min(t + j * threads, groups - 1), N, v[j]);
    }
    uint4 r4[G];
    if (kStochastic) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (kAhead) {
          r4[j] = ahead[j];
          ahead[j] = draw(j, step + 1);
        } else {
          r4[j] = draw(j, step);
        }
      }
    }
    // each group folds its own columns, then the groups merge in column
    // order, so that their chains overlap; an index is 2 * column + bit
    float gbest[G];
    int gidx[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      gbest[j] = -INFINITY;
      gidx[j] = 0x7FFFFFFF;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int bit = 4 * j + q;
        float x = v[j][q];
        if (kStochastic) {
          const uint32_t bits = philox_word(r4[j], q);
          const float u = ((float)(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;  // 2^-23
          x = x - logf(-logf(u));
        }
        const uint32_t seen = (vis[bit >> 5] >> (bit & 31)) & 1u;
        x = (seen || !(dem[bit] <= remaining)) ? kNegInf : x;
        fold_first_max(x, 2 * (4 * (t + j * threads) + q) + (int)seen, gbest[j], gidx[j]);
      }
    }
#pragma unroll
    for (int span = 1; span < G; span *= 2) {
#pragma unroll
      for (int j = 0; j + span < G; j += 2 * span) {
        fold_first_max(gbest[j + span], gidx[j + span], gbest[j], gidx[j]);
      }
    }
    // the warp's largest key, then the lowest index holding it
    const uint32_t k = order_key(gbest[0]);
    const uint32_t wbest = __reduce_max_sync(kFullMask, k);
    uint32_t pick = __reduce_min_sync(kFullMask, k == wbest ? (uint32_t)gidx[0] : 0xFFFFFFFFu);
    if (warps > 1) {
      unsigned long long* s = my_slots + (step & 1) * (kBlockThreads / 32);
      if (lane == 0) s[warp] = ((unsigned long long)wbest << 32) | (0xFFFFFFFFu - pick);
      named_barrier(1 + local, threads);
      unsigned long long m = s[0];
      for (int w = 1; w < warps; ++w) m = max(m, s[w]);
      pick = 0xFFFFFFFFu - (uint32_t)m;
    }
    cur = (int)(pick >> 1);
    left -= (cur != 0 && !(pick & 1u)) ? 1 : 0;
    used = __fadd_rn(cur == 0 ? 0.0f : used, __ldg(dem_row + cur));
    if (cur != 0) {  // the owner marks the customer served
      const int g = cur >> 2;
      if ((g & (threads - 1)) == t) {
        const int bit = 4 * (g >> shift) + (cur & 3);
#pragma unroll
        for (int w = 0; w < kVisWords; ++w) {
          if (w == bit >> 5) vis[w] |= 1u << (bit & 31);
        }
      }
    }
    if (t == 0) {
      vis[0] = (vis[0] & ~1u) | (uint32_t)(cur == 0 && left > 0);  // the depot rule
      out[(size_t)(step + 1) * A] = cur;
    }
  }
  for (int r = step + 1 + t; r < rows; r += threads) out[(size_t)r * A] = 0;  // parked
}

template <bool kStochastic, bool kVec, int G>
cudaError_t launch_g(const float* score, const float* demand, int64_t* paths, const int64_t* seed,
                     float capacity, int B, int N, int A, int warps, cudaStream_t s) {
  const int per_block = kBlockThreads / (32 * warps);
  const long ants = (long)B * A;
  const unsigned blocks = (unsigned)((ants + per_block - 1) / per_block);
  cvrp_sweep_kernel<kStochastic, kVec, G><<<blocks, 32 * warps * per_block, 0, s>>>(
      score, demand, paths, seed, capacity, B, N, A, warps);
  return cudaGetLastError();
}

template <bool kStochastic, bool kVec>
cudaError_t launch_sized(const float* score, const float* demand, int64_t* paths,
                         const int64_t* seed, float capacity, int B, int N, int A,
                         cudaStream_t s) {
  const int groups = (N + 3) / 4;
  int device = 0, sms = 0;  // W from the ants per SM, as K2 chooses it
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int warps = kMaxWarps;
  while (warps > 1 && (long)B * A * warps > (long)kWarpsPerSm * sms) warps /= 2;
  while (warps > 1 && 32 * (warps / 2) >= groups) warps /= 2;  // every warp owns columns
  while (warps < kMaxWarps && groups > 32 * warps * kMaxGroups) warps *= 2;
  const int per = (groups + 32 * warps - 1) / (32 * warps);
#define DEEPACO_CVRP_G(g)                                                                     \
  if (per <= g)                                                                               \
  return launch_g<kStochastic, kVec, g>(score, demand, paths, seed, capacity, B, N, A, warps, s)
  DEEPACO_CVRP_G(1);
  DEEPACO_CVRP_G(2);
  DEEPACO_CVRP_G(4);
  DEEPACO_CVRP_G(kMaxGroups);
#undef DEEPACO_CVRP_G
  return cudaErrorInvalidValue;  // N > 4 * kMaxGroups * 32 * kMaxWarps
}

template <bool kStochastic>
cudaError_t launch(const float* score, const float* demand, int64_t* paths, const int64_t* seed,
                   float capacity, int B, int N, int A, cudaStream_t s) {
  if (N % 4 == 0 && reinterpret_cast<uintptr_t>(score) % 16 == 0) {
    return launch_sized<kStochastic, true>(score, demand, paths, seed, capacity, B, N, A, s);
  }
  return launch_sized<kStochastic, false>(score, demand, paths, seed, capacity, B, N, A, s);
}

}  // namespace
}  // namespace deepaco

// score [B,N,N] f32, demand [B,N] f32 -> paths [B, 2(N-1)+1, A] int64, row 0
// the depot. seed: one int64 on the device (read for stochastic sweeps only).
extern "C" int deepaco_cvrp_sweep(const float* score, const float* demand, int64_t* paths,
                                  const int64_t* seed, float capacity, int B, int N, int A,
                                  int stochastic, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stochastic ? launch<true>(score, demand, paths, seed, capacity, B, N, A, s)
                    : launch<false>(score, demand, paths, seed, capacity, B, N, A, s);
}
