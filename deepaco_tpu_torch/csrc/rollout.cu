// K7r: a whole sampled construction with its log-probabilities, every step of
// every ant in one launch, and its gradient in the score matrix in one more.
//
// Replaces, on the training paths (engine.rollout(require_prob=True) over the
// TSP and CVRP plug-ins: TSP, TSP-NLS, CVRP and BPP training, the facades'
// sample), deepaco_tpu/ops/pallas_kernels.py:65 fused_pick_pallas a step, the
// step of the construction scan deepaco_tpu/aco/engine.py:104-129. The port
// ran that scan as a host loop, K7 (csrc/pick.cu) and 14-48 PyTorch launches
// of glue a step (row gathers, masks, noise), and autograd's backward a step.
//
// Forward, a block an ant (1-8 warps, G <= 16 columns a thread), K7c's
// structure (csrc/cvrp_sweep.cu) on the given noise:
// - the visited set is one register word a thread, bit j for the column
//   tid + j * threads; the demands of those columns are registers; the CVRP
//   load `used`, the count of customers left and the current node are the
//   same in every thread, so the depot rule (closed right after a depot pick
//   while customers remain) needs no exchange;
// - each step issues its G loads of the row score[b, cur, :] together (the
//   whole [B, N, N] of a TSP500-NLS step is 20 MB, held in the 50 MB L2),
//   then the next step's noise[t + 1, b, a, :], which no pick decides, so
//   that it arrives during this step; then K7's logsumexp (a maximum, then a
//   sum of exps) and first maximum of logits + noise (NaN above every
//   number, ties to the lower column), the logit of the maximum and whether
//   its column was visited riding along (key 2c + bit);
// - it writes the action, logp = logit - lse, and the step's lse (and, for
//   CVRP, capacity - used) for the backward, and each node's path index pos.
// An ant of CVRP back at the depot with every customer served picks the depot
// with certainty and log-probability 0 (when score[b, 0, 0] is finite, not
// below -1e30, and the depot's demand fits): the loop stops there and writes
// those steps directly, and the backward skips them (their gradient is 0).
//
// Backward, a block a row r and 32 columns of an instance, no atomics: each
// thread sums its column's terms
//     g[b,t,a] * (1[c = a_{t+1}] - exp(score[b,r,c] - lse_t)) * open_t(c)
// over the steps that leave row r, warp w the ants w, w + 4, ... in order,
// then the four sums in order, so a repeat gives equal bits (the depot row
// of CVRP and BPP, a few thousand departures, splits four ways). A TSP ant leaves each row once, at t = pos(r), and there
// open_t(c) <=> pos(c) > t. A CVRP ant leaves a customer row at most once, and
// the depot at the departures the forward listed (2t + the depot's own open
// bit); open_t(c) adds demand[c] <= rem_t, the forward's own f32 value.
//
// What bounds it: the forward's chain of T dependent steps an ant (a row read
// from L2, two butterflies and a block barrier a step), not its bytes (the
// noise, T * B * A * N * 4, read once). The backward reads pos, lse and g of
// every ant for every row: B * N * A * (N + 4) words, mostly from L2.
#include "common.cuh"

namespace deepaco {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;   // warps an ant
constexpr int kMaxCols = 16;   // columns a thread: N <= 16 * 32 * 8 = 4096
constexpr int kBwdWarps = 4;   // a backward block: 32 columns, each warp a share of the ants

// A candidate of the running first maximum: v = logit + noise, key = 2 *
// column + (column visited before the step), and the logit itself.
struct Cand {
  float v;
  int key;
  float l;
};

__device__ __forceinline__ void take_first(const Cand& o, Cand& best) {
  if (argmax_before(o.v, o.key, best.v, best.key)) best = o;
}

// One ant a block of 32 * warps threads; G: columns a thread (a power of two,
// G * threads >= N), column tid + j * threads in slot j.
template <bool kCvrp, int G>
__global__ void __launch_bounds__(32 * kMaxWarps)
    rollout_fwd_kernel(const float* __restrict__ score, const int64_t* __restrict__ start,
                       const float* __restrict__ noise, const float* __restrict__ demand,
                       float capacity, int B, int N, int A, int T, int64_t* __restrict__ paths,
                       float* __restrict__ logp, float* __restrict__ lse, int* __restrict__ pos,
                       float* __restrict__ rem, int* __restrict__ dep, int* __restrict__ ndep) {
  __shared__ Cand s_best[2][kMaxWarps];
  __shared__ float s_top[2][kMaxWarps], s_total[2][kMaxWarps];
  const int threads = blockDim.x, warps = threads >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long ant = blockIdx.x;  // b * A + a
  const int b = (int)(ant / A), a = (int)(ant % A);
  const float* inst = score + (size_t)b * N * N;
  const float* dem_row = kCvrp ? demand + (size_t)b * N : nullptr;
  const float* my_noise = noise + (size_t)ant * N;  // step t at my_noise + t * step_stride
  const size_t step_stride = (size_t)B * A * N;
  int* my_pos = pos + (size_t)ant * N;
  int64_t* out = paths + (size_t)b * (T + 1) * A + a;  // step s at out[s * A]
  const size_t row0 = (size_t)b * T * A + a;            // [B, T, A] outputs at row0 + t * A

  uint32_t live = 0, vis = 0;  // bit j: column tid + j * threads exists / was visited
  float dem[G], g[G];          // the columns' demands; this step's noise, read a step ahead
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c = tid + j * threads;
    const bool here = c < N;
    live |= (uint32_t)here << j;
    if (here) my_pos[c] = T + 1;
    dem[j] = kCvrp && here ? __ldg(dem_row + c) : 0.0f;
    g[j] = here && T > 0 ? __ldg(my_noise + c) : 0.0f;
  }
  // mark column c reached at path index s (its owner alone)
  const auto visit = [&](int c, int s) {
    if (c % threads == tid) {
      const uint32_t bit = 1u << (c / threads);
      if (!(vis & bit)) {
        vis |= bit;
        my_pos[c] = s;
      }
    }
  };
  // the plug-in's init is a step with the start as its action
  int cur = (int)start[ant];
  int left = N - 1;
  float used = 0.0f;
  if (kCvrp) {
    left -= cur != 0;
    used = __fadd_rn(0.0f, __ldg(dem_row + cur));
  }
  visit(cur, 0);
  if (tid == 0) out[0] = cur;
  float s00 = 0.0f, park_rem = 0.0f;
  bool park = false;
  if (kCvrp) {
    s00 = __ldg(inst);
    const float d0 = __ldg(dem_row);
    park_rem = __fsub_rn(capacity, __fadd_rn(0.0f, d0));
    park = isfinite(s00) && s00 > kNegInf && d0 <= park_rem;
  }
  int nd = 0, t = 0;
  for (; t < T; ++t) {
    if (kCvrp && park && cur == 0 && left == 0) break;  // the same in every thread
    const bool depot_closed = kCvrp && cur == 0 && left > 0;
    const float r = kCvrp ? __fsub_rn(capacity, used) : 0.0f;
    const float* row = inst + (size_t)cur * N;
    float l[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {  // the row's loads first, all in flight together
      const int c = tid + j * threads;
      bool open = (live >> j) & 1u;
      open = open && ((kCvrp && c == 0) ? !depot_closed : !((vis >> j) & 1u));
      if (kCvrp) open = open && dem[j] <= r;
      l[j] = open ? __ldg(row + c) : kNegInf;
    }
    float g_next[G];  // the next step's noise, in flight during this step
    const float* noise_next = my_noise + (size_t)(t + 1) * step_stride;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      g_next[j] = (t + 1 < T && ((live >> j) & 1u)) ? __ldg(noise_next + tid + j * threads) : 0.0f;
    }
    float mx = -INFINITY, sum = 0.0f;  // the thread's share of the logsumexp
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if ((live >> j) & 1u) mx = fmaxf(mx, l[j]);
    }
    Cand best{-INFINITY, 0x7FFFFFFF, kNegInf};
#pragma unroll
    for (int j = 0; j < G; ++j) {  // ascending columns: the thread's first maximum
      if ((live >> j) & 1u) {
        sum += expf(l[j] - mx);
        take_first(Cand{l[j] + g[j], 2 * (tid + j * threads) + (int)((vis >> j) & 1u), l[j]},
                   best);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take_first(Cand{__shfl_xor_sync(kFullMask, best.v, off),
                      __shfl_xor_sync(kFullMask, best.key, off),
                      __shfl_xor_sync(kFullMask, best.l, off)},
                 best);
    }
    float top = mx;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) top = fmaxf(top, __shfl_xor_sync(kFullMask, top, off));
    float total = warp_sum(mx == -INFINITY ? 0.0f : sum * expf(mx - top));
    if (warps > 1) {  // the warps in order; buffers alternate by step parity
      const int p = t & 1;
      if (lane == 0) {
        s_best[p][warp] = best;
        s_top[p][warp] = top;
        s_total[p][warp] = total;
      }
      __syncthreads();
      best = s_best[p][0];
      top = s_top[p][0];
      for (int w = 1; w < warps; ++w) {
        take_first(s_best[p][w], best);
        top = fmaxf(top, s_top[p][w]);
      }
      total = 0.0f;
      for (int w = 0; w < warps; ++w) {
        const float tw = s_top[p][w];
        total += tw == -INFINITY ? 0.0f : s_total[p][w] * expf(tw - top);
      }
    }
    const int nxt = best.key >> 1;
    const float lg = logf(total);
    if (tid == 0) {
      out[(size_t)(t + 1) * A] = nxt;
      logp[row0 + (size_t)t * A] = (best.l - top) - lg;
      lse[row0 + (size_t)t * A] = top + lg;
      if (kCvrp) {
        rem[row0 + (size_t)t * A] = r;
        if (cur == 0) dep[(size_t)ant * T + nd] = 2 * t + (left == 0);
      }
    }
    if (kCvrp) {
      nd += cur == 0;
      left -= (nxt != 0 && !(best.key & 1)) ? 1 : 0;
      used = __fadd_rn(nxt == 0 ? 0.0f : used, __ldg(dem_row + nxt));
    }
    visit(nxt, t + 1);
    cur = nxt;
#pragma unroll
    for (int j = 0; j < G; ++j) g[j] = g_next[j];
  }
  if (kCvrp) {
    for (int s = t + tid; s < T; s += threads) {  // parked: the depot, log-probability 0
      out[(size_t)(s + 1) * A] = 0;
      logp[row0 + (size_t)s * A] = 0.0f;
      lse[row0 + (size_t)s * A] = s00;
      rem[row0 + (size_t)s * A] = park_rem;
    }
    if (tid == 0) ndep[ant] = nd;
  }
}

// A block: 32 columns of row r of instance b; warp w sums the ants w, w +
// kBwdWarps, ... in order, then warp 0 adds the warps' sums in order.
template <bool kCvrp>
__global__ void __launch_bounds__(32 * kBwdWarps)
    rollout_bwd_kernel(const float* __restrict__ score, const int64_t* __restrict__ paths,
                       const float* __restrict__ g, const float* __restrict__ lse,
                       const int* __restrict__ pos, const float* __restrict__ rem,
                       const int* __restrict__ dep, const int* __restrict__ ndep,
                       const float* __restrict__ demand, int B, int N, int A, int T,
                       float* __restrict__ d_score) {
  __shared__ float s_part[kBwdWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r = blockIdx.y, b = blockIdx.z;
  const bool live = c < N;
  const float s = live ? __ldg(score + ((size_t)b * N + r) * N + c) : 0.0f;
  const float dc = kCvrp && live ? __ldg(demand + (size_t)b * N + c) : 0.0f;
  float acc = 0.0f;
  for (int a = warp; a < A; a += kBwdWarps) {
    const long ant = (long)b * A + a;
    const int* ant_pos = pos + (size_t)ant * N;
    const int pc = live ? __ldg(ant_pos + c) : 0;
    // the term of the step t that leaves row r; depot_open: the visit rule's
    // verdict on column 0 there
    const auto term = [&](int t, bool depot_open) {
      const size_t i = ((size_t)b * T + t) * A + a;
      const int nxt = (int)__ldg(paths + ((size_t)b * (T + 1) + t + 1) * A + a);
      bool open = (kCvrp && c == 0) ? depot_open : pc > t;
      if (kCvrp) open = open && dc <= __ldg(rem + i);
      if (live && open) acc += __ldg(g + i) * ((c == nxt ? 1.0f : 0.0f) - expf(s - __ldg(lse + i)));
    };
    if (kCvrp && r == 0) {
      const int cnt = __ldg(ndep + ant);
      const int* list = dep + (size_t)ant * T;
      for (int k = 0; k < cnt; ++k) {
        const int e = __ldg(list + k);
        term(e >> 1, e & 1);
      }
    } else {
      const int t = __ldg(ant_pos + r);
      if (t < T) term(t, true);
    }
  }
  s_part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    float total = s_part[0][lane];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) total += s_part[w][lane];
    d_score[((size_t)b * N + r) * N + c] = total;
  }
}

template <bool kCvrp, int G>
void launch_fwd(unsigned blocks, int warps, cudaStream_t s, const float* score,
                const int64_t* start, const float* noise, const float* demand, float capacity,
                int B, int N, int A, int T, int64_t* paths, float* logp, float* lse, int* pos,
                float* rem, int* dep, int* ndep) {
  rollout_fwd_kernel<kCvrp, G><<<blocks, 32 * warps, 0, s>>>(
      score, start, noise, demand, capacity, B, N, A, T, paths, logp, lse, pos, rem, dep, ndep);
}

}  // namespace
}  // namespace deepaco

// score [B,N,N] f32, start [B,A] int64, noise [T,B,A,N] f32, demand [B,N] f32
// (CVRP; null for TSP) -> paths [B,T+1,A] int64, logp and lse [B,T,A] f32,
// pos [B,A,N] int32; CVRP also rem [B,T,A] f32, dep [B,A,T] and ndep [B,A]
// int32. warps: 1, 2, 4 or 8 an ant (16 columns a thread at most), 0 to choose.
extern "C" int deepaco_rollout_fwd(const float* score, const int64_t* start, const float* noise,
                                   const float* demand, float capacity, int B, int N, int A,
                                   int T, int cvrp, int warps, int64_t* paths, float* logp,
                                   float* lse, int* pos, float* rem, int* dep, int* ndep,
                                   void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 2 || N > 32 * kMaxWarps * kMaxCols) return cudaErrorInvalidValue;
  int least = 1;  // at most kMaxCols columns a thread
  while (32 * least * kMaxCols < N) least *= 2;
  if (warps == 0) {  // the ants' warps at most 12 an SM, as K7c chooses
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    warps = 4;
    while (warps > 1 && (long)B * A * warps > 12L * sms) warps /= 2;
    warps = max(warps, least);
  }
  if ((warps & (warps - 1)) || warps > kMaxWarps || warps < least) return cudaErrorInvalidValue;
  const int per = (N + 32 * warps - 1) / (32 * warps);
  const unsigned blocks = (unsigned)((long)B * A);
  if (!cvrp) demand = nullptr, rem = nullptr, dep = nullptr, ndep = nullptr;
#define DEEPACO_ROLLOUT_G(g)                                                                    \
  if (per <= g) {                                                                               \
    (cvrp ? launch_fwd<true, g> : launch_fwd<false, g>)(blocks, warps, s, score, start, noise,  \
                                                        demand, capacity, B, N, A, T, paths,    \
                                                        logp, lse, pos, rem, dep, ndep);        \
    return cudaGetLastError();                                                                  \
  }
  DEEPACO_ROLLOUT_G(1)
  DEEPACO_ROLLOUT_G(2)
  DEEPACO_ROLLOUT_G(4)
  DEEPACO_ROLLOUT_G(8)
  DEEPACO_ROLLOUT_G(kMaxCols)
#undef DEEPACO_ROLLOUT_G
  return cudaErrorInvalidValue;
}

// The gradient d_score [B,N,N] f32 of sum(g * logp) for g [B,T,A] f32 and the
// forward's paths, lse, pos (and rem, dep, ndep, demand for CVRP).
extern "C" int deepaco_rollout_bwd(const float* score, const int64_t* paths, const float* g,
                                   const float* lse, const int* pos, const float* rem,
                                   const int* dep, const int* ndep, const float* demand, int B,
                                   int N, int A, int T, int cvrp, float* d_score, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((N + 31) / 32), (unsigned)N, (unsigned)B);
  if (cvrp) {
    rollout_bwd_kernel<true><<<grid, 32 * kBwdWarps, 0, s>>>(score, paths, g, lse, pos, rem, dep,
                                                             ndep, demand, B, N, A, T, d_score);
  } else {
    rollout_bwd_kernel<false><<<grid, 32 * kBwdWarps, 0, s>>>(score, paths, g, lse, pos, nullptr,
                                                              nullptr, nullptr, nullptr, B, N, A,
                                                              T, d_score);
  }
  return cudaGetLastError();
}
