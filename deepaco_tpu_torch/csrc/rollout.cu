// K7r: a whole sampled construction, every step of every ant in one launch,
// with its log-probabilities and their gradient in the score matrix in one
// more, or (untraced) its paths alone.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:65 fused_pick_pallas a step, the
// step of the construction scan deepaco_tpu/aco/engine.py:104-129, on every
// rollout whose plug-in keeps the visited set and at most a few registers of
// state (engine.rollout over a spec with `fused`): TSP (and SMTWTP, TSP's walk
// from the dummy job), CVRP and BPP, SOP (and RCPSP's direct evaluation, SOP's
// state on the score where(p > 0, log p, -1e30)), MKP (PH_suc), MKP's PH_items
// (one score row an instance), OP, PCTSP and RCPSP's summation blend (SOP's
// state and a running sum of pheromone rows, the probabilities computed here),
// in training (traced: logp and what the backward reads) and inference
// (untraced: the paths). The port ran that scan as a host loop, K7
// (csrc/pick.cu) and 14-48 PyTorch launches of glue a step, and autograd's
// backward a step; K7 now steps only past K7r's caps (and RCPSP's blend at
// alpha <= 0, whose closed columns the plug-in reopens).
//
// Forward, a block an ant (1-8 warps, G <= 16 columns a thread, G <= 8 for
// MKP), K7c's structure (csrc/cvrp_sweep.cu) on the given noise:
// - the visited set is one register word a thread, bit j for the column
//   tid + j * threads. The kind's state:
//   CVRP: the columns' demands are registers; the load `used`, the count of
//     customers left and the current node are the same in every thread, so
//     the depot rule (closed right after a depot pick while customers remain)
//     needs no exchange;
//   SOP: each column's count of unvisited predecessors is a register int;
//     each step subtracts the row succ[cur, :] (succ = prec^T, 0/1 bytes)
//     before it decides the open set, so a column opens once its count is 0.
//     A step whose every logit is -1e30 (RCPSP: no open activity with p > 0)
//     picks column 0 again, as the plug-in does, and subtracts its row once
//     more: a count that falls below 0 shuts its column for good, and the
//     trace's pos holds that step;
//   MKP: each column's m <= 8 weights are registers, and the knapsack's m f32
//     sums (added in pick order, as the plug-in adds them) are the same in
//     every thread; a real item is open when unpicked and fitting in every
//     dimension, recomputed each step (with non-negative weights the sums only
//     grow, so the plug-in's cumulative mask is the same set), and the dummy
//     item once no real item is open (a block-wide vote);
//   ITEMS (MKP's PH_items): MKP's state on one score row an instance, the same
//     for every ant and step (score [B, N], a thread's columns in registers
//     beside their weights, so that a step reads only its noise row); the
//     start, the dummy, is no pick;
//   OP: the tour length `travel` (f32, `travel + dist[cur, next]` a pick) is
//     the same in every thread, and each column's dist[c, 0] is a register.
//     The mask is cumulative: at each node but the dummy a real column closes
//     for good once (travel + dist[cur, c]) + dist[c, 0] > max_len, so the
//     closed bits hold "visited or once infeasible" (with f32 rounding, or a
//     distance that is no metric, a column can fail once and fit later: the
//     plug-in keeps it shut). The row dist[cur, :] is loaded beside the score
//     row. The dummy opens once no real column is open (a block vote);
//   PCTSP: the prize collected (f32, added in pick order), the count of
//     customers left and the depot gate are the same in every thread. The
//     start is no pick (the plug-in's init applies none); the depot opens from
//     the step after a pick that takes the prize above min_prizes (compared in
//     f32) or visits the last customer, and stays open; a depot pick shuts
//     every customer;
//   BLEND (RCPSP's summation blend): SOP's state and, a register a column,
//     the running sum S: S = phe[start, c] at step 0, then gamma S + phe[cur,
//     c] at each step, with the rows of P = phe^alpha heu^beta (the score),
//     heu_pow = heu^beta and phe loaded beside succ's. An open column's
//     p = c P + (1 - c) (S^alpha heu_pow) (c = 0: the second term alone), each
//     product and sum rounded as the plug-in's probs_fn rounds it (__fmul_rn,
//     __fadd_rn: no FMA contraction), its logit log(max(p, 1e-30)) where p > 0,
//     else -1e30, as the engine's mask p > 0 shuts it (the plug-in's closed
//     columns have p = 0 at alpha > 0);
// - each step issues its G loads of the row score[b, cur, :] together (SOP:
//   with its row of succ), then the next step's noise[t + 1, b, a, :], which
//   no pick decides, so that it arrives during this step; then K7's
//   logsumexp (a maximum, then a sum of exps) and first maximum of logits +
//   noise (NaN above every number, ties to the lower column), the logit of
//   the maximum and whether its column was visited riding along (key 2c +
//   bit);
// - it writes the action and, traced, logp = logit - lse, the step's lse
//   (and CVRP's capacity - used, MKP's knapsack, SOP's step at which each
//   column's count reached 0) for the backward, and each node's path index
//   pos. Untraced it writes the paths alone, the same bits.
// An ant that parks picks its node with certainty and log-probability 0: a
// CVRP ant back at the depot with every customer served (when score[b, 0, 0]
// is finite above -1e30 and the depot's demand fits), an MKP or OP ant on the
// dummy with no real column open (when score[b, dummy, dummy] is finite above
// -1e30), a PCTSP ant back at the depot with the gate open (when score[b, 0,
// 0] is). The loop stops there and writes those steps directly, and the
// backward skips them (their gradient is 0).
//
// Backward (every kind but ITEMS and BLEND), a block a row r and 32 columns of an
// instance, no atomics: each thread sums its column's terms
//     g[b,t,a] * (1[c = a_{t+1}] - exp(score[b,r,c] - lse_t)) * open_t(c)
// over the steps that leave row r, warp w the ants w, w + 4, ... in order,
// then the four sums in order, so a repeat gives equal bits (the depot row
// of CVRP and BPP, a few thousand departures, splits four ways). A TSP, SOP
// or MKP ant leaves each row once, at t = pos(r), and there open_t(c) <=>
// pos(c) > t and: SOP ready(c) <= t; MKP (real c) every knap_t + w[c] <=
// capacity on the forward's own sums, the dummy open iff it was picked (it
// opens only as the last open column). MKP's dummy row holds parked steps
// only: its gradient is 0. OP's pos is the path index at which each column
// closed (visited or infeasible): the ant left row r at t = pos(r) iff
// paths[t] = r, open_t(c) <=> pos(c) > t, the dummy as MKP's. PCTSP's pos
// holds each customer's pick and the trace its gate step: the ant leaves the
// start's row at t = 0 and a customer's at pos(r); open_t(c) <=> pos(c) > t,
// the depot t >= gate. A CVRP ant leaves a customer row at most once, and
// the depot at the departures the forward listed (2t + the depot's own open
// bit); open_t(c) adds demand[c] <= rem_t, the forward's own f32 value. A
// SOP ant leaves row 0 at every step it stands there (the start and any
// repeat of column 0), and a column shut by a repeat is no row it left. A step
// whose every logit is -1e30 has lse -1e30 and softmax 1/N.
//
// ITEMS' backward is a reduction into one row: d_score[b, c] = the sum over
// every (a, t) of the term above, open_t(c) <=> pos(c) > t and knap_t + w[c]
// <= capacity (real c), nxt = c (the dummy), the parked steps (from
// pos(dummy) on) left out. A block takes 32 columns and a fixed share of the
// A * T terms (its four warps each a fixed part of the share) and writes its
// partial sums; a second launch adds the shares of each column in order. No
// atomics: a repeat gives equal bits.
//
// BLEND's backward, two launches. The first, a thread an ant's column c,
// replays S as the forward does, recomputes each step's p, and for each step
// t < pos(c) writes three terms into part [3, B, A, T, N]: with e = g (1[c =
// a_{t+1}] - softmax) and dp = e / p (0 unless p >= 1e-30, the clamp's
// gradient; 0 where the column is shut or p = 0), c dp for P, (1 - c) dp
// S^alpha for heu_pow, and the running sum's own term (1 - c) dp heu_pow
// alpha S^(alpha - 1), which it then turns, last step first, into D_t =
// term_t + gamma D_{t+1}, the gradient of phe's row cur_t. The second, a
// block a row r and 32 columns as above, adds for each ant in order the
// three terms of the steps that stand on r (pos(r), row 0 every such step)
// and the columns still open there (t < pos(c)). No atomics: a repeat gives
// equal bits.
//
// What bounds it: the forward's chain of T dependent steps an ant (a row read
// from L2, two butterflies and a block barrier a step; BLEND's rows of P,
// heu_pow, phe and succ together), not its bytes (the noise, T * B * A * N *
// 4, read once). The backward reads pos, lse and g of
// every ant for every row: B * N * A * (N + 4) words, mostly from L2; ITEMS'
// reads g, lse, paths and the knapsack of every step once a column tile.
#include "common.cuh"

namespace deepaco {
namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;    // warps an ant
constexpr int kMaxCols = 16;    // columns a thread: N <= 16 * 32 * 8 = 4096
constexpr int kMkpMaxCols = 8;  // MKP: a thread's columns' weights are registers, N <= 2048
constexpr int kMaxDims = 8;     // MKP: capacity dimensions
constexpr int kBwdWarps = 4;    // a backward block: 32 columns, each warp a share of the ants
constexpr int kTermThreads = 128;  // BLEND's first backward pass: a thread an ant's column

enum Kind : int {
  kTsp = 0, kCvrp = 1, kSop = 2, kMkp = 3, kOp = 4, kPctsp = 5, kItems = 6, kBlend = 7
};

// The plug-in's inputs; a kind reads its own and leaves the others null.
struct Plugin {
  const float* demand;   // CVRP [B, N]
  const uint8_t* succ;   // SOP [B, N, N]: succ[b, k, c] = 1 iff k must precede c
  const int* npred;      // SOP [B, N]: each node's count of predecessors
  const float* weight;   // MKP, ITEMS [B, N, m]
  const float* dist;     // OP [B, N, N]
  const float* max_len;  // OP [B]
  const float* prizes;   // PCTSP [B, N]
  const float* phe;      // BLEND [B, N, N]: the rows the running sum adds
  const float* heu_pow;  // BLEND [B, N, N]: heu^beta
  float capacity;        // CVRP, MKP, ITEMS
  float min_prizes;      // PCTSP: the depot's gate
  float gamma, cc, cb, alpha;  // BLEND: the discount, c, 1 - c and the exponent
  int m, dummy;          // MKP, ITEMS: dimensions; MKP, ITEMS, OP: the dummy column
};

// What the traced forward writes for the backward (null untraced, and where
// a kind keeps no such state).
struct Trace {
  float* logp;  // [B, T, A]
  float* lse;   // [B, T, A]
  int* pos;     // [B, A, N]
  float* rem;   // CVRP [B, T, A]
  int* dep;     // CVRP [B, A, T]
  int* ndep;    // CVRP [B, A]
  int* ready;   // SOP, BLEND [B, A, N]
  float* knap;  // MKP, ITEMS [B, T, A, m]
  int* gate;    // PCTSP [B, A]
};

struct Fwd {
  const float* score;
  const int64_t* start;
  const float* noise;
  Plugin pl;
  int B, N, A, T;
  int64_t* paths;
  Trace tr;
};

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

// softmax_t(c) of a column whose logit is s, from the step's lse: a step whose
// every logit is -1e30 has lse -1e30 (the log of the count is below its
// rounding) and softmax 1/N, as the plain softmax gives it
__device__ __forceinline__ float softmax_at(float s, float lse, int N) {
  return lse == kNegInf ? 1.0f / (float)N : expf(s - lse);
}

// x^alpha as torch.pow(x, alpha) computes it on the card for alpha > 0: the
// exponents 1, 2, 3 and 0.5 by their own rules, powf otherwise.
__device__ __forceinline__ float pow_alpha(float x, float alpha) {
  if (alpha == 1.0f) return x;
  if (alpha == 2.0f) return __fmul_rn(x, x);
  if (alpha == 3.0f) return __fmul_rn(__fmul_rn(x, x), x);
  if (alpha == 0.5f) return __fsqrt_rn(x);
  return powf(x, alpha);
}

// BLEND's p of an open column, from its P and heu_pow entries and its S, in
// the plug-in's order: c (P m) + (1 - c) ((S m)^alpha heu_pow) with m = 1.
__device__ __forceinline__ float blend_p(const Plugin& pl, float P, float hb, float S) {
  const float summation = __fmul_rn(pow_alpha(S, pl.alpha), hb);
  if (pl.cc == 0.0f) return summation;
  return __fadd_rn(__fmul_rn(pl.cc, P), __fmul_rn(pl.cb, summation));
}

// The engine's logit of p: log(max(p, 1e-30)) where p > 0, else -1e30.
__device__ __forceinline__ float blend_logit(float p) {
  return p > 0.0f ? logf(fmaxf(p, 1e-30f)) : kNegInf;
}

// Whether an MKP item of weights w fits beside the knapsack's sums.
__device__ __forceinline__ bool fits(const float* knap, const float* w, int m, float capacity) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    if (k < m) ok = ok && __fadd_rn(knap[k], w[k]) <= capacity;
  }
  return ok;
}

// One ant a block of 32 * warps threads; G: columns a thread (a power of two,
// G * threads >= N), column tid + j * threads in slot j.
template <int kKind, bool kTrace, int G>
__global__ void __launch_bounds__(32 * kMaxWarps) rollout_fwd_kernel(const Fwd p) {
  constexpr bool kCv = kKind == kCvrp, kSp = kKind == kSop, kMk = kKind == kMkp;
  constexpr bool kO = kKind == kOp, kPc = kKind == kPctsp, kIt = kKind == kItems;
  constexpr bool kBl = kKind == kBlend;
  constexpr bool kKn = kMk || kIt;     // a knapsack
  constexpr bool kDummy = kKn || kO;  // a dummy column that opens once no real one is open
  constexpr bool kPr = kSp || kBl;    // SOP's precedence counts
  __shared__ Cand s_best[2][kMaxWarps];
  __shared__ float s_top[2][kMaxWarps], s_total[2][kMaxWarps];
  const int B = p.B, N = p.N, A = p.A, T = p.T;
  const int threads = blockDim.x, warps = threads >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long ant = blockIdx.x;  // b * A + a
  const int b = (int)(ant / A), a = (int)(ant % A);
  const float* inst = p.score + (size_t)b * N * (kIt ? 1 : N);  // ITEMS: the one row
  const float* dem_row = kCv ? p.pl.demand + (size_t)b * N : nullptr;
  const uint8_t* succ = kPr ? p.pl.succ + (size_t)b * N * N : nullptr;
  const float* phe_inst = kBl ? p.pl.phe + (size_t)b * N * N : nullptr;
  const float* hb_inst = kBl ? p.pl.heu_pow + (size_t)b * N * N : nullptr;
  const int m = kKn ? p.pl.m : 0, dummy = kDummy ? p.pl.dummy : -1;
  const float* w_inst = kKn ? p.pl.weight + (size_t)b * N * m : nullptr;
  const float* d_inst = kO ? p.pl.dist + (size_t)b * N * N : nullptr;
  const float* prize_row = kPc ? p.pl.prizes + (size_t)b * N : nullptr;
  const float limit = kO ? __ldg(p.pl.max_len + b) : 0.0f;
  const float* my_noise = p.noise + (size_t)ant * N;  // step t at my_noise + t * step_stride
  const size_t step_stride = (size_t)B * A * N;
  int* my_pos = kTrace ? p.tr.pos + (size_t)ant * N : nullptr;
  int* my_ready = kTrace && kPr ? p.tr.ready + (size_t)ant * N : nullptr;
  int64_t* out = p.paths + (size_t)b * (T + 1) * A + a;  // step s at out[s * A]
  const size_t row0 = (size_t)b * T * A + a;              // [B, T, A] outputs at row0 + t * A

  uint32_t live = 0, vis = 0, rdy = 0;  // bit j: column tid + j * threads exists / visited / ready
  float g[G];                           // this step's noise, read a step ahead
  float dem[kCv ? G : 1];               // CVRP: the columns' demands
  int cnt[kPr ? G : 1];                 // SOP, BLEND: the columns' unvisited predecessors
  float S[kBl ? G : 1];                 // BLEND: the columns' running sums
  float w[kKn ? G : 1][kKn ? kMaxDims : 1];  // MKP, ITEMS: the columns' weights
  float back[kO ? G : 1];               // OP: the columns' dist[c, 0]
  float sv[kIt ? G : 1];                // ITEMS: the columns' scores
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c = tid + j * threads;
    const bool here = c < N;
    live |= (uint32_t)here << j;
    if (kTrace && here) my_pos[c] = T + 1;
    if constexpr (kCv) dem[j] = here ? __ldg(dem_row + c) : 0.0f;
    if constexpr (kO) back[j] = here ? __ldg(d_inst + (size_t)c * N) : 0.0f;
    if constexpr (kBl) S[j] = 0.0f;
    if constexpr (kPr) {
      cnt[j] = here ? __ldg(p.pl.npred + (size_t)b * N + c) : 0;
      if (kTrace && here) my_ready[c] = T + 1;
    }
    if constexpr (kKn) {
#pragma unroll
      for (int k = 0; k < kMaxDims; ++k) {
        w[j][k] = here && k < m ? __ldg(w_inst + (size_t)c * m + k) : 0.0f;
      }
    }
    if constexpr (kIt) sv[j] = here ? __ldg(inst + c) : kNegInf;
    g[j] = here && T > 0 ? __ldg(my_noise + c) : 0.0f;
  }
  // mark column c reached (OP: closed) at path index s (its owner alone)
  const auto visit = [&](int c, int s) {
    if (c % threads == tid) {
      const uint32_t bit = 1u << (c / threads);
      if (!(vis & bit)) {
        vis |= bit;
        if (kTrace) my_pos[c] = s;
      }
    }
  };
  // the plug-in's init is a step with the start as its action (PCTSP, ITEMS:
  // none; OP's feasibility at the start is its step 0's)
  int cur = (int)p.start[ant];
  int left = N - 1;
  float used = 0.0f;  // CVRP: the load; OP: the tour length; PCTSP: the prize collected
  bool home = false, gate_open = false;  // PCTSP: a depot pick made; the depot's gate
  int gate_step = T + 1;
  float knap[kKn ? kMaxDims : 1];  // MKP, ITEMS: the knapsack's sums, the same in every thread
  if constexpr (kCv) {
    left -= cur != 0;
    used = __fadd_rn(0.0f, __ldg(dem_row + cur));
  }
  if constexpr (kKn) {
#pragma unroll
    for (int k = 0; k < kMaxDims; ++k) {
      knap[k] = k < m && kMk ? __fadd_rn(0.0f, __ldg(w_inst + (size_t)cur * m + k)) : 0.0f;
    }
  }
  if constexpr (!kPc && !kIt) visit(cur, 0);
  if (tid == 0) out[0] = cur;
  // parking: the parked step's lse (its only open logit) and, for CVRP, rem
  float park_lse = 0.0f, park_rem = 0.0f;
  bool park = false;
  if constexpr (kCv) {
    park_lse = __ldg(inst);
    const float d0 = __ldg(dem_row);
    park_rem = __fsub_rn(p.pl.capacity, __fadd_rn(0.0f, d0));
    park = isfinite(park_lse) && park_lse > kNegInf && d0 <= park_rem;
  }
  if constexpr (kDummy || kPc) {
    const int parked = kPc ? 0 : dummy;
    park_lse = __ldg(inst + (kIt ? 0 : (size_t)parked * N) + parked);
    park = isfinite(park_lse) && park_lse > kNegInf;
  }
  // MKP, OP: the dummy opens once no real column does (a block vote); true
  // where the ant is parked on it (the same in every thread)
  const auto parked_on_dummy = [&](uint32_t& open) {
    const bool any = warps > 1 ? __syncthreads_or(open != 0) != 0
                               : __any_sync(kFullMask, open != 0);
    if (any) return false;
    if (park && cur == dummy) return true;
    if (dummy % threads == tid) open |= 1u << (dummy / threads);
    return false;
  };
  int nd = 0, t = 0;
  for (; t < T; ++t) {
    if (kCv && park && cur == 0 && left == 0) break;  // the same in every thread
    if (kPc && park && home && gate_open) break;
    const float* row = inst + (kIt ? 0 : (size_t)cur * N);
    float l[G];
    if constexpr (kPr) {
      // the row's score and succ loads together (BLEND: and heu_pow's and
      // phe's), for the unvisited columns
      const uint8_t* srow = succ + (size_t)cur * N;
      uint8_t sc[G];
      float hb[kBl ? G : 1], ph[kBl ? G : 1];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = tid + j * threads;
        const bool cand = ((live & ~vis) >> j) & 1u;
        l[j] = cand ? __ldg(row + c) : kNegInf;
        sc[j] = cand ? __ldg(srow + c) : 0;
        if constexpr (kBl) {
          hb[j] = cand ? __ldg(hb_inst + (size_t)cur * N + c) : 0.0f;
          ph[j] = cand ? __ldg(phe_inst + (size_t)cur * N + c) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if constexpr (kBl) {  // the running sum takes the row of the node the ant stands on
          if (((live & ~vis) >> j) & 1u) {
            S[j] = t == 0 ? ph[j] : __fadd_rn(__fmul_rn(p.pl.gamma, S[j]), ph[j]);
          }
        }
        cnt[j] -= sc[j];
        if (((live & ~rdy) >> j) & 1u && cnt[j] == 0) {
          rdy |= 1u << j;
          if (kTrace) my_ready[tid + j * threads] = t;
        }
        if (cnt[j] < 0 && ((live & ~vis) >> j) & 1u) {  // shut for good by a repeat
          vis |= 1u << j;
          if (kTrace) my_pos[tid + j * threads] = t;
        }
        if (cnt[j] != 0) l[j] = kNegInf;
        if constexpr (kBl) {
          if (((live & ~vis) >> j) & 1u && cnt[j] == 0) {
            l[j] = blend_logit(blend_p(p.pl, l[j], hb[j], S[j]));
          }
        }
      }
    } else if constexpr (kO) {
      // the row's score and dist loads together, for the open real columns and
      // the dummy; at the dummy the plug-in keeps its mask
      const float* drow = d_inst + (size_t)cur * N;
      const bool update = cur != dummy;
      float dr[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = tid + j * threads;
        const bool cand = (((live & ~vis) >> j) & 1u) && c != dummy;
        l[j] = cand || c == dummy ? __ldg(row + c) : kNegInf;
        dr[j] = cand && update ? __ldg(drow + c) : 0.0f;
      }
      uint32_t open = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = tid + j * threads;
        bool o = (((live & ~vis) >> j) & 1u) && c != dummy;
        if (o && update && !(__fadd_rn(__fadd_rn(used, dr[j]), back[j]) <= limit)) {
          vis |= 1u << j;  // out of reach: shut for good
          if (kTrace) my_pos[c] = t;
          o = false;
        }
        open |= (uint32_t)o << j;
      }
      if (parked_on_dummy(open)) break;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (!((open >> j) & 1u)) l[j] = kNegInf;
      }
    } else {
      uint32_t open = 0;
      const bool depot_closed = kCv && cur == 0 && left > 0;
      const float r = kCv ? __fsub_rn(p.pl.capacity, used) : 0.0f;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = tid + j * threads;
        bool o = (live >> j) & 1u;
        if constexpr (kCv) {
          o = o && (c == 0 ? !depot_closed : !((vis >> j) & 1u)) && dem[j] <= r;
        } else if constexpr (kKn) {
          o = o && c != dummy && !((vis >> j) & 1u) && fits(knap, w[j], m, p.pl.capacity);
        } else if constexpr (kPc) {
          o = o && (c == 0 ? gate_open : !home && !((vis >> j) & 1u));
        } else {
          o = o && !((vis >> j) & 1u);
        }
        open |= (uint32_t)o << j;
      }
      if constexpr (kKn) {
        if (parked_on_dummy(open)) break;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {  // the row's loads first, all in flight together
        const bool o = (open >> j) & 1u;
        if constexpr (kIt) {
          l[j] = o ? sv[j] : kNegInf;
        } else {
          l[j] = o ? __ldg(row + tid + j * threads) : kNegInf;
        }
      }
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
      const int par = t & 1;
      if (lane == 0) {
        s_best[par][warp] = best;
        s_top[par][warp] = top;
        s_total[par][warp] = total;
      }
      __syncthreads();
      best = s_best[par][0];
      top = s_top[par][0];
      for (int wi = 1; wi < warps; ++wi) {
        take_first(s_best[par][wi], best);
        top = fmaxf(top, s_top[par][wi]);
      }
      total = 0.0f;
      for (int wi = 0; wi < warps; ++wi) {
        const float tw = s_top[par][wi];
        total += tw == -INFINITY ? 0.0f : s_total[par][wi] * expf(tw - top);
      }
    }
    const int nxt = best.key >> 1;
    if (tid == 0) {
      out[(size_t)(t + 1) * A] = nxt;
      if constexpr (kTrace) {
        const float lg = logf(total);
        const size_t i = row0 + (size_t)t * A;
        p.tr.logp[i] = (best.l - top) - lg;
        p.tr.lse[i] = top + lg;
        if constexpr (kCv) {
          p.tr.rem[i] = __fsub_rn(p.pl.capacity, used);
          if (cur == 0) p.tr.dep[(size_t)ant * T + nd] = 2 * t + (left == 0);
        }
        if constexpr (kKn) {
#pragma unroll
          for (int k = 0; k < kMaxDims; ++k) {
            if (k < m) p.tr.knap[i * m + k] = knap[k];
          }
        }
      }
    }
    if constexpr (kCv) {
      nd += cur == 0;
      left -= (nxt != 0 && !(best.key & 1)) ? 1 : 0;
      used = __fadd_rn(nxt == 0 ? 0.0f : used, __ldg(dem_row + nxt));
    }
    if constexpr (kKn) {
#pragma unroll
      for (int k = 0; k < kMaxDims; ++k) {
        if (k < m) knap[k] = __fadd_rn(knap[k], __ldg(w_inst + (size_t)nxt * m + k));
      }
    }
    if constexpr (kO) used = __fadd_rn(used, __ldg(d_inst + (size_t)cur * N + nxt));
    if constexpr (kPc) {
      used = __fadd_rn(used, __ldg(prize_row + nxt));
      if (nxt == 0) {  // home: every customer shut, and "every customer visited" holds
        home = true;
        left = 0;
      } else if (!home) {
        left -= !(best.key & 1);
      }
      if (nxt != 0 && !gate_open && (used > p.pl.min_prizes || left == 0)) {
        gate_open = true;
        gate_step = t + 1;
      }
    }
    if (!kPc || nxt != 0) visit(nxt, t + 1);
    cur = nxt;
#pragma unroll
    for (int j = 0; j < G; ++j) g[j] = g_next[j];
  }
  if constexpr (kCv || kDummy || kPc) {
    const int parked = kDummy ? dummy : 0;
    for (int s = t + tid; s < T; s += threads) {  // parked: certain, log-probability 0
      out[(size_t)(s + 1) * A] = parked;
      if constexpr (kTrace) {
        const size_t i = row0 + (size_t)s * A;
        p.tr.logp[i] = 0.0f;
        p.tr.lse[i] = park_lse;
        if constexpr (kCv) p.tr.rem[i] = park_rem;
        if constexpr (kKn) {
#pragma unroll
          for (int k = 0; k < kMaxDims; ++k) {
            if (k < m) p.tr.knap[i * m + k] = knap[k];
          }
        }
      }
    }
    if (kTrace && kCv && tid == 0) p.tr.ndep[ant] = nd;
    if (kTrace && kPc && tid == 0) p.tr.gate[ant] = gate_step;
  }
}

// A block: 32 columns of row r of instance b; warp w sums the ants w, w +
// kBwdWarps, ... in order, then warp 0 adds the warps' sums in order.
template <int kKind>
__global__ void __launch_bounds__(32 * kBwdWarps)
    rollout_bwd_kernel(const float* __restrict__ score, const int64_t* __restrict__ paths,
                       const float* __restrict__ g, const Plugin pl, const Trace tr, int B,
                       int N, int A, int T, float* __restrict__ d_score) {
  constexpr bool kCv = kKind == kCvrp, kSp = kKind == kSop, kMk = kKind == kMkp;
  constexpr bool kO = kKind == kOp, kPc = kKind == kPctsp;
  __shared__ float s_part[kBwdWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r = blockIdx.y, b = blockIdx.z;
  const bool live = c < N;
  const float s = live ? __ldg(score + ((size_t)b * N + r) * N + c) : 0.0f;
  const float dc = kCv && live ? __ldg(pl.demand + (size_t)b * N + c) : 0.0f;
  const int m = kMk ? pl.m : 0;
  float wc[kMk ? kMaxDims : 1];  // MKP: the column's weights
  if constexpr (kMk) {
#pragma unroll
    for (int k = 0; k < kMaxDims; ++k) {
      wc[k] = live && k < m ? __ldg(pl.weight + ((size_t)b * N + c) * m + k) : 0.0f;
    }
  }
  float acc = 0.0f;
  // MKP's and OP's dummy row holds parked steps alone: gradient 0
  const int ants = (kMk || kO) && r == pl.dummy ? 0 : A;
  for (int a = warp; a < ants; a += kBwdWarps) {
    const long ant = (long)b * A + a;
    const int* ant_pos = tr.pos + (size_t)ant * N;
    const int pc = live ? __ldg(ant_pos + c) : 0;
    const int rc = kSp && live ? __ldg(tr.ready + (size_t)ant * N + c) : 0;
    const int gate = kPc ? __ldg(tr.gate + ant) : 0;
    // the term of the step t that leaves row r; depot_open: the visit rule's
    // verdict on column 0 there
    const auto term = [&](int t, bool depot_open) {
      const size_t i = ((size_t)b * T + t) * A + a;
      const int nxt = (int)__ldg(paths + ((size_t)b * (T + 1) + t + 1) * A + a);
      bool open;
      if constexpr (kCv) {
        open = (c == 0 ? depot_open : pc > t) && dc <= __ldg(tr.rem + i);
      } else if constexpr (kSp) {
        open = pc > t && rc <= t;
      } else if constexpr (kO) {
        open = c == pl.dummy ? nxt == c : pc > t;
      } else if constexpr (kPc) {
        open = c == 0 ? t >= gate : pc > t;
      } else if constexpr (kMk) {
        if (c == pl.dummy) {
          open = nxt == c;
        } else {
          float kt[kMaxDims];
#pragma unroll
          for (int k = 0; k < kMaxDims; ++k) kt[k] = k < m ? __ldg(tr.knap + i * m + k) : 0.0f;
          open = pc > t && fits(kt, wc, m, pl.capacity);
        }
      } else {
        open = pc > t;
      }
      if (live && open) {
        acc += __ldg(g + i) * ((c == nxt ? 1.0f : 0.0f) - softmax_at(s, __ldg(tr.lse + i), N));
      }
    };
    if (kCv && r == 0) {
      const int cnt = __ldg(tr.ndep + ant);
      const int* list = tr.dep + (size_t)ant * T;
      for (int k = 0; k < cnt; ++k) {
        const int e = __ldg(list + k);
        term(e >> 1, e & 1);
      }
    } else if (kO || (kSp && r != 0)) {
      // pos(r): the step at which r closed, by a visit or (OP) out of reach,
      // (SOP) shut by a repeat of column 0
      const int t = __ldg(ant_pos + r);
      if (t < T && __ldg(paths + ((size_t)b * (T + 1) + t) * A + a) == r) term(t, true);
    } else if (kSp) {  // row 0: the start, and every repeat of column 0
      for (int t = 0; t < T; ++t) {
        if (__ldg(paths + ((size_t)b * (T + 1) + t) * A + a) == 0) term(t, true);
      }
    } else {
      // PCTSP: the start's row at step 0 (no pick), a customer's at its pick;
      // the depot's later steps are parked
      if (kPc && __ldg(paths + (size_t)b * (T + 1) * A + a) == r) term(0, true);
      const int t = kPc && r == 0 ? T : __ldg(ant_pos + r);
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

// ITEMS: a block 32 columns of instance b and the terms k = a * T + t in
// [split * per, (split + 1) * per), warp w the terms lo + w, lo + w + 4, ...
// in order, then warp 0 adds the warps' sums in order into part[b, split, c].
// An ant's steps from pos(dummy) on (the step after its dummy pick) are
// parked, their terms 0: the warp jumps to the ant's end, keeping its
// residue, so the work is the steps the ants took.
__global__ void __launch_bounds__(32 * kBwdWarps)
    rollout_bwd_items_kernel(const float* __restrict__ score, const int64_t* __restrict__ paths,
                             const float* __restrict__ g, const Plugin pl, const Trace tr, int B,
                             int N, int A, int T, long per, float* __restrict__ part) {
  __shared__ float s_part[kBwdWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int split = blockIdx.y, splits = gridDim.y, b = blockIdx.z;
  const bool live = c < N;
  const float s = live ? __ldg(score + (size_t)b * N + c) : 0.0f;
  const int m = pl.m;
  const bool dummy = c == pl.dummy;
  float wc[kMaxDims];
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    wc[k] = live && k < m ? __ldg(pl.weight + ((size_t)b * N + c) * m + k) : 0.0f;
  }
  const long terms = (long)A * T, lo = (long)split * per;
  const long hi = lo + per < terms ? lo + per : terms;
  float acc = 0.0f;
  for (long k = lo + warp; k < hi; k += kBwdWarps) {
    const int a = (int)(k / T), t = (int)(k % T);
    if (t >= __ldg(tr.pos + ((size_t)b * A + a) * N + pl.dummy)) {  // parked from here
      const long end = (long)(a + 1) * T;
      k += (end - k - 1) / kBwdWarps * kBwdWarps;  // the last term of the ant's in the residue
      continue;
    }
    const size_t i = ((size_t)b * T + t) * A + a;
    const int nxt = (int)__ldg(paths + ((size_t)b * (T + 1) + t + 1) * A + a);
    bool open;
    if (dummy) {
      open = nxt == c;  // it opens only as the last open column
    } else {
      float kt[kMaxDims];
#pragma unroll
      for (int q = 0; q < kMaxDims; ++q) kt[q] = q < m ? __ldg(tr.knap + i * m + q) : 0.0f;
      open = live && __ldg(tr.pos + ((size_t)b * A + a) * N + c) > t
             && fits(kt, wc, m, pl.capacity);
    }
    if (live && open) {
      acc += __ldg(g + i) * ((c == nxt ? 1.0f : 0.0f) - softmax_at(s, __ldg(tr.lse + i), N));
    }
  }
  s_part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    float total = s_part[0][lane];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) total += s_part[w][lane];
    part[((size_t)b * splits + split) * N + c] = total;
  }
}

// ITEMS' second pass: d_score[b, c] = the splits' partial sums in order.
__global__ void rollout_items_sum_kernel(const float* __restrict__ part, int splits, int B,
                                         int N, float* __restrict__ d_score) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * N) return;
  const long b = idx / N, c = idx % N;
  float total = 0.0f;
  for (int s = 0; s < splits; ++s) total += __ldg(part + ((size_t)b * splits + s) * N + c);
  d_score[idx] = total;
}

// BLEND's first backward pass: a thread column c of ant blockIdx.x, its
// steps t < pos(c). part holds three planes [B, A, T, N]: the terms of P and
// heu_pow of the row cur_t, and D_t, the gradient of phe's row cur_t.
__global__ void __launch_bounds__(kTermThreads)
    rollout_bwd_blend_terms_kernel(const float* __restrict__ score,
                                   const int64_t* __restrict__ paths,
                                   const float* __restrict__ g, const Plugin pl, const Trace tr,
                                   int B, int N, int A, int T, float* __restrict__ part) {
  const int c = blockIdx.y * kTermThreads + threadIdx.x;
  const long ant = blockIdx.x;  // b * A + a
  if (c >= N) return;
  const int b = (int)(ant / A), a = (int)(ant % A);
  const size_t plane = (size_t)B * A * T * N;
  float* t_score = part + (size_t)ant * T * N + c;  // step t at t * N
  float* t_heu = t_score + plane;
  float* t_phe = t_heu + plane;
  const int pc = __ldg(tr.pos + (size_t)ant * N + c);
  const int rc = __ldg(tr.ready + (size_t)ant * N + c);
  const int steps = pc < T ? pc : T;  // the column is shut from pos(c) on
  const size_t inst = (size_t)b * N * N;
  const int64_t* my_path = paths + (size_t)b * (T + 1) * A + a;  // step s at my_path[s * A]
  float S = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const int cur = (int)__ldg(my_path + (size_t)t * A);
    const size_t at = inst + (size_t)cur * N + c;
    const float ph = __ldg(pl.phe + at);
    S = t == 0 ? ph : __fadd_rn(__fmul_rn(pl.gamma, S), ph);
    float d_score = 0.0f, d_heu = 0.0f, d_s = 0.0f;
    if (rc <= t) {  // open: unvisited, every predecessor visited
      const float P = __ldg(score + at), hb = __ldg(pl.heu_pow + at);
      const float pr = blend_p(pl, P, hb, S);
      if (pr > 0.0f) {
        const size_t i = ((size_t)b * T + t) * A + a;
        const int nxt = (int)__ldg(my_path + (size_t)(t + 1) * A);
        const float e = __ldg(g + i) * ((c == nxt ? 1.0f : 0.0f)
                                        - softmax_at(blend_logit(pr), __ldg(tr.lse + i), N));
        const float dp = pr >= 1e-30f ? __fdiv_rn(e, pr) : 0.0f;
        const float d_sum = pl.cc == 0.0f ? dp : dp * pl.cb;
        d_score = pl.cc == 0.0f ? 0.0f : dp * pl.cc;
        d_heu = d_sum * pow_alpha(S, pl.alpha);
        d_s = d_sum * hb;
        if (pl.alpha != 1.0f) d_s *= pl.alpha * powf(S, pl.alpha - 1.0f);
      }
    }
    t_score[(size_t)t * N] = d_score;
    t_heu[(size_t)t * N] = d_heu;
    t_phe[(size_t)t * N] = d_s;
  }
  float d = 0.0f;  // the running sum's adjoint, last step first
  for (int t = steps - 1; t >= 0; --t) {
    d = t_phe[(size_t)t * N] + pl.gamma * d;
    t_phe[(size_t)t * N] = d;
  }
}

// BLEND's second pass: a block 32 columns of row r of instance b; warp w adds
// the terms of the ants w, w + kBwdWarps, ... in order at the steps that
// stand on r and where the column is still open, then warp 0 the warps' sums
// in order.
__global__ void __launch_bounds__(32 * kBwdWarps)
    rollout_bwd_blend_rows_kernel(const int64_t* __restrict__ paths, const Trace tr, int B,
                                  int N, int A, int T, const float* __restrict__ part,
                                  float* __restrict__ d_score, float* __restrict__ d_heu,
                                  float* __restrict__ d_phe) {
  __shared__ float s_part[3][kBwdWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int r = blockIdx.y, b = blockIdx.z;
  const bool live = c < N;
  const size_t plane = (size_t)B * A * T * N;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int a = warp; a < A; a += kBwdWarps) {
    const long ant = (long)b * A + a;
    const int* ant_pos = tr.pos + (size_t)ant * N;
    const int pc = live ? __ldg(ant_pos + c) : 0;
    const int64_t* my_path = paths + (size_t)b * (T + 1) * A + a;
    const auto add = [&](int t) {
      if (live && t < pc) {
        const size_t i = ((size_t)ant * T + t) * N + c;
        acc[0] += __ldg(part + i);
        acc[1] += __ldg(part + plane + i);
        acc[2] += __ldg(part + 2 * plane + i);
      }
    };
    if (r != 0) {  // the step that stands on r, if the ant visited it
      const int t = __ldg(ant_pos + r);
      if (t < T && __ldg(my_path + (size_t)t * A) == r) add(t);
    } else {  // row 0: the start, and every repeat of column 0
      for (int t = 0; t < T; ++t) {
        if (__ldg(my_path + (size_t)t * A) == 0) add(t);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) s_part[k][warp][lane] = acc[k];
  __syncthreads();
  if (warp == 0 && live) {
    float* out[3] = {d_score, d_heu, d_phe};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float total = s_part[k][0][lane];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) total += s_part[k][w][lane];
      out[k][((size_t)b * N + r) * N + c] = total;
    }
  }
}

template <int kKind, bool kTrace, int G>
int launch_g(unsigned blocks, int warps, cudaStream_t s, const Fwd& p) {
  rollout_fwd_kernel<kKind, kTrace, G><<<blocks, 32 * warps, 0, s>>>(p);
  return cudaGetLastError();
}

template <int kKind, bool kTrace>
int launch_fwd(int per, unsigned blocks, int warps, cudaStream_t s, const Fwd& p) {
  if (per <= 1) return launch_g<kKind, kTrace, 1>(blocks, warps, s, p);
  if (per <= 2) return launch_g<kKind, kTrace, 2>(blocks, warps, s, p);
  if (per <= 4) return launch_g<kKind, kTrace, 4>(blocks, warps, s, p);
  if (per <= 8) return launch_g<kKind, kTrace, 8>(blocks, warps, s, p);
  if constexpr (kKind != kMkp && kKind != kItems) {
    if (per <= kMaxCols) return launch_g<kKind, kTrace, kMaxCols>(blocks, warps, s, p);
  }
  return cudaErrorInvalidValue;
}

template <int kKind>
int launch_kind(bool trace, int per, unsigned blocks, int warps, cudaStream_t s, const Fwd& p) {
  return trace ? launch_fwd<kKind, true>(per, blocks, warps, s, p)
               : launch_fwd<kKind, false>(per, blocks, warps, s, p);
}

template <int kKind>
int launch_bwd(const float* score, const int64_t* paths, const float* g, const Plugin& pl,
               const Trace& tr, int B, int N, int A, int T, float* d_score, cudaStream_t s) {
  const dim3 grid((unsigned)((N + 31) / 32), (unsigned)N, (unsigned)B);
  rollout_bwd_kernel<kKind><<<grid, 32 * kBwdWarps, 0, s>>>(score, paths, g, pl, tr, B, N, A, T,
                                                             d_score);
  return cudaGetLastError();
}

int launch_blend_bwd(const float* score, const int64_t* paths, const float* g, const Plugin& pl,
                     const Trace& tr, int B, int N, int A, int T, float* part, float* d_score,
                     float* d_heu, float* d_phe, cudaStream_t s) {
  const dim3 terms((unsigned)((long)B * A), (unsigned)((N + kTermThreads - 1) / kTermThreads));
  rollout_bwd_blend_terms_kernel<<<terms, kTermThreads, 0, s>>>(score, paths, g, pl, tr, B, N, A,
                                                               T, part);
  const int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rows((unsigned)((N + 31) / 32), (unsigned)N, (unsigned)B);
  rollout_bwd_blend_rows_kernel<<<rows, 32 * kBwdWarps, 0, s>>>(paths, tr, B, N, A, T, part,
                                                                d_score, d_heu, d_phe);
  return cudaGetLastError();
}

int launch_items_bwd(const float* score, const int64_t* paths, const float* g, const Plugin& pl,
                     const Trace& tr, int B, int N, int A, int T, int splits, float* part,
                     float* d_score, cudaStream_t s) {
  const long per = ((long)A * T + splits - 1) / splits;
  const dim3 grid((unsigned)((N + 31) / 32), (unsigned)splits, (unsigned)B);
  rollout_bwd_items_kernel<<<grid, 32 * kBwdWarps, 0, s>>>(score, paths, g, pl, tr, B, N, A, T,
                                                            per, part);
  const int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = (long)B * N;
  rollout_items_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part, splits, B, N,
                                                                          d_score);
  return cudaGetLastError();
}

}  // namespace
}  // namespace deepaco

// score [B,N,N] f32 (ITEMS: [B,N]), start [B,A] int64, noise [T,B,A,N] f32 and
// the kind's inputs (CVRP: demand [B,N] f32 and capacity; SOP: succ [B,N,N]
// uint8, succ[b,k,c] = 1 iff k must precede c, and npred [B,N] int32; MKP and
// ITEMS: weight [B,N,m] f32, m <= 8, capacity and the dummy's index, N <= 2048; OP: dist
// [B,N,N] f32, max_len [B] f32 and the dummy's index; PCTSP: prizes [B,N] f32
// and min_prizes; BLEND: SOP's succ and npred, phe and heu_pow [B,N,N] f32,
// gamma, c, cb = 1 - c and alpha > 0, the score P = phe^alpha heu^beta; null
// where unused) -> paths [B,T+1,A] int64; traced also
// logp and lse [B,T,A] f32 and pos [B,A,N] int32, CVRP rem [B,T,A] f32, dep
// [B,A,T] and ndep [B,A] int32, SOP and BLEND ready [B,A,N] int32, MKP and ITEMS knap
// [B,T,A,m] f32, PCTSP gate [B,A] int32. kind: 0 TSP, 1 CVRP, 2 SOP, 3 MKP, 4
// OP, 5 PCTSP, 6 ITEMS, 7 BLEND. warps: 1, 2, 4 or 8 an ant (16 columns a thread at
// most, 8 for MKP and ITEMS), 0 to choose.
extern "C" int deepaco_rollout_fwd_kind(const float* score, const int64_t* start,
                                        const float* noise, const float* demand,
                                        const uint8_t* succ, const int* npred, const float* weight,
                                        const float* dist, const float* max_len,
                                        const float* prizes, const float* phe,
                                        const float* heu_pow, float capacity, float min_prizes,
                                        float gamma, float c, float cb, float alpha, int m,
                                        int dummy, int B, int N, int A, int T, int kind,
                                        int trace, int warps, int64_t* paths, float* logp,
                                        float* lse, int* pos, float* rem, int* dep, int* ndep,
                                        int* ready, float* knap, int* gate, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool knapsack = kind == kMkp || kind == kItems;
  const bool prec = kind == kSop || kind == kBlend;
  const int max_cols = knapsack ? kMkpMaxCols : kMaxCols;
  if (kind < kTsp || kind > kBlend || N < 2 || N > 32 * kMaxWarps * max_cols) {
    return cudaErrorInvalidValue;
  }
  if (kind == kBlend && !(alpha > 0.0f)) return cudaErrorInvalidValue;
  if (knapsack && (m < 1 || m > kMaxDims)) return cudaErrorInvalidValue;
  if ((knapsack || kind == kOp) && (dummy < 0 || dummy >= N)) return cudaErrorInvalidValue;
  int least = 1;  // at most max_cols columns a thread
  while (32 * least * max_cols < N) least *= 2;
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
  const bool tr = trace != 0;
  const bool blend = kind == kBlend;
  Fwd p{score, start, noise,
        Plugin{kind == kCvrp ? demand : nullptr, prec ? succ : nullptr, prec ? npred : nullptr,
               knapsack ? weight : nullptr, kind == kOp ? dist : nullptr,
               kind == kOp ? max_len : nullptr, kind == kPctsp ? prizes : nullptr,
               blend ? phe : nullptr, blend ? heu_pow : nullptr, capacity, min_prizes, gamma, c,
               cb, alpha, m, dummy},
        B, N, A, T, paths,
        tr ? Trace{logp, lse, pos, kind == kCvrp ? rem : nullptr, kind == kCvrp ? dep : nullptr,
                   kind == kCvrp ? ndep : nullptr, prec ? ready : nullptr,
                   knapsack ? knap : nullptr, kind == kPctsp ? gate : nullptr}
           : Trace{}};
  switch (kind) {
    case kTsp: return launch_kind<kTsp>(tr, per, blocks, warps, s, p);
    case kCvrp: return launch_kind<kCvrp>(tr, per, blocks, warps, s, p);
    case kSop: return launch_kind<kSop>(tr, per, blocks, warps, s, p);
    case kMkp: return launch_kind<kMkp>(tr, per, blocks, warps, s, p);
    case kOp: return launch_kind<kOp>(tr, per, blocks, warps, s, p);
    case kPctsp: return launch_kind<kPctsp>(tr, per, blocks, warps, s, p);
    case kBlend: return launch_kind<kBlend>(tr, per, blocks, warps, s, p);
    default: return launch_kind<kItems>(tr, per, blocks, warps, s, p);
  }
}

// The gradient d_score [B,N,N] f32 (ITEMS: [B,N]) of sum(g * logp) for g
// [B,T,A] f32 and the traced forward's outputs and inputs, as
// deepaco_rollout_fwd_kind takes them; ITEMS also takes splits >= 1, the term
// shares of a column, and part [B,splits,N] f32 for their sums; BLEND takes
// part [3,B,A,T,N] f32 for its terms and also writes d_heu and d_phe
// [B,N,N] f32, the gradients in heu_pow and (through the running sum) phe.
extern "C" int deepaco_rollout_bwd_kind(const float* score, const int64_t* paths, const float* g,
                                        const float* lse, const int* pos, const float* rem,
                                        const int* dep, const int* ndep, const int* ready,
                                        const float* knap, const int* gate, const float* demand,
                                        const float* weight, const float* phe,
                                        const float* heu_pow, float capacity, float gamma,
                                        float c, float cb, float alpha, int m, int dummy, int B,
                                        int N, int A, int T, int kind, int splits, float* part,
                                        float* d_score, float* d_heu, float* d_phe,
                                        void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool knapsack = kind == kMkp || kind == kItems;
  if (kind < kTsp || kind > kBlend || (knapsack && (m < 1 || m > kMaxDims))) {
    return cudaErrorInvalidValue;
  }
  if (kind == kItems && (splits < 1 || part == nullptr || dummy < 0 || dummy >= N)) {
    return cudaErrorInvalidValue;
  }
  if (kind == kBlend && (part == nullptr || d_heu == nullptr || d_phe == nullptr
                         || !(alpha > 0.0f))) {
    return cudaErrorInvalidValue;
  }
  const Plugin pl{demand, nullptr, nullptr, weight, nullptr, nullptr, nullptr, phe, heu_pow,
                  capacity, 0.0f, gamma, c, cb, alpha, m, dummy};
  const Trace tr{nullptr, const_cast<float*>(lse), const_cast<int*>(pos),
                 const_cast<float*>(rem), const_cast<int*>(dep), const_cast<int*>(ndep),
                 const_cast<int*>(ready), const_cast<float*>(knap), const_cast<int*>(gate)};
  switch (kind) {
    case kTsp: return launch_bwd<kTsp>(score, paths, g, pl, tr, B, N, A, T, d_score, s);
    case kCvrp: return launch_bwd<kCvrp>(score, paths, g, pl, tr, B, N, A, T, d_score, s);
    case kSop: return launch_bwd<kSop>(score, paths, g, pl, tr, B, N, A, T, d_score, s);
    case kMkp: return launch_bwd<kMkp>(score, paths, g, pl, tr, B, N, A, T, d_score, s);
    case kOp: return launch_bwd<kOp>(score, paths, g, pl, tr, B, N, A, T, d_score, s);
    case kPctsp: return launch_bwd<kPctsp>(score, paths, g, pl, tr, B, N, A, T, d_score, s);
    case kBlend:
      return launch_blend_bwd(score, paths, g, pl, tr, B, N, A, T, part, d_score, d_heu, d_phe, s);
    default:
      return launch_items_bwd(score, paths, g, pl, tr, B, N, A, T, splits, part, d_score, s);
  }
}

// The TSP and CVRP kinds, traced, in the signature that earlier builds of
// this file export, so that scripts/compare_kernels.py --k7r-variant times
// them against this build.
extern "C" int deepaco_rollout_fwd(const float* score, const int64_t* start, const float* noise,
                                   const float* demand, float capacity, int B, int N, int A,
                                   int T, int cvrp, int warps, int64_t* paths, float* logp,
                                   float* lse, int* pos, float* rem, int* dep, int* ndep,
                                   void* stream) {
  return deepaco_rollout_fwd_kind(score, start, noise, demand, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, nullptr, nullptr, capacity, 0.0f, 0.0f, 0.0f,
                                  0.0f, 0.0f, 0, 0, B, N, A, T, cvrp ? 1 : 0, 1, warps, paths,
                                  logp, lse, pos, rem, dep, ndep, nullptr, nullptr, nullptr,
                                  stream);
}

extern "C" int deepaco_rollout_bwd(const float* score, const int64_t* paths, const float* g,
                                   const float* lse, const int* pos, const float* rem,
                                   const int* dep, const int* ndep, const float* demand, int B,
                                   int N, int A, int T, int cvrp, float* d_score, void* stream) {
  return deepaco_rollout_bwd_kind(score, paths, g, lse, pos, rem, dep, ndep, nullptr, nullptr,
                                  nullptr, demand, nullptr, nullptr, nullptr, 0.0f, 0.0f, 0.0f,
                                  0.0f, 0.0f, 0, 0, B, N, A, T, cvrp ? 1 : 0, 0, nullptr, d_score,
                                  nullptr, nullptr, stream);
}
