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
// keeps its ant's state in shared memory, one float4 a position k = 0..n:
// x, y (the coordinates in tour order), c = d(t[k-1], t[k]) and t (the city,
// as int bits); entry n repeats entry 0 (it never moves: a move reverses
// t[i..j] with 1 <= i < j <= n-1), so c[n] is the closing edge. The state is
// double-buffered, so that a move writes the reversed tour into the other
// buffer in one pass.
//
// One move is one scan of the pairs 1 <= i < j <= n-1 for
//   delta = ((d(t[i-1], t[j]) + d(t[i], t[j+1])) - c[i]) - c[j+1],
// in that order, as deepaco_tpu/ops/two_opt.py:36-40 does, and the first
// flat argmin of delta (flat index i*n + j), as jnp.argmin and torch.argmin
// take it. Only a move with delta below -1e-6 is ever taken, so each thread
// keeps the lexicographic minimum of (delta, flat) from -1e-6 down, over the
// pairs it prices in any order, and a warp and a block reduction over
// (delta, flat) give the first flat argmin among the improving moves.
//
// On the Euclidean distances the scan walks diagonals g = j - i: along one,
// d(t[i], t[j+1]) of pair (i, j) is d(t[(i+1)-1], t[j+1]) of pair
// (i+1, j+1), the same arguments and so the same bits, so a walk of R pairs
// computes R + 1 distances instead of 2R. A tile is 32 diagonals (one a
// lane) by R = 32 rows i: the lanes read position i together (a broadcast)
// and positions i+g+1 side by side (no bank conflict). A pair costs two
// correctly rounded roots only where a cheap approximate price says it might
// reach the warp's minimum so far.
//
// On the perturbation metric H (bf16, asymmetric) the scan prices only the
// pairs that can improve. With c the bf16 edge costs and every entry of H
// non-negative, delta < 0 needs H[t[i-1], t[j]] <= c[i] or H[t[i], t[j+1]]
// <= c[j+1]: an entry above a bf16 value exceeds it by at least 2^-8 of it,
// so two such entries would sum, rounded to f32, to at least c[i] + c[j+1]
// and every rounded step after that would stay at or above 0. Before the
// descents, sort_metric_kernel sorts each row and each column of the
// instance's H once and keeps the 16 least entries of each. A scan then
// walks row t[i-1] for every i while its entries are <= c[i] (the entry at
// column v is the pair (i, pos[v])) and column t[j+1] for every j while its
// entries are <= c[j+1] (row w: the pair (pos[w], j)), and prices each such
// pair exactly as the full scan would. Tour edges lie near the front of
// their rows, so a scan prices few of the (n-1)(n-2)/2 pairs; a row or
// column whose walk goes past its 16 entries is priced whole by the block.
// An instance with a negative entry prices every row whole instead: all
// pairs.
//
// If the scan finds an improving move, the block writes the tour with
// t[i..j] reversed into the other buffer (the edge costs inside move with
// their edges; the two new edges are computed) and swaps buffers; otherwise,
// or after max_it scans, the descent ends. A move costs two block barriers
// (three on the metric).
//
// Euclidean distances are sqrt((dx*dx + dy*dy) + 1e-20) with every operation
// rounded on its own (no FMA contraction), bit-equal to distance_matrix and
// symmetric bit for bit. The perturbation metric and its sorted rows and
// columns are read from device memory (they sit in L2).
//
// K5 runs the Euclidean descent, then t_nls rounds of a t_p-scan descent on
// the metric and a Euclidean descent, in one launch. The running tour carries
// across rounds; after each round its cost, c[n] + c[1] + ... + c[n-1] added
// one by one in f32 (the order of the plain version's _tour_lengths), replaces
// the best one when strictly lower, and the tour is copied to the output.
//
// Counters (K5): with a non-null counts pointer, each block counts its
// scans on the Euclidean distances and on the metric (a descent's last scan,
// which finds no move, included) and the moves it applied, in registers,
// and adds them to counts[0..2] once at its end; with a null pointer it adds
// nothing, and the tours are the same bits either way.
//
// What bounds it: operations. Each Euclidean scan evaluates (n-1)(n-2)/2
// pairs; the inputs are read once. The blocks are independent, so a
// converged ant frees its SM slot at once.
#include <cassert>
#include <climits>
#include <cuda_bf16.h>

#include "common.cuh"

namespace deepaco {

// The block's two buffers of ant_stride(n) entries: n + 1 positions and 32
// of padding (city 0, zero coordinates), so that the lanes of a tile whose
// diagonals have ended may read past position n without a bounds check;
// for K5 then pos [n], the position of each city in the current tour, and
// spill [2n].
extern __shared__ float4 ant_smem[];

namespace {

constexpr int kLsThreads = 512;
constexpr int kLsWarps = kLsThreads / 32;
constexpr int kTileRows = 32;  // R, the pairs a lane walks along its diagonal in a tile
constexpr int kWalk = 16;      // the sorted words of a row or column a thread reads
constexpr float kImprove = -1e-6f;

// distance_matrix's formula, sqrt((dx*dx + dy*dy) + 1e-20), each step rounded.
__device__ __forceinline__ float euclid(float ax, float ay, float bx, float by) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by);
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 1e-20f));
}

// A cheap distance for the Euclidean scan's filter: relative error below
// 2^-21, and 1e-10 absolute where euclid() adds 1e-20 under the root.
__device__ __forceinline__ float euclid_approx(float2 a, float2 b) {
  const float dx = a.x - b.x, dy = a.y - b.y;
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(fmaf(dx, dx, dy * dy)));
  return r;
}

__device__ __forceinline__ int city(const float4& e) { return __float_as_int(e.w); }

__host__ __device__ __forceinline__ int ant_stride(int n) { return n + 1 + 32; }

struct Ant {
  int cur;  // offset in ant_smem of [n + 1] (x, y, c, t) in tour order
  int nxt;  // the other buffer
  int n;
  int parity;   // which half of the reduction slots this scan writes
  float slack;  // bound of the error of an approximate price (see walk_tile)
  const __nv_bfloat16* metric;  // [n, n] the instance's perturbation metric, or null
  const unsigned* sorted;       // [2, n, kWalk] its rows, then its columns: the least words
  bool every;  // H has a negative entry: walk every row to its end
  int* pos;    // [n] in shared memory, or null (K4)
  int* spill;    // [2n] the rows and columns the block prices whole
  int* spilled;  // their count
  float* red_v;  // [2 * kLsWarps]
  int* red_i;
};

// d(a, b) for the entries a (earlier in the tour) and b: the metric, or the
// Euclidean distance with D[a, b]'s sign convention (coords[a] - coords[b]).
template <bool kMetric>
__device__ __forceinline__ float dist(const Ant& s, const float4& a, const float4& b) {
  if (kMetric) return __bfloat162float(s.metric[(size_t)city(a) * s.n + city(b)]);
  return euclid(a.x, a.y, b.x, b.y);
}

template <bool kMetric>
__device__ void edge_costs(const Ant& s) {  // c[1..n]
  for (int k = 1 + (int)threadIdx.x; k <= s.n; k += blockDim.x)
    ant_smem[s.cur + k].z = dist<kMetric>(s, ant_smem[s.cur + k - 1], ant_smem[s.cur + k]);
  __syncthreads();
}

// Loads the tour and sets s.slack from the instance's bounding box: every
// distance, exact or approximate, is at most its diagonal D (to a rounding),
// so a price of two distances and two edge costs errs by less than
// 4.01 D 2^-15 + 1e-9, 16 times the bound of euclid_approx's errors.
__device__ void load_ant(Ant& s, const float* coords, const int64_t* tour) {
  __shared__ float box[4][kLsWarps];
  float lo_x = INFINITY, lo_y = INFINITY, hi_x = -INFINITY, hi_y = -INFINITY;
  for (int k = threadIdx.x; k < s.n; k += blockDim.x) {
    const int64_t v = tour[k];
    assert(0 <= v && v < s.n);
    const float x = coords[2 * v], y = coords[2 * v + 1];
    ant_smem[s.cur + k] = make_float4(x, y, 0.0f, __int_as_float((int)v));
    if (s.pos) s.pos[v] = k;
    lo_x = fminf(lo_x, x);
    hi_x = fmaxf(hi_x, x);
    lo_y = fminf(lo_y, y);
    hi_y = fmaxf(hi_y, y);
  }
  for (int k = s.n + 1 + (int)threadIdx.x; k < ant_stride(s.n); k += blockDim.x)
    ant_smem[s.cur + k] = ant_smem[s.nxt + k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int off = 16; off > 0; off >>= 1) {
    lo_x = fminf(lo_x, __shfl_xor_sync(kFullMask, lo_x, off));
    hi_x = fmaxf(hi_x, __shfl_xor_sync(kFullMask, hi_x, off));
    lo_y = fminf(lo_y, __shfl_xor_sync(kFullMask, lo_y, off));
    hi_y = fmaxf(hi_y, __shfl_xor_sync(kFullMask, hi_y, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    box[0][warp] = lo_x;
    box[1][warp] = hi_x;
    box[2][warp] = lo_y;
    box[3][warp] = hi_y;
  }
  __syncthreads();
  if (threadIdx.x == 0) ant_smem[s.cur + s.n] = ant_smem[s.cur];
  for (int w = 0; w < kLsWarps; ++w) {
    lo_x = fminf(lo_x, box[0][w]);
    hi_x = fmaxf(hi_x, box[1][w]);
    lo_y = fminf(lo_y, box[2][w]);
    hi_y = fmaxf(hi_y, box[3][w]);
  }
  const float w = fmaxf(hi_x - lo_x, 0.0f), h = fmaxf(hi_y - lo_y, 0.0f);
  s.slack = fmaf(4.01f * 1.0001f * sqrtf(w * w + h * h), 0x1p-15f, 1e-9f);
  __syncthreads();
}

__device__ void store_ant(const Ant& s, int64_t* out) {
  for (int k = threadIdx.x; k < s.n; k += blockDim.x) out[k] = city(ant_smem[s.cur + k]);
}

// The first 8-byte half of an entry: (x, y).
__device__ __forceinline__ float2 xy_of(const float4* e) { return reinterpret_cast<const float2*>(e)[0]; }

// Lanes walk diagonals g = g0 + lane of the Euclidean distances over rows i
// in [i0, i1) (lane 0's range; a lane stops where its diagonal ends, at
// i = n - 1 - g), keeping the lexicographic minimum of (delta, i*n + j) in
// (best, bidx). Each walk loads only the fields it reads, (x, y) and c. A
// pair is first priced with euclid_approx; only where that price lies within
// s.slack of thr (load_ant) are the exact distances taken. thr is -1e-6 or
// the exact delta of a pair that this warp found, so it is at least the
// scan's minimum, and no pair whose exact delta could reach that minimum is
// skipped.
__device__ __forceinline__ void walk_tile(const Ant& s, int g0, int i0, int i1, float& best,
                                          int& bidx, float& thr) {
  const int n = s.n, g = g0 + (threadIdx.x & 31);
  const int live = min(i1, n - g) - i0;  // this lane's rows: j = i + g <= n - 1
  const float4* pi = ant_smem + s.cur + i0;          // position i
  const float4* pj = ant_smem + s.cur + i0 + g + 1;  // position j + 1 (<= n + 31)
  float2 up = xy_of(pi - 1), at = xy_of(pj - 1);  // t[i-1] and t[j]
  float d = euclid_approx(up, at);
  float limit = thr + s.slack;
#pragma unroll 4
  for (int r = 0; r < i1 - i0; ++r) {
    const float2 a = xy_of(pi + r), b = xy_of(pj + r);
    const float ca = pi[r].z, cb = pj[r].z;
    const float dn = euclid_approx(a, b);
    const float price = ((d + dn) - ca) - cb;
    if (r < live && price <= limit) {
      const float delta = __fsub_rn(
          __fsub_rn(__fadd_rn(euclid(up.x, up.y, at.x, at.y), euclid(a.x, a.y, b.x, b.y)), ca), cb);
      const int flat = (i0 + r) * (n + 1) + g;
      if (delta < best || (delta == best && flat < bidx)) {
        best = delta;
        bidx = flat;
        thr = fminf(thr, delta);
        limit = thr + s.slack;
      }
    }
    up = a;
    at = b;
    d = dn;
  }
}

// The metric scan from the sorted rows and columns (see the top of the file).
// Thread w takes row t[i-1], i = 1 + w, with the bound c[i], or column
// t[j+1], j = 2 + w - (n - 2), with the bound c[j+1]; it reads the first
// kWalk sorted words at once and prices the pairs of those whose entries are
// within the bound. A row or column whose bound reaches past them goes on a
// list, and after a barrier the block prices each listed row or column whole,
// a pair a thread. Each thread keeps the lexicographic minimum of
// (delta, i*n + j) over the pairs it priced in (best, bidx).
__device__ void candidate_scan(const Ant& s, float& best, int& bidx) {
  const int n = s.n;
  const float4* e = ant_smem + s.cur;
  auto gather = [&](const float4& a, const float4& b) {  // H[t_a, t_b]
    return __bfloat162float(s.metric[(size_t)city(a) * n + city(b)]);
  };
  auto price = [&](int i, int j, float d, float dn) {
    const float delta = __fsub_rn(__fsub_rn(__fadd_rn(d, dn), e[i].z), e[j + 1].z);
    const int flat = i * n + j;
    if (delta < best || (delta == best && flat < bidx)) {
      best = delta;
      bidx = flat;
    }
  };
  const int walks = s.every ? n - 2 : 2 * (n - 2);
  for (int w = threadIdx.x; w < walks; w += blockDim.x) {
    const bool by_row = w < n - 2;
    const int k = by_row ? 1 + w : 2 + w - (n - 2);  // i on a row, j on a column
    const int head = city(e[by_row ? k - 1 : k + 1]);  // t[i-1] or t[j+1]
    // c[i] or c[j+1], a bf16 value: its top 16 bits order like the entries
    const unsigned cap = s.every ? 0xffffu : __float_as_uint(e[by_row ? k : k + 1].z) >> 16;
    const uint4* list = reinterpret_cast<const uint4*>(
        s.sorted + ((size_t)(by_row ? 0 : n) + head) * kWalk);
    uint4 four[kWalk / 4];
#pragma unroll
    for (int q = 0; q < kWalk / 4; ++q) four[q] = list[q];
#pragma unroll
    for (int q = 0; q < kWalk / 4; ++q) {
      const unsigned words[4] = {four[q].x, four[q].y, four[q].z, four[q].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned word = words[r];  // sorted: once one fails, the rest do
        if (4 * q + r >= n || (word >> 16) > cap) continue;
        const int other = s.pos[word & 0xffffu];
        const int i = by_row ? k : other, j = by_row ? other : k;
        if (i < 1 || i >= j) continue;
        const float entry = __uint_as_float(word & 0xffff0000u);
        price(i, j, by_row ? entry : gather(e[i - 1], e[j]),
              by_row ? gather(e[i], e[j + 1]) : entry);
      }
    }
    if (kWalk < n && (four[kWalk / 4 - 1].w >> 16) <= cap) s.spill[atomicAdd(s.spilled, 1)] = w;
  }
  __syncthreads();
  const int listed = *s.spilled;  // reset after the block's reduction (best_move)
  for (int l = 0; l < listed; ++l) {
    const int w = s.spill[l];
    const bool by_row = w < n - 2;
    const int k = by_row ? 1 + w : 2 + w - (n - 2);
    const int len = by_row ? n - 1 - k : k - 1;  // j in (i, n-1], or i in [1, j)
    for (int x = threadIdx.x; x < len; x += blockDim.x) {
      const int i = by_row ? k : 1 + x, j = by_row ? k + 1 + x : k;
      price(i, j, gather(e[i - 1], e[j]), gather(e[i], e[j + 1]));
    }
  }
}

// The first flat argmin (g, i*n + j) of the delta matrix over 1 <= i < j <= n-1
// where its delta is at most -1e-6, the same in every thread on return; else
// g = -1e-6 (no move improves), and flat INT_MAX.
template <bool kMetric>
__device__ void best_move(Ant& s, float& g, int& flat) {
  const int n = s.n, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float best = kImprove;  // only a move below it is taken, so none above it is priced
  int bidx = INT_MAX;
  if (kMetric) {
    candidate_scan(s, best, bidx);
  } else {
    float thr = kImprove;  // the warp's minimum so far, shared between tiles
    // tiles: chunk c of rows i0 = 1 + c*R .. (i <= n-2), block G of
    // diagonals g0 = 1 + 32G with g0 <= n-1-i0; warp w takes tiles w, w +
    // kLsWarps, ... in chunk-major order
    constexpr int R = kTileRows;
    const int chunks = (n - 2 + R - 1) / R;
    auto blocks = [&](int c) { return (n - 3 - c * R) / 32 + 1; };
    int c = 0, G = warp;
    while (c < chunks && G >= blocks(c)) G -= blocks(c++);
    while (c < chunks) {
      const int g0 = 1 + 32 * G, i0 = 1 + c * R;
      walk_tile(s, g0, i0, min(i0 + R, n - g0), best, bidx, thr);
      // the least thr of the warp: thr < 0, and negative floats order
      // backwards as ints
      thr = __int_as_float(__reduce_max_sync(kFullMask, __float_as_int(thr)));
      G += kLsWarps;
      while (c < chunks && G >= blocks(c)) G -= blocks(c++);
    }
  }
  warp_pick<true>(best, bidx);
  float* red_v = s.red_v + s.parity * kLsWarps;
  int* red_i = s.red_i + s.parity * kLsWarps;
  s.parity ^= 1;  // the next scan writes the other half while this one is read
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (kMetric && threadIdx.x == 0) *s.spilled = 0;  // every thread has read it
  best = lane < kLsWarps ? red_v[lane] : kImprove;
  bidx = lane < kLsWarps ? red_i[lane] : INT_MAX;
  warp_pick<true>(best, bidx);
  g = best;
  flat = bidx;
}

// Reverse positions [p..q] (1 <= p < q <= n-1) into the other buffer and
// swap buffers. Inside the reversed range each edge keeps its cost (the
// Euclidean distance is symmetric bit for bit; the metric is not, so it is
// gathered again); the edges into p and out of q are new.
template <bool kMetric>
__device__ void flip(Ant& s, int p, int q) {
  for (int k = threadIdx.x; k <= s.n; k += blockDim.x) {
    const bool in = p <= k && k <= q;
    float4 e = ant_smem[s.cur + (in ? p + q - k : k)];
    if (k == p || k == q + 1) {
      e.z = dist<kMetric>(s, ant_smem[s.cur + (k == p ? p - 1 : p)], e);
    } else if (in) {
      const float4 prev = ant_smem[s.cur + p + q + 1 - k];  // the entry before k after the move
      e.z = kMetric ? dist<true>(s, prev, e) : prev.z;
    }
    if (in && s.pos) s.pos[city(e)] = k;
    ant_smem[s.nxt + k] = e;
  }
  __syncthreads();
  const int t = s.cur;
  s.cur = s.nxt;
  s.nxt = t;
}

// A block's counts: scans on the Euclidean distances, on the metric, and the
// moves applied (the same in every thread).
struct Tally {
  unsigned euclid = 0, metric = 0, moves = 0;
};

// two_opt of deepaco_tpu/ops/two_opt.py:68-82: at most max_it scans, the
// last one included when it finds no move. c must hold this metric's costs.
template <bool kMetric>
__device__ void descent(Ant& s, int max_it, Tally& tally) {
  for (int it = 0; it < max_it; ++it) {
    float g;
    int flat;
    best_move<kMetric>(s, g, flat);
    ++(kMetric ? tally.metric : tally.euclid);
    if (!(g < kImprove)) return;  // g and flat are the same in every thread
    ++tally.moves;
    flip<kMetric>(s, flat / s.n, flat % s.n);
  }
}

// c[n] + c[1] + ... + c[n-1], one by one, from the Euclidean costs.
__device__ float tour_cost(const Ant& s, float* out) {
  if (threadIdx.x == 0) {
    float total = ant_smem[s.cur + s.n].z;
    for (int k = 1; k < s.n; ++k) total = __fadd_rn(total, ant_smem[s.cur + k].z);
    *out = total;
  }
  __syncthreads();
  const float total = *out;
  __syncthreads();
  return total;
}

__device__ Ant carve(int n, float* red_v, int* red_i) {
  return Ant{0, ant_stride(n), n, 0, 0.0f, nullptr, nullptr, false,
             nullptr, nullptr, nullptr, red_v, red_i};
}

// Sorts row u (blockIdx.y = 0) or column u (1) of instance b's metric and
// keeps its kWalk least words in keys[b, y, u, :]: the words bits(H[u, v]) <<
// 16 | v, or bits(H[v, u]) << 16 | v, ascending (an entry's bf16 bits order
// like its value when it is not negative), then UINT_MAX past n. negative[b]
// = 1 where an entry has its sign bit set. A bitonic sort of P >= n words (a
// power of two, at least kWalk) in shared memory.
__global__ void sort_metric_kernel(const unsigned short* __restrict__ metric,
                                   unsigned* __restrict__ keys, int* __restrict__ negative,
                                   int n, int P) {
  extern __shared__ unsigned words[];
  const int u = blockIdx.x, y = blockIdx.y;
  const long b = blockIdx.z;
  const unsigned short* m = metric + b * n * n;
  bool neg = false;
  for (int v = threadIdx.x; v < P; v += blockDim.x) {
    unsigned w = UINT_MAX;
    if (v < n) {
      const unsigned h = y ? m[(long)v * n + u] : m[(long)u * n + v];
      neg = neg || (h >> 15);
      w = h << 16 | (unsigned)v;
    }
    words[v] = w;
  }
  if (__syncthreads_or(neg) && threadIdx.x == 0) negative[b] = 1;
  for (int size = 2; size <= P; size <<= 1) {
    for (int half = size >> 1; half > 0; half >>= 1) {
      for (int x = threadIdx.x; x < P; x += blockDim.x) {
        const int z = x ^ half;
        if (z > x) {
          const unsigned a = words[x], c = words[z];
          if ((a > c) == ((x & size) == 0)) {
            words[x] = c;
            words[z] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  unsigned* out = keys + ((b * 2 + y) * n + u) * (long)kWalk;
  for (int v = threadIdx.x; v < kWalk; v += blockDim.x) out[v] = words[v];
}

__global__ void __launch_bounds__(kLsThreads)
    two_opt_kernel(const float* __restrict__ coords, const int64_t* __restrict__ tours,
                   int64_t* __restrict__ out, int A, int n, int max_it) {
  __shared__ float red_v[2 * kLsWarps];
  __shared__ int red_i[2 * kLsWarps];
  const long ba = blockIdx.x;  // b * A + a
  const long b = ba / A;
  Ant s = carve(n, red_v, red_i);
  Tally tally;
  load_ant(s, coords + b * n * 2, tours + ba * n);
  edge_costs<false>(s);
  descent<false>(s, max_it, tally);
  store_ant(s, out + ba * n);
}

__global__ void __launch_bounds__(kLsThreads)
    nls_kernel(const float* __restrict__ coords, const __nv_bfloat16* __restrict__ metric,
               const unsigned* __restrict__ keys, const int* __restrict__ negative,
               const int64_t* __restrict__ tours, int64_t* __restrict__ out, int A, int n,
               int max_it, int t_nls, int t_p, unsigned long long* __restrict__ counts) {
  __shared__ float red_v[2 * kLsWarps];
  __shared__ int red_i[2 * kLsWarps];
  __shared__ float cost_slot;
  __shared__ int spilled;
  const long ba = blockIdx.x;
  const long b = ba / A;
  Ant s = carve(n, red_v, red_i);
  if (threadIdx.x == 0) spilled = 0;
  s.metric = metric + b * n * n;
  s.sorted = keys + b * 2 * n * kWalk;
  s.every = negative[b] != 0;
  s.pos = reinterpret_cast<int*>(ant_smem + 2 * ant_stride(n));
  s.spill = s.pos + n;
  s.spilled = &spilled;
  int64_t* best_tour = out + ba * n;
  Tally tally;
  load_ant(s, coords + b * n * 2, tours + ba * n);
  edge_costs<false>(s);
  descent<false>(s, max_it, tally);
  float best = tour_cost(s, &cost_slot);
  store_ant(s, best_tour);
  for (int r = 0; r < t_nls; ++r) {
    edge_costs<true>(s);  // perturb toward the model
    descent<true>(s, t_p, tally);
    edge_costs<false>(s);  // re-optimise on the true distances
    descent<false>(s, max_it, tally);
    const float cost = tour_cost(s, &cost_slot);
    if (cost < best) {
      best = cost;
      store_ant(s, best_tour);
    }
  }
  if (counts != nullptr && threadIdx.x == 0) {
    atomicAdd(counts + 0, (unsigned long long)tally.euclid);
    atomicAdd(counts + 1, (unsigned long long)tally.metric);
    atomicAdd(counts + 2, (unsigned long long)tally.moves);
  }
}

size_t ant_bytes(int n) { return 2 * (size_t)ant_stride(n) * sizeof(float4); }  // two buffers

}  // namespace
}  // namespace deepaco

// coords [B,N,2] f32, tours [B,A,N] int64 permutations -> out [B,A,N] int64.
extern "C" int deepaco_two_opt(const float* coords, const int64_t* tours, int64_t* out, int B, int A,
                               int N, int max_it, void* stream) {
  using namespace deepaco;
  const size_t smem = ant_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(two_opt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  two_opt_kernel<<<(unsigned)((long)B * A), kLsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coords, tours, out, A, N, max_it);
  return cudaGetLastError();
}

// coords [B,N,2] f32, metric [B,N,N] bf16, tours [B,A,N] int64 -> out [B,A,N],
// with the scratch keys [B, 2, N, 16] int32 (kWalk words a row and a column)
// and negative [B] int32. N < 2^16 and B < 2^16. counts: null, or three u64
// that the launch adds its Euclidean scans, metric scans and moves to.
extern "C" int deepaco_nls(const float* coords, const void* metric, void* keys, int* negative,
                           const int64_t* tours, int64_t* out, int B, int A, int N, int max_it,
                           int t_nls, int t_p, unsigned long long* counts, void* stream) {
  using namespace deepaco;
  if (N >= (1 << 16) || B >= (1 << 16)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  int P = kWalk;
  while (P < N) P <<= 1;
  cudaError_t err = cudaMemsetAsync(negative, 0, sizeof(int) * B, s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sort_metric_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(unsigned) * P));
  if (err != cudaSuccess) return err;
  sort_metric_kernel<<<dim3((unsigned)N, 2, (unsigned)B), 256, sizeof(unsigned) * P, s>>>(
      static_cast<const unsigned short*>(metric), static_cast<unsigned*>(keys), negative, N, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = ant_bytes(N) + sizeof(int) * 3 * N;  // and pos, spill
  err = cudaFuncSetAttribute(nls_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  nls_kernel<<<(unsigned)((long)B * A), kLsThreads, smem, s>>>(
      coords, static_cast<const __nv_bfloat16*>(metric), static_cast<const unsigned*>(keys),
      negative, tours, out, A, N, max_it, t_nls, t_p, counts);
  return cudaGetLastError();
}
