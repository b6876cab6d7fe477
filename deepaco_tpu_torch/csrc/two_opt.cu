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
// On the Euclidean distances each lane holds a group of kRows = 4 rows
// i..i+3 in registers: (x, y) of t[i-1..i+3] and c[i..i+3]. The lanes of a
// warp walk columns j in step, and at each step a lane reads t[j+1] once
// (one float4, the same address in every lane of its column tile) and takes
// the 5 distances d(t[i-1+m], t[j+1]), m = 0..4: the one at m+1 is
// d(t[i+m], t[j+1]) of the pair (i+m, j), and the one at m is
// d(t[i-1+m], t[j]) of the pair (i+m, j+1) at the next step, so 4 pairs
// cost 5 distances. The triangle is cut into tiles of C columns (C from n,
// see scan_cols: 16 at n 500) and the 4-row groups above or across each
// tile's diagonal; 32 such items make a warp tile, and the warps take warp
// tiles from a block counter (euclid_scan). A pair costs two correctly
// rounded roots only where a cheap approximate price says it might reach
// the warp's minimum so far.
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
// What bounds it: instruction issue and the MUFU pipe. A step of the
// Euclidean scan prices 4 pairs a lane with about 45 instructions in SASS,
// 5 of them MUFU.SQRT (the SM's 16 a clock take a warp's 5 in 10 clocks,
// its four schedulers the 45 in 11), and one LDS.128 that is one
// shared-memory wavefront a warp step of 128 pairs where the warp tile lies
// in one column tile; the set-up of a warp tile reads its 5 rows a lane at
// a 64-byte lane stride (16 wavefronts each). The diagonal walk before it
// read two LDS.128 a step of one pair a lane (position i, a broadcast, and
// j+1 side by side: 5 wavefronts a warp step of 32 pairs, about 16
// instructions a pair) and was bound by those loads. Each Euclidean scan
// evaluates (n-1)(n-2)/2 pairs; the inputs are read once. The blocks are
// independent, so a converged ant frees its SM slot at once.
#include <cassert>
#include <climits>
#include <cuda_bf16.h>

#include "common.cuh"

namespace deepaco {

// The block's two buffers of ant_stride(n) entries, positions 0..n; for K5
// then pos [n], the position of each city in the current tour, and spill
// [2n].
extern __shared__ float4 ant_smem[];

namespace {

constexpr int kLsThreads = 512;  // two blocks an SM: 64 registers a thread
constexpr int kLsWarps = kLsThreads / 32;
constexpr int kRows = 4;   // the rows a lane holds in the Euclidean scan
constexpr int kWalk = 16;  // the sorted words of a row or column a thread reads
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

__host__ __device__ __forceinline__ int ant_stride(int n) { return n + 1; }

// The Euclidean scan's tiling (see the top of the file): every lane holds a
// group g of kRows rows i = 1 + kRows g .., and walks the columns of one
// column tile c, [2 + cC, 2 + (c+1)C) with C = plan.cols, in step with the
// other lanes of its warp. Three lists of such items, each cut into warp
// tiles of 32: the edge items (the groups cQ .. (c+1)Q - 1, Q = C / kRows,
// of each column tile c < ctf = (n-2) / C: they meet its diagonal), the
// full items (groups 0 .. cQ - 1 of column tile c, 1 <= c < ctf: every row
// lies above the tile's first column) and, where (n-2) % C columns are left,
// the ragged items (every group against those columns). The edge and ragged
// tiles check i + m < j on each pair; the full tiles need not.
struct ScanPlan {
  int cols;                // C, a multiple of kRows
  int ctf;                 // the column tiles of C columns
  int rag;                 // the columns left past them, (n-2) % C
  int edge, full, ragged;  // the items of each list
  int tiles[3];            // the warp tiles before the end of each list
};

__host__ __device__ void make_plan(ScanPlan& p, int n, int cols) {
  const int q = cols / kRows, groups = (n - 2 + kRows - 1) / kRows;
  p.cols = cols;
  p.ctf = (n - 2) / cols;
  p.rag = (n - 2) % cols;
  p.edge = q * p.ctf;
  p.full = q * p.ctf * (p.ctf - 1) / 2;
  p.ragged = p.rag > 0 ? groups : 0;
  p.tiles[0] = (p.edge + 31) / 32;
  p.tiles[1] = p.tiles[0] + (p.full + 31) / 32;
  p.tiles[2] = p.tiles[1] + (p.ragged + 31) / 32;
}

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
  const ScanPlan* plan;  // the Euclidean scan's tiles
  int* next;             // [2] the next warp tile of the scan, one slot a parity
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

// One warp tile: this lane's rows i..i+kRows-1 against columns j0 ..
// j0+steps-1, the lanes in step. The lane keeps t[i-1..i+kRows-1] (x, y)
// and c[i..i+kRows-1] in registers, and a[m] = d(t[i-1+m], t[j]) - c[i+m]
// from the step before; each step reads t[j+1] once (the same address in
// every lane of a column tile) and takes dn[m] = d(t[i-1+m], t[j+1]) for m =
// 0..kRows: dn[m+1] is dB of the pair (i+m, j) and dn[m] - c[i+m] the a[m] of
// the next step, kRows + 1 distances for kRows pairs. Every distance here is
// euclid_approx, and a pair's approximate price a[m] + dn[m+1] is held
// against thr + s.slack + c[j+1]; only where it lies within are the exact
// distances taken. thr is -1e-6 or the exact delta of a pair that this warp
// priced, the same in every lane, so it is at least the scan's minimum, and
// no pair whose exact delta could reach that minimum is skipped (load_ant
// bounds the error). A lane without an item holds c = -inf: its a[m] is
// +inf, and it prices nothing. kChecked: a pair counts only where i+m < j
// (rows past n - 2, read clamped to position n, never do).
template <bool kChecked>
__device__ __forceinline__ void walk_tile(const Ant& s, int i, int j0, int steps, bool live,
                                          float& best, int& bidx, float& thr) {
  const int n = s.n;
  const float4* e = ant_smem + s.cur;
  float2 row[kRows + 1];  // t[i-1+m]
  float c[kRows];         // c[i+m], or -inf
#pragma unroll
  for (int m = 0; m <= kRows; ++m) {
    const float4 v = e[min(i - 1 + m, n)];
    row[m] = make_float2(v.x, v.y);
    if (m > 0) c[m - 1] = live ? v.z : -INFINITY;
  }
  float2 at = make_float2(e[j0].x, e[j0].y);  // t[j]
  float a[kRows];                              // d(t[i-1+m], t[j]) - c[i+m]
#pragma unroll
  for (int m = 0; m < kRows; ++m) a[m] = euclid_approx(row[m], at) - c[m];
  float limit = thr + s.slack;
#pragma unroll 2
  for (int j = j0; j < j0 + steps; ++j) {
    const float4 v = e[j + 1];
    const float2 b = make_float2(v.x, v.y);
    float dn[kRows + 1];  // d(t[i-1+m], t[j+1])
#pragma unroll
    for (int m = 0; m <= kRows; ++m) dn[m] = euclid_approx(row[m], b);
    const float lim = limit + v.z;
    bool hit = false;
#pragma unroll
    for (int m = 0; m < kRows; ++m) hit |= a[m] + dn[m + 1] <= lim && (!kChecked || i + m < j);
    if (__any_sync(kFullMask, hit)) {
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (a[m] + dn[m + 1] <= lim && (!kChecked || i + m < j)) {
          const float delta = __fsub_rn(
              __fsub_rn(__fadd_rn(euclid(row[m].x, row[m].y, at.x, at.y),
                                  euclid(row[m + 1].x, row[m + 1].y, b.x, b.y)),
                        c[m]),
              v.z);
          const int flat = (i + m) * n + j;
          if (delta < best || (delta == best && flat < bidx)) {
            best = delta;
            bidx = flat;
            thr = fminf(thr, delta);
          }
        }
      }
      // the least thr of the warp: thr < 0, and negative floats order
      // backwards as ints
      thr = __int_as_float(__reduce_max_sync(kFullMask, __float_as_int(thr)));
      limit = thr + s.slack;
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) a[m] = dn[m] - c[m];
    at = b;
  }
}

// The Euclidean scan: each warp takes the next warp tile of the block's
// counter (edge tiles, then full, then ragged: the long ones first) until
// none is left, keeping its thr from tile to tile.
__device__ void euclid_scan(const Ant& s, float& best, int& bidx) {
  const ScanPlan& p = *s.plan;
  const int lane = threadIdx.x & 31, cols = p.cols, q = cols / kRows;
  float thr = kImprove;  // the warp's minimum so far
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(s.next + s.parity, 1);
    t = __shfl_sync(kFullMask, t, 0);
    if (t >= p.tiles[2]) return;
    int g = 0, c = 0;
    if (t < p.tiles[0]) {  // edge item k: group k of column tile k / Q
      const int k = 32 * t + lane;
      const bool live = k < p.edge;
      if (live) {
        g = k;
        c = k / q;
      }
      walk_tile<true>(s, 1 + kRows * g, 2 + c * cols, cols, live, best, bidx, thr);
    } else if (t < p.tiles[1]) {  // full item k: tile c holds c Q items after Q c (c-1) / 2
      const int k = 32 * (t - p.tiles[0]) + lane;
      const bool live = k < p.full;
      if (live) {
        c = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)k / (float)q)) * 0.5f);
        while (q * c * (c - 1) / 2 > k) --c;
        while (q * (c + 1) * c / 2 <= k) ++c;
        g = k - q * c * (c - 1) / 2;
      }
      walk_tile<false>(s, 1 + kRows * g, 2 + c * cols, cols, live, best, bidx, thr);
    } else {  // ragged item k: group k against the last p.rag columns
      const int k = 32 * (t - p.tiles[1]) + lane;
      const bool live = k < p.ragged;
      if (live) g = k;
      walk_tile<true>(s, 1 + kRows * g, 2 + p.ctf * cols, p.rag, live, best, bidx, thr);
    }
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float best = kImprove;  // only a move below it is taken, so none above it is priced
  int bidx = INT_MAX;
  if (kMetric)
    candidate_scan(s, best, bidx);
  else
    euclid_scan(s, best, bidx);
  warp_pick<true>(best, bidx);
  float* red_v = s.red_v + s.parity * kLsWarps;
  int* red_i = s.red_i + s.parity * kLsWarps;
  int* next = s.next + s.parity;
  s.parity ^= 1;  // the next scan writes the other half while this one is read
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // every thread is past its last read of them
    if (kMetric) *s.spilled = 0;
    else *next = 0;
  }
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

// The block's state over its two buffers; the scan's plan and counters are
// set before load_ant's barriers.
__device__ Ant carve(int n, int cols, float* red_v, int* red_i, ScanPlan* plan, int* next) {
  if (threadIdx.x == 0) {
    make_plan(*plan, n, cols);
    next[0] = next[1] = 0;
  }
  return Ant{0, ant_stride(n), n, 0, 0.0f, nullptr, nullptr, false,
             nullptr, nullptr, nullptr, red_v, red_i, plan, next};
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

__global__ void __launch_bounds__(kLsThreads, 2)
    two_opt_kernel(const float* __restrict__ coords, const int64_t* __restrict__ tours,
                   int64_t* __restrict__ out, int A, int n, int max_it, int cols) {
  __shared__ float red_v[2 * kLsWarps];
  __shared__ int red_i[2 * kLsWarps];
  __shared__ ScanPlan plan;
  __shared__ int next[2];
  const long ba = blockIdx.x;  // b * A + a
  const long b = ba / A;
  Ant s = carve(n, cols, red_v, red_i, &plan, next);
  Tally tally;
  load_ant(s, coords + b * n * 2, tours + ba * n);
  edge_costs<false>(s);
  descent<false>(s, max_it, tally);
  store_ant(s, out + ba * n);
}

__global__ void __launch_bounds__(kLsThreads, 2)
    nls_kernel(const float* __restrict__ coords, const __nv_bfloat16* __restrict__ metric,
               const unsigned* __restrict__ keys, const int* __restrict__ negative,
               const int64_t* __restrict__ tours, int64_t* __restrict__ out, int A, int n,
               int max_it, int t_nls, int t_p, int cols, unsigned long long* __restrict__ counts) {
  __shared__ float red_v[2 * kLsWarps];
  __shared__ int red_i[2 * kLsWarps];
  __shared__ ScanPlan plan;
  __shared__ int next[2];
  __shared__ float cost_slot;
  __shared__ int spilled;
  const long ba = blockIdx.x;
  const long b = ba / A;
  Ant s = carve(n, cols, red_v, red_i, &plan, next);
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

// C, the columns of the Euclidean scan's tiles at n: the multiple of kRows
// in 8..64 whose scan a model ends first (the lower C on a tie). In the
// model a warp tile takes its steps, a tenth more where it checks each
// pair, and two steps of set-up, and the 16 warps take the tiles in list
// order, each as it frees. Small C wastes less at the diagonal and shares
// the tiles out more evenly; large C sets up fewer tiles.
int scan_cols(int n) {
  static int known[4097];  // 0 until computed
  if (n <= 4096 && known[n] != 0) return known[n];
  int best_cols = 8;
  double best_span = 0.0;
  for (int cols = 8; cols <= 64; cols += kRows) {
    ScanPlan p;
    make_plan(p, n, cols);
    double finish[kLsWarps] = {};
    for (int t = 0; t < p.tiles[2]; ++t) {
      int w = 0;
      for (int v = 1; v < kLsWarps; ++v)
        if (finish[v] < finish[w]) w = v;
      finish[w] += t < p.tiles[0] ? 1.1 * cols + 2.0 : t < p.tiles[1] ? cols + 2.0 : 1.1 * p.rag + 2.0;
    }
    double span = 0.0;
    for (double f : finish) span = f > span ? f : span;
    if (cols == 8 || span < best_span) {
      best_span = span;
      best_cols = cols;
    }
  }
  if (n <= 4096) known[n] = best_cols;
  return best_cols;
}

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
      coords, tours, out, A, N, max_it, scan_cols(N));
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
      negative, tours, out, A, N, max_it, t_nls, t_p, scan_cols(N), counts);
  return cudaGetLastError();
}
