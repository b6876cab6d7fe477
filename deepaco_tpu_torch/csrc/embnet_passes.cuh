// The folded EmbNet layer passes, shared by K1 (dense_heuristic.cu) and K9
// (embnet_layers.cu), the tensor-core tile routine that K1's head uses too,
// and the edge loop that K6 (gnn_layer.cu) runs with tails of its own.
// Each layer streams the edge state [rows, K, 32] f32 once through device
// memory:
//   node_pass: x1234 = x @ wv_i + bv_i, [rows, 4U], one row per thread row;
//   edge_pass: edge_loop with LayerTail. Persistent warps, each walking
//     whole nodes. A node's K edge rows go in tiles of 16 (the last one
//     masked), the 16x32 @ 32x32 product runs on the tensor cores in
//     3xTF32, the edge update is written in place and the node's aggregate
//     stays in registers until the node update, summed in a fixed order. No
//     atomics; every write is owned by one warp, and any K works.
//
// What bounds the edge pass on the H100: the edge state's bytes, read and
// written once a layer (320 MB each way at B=100, N=500, K=50). The product
// on f32 FMAs needed a shuffle and a shared load per multiply-add, and its
// instruction rate bound the pass; on the tensor cores three TF32 products
// (hi*lo, lo*hi, hi*hi, each operand split as x = hi + lo, both rounded to
// TF32) keep the f32 function at 3x the TF32 work, still well below the
// bytes. The rest of a tile's work (the split, the activations' exponentials
// and reciprocals on the special-function unit, the neighbour gathers from
// L2) runs while the next tile's rows load: a warp keeps one tile in flight,
// and an SM three blocks of four warps, as many as 168 registers allow.
//
// The tile layout: lane (g, t) = (lane >> 2, lane & 3) holds rows g and g+8
// of a tile, and of each row the 8 columns tile_col(t, j): two float4 at 4t
// and 16 + 4t. The product's k and n orders are permuted (in the weight
// fragments only) so that the mma.m16n8k8 A fragment and its f32 result
// both fall on exactly these columns: loads, the epilogue's gathers and the
// stores are 16-byte accesses in the natural row-major layout, and one
// product's output is the next one's input without any exchange.
#pragma once

#include <atomic>

#include "common.cuh"

namespace deepaco {
namespace {

constexpr int U = 32;             // hidden width
constexpr int kNodeRows = 32;     // rows per node_pass block
constexpr int kEdgeWarps = 4;     // warps per edge_pass block
constexpr int kEdgeBlocks = 3;    // edge_pass blocks an SM holds (at most 168 registers)
constexpr int kTileRows = 16;     // edge rows per tensor-core tile
constexpr int kFrags = 16;        // (k step, n tile) pairs of a 32x32 product

// The folded layer weights in the packed parameter buffer; the order
// matches ops/fused_gnn.py:_pack_layers. we_in holds E rows of U.
struct LayerParams {
  const float *we_in, *be_in, *wv, *bv, *wel, *bel, *vs, *vb, *es, *eb;
};

// Reads the layer weights from p and returns the first float after them.
inline const float* unpack_layers(const float* p, int L, int E, LayerParams& q) {
  q.we_in = p; p += (size_t)E * U;
  q.be_in = p; p += U;
  q.wv = p; p += (size_t)L * U * 4 * U;
  q.bv = p; p += (size_t)L * 4 * U;
  q.wel = p; p += (size_t)L * U * U;
  q.bel = p; p += (size_t)L * U;
  q.vs = p; p += (size_t)L * U;
  q.vb = p; p += (size_t)L * U;
  q.es = p; p += (size_t)L * U;
  q.eb = p; p += (size_t)L * U;
  return p;
}

// ------------------------------------------------------ the tile routine ---
// Column j (0..7) of the thread with t = lane & 3.
__device__ __forceinline__ int tile_col(int t, int j) { return (j & 4) * 4 + 4 * t + (j & 3); }

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding in two integer instructions, without its
// test for NaN, which the passes never hold.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// sigma(x) and silu(x) with the exponential and the reciprocal on the
// special-function unit (about 2 ulp each, far inside the kernels' checks).
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float fast_silu(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// The thread's 8 columns of a row, or of a per-feature vector.
__device__ __forceinline__ void load8(const float* __restrict__ row, int t, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 16 + 4 * t);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(float* __restrict__ row, int t, const float (&v)[8]) {
  *reinterpret_cast<float4*>(row + 4 * t) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(row + 16 + 4 * t) = make_float4(v[4], v[5], v[6], v[7]);
}

// The weight fragments of m [32 in, 32 out] (row-major; with kTransposed,
// of m^T, m given as [32 out, 32 in]) for tile_product:
// frag[(kk * 4 + nt) * 32 + lane] = {b0 hi, b1 hi, b0 lo, b1 lo} of k step
// kk and n tile nt. The block's threads fill it; the caller synchronises.
template <bool kTransposed = false>
__device__ void load_weight_frags(const float* __restrict__ m, float4* frag) {
  const auto at = [m](int in, int out) {
    return kTransposed ? m[out * U + in] : m[in * U + out];
  };
  for (int i = threadIdx.x; i < kFrags * 32; i += blockDim.x) {
    const int f = i >> 5, lane = i & 31, kk = f >> 2, nt = f & 3;
    const int g = lane >> 2, t = lane & 3;
    const int col = tile_col(g >> 1, 2 * nt + (g & 1));
    const float b0 = at(tile_col(t, 2 * kk), col);
    const float b1 = at(tile_col(t, 2 * kk + 1), col);
    const float h0 = to_tf32(b0), h1 = to_tf32(b1);
    frag[i] = make_float4(h0, h1, to_tf32(b0 - h0), to_tf32(b1 - h1));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// out = a @ m for a 16-row tile in the thread layout above (a[h][j]: row
// g + 8h, column tile_col(t, j)), in 3xTF32: a = hi + lo, each rounded to
// TF32, and a @ m = hi @ m_hi + (lo @ m_hi + hi @ m_lo), summed in f32.
// frag comes from load_weight_frags. The whole warp calls it.
__device__ __forceinline__ void tile_product(const float (&a)[2][8], const float4* frag, int lane,
                                             float (&out)[2][8]) {
  uint32_t hi[2][8], lo[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x = a[h][j], xh = to_tf32(x);
      hi[h][j] = __float_as_uint(xh);
      lo[h][j] = __float_as_uint(to_tf32(x - xh));
    }
  // per n tile, hi * hi of each k step in an accumulator of its own and the
  // small products in one more, summed last by f32 adds: a tensor-core
  // accumulation keeps fewer low bits than an f32 add, so one running sum
  // over the k steps drifts from the f32 function (scripts/compare_kernels.py
  // float64_errors holds both against float64)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float d[4][4] = {}, e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b = frag[(kk * 4 + nt) * 32 + lane];
      const int j0 = 2 * kk, j1 = 2 * kk + 1;
      mma_tf32(e, lo[0][j0], lo[1][j0], lo[0][j1], lo[1][j1], b.x, b.y);
      mma_tf32(e, hi[0][j0], hi[1][j0], hi[0][j1], hi[1][j1], b.z, b.w);
      mma_tf32(d[kk], hi[0][j0], hi[1][j0], hi[0][j1], hi[1][j1], b.x, b.y);
    }
    float sum[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[c] = ((d[0][c] + d[1][c]) + d[2][c]) + d[3][c] + e[c];
    out[0][2 * nt] = sum[0];
    out[0][2 * nt + 1] = sum[1];
    out[1][2 * nt] = sum[2];
    out[1][2 * nt + 1] = sum[3];
  }
}

// Rows g and g+8 of tile i of a node whose K edge rows start at wr and
// ids at nr: their edge state and neighbour ids (0 past K).
__device__ __forceinline__ void load_tile(const float* __restrict__ wr, const int* __restrict__ nr,
                                          int i, int k, int g, int t, float (&a)[2][8],
                                          int (&id)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = i * kTileRows + g + 8 * h;
    if (j < k) {
      load8(wr + j * U, t, a[h]);
      id[h] = nr[j];
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) a[h][c] = 0.0f;
      id[h] = 0;
    }
  }
}

// One kernel's host-side launch settings, kept per device so that a launch
// makes no runtime query after the first at its shared-memory size: the
// persistent grid's capacity (SMs x resident blocks) for the last dynamic
// shared-memory size asked for, and the largest size allowed so far.
constexpr int kMaxDevices = 64;
struct LaunchCache {
  std::atomic<unsigned long long> grid[kMaxDevices];  // smem << 32 | capacity, 0: none
  std::atomic<size_t> smem_allowed[kMaxDevices];
};

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// device, asking the runtime only when `smem` exceeds what it allowed.
template <typename Kernel>
inline cudaError_t allow_smem(LaunchCache& cache, Kernel kernel, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache.smem_allowed[dev].load(std::memory_order_relaxed) >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) {
    size_t seen = cache.smem_allowed[dev].load(std::memory_order_relaxed);
    while (seen < smem && !cache.smem_allowed[dev].compare_exchange_weak(seen, smem)) {
    }
  }
  return err;
}

// A persistent grid: one block per work unit, at most as many as fit on
// the card at once.
template <typename Kernel>
inline unsigned persistent_grid(LaunchCache& cache, Kernel kernel, int threads, size_t smem,
                                long units) {
  int dev = 0;
  cudaGetDevice(&dev);
  const unsigned long long key = (unsigned long long)smem << 32;
  unsigned long long cap = 0;
  if (dev < kMaxDevices) {
    const unsigned long long v = cache.grid[dev].load(std::memory_order_relaxed);
    if (v != 0 && (v & ~0xffffffffull) == key) cap = v & 0xffffffffull;
  }
  if (cap == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    cap = (unsigned long long)sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) cache.grid[dev].store(key | cap, std::memory_order_relaxed);
  }
  return (unsigned)(units < (long)cap ? units : (long)cap);
}

// ---------------------------------------------------------- the passes ---
__global__ void node_pass_kernel(const float* __restrict__ x, float* __restrict__ x1234,
                                 const float* __restrict__ wv, const float* __restrict__ bv,
                                 long rows) {
  __shared__ float ws[U * 4 * U];
  __shared__ float xs[kNodeRows][U];
  const int j = threadIdx.x;  // output column, blockDim.x == 4U
  for (int t = j; t < U * 4 * U; t += 4 * U) ws[t] = wv[t];
  const long r0 = (long)blockIdx.x * kNodeRows;
  for (int t = j; t < kNodeRows * U; t += 4 * U) {
    const long r = r0 + t / U;
    xs[t / U][t % U] = r < rows ? x[r * U + t % U] : 0.0f;
  }
  __syncthreads();
  const float bj = bv[j];
  for (int q = 0; q < kNodeRows; ++q) {
    const long r = r0 + q;
    if (r >= rows) break;
    float acc = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) acc = fmaf(xs[q][u], ws[u * 4 * U + j], acc);
    x1234[r * 4 * U + j] = acc + bj;
  }
}

// ------------------------------------------------------- the edge loop ---
// The loop of every edge pass (K1's and K9's layer pass; K6's forward, row
// 8 and K6's backward edge pass): persistent warps, warp after warp of the
// grid taking row r, r + warps, ...; a row's K edge rows go in tiles of 16
// (the last one masked), whose operand rows `a` and neighbour ids are
// loaded one tile ahead of the compute (a tail may write the operand in
// place: each row is read once, before its tile is written). Per tile, the
// tail first fetches what each edge row needs beside its operand (neighbour
// rows, from L2; a second stream's row), then the tile's 32x32 product
// a @ m runs on the tensor cores (tile_product on frag, when the tail has
// one) while those loads are in flight, and the tail takes each edge row in
// turn. Every write is the row's warp's own: no atomics, and any K works.
//
// A Tail holds the row's registers and provides
//   static constexpr bool kProduct;  // whether the tile product runs
//   void begin(long r, int t);       // row r's registers, before its tiles
//   void fetch(long r, int j, int id, int t, float (&v)[2][8]);
//                                    // edge j of r (neighbour id): its rows
//   void edge(long r, int j, int t, const float (&a)[8],
//             const float (&acc)[8], const float (&v)[2][8]);
//                                    // edge j's epilogue (acc = a @ m)
//   void end(long r, int g, int t);  // after r's last tile
// All of it is inlined: a tail's fields live in registers.
template <class Tail>
__device__ __forceinline__ void edge_loop(Tail& tail, const float* a_rows,
                                          const int* __restrict__ nbr, const float4* frag,
                                          long rows, int k) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long warps = (long)gridDim.x * kEdgeWarps;
  const int tiles = (k + kTileRows - 1) / kTileRows;
  const long first = (long)blockIdx.x * kEdgeWarps + (threadIdx.x >> 5);
  // the load cursor runs one tile ahead of the compute loop
  long lr = first;
  int li = 0;
  float nw[2][8];
  int nid[2];
  if (lr < rows) load_tile(a_rows + lr * k * U, nbr + lr * k, 0, k, g, t, nw, nid);
  for (long cr = first; cr < rows; cr += warps) {
    tail.begin(cr, t);
    for (int ci = 0; ci < tiles; ++ci) {
      float a[2][8];
      int id[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        id[h] = nid[h];
#pragma unroll
        for (int c = 0; c < 8; ++c) a[h][c] = nw[h][c];
      }
      if (++li == tiles) {
        li = 0;
        lr += warps;
      }
      if (lr < rows) load_tile(a_rows + lr * k * U, nbr + lr * k, li, k, g, t, nw, nid);
      // the tail's rows, loaded before the product runs
      float v[2][2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = ci * kTileRows + g + 8 * h;
        if (j < k) tail.fetch(cr, j, id[h], t, v[h]);
      }
      float acc[2][8];
      if constexpr (Tail::kProduct) tile_product(a, frag, lane, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = ci * kTileRows + g + 8 * h;
        if (j < k) tail.edge(cr, j, t, a[h], acc[h], v[h]);
      }
    }
    tail.end(cr, g, t);
  }
}

// The sum over lanes g = 0..7 (the 8 row pairs of a tile) of each of the
// thread's 8 columns, in a fixed butterfly: every lane ends with the total.
__device__ __forceinline__ void sum_over_rows(float (&v)[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) v[c] += __shfl_xor_sync(kFullMask, v[c], off);
}

// The folded layer's edge and node update: w[r, :, :] and x[r] are read and
// written only by r's warp; x1234 holds the layer's input node state for
// the gathers, so both updates see the old state without a second x buffer.
struct LayerTail {
  static constexpr bool kProduct = true;  // acc = w @ wel
  float* x;
  const float* x1234;
  float* w;
  const float *bel, *vs, *vb;
  const float (*affine)[U];  // es, eb, in shared memory
  int n, k, node_update;
  const float* inst;  // x1234's rows of r's instance
  float base[8], agg[8];

  __device__ __forceinline__ void begin(long r, int t) {
    inst = x1234 + (r / n) * n * 4 * U;
    float bel8[8];
    load8(x1234 + r * 4 * U + 2 * U, t, base);  // x3 + bel
    load8(bel, t, bel8);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      base[c] += bel8[c];
      agg[c] = 0.0f;
    }
  }
  __device__ __forceinline__ void fetch(long, int, int id, int t, float (&v)[2][8]) {
    const float* xc = inst + id * 4 * U;  // the neighbour's x2 and x4
    load8(xc + U, t, v[0]);
    load8(xc + 3 * U, t, v[1]);
  }
  __device__ __forceinline__ void edge(long r, int j, int t, const float (&a)[8],
                                       const float (&acc)[8], const float (&v)[2][8]) {
    float es8[8], eb8[8], out[8];
    load8(affine[0], t, es8);
    load8(affine[1], t, eb8);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float pre = acc[c] + base[c] + v[1][c];  // + x4[nbr]
      agg[c] += fast_sigmoid(a[c]) * v[0][c];        // sigma(w0) * x2[nbr]
      out[c] = a[c] + fast_silu(pre * es8[c] + eb8[c]);
    }
    store8(w + (r * k + j) * U, t, out);
  }
  __device__ __forceinline__ void end(long r, int g, int t) {
    if (!node_update) return;
    sum_over_rows(agg);
    if (g == 0) {
      float x1[8], xv[8], vs8[8], vb8[8];
      load8(x1234 + r * 4 * U, t, x1);
      load8(x + r * U, t, xv);
      load8(vs, t, vs8);
      load8(vb, t, vb8);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        xv[c] += siluf_((x1[c] + agg[c] * (1.0f / k)) * vs8[c] + vb8[c]);
      store8(x + r * U, t, xv);
    }
  }
};

__global__ void __launch_bounds__(kEdgeWarps * 32, kEdgeBlocks)
edge_pass_kernel(float* __restrict__ x, const float* __restrict__ x1234,
                 const int* __restrict__ nbr, float* __restrict__ w,
                 const float* __restrict__ wel, const float* __restrict__ bel,
                 const float* __restrict__ vs, const float* __restrict__ vb,
                 const float* __restrict__ es, const float* __restrict__ eb, long rows, int n,
                 int k, int node_update) {
  __shared__ float4 frag[kFrags * 32];
  __shared__ __align__(16) float affine[2][U];  // es, eb
  load_weight_frags(wel, frag);
  if (threadIdx.x < U) {
    affine[0][threadIdx.x] = es[threadIdx.x];
    affine[1][threadIdx.x] = eb[threadIdx.x];
  }
  __syncthreads();
  LayerTail tail{x, x1234, w, bel, vs, vb, affine, n, k, node_update};
  edge_loop(tail, w, nbr, frag, rows, k);
}

// The L layers on the caller's stream: x [rows, U] holds the node state
// (updated in place), w [rows, K, U] the edge state, x1234 [rows, 4U] is
// scratch and nbr [rows, K] holds ids within each instance of N rows.
inline cudaError_t run_layers(float* x, float* x1234, const int* nbr, float* w,
                              const LayerParams& p, long rows, int N, int K, int L,
                              int node_update, cudaStream_t s) {
  static LaunchCache edge_launch;
  const unsigned edge_blocks = persistent_grid(edge_launch, edge_pass_kernel, kEdgeWarps * 32, 0,
                                               (rows + kEdgeWarps - 1) / kEdgeWarps);
  for (int i = 0; i < L; ++i) {
    node_pass_kernel<<<(unsigned)((rows + kNodeRows - 1) / kNodeRows), 4 * U, 0, s>>>(
        x, x1234, p.wv + (size_t)i * U * 4 * U, p.bv + (size_t)i * 4 * U, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    edge_pass_kernel<<<edge_blocks, kEdgeWarps * 32, 0, s>>>(
        x, x1234, nbr, w, p.wel + (size_t)i * U * U, p.bel + (size_t)i * U, p.vs + (size_t)i * U,
        p.vb + (size_t)i * U, p.es + (size_t)i * U, p.eb + (size_t)i * U, rows, N, K,
        node_update);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace deepaco
