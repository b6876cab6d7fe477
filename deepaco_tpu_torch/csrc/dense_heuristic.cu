// K1: distance matrix -> dense neural heuristic, in f32.
//
// Replaces deepaco_tpu/ops/fused_gnn.py:416 tsp_dense_heuristic (Pallas
// kernel _dense_kernel, 304-400, with _layer_stack 171-239). On the TPU one
// grid cell per instance kept the whole edge state in VMEM and gathered by
// one-hot MXU contractions. On the H100 the edge state ([B, N, K, 32] f32,
// 320 MB at B=100, N=500, K=50) does not fit on chip, so each layer streams
// it once through device memory and the neighbour gathers are direct loads
// from L2. What bounds it: the f32 FMAs of the per-edge 32x32 products
// (e_lins0 each layer, two head layers) and the edge-state traffic of 12
// layers. The design keeps each edge's 32 features in one warp, one feature
// per lane: a product is 32 shuffles and FMAs against weights in shared
// memory, with no atomics and every write owned by one block.
//
// Phases, all on the caller's stream:
//   (a) knn_elin0: one warp per row takes the K smallest distances by
//       (value, index), the lowest index winning, and writes
//       nbr and w = silu(d * we_in + be_in);
//   (b) node_pass, each layer: x1234 = x @ wv_i + bv_i, [rows, 4U];
//   (c) edge_pass, each layer, one block per node: the edge update in place
//       and the node update from the layer's input state;
//   (d) head: the 32->32->32->1 MLP and sigmoid per edge, then the dense
//       row written in full: fill off the support, o + fill on it.
#include "common.cuh"

namespace deepaco {
namespace {

constexpr int U = 32;             // hidden width (one feature per lane)
constexpr int kKnnWarps = 4;      // rows per knn block
constexpr int kNodeRows = 32;     // rows per node_pass block
constexpr int kEdgeWarps = 8;     // warps per edge_pass / head block

// Offsets of the folded weights in the packed parameter buffer; the order
// matches ops/fused_gnn.py:_pack_params.
struct Params {
  const float *we_in, *be_in, *wv, *bv, *wel, *bel, *vs, *vb, *es, *eb;
  const float *h0, *hb0, *h1, *hb1, *h2, *hb2;
};

Params unpack(const float* p, int L) {
  Params q;
  q.we_in = p; p += U;
  q.be_in = p; p += U;
  q.wv = p; p += (size_t)L * U * 4 * U;
  q.bv = p; p += (size_t)L * 4 * U;
  q.wel = p; p += (size_t)L * U * U;
  q.bel = p; p += (size_t)L * U;
  q.vs = p; p += (size_t)L * U;
  q.vb = p; p += (size_t)L * U;
  q.es = p; p += (size_t)L * U;
  q.eb = p; p += (size_t)L * U;
  q.h0 = p; p += U * U;
  q.hb0 = p; p += U;
  q.h1 = p; p += U * U;
  q.hb1 = p; p += U;
  q.h2 = p; p += U;
  q.hb2 = p;
  return q;
}

__global__ void knn_elin0_kernel(const float* __restrict__ dist, int* __restrict__ nbr,
                                 float* __restrict__ w, const float* __restrict__ we_in,
                                 const float* __restrict__ be_in, long rows, int n, int k) {
  extern __shared__ float srow[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kKnnWarps + warp;
  if (row >= rows) return;  // only warp-level synchronisation below
  float* d = srow + (size_t)warp * n;
  const float* src = dist + row * n;
  for (int c = lane; c < n; c += 32) d[c] = src[c];
  __syncwarp();
  const float wi = we_in[lane], bi = be_in[lane];
  for (int j = 0; j < k; ++j) {
    float best = INFINITY;
    int bidx = n;
    for (int c = lane; c < n; c += 32) {  // ascending c: the lane's first minimum
      const float v = d[c];
      if (v < best) {
        best = v;
        bidx = c;
      }
    }
    warp_pick<true>(best, bidx);
    __syncwarp();
    if (lane == 0) {
      nbr[row * k + j] = bidx;
      d[bidx] = INFINITY;  // taken; real distances are finite
    }
    __syncwarp();
    w[(row * k + j) * U + lane] = siluf_(best * wi + bi);
  }
}

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

// One block per node r. w[r, :, :] is read and written only here, and x[r]
// too; x1234 holds the layer's input node state for the gathers, so both
// updates see the old state without a second x buffer.
__global__ void edge_pass_kernel(float* __restrict__ x, const float* __restrict__ x1234,
                                 const int* __restrict__ nbr, float* __restrict__ w,
                                 const float* __restrict__ wel, const float* __restrict__ bel,
                                 const float* __restrict__ vs, const float* __restrict__ vb,
                                 const float* __restrict__ es, const float* __restrict__ eb,
                                 int n, int k, int node_update) {
  __shared__ float wel_s[U * U];
  __shared__ float agg_s[kEdgeWarps][U];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r = blockIdx.x;
  const long inst0 = (r / n) * n;  // first row of this instance
  for (int t = threadIdx.x; t < U * U; t += blockDim.x) wel_s[t] = wel[t];
  __syncthreads();
  const float* xr = x1234 + r * 4 * U;
  const float base = xr[2 * U + lane] + bel[lane];  // x3 + bel
  const float esu = es[lane], ebu = eb[lane];
  float agg = 0.0f;
  for (int j = warp; j < k; j += kEdgeWarps) {
    const long e = r * k + j;
    const float* xc = x1234 + (inst0 + nbr[e]) * 4 * U;
    const float w0 = w[e * U + lane];
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < U; ++v) acc = fmaf(__shfl_sync(kFullMask, w0, v), wel_s[v * U + lane], acc);
    const float pre = acc + base + xc[3 * U + lane];  // + x4[nbr]
    agg += sigmoidf_(w0) * xc[U + lane];              // sigma(w0) * x2[nbr]
    w[e * U + lane] = w0 + siluf_(pre * esu + ebu);
  }
  if (node_update) {
    agg_s[warp][lane] = agg;
    __syncthreads();
    if (warp == 0) {
      float a = 0.0f;
#pragma unroll
      for (int q = 0; q < kEdgeWarps; ++q) a += agg_s[q][lane];
      const float pre_v = (xr[lane] + a * (1.0f / k)) * vs[lane] + vb[lane];
      x[r * U + lane] += siluf_(pre_v);
    }
  }
}

__global__ void head_kernel(const float* __restrict__ w, const int* __restrict__ nbr,
                            const float* __restrict__ h0, const float* __restrict__ hb0,
                            const float* __restrict__ h1, const float* __restrict__ hb1,
                            const float* __restrict__ h2, const float* __restrict__ hb2,
                            float* __restrict__ heu, int n, int k, float fill) {
  extern __shared__ float smem[];
  float* h0s = smem;
  float* h1s = smem + U * U;
  float* row = smem + 2 * U * U;
  float* os = row + n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long r = blockIdx.x;
  for (int t = threadIdx.x; t < U * U; t += blockDim.x) {
    h0s[t] = h0[t];
    h1s[t] = h1[t];
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) row[c] = fill;
  __syncthreads();
  const float b0 = hb0[lane], b1 = hb1[lane], w2 = h2[lane], b2 = hb2[0];
  for (int j = warp; j < k; j += kEdgeWarps) {
    const float w0 = w[(r * k + j) * U + lane];
    float a = 0.0f;
#pragma unroll
    for (int v = 0; v < U; ++v) a = fmaf(__shfl_sync(kFullMask, w0, v), h0s[v * U + lane], a);
    const float h = siluf_(a + b0);
    a = 0.0f;
#pragma unroll
    for (int v = 0; v < U; ++v) a = fmaf(__shfl_sync(kFullMask, h, v), h1s[v * U + lane], a);
    const float o = warp_sum(siluf_(a + b1) * w2);
    if (lane == 0) os[j] = sigmoidf_(o + b2);
  }
  __syncthreads();
  // k-NN columns of a row are distinct, so these writes never collide
  for (int j = threadIdx.x; j < k; j += blockDim.x) row[nbr[r * k + j]] = os[j] + fill;
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) heu[r * n + c] = row[c];
}

}  // namespace
}  // namespace deepaco

// dist [B,N,N] f32 -> heu [B,N,N] f32. x [B,N,U] holds silu(v_lin0(x_in)) on
// entry and the final node state on exit; x1234 [B,N,4U], nbr [B,N,K] and
// w [B,N,K,U] are scratch owned by the caller.
extern "C" int deepaco_dense_heuristic(const float* dist, float* x, float* x1234, int* nbr,
                                       float* w, const float* params, float* heu, int B, int N,
                                       int K, int L, int node_update, float fill, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Params p = unpack(params, L);
  const long rows = (long)B * N;
  knn_elin0_kernel<<<(unsigned)((rows + kKnnWarps - 1) / kKnnWarps), kKnnWarps * 32,
                     kKnnWarps * N * sizeof(float), s>>>(dist, nbr, w, p.we_in, p.be_in, rows, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int i = 0; i < L; ++i) {
    node_pass_kernel<<<(unsigned)((rows + kNodeRows - 1) / kNodeRows), 4 * U, 0, s>>>(
        x, x1234, p.wv + (size_t)i * U * 4 * U, p.bv + (size_t)i * 4 * U, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    edge_pass_kernel<<<(unsigned)rows, kEdgeWarps * 32, 0, s>>>(
        x, x1234, nbr, w, p.wel + (size_t)i * U * U, p.bel + (size_t)i * U, p.vs + (size_t)i * U,
        p.vb + (size_t)i * U, p.es + (size_t)i * U, p.eb + (size_t)i * U, N, K, node_update);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  head_kernel<<<(unsigned)rows, kEdgeWarps * 32, (2 * U * U + N + K) * sizeof(float), s>>>(
      w, nbr, p.h0, p.hb0, p.h1, p.hb1, p.h2, p.hb2, heu, N, K, fill);
  return cudaGetLastError();
}
