// The folded EmbNet layer passes, shared by K1 (dense_heuristic.cu) and K9
// (embnet_layers.cu). Each layer streams the edge state [rows, K, 32] f32
// once through device memory:
//   node_pass: x1234 = x @ wv_i + bv_i, [rows, 4U], one row per thread row;
//   edge_pass: one block per node, one warp per edge and one feature per
//     lane: the edge update in place and the node update from the layer's
//     input state. The K loop strides over the block's warps and keeps no
//     edge row in shared memory, so any K works.
#pragma once

#include "common.cuh"

namespace deepaco {
namespace {

constexpr int U = 32;             // hidden width (one feature per lane)
constexpr int kNodeRows = 32;     // rows per node_pass block
constexpr int kEdgeWarps = 8;     // warps per edge_pass block

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

// The L layers on the caller's stream: x [rows, U] holds the node state
// (updated in place), w [rows, K, U] the edge state, x1234 [rows, 4U] is
// scratch and nbr [rows, K] holds ids within each instance of N rows.
inline cudaError_t run_layers(float* x, float* x1234, const int* nbr, float* w,
                              const LayerParams& p, long rows, int N, int K, int L,
                              int node_update, cudaStream_t s) {
  for (int i = 0; i < L; ++i) {
    node_pass_kernel<<<(unsigned)((rows + kNodeRows - 1) / kNodeRows), 4 * U, 0, s>>>(
        x, x1234, p.wv + (size_t)i * U * 4 * U, p.bv + (size_t)i * 4 * U, rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    edge_pass_kernel<<<(unsigned)rows, kEdgeWarps * 32, 0, s>>>(
        x, x1234, nbr, w, p.wel + (size_t)i * U * U, p.bel + (size_t)i * U, p.vs + (size_t)i * U,
        p.vb + (size_t)i * U, p.es + (size_t)i * U, p.eb + (size_t)i * U, N, K, node_update);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace deepaco
