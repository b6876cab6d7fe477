// K6: the gather phase of one EmbNet layer, forward and backward, in f32.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:203 fused_gnn_layer_pallas
// (Pallas kernel _fused_layer_kernel, 156-185) and the backward of its custom
// VJP fused_gnn_layer_ad (_fused_ad_bwd, 290-306); with the pre output
// compiled out, also pallas_kernels.py:114 gated_mean_aggregate_pallas
// (_aggregate_kernel, 94-111). The TPU fetched x2[nbr] and x4[nbr] by one-hot
// MXU products against VMEM-resident node tables and halved its row tile to
// fit VMEM; on the H100 the node tables ([N, 32] f32, 64 KB an instance) sit
// in L2 and a neighbour row is one coalesced 128-byte load.
//
// What bounds it: bytes. At B=20, N=500, K=50 the edge state w and the
// output pre are 64 MB each and the edge products w @ ew are 1 GFLOP, so the
// forward needs 40 us of memory time against 15 us of f32 FMAs; the backward
// reads w and d_pre and writes d_w, 192 MB. The design streams each edge's
// 32 features once, one feature per lane, and keeps ew in shared memory:
// an edge's product is 32 shuffles and FMAs. Nothing is written twice and no
// write is shared, so there are no atomics and every result is the same from
// run to run.
//
// Layout: x2, x3, x4 [B, N, U]; nbr [B, R, K] int32 (ids within the
// instance); w, pre, d_pre, d_w [B, R, K, U]; ew [U, U] in the Flax [in, out]
// orientation, eb [U]. R = N for the layer.
//   fwd (one block per row, warps over the row's edges):
//     agg[r] = (sum_k sigmoid(w[r,k]) * x2[nbr[r,k]]) / K
//     pre[r,k] = ((w[r,k] @ ew + eb) + x3[r]) + x4[nbr[r,k]]
//   bwd edge pass (one block per row):
//     d_w[r,k] = (d_agg[r] / K) * x2[nbr[r,k]] * s * (1 - s) + d_pre[r,k] @ ew^T,
//     s = sigmoid(w[r,k]);  d_x3[r] = sum_k d_pre[r,k]
//   bwd node pass (one warp per node j, over the CSR of incoming edges, in
//   increasing edge order):
//     d_x2[j] = sum_{e -> j} sigmoid(w[e]) * (d_agg[src(e)] / K)
//     d_x4[j] = sum_{e -> j} d_pre[e]
#include "common.cuh"

namespace deepaco {
namespace {

constexpr int U = 32;           // hidden width (one feature per lane)
constexpr int kRowWarps = 8;    // warps per row block
constexpr int kNodeWarps = 8;   // nodes per node-pass block

template <bool kWritePre>
__global__ void layer_fwd_kernel(const float* __restrict__ x2, const float* __restrict__ x3,
                                 const float* __restrict__ x4, const int* __restrict__ nbr,
                                 const float* __restrict__ w, const float* __restrict__ ew,
                                 const float* __restrict__ eb, float* __restrict__ agg,
                                 float* __restrict__ pre, int R, int N, int K) {
  __shared__ float ew_s[U * U];
  __shared__ float part[kRowWarps][U];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = blockIdx.x;             // b * R + i
  const long node0 = (row / R) * N;        // the instance's first node
  float ebl = 0.0f, x3l = 0.0f;
  if (kWritePre) {
    for (int t = threadIdx.x; t < U * U; t += blockDim.x) ew_s[t] = ew[t];
    ebl = eb[lane];
    x3l = x3[row * U + lane];
  }
  __syncthreads();
  float acc = 0.0f;
  for (int j = warp; j < K; j += kRowWarps) {
    const long e = row * K + j;
    const long c = (node0 + nbr[e]) * U + lane;
    const float w0 = w[e * U + lane];
    acc += sigmoidf_(w0) * x2[c];
    if (kWritePre) {
      float lin = 0.0f;
#pragma unroll
      for (int v = 0; v < U; ++v) lin = fmaf(__shfl_sync(kFullMask, w0, v), ew_s[v * U + lane], lin);
      pre[e * U + lane] = ((lin + ebl) + x3l) + x4[c];
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float a = 0.0f;
#pragma unroll
    for (int q = 0; q < kRowWarps; ++q) a += part[q][lane];
    agg[row * U + lane] = a / (float)K;
  }
}

__global__ void layer_bwd_edge_kernel(const float* __restrict__ x2, const int* __restrict__ nbr,
                                      const float* __restrict__ w, const float* __restrict__ ew,
                                      const float* __restrict__ d_agg,
                                      const float* __restrict__ d_pre, float* __restrict__ d_w,
                                      float* __restrict__ d_x3, int N, int K) {
  __shared__ float ewt_s[U * U];  // ewt_s[u * U + v] = ew[v * U + u]: lane v reads a row
  __shared__ float part[kRowWarps][U];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = blockIdx.x;     // b * N + i
  const long node0 = (row / N) * N;
  for (int t = threadIdx.x; t < U * U; t += blockDim.x) ewt_s[(t % U) * U + t / U] = ew[t];
  __syncthreads();
  const float dg = d_agg[row * U + lane] / (float)K;
  float dx3 = 0.0f;
  for (int j = warp; j < K; j += kRowWarps) {
    const long e = row * K + j;
    const float w0 = w[e * U + lane];
    const float dp = d_pre[e * U + lane];
    const float s = sigmoidf_(w0);
    float lin = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) lin = fmaf(__shfl_sync(kFullMask, dp, u), ewt_s[u * U + lane], lin);
    const float x2n = x2[(node0 + nbr[e]) * U + lane];
    d_w[e * U + lane] = dg * x2n * s * (1.0f - s) + lin;
    dx3 += dp;
  }
  part[warp][lane] = dx3;
  __syncthreads();
  if (warp == 0) {
    float a = 0.0f;
#pragma unroll
    for (int q = 0; q < kRowWarps; ++q) a += part[q][lane];
    d_x3[row * U + lane] = a;
  }
}

__global__ void layer_bwd_node_kernel(const int* __restrict__ offsets, const int* __restrict__ edges,
                                      const float* __restrict__ w, const float* __restrict__ d_agg,
                                      const float* __restrict__ d_pre, float* __restrict__ d_x2,
                                      float* __restrict__ d_x4, long nodes, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long node = (long)blockIdx.x * kNodeWarps + warp;  // b * N + j
  if (node >= nodes) return;
  const long b = node / N;
  const int j = (int)(node % N);
  const int* off = offsets + b * (N + 1);
  const int* in = edges + b * (long)N * K;
  const long e0 = b * (long)N * K;  // the instance's first edge
  float a2 = 0.0f, a4 = 0.0f;
  for (int t = off[j]; t < off[j + 1]; ++t) {
    const int f = in[t];              // i * K + k
    const long e = (e0 + f) * U + lane;
    const long src = (b * N + f / K) * U + lane;
    a2 += sigmoidf_(w[e]) * (d_agg[src] / (float)K);
    a4 += d_pre[e];
  }
  d_x2[node * U + lane] = a2;
  d_x4[node * U + lane] = a4;
}

}  // namespace
}  // namespace deepaco

// Forward over B instances of R rows (x2 [B,N,U], nbr [B,R,K]) -> agg
// [B,R,U] and, when write_pre, pre [B,R,K,U]; x3, x4, ew, eb and pre are
// read only when write_pre.
extern "C" int deepaco_gnn_layer_fwd(const float* x2, const float* x3, const float* x4,
                                     const int* nbr, const float* w, const float* ew,
                                     const float* eb, float* agg, float* pre, int B, int R,
                                     int N, int K, int write_pre, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned rows = (unsigned)((long)B * R);
  if (write_pre) {
    layer_fwd_kernel<true><<<rows, kRowWarps * 32, 0, s>>>(x2, x3, x4, nbr, w, ew, eb, agg, pre,
                                                           R, N, K);
  } else {
    layer_fwd_kernel<false><<<rows, kRowWarps * 32, 0, s>>>(x2, x3, x4, nbr, w, ew, eb, agg,
                                                            pre, R, N, K);
  }
  return cudaGetLastError();
}

// Backward of the layer over B instances of N rows: d_w [B,N,K,U] and d_x3
// [B,N,U] by the edge pass, then d_x2, d_x4 [B,N,U] by the node pass over
// the reverse adjacency (offsets [B,N+1], edges [B,N*K]).
extern "C" int deepaco_gnn_layer_bwd(const float* x2, const int* nbr, const int* offsets,
                                     const int* edges, const float* w, const float* ew,
                                     const float* d_agg, const float* d_pre, float* d_w,
                                     float* d_x3, float* d_x2, float* d_x4, int B, int N, int K,
                                     void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long nodes = (long)B * N;
  layer_bwd_edge_kernel<<<(unsigned)nodes, kRowWarps * 32, 0, s>>>(x2, nbr, w, ew, d_agg, d_pre,
                                                                   d_w, d_x3, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_bwd_node_kernel<<<(unsigned)((nodes + kNodeWarps - 1) / kNodeWarps), kNodeWarps * 32, 0,
                          s>>>(offsets, edges, w, d_agg, d_pre, d_x2, d_x4, nodes, N, K);
  return cudaGetLastError();
}
