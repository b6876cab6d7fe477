// K6: the gather phase of one EmbNet layer, forward and backward, in f32.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:203 fused_gnn_layer_pallas
// (Pallas kernel _fused_layer_kernel, 156-185) and the backward of its custom
// VJP fused_gnn_layer_ad (_fused_ad_bwd, 290-306); with the pre output
// compiled out, also pallas_kernels.py:114 gated_mean_aggregate_pallas
// (_aggregate_kernel, 94-111). The TPU fetched x2[nbr] and x4[nbr] by one-hot
// MXU products against VMEM-resident node tables and halved its row tile to
// fit VMEM; on the H100 the node tables ([N, 32] f32, 64 KB an instance) sit
// in L2 and a neighbour row is a direct load.
//
// What bounds it: bytes. At B=20, N=500, K=50 the edge state w and the
// output pre are 64 MB each and the edge products w @ ew are 1 GFLOP, so the
// forward needs 40 us of memory time; the backward reads w and d_pre and
// writes d_w, 192 MB. A product on f32 FMAs costs a shuffle and a shared
// load per multiply-add, and that instruction rate, not the bytes, bound
// the first design (a block of 8 warps a row, a warp an edge). So the edge
// passes run K1's and K9's edge loop (embnet_passes.cuh: persistent warps
// owning whole rows, 16-edge tiles loaded a tile ahead, the 32x32 products
// on mma.sync in 3xTF32, the f32 function) with tails of their own. The
// backward's node pass re-reads w and d_pre (its design floor: 320 MB at
// that shape) with 8 incoming edges in flight a warp. Nothing is written
// twice and no write is shared, so there are no atomics and every result is
// the same from run to run.
//
// Layout: x2, x3, x4 [B, N, U]; nbr [B, R, K] int32 (ids within the
// instance); w, pre, d_pre, d_w [B, R, K, U]; ew [U, U] in the Flax [in, out]
// orientation, eb [U]. R = N for the layer; R < N on a row shard
// (parallel/gnn_shard.py), where x3, w, nbr, agg and pre hold the shard's
// rows (row r of instance r / R) and x2, x4 the instance's N nodes.
//   fwd (edge_loop, FwdTail; the product acc = w @ ew):
//     agg[r] = (sum_k sigmoid(w[r,k]) * x2[nbr[r,k]]) / K
//     pre[r,k] = ((acc + eb) + x3[r]) + x4[nbr[r,k]]
//   bwd edge pass (edge_loop on d_pre, BwdEdgeTail; acc = d_pre @ ew^T):
//     d_w[r,k] = (d_agg[r] / K) * x2[nbr[r,k]] * s * (1 - s) + acc,
//     s = sigmoid(w[r,k]);  d_x3[r] = sum_k d_pre[r,k]
//   bwd node pass (a warp a node j, over the CSR of incoming edges in
//   increasing edge order, 8 edges a step):
//     d_x2[j] = (sum_{e -> j} sigmoid(w[e]) * d_agg[src(e)]) / K
//     d_x4[j] = sum_{e -> j} d_pre[e]
#include "embnet_passes.cuh"

namespace deepaco {
namespace {

constexpr int kNodeWarps = 8;   // nodes per node-pass block
constexpr int kNodeSlots = 4;   // edges a warp loads at once: 8 lanes a row, a float4 each

// The forward's tail. Row 8 (gated_mean_aggregate) is kWritePre = false:
// no product, no x3 or x4, agg alone.
template <bool kWritePre>
struct FwdTail {
  static constexpr bool kProduct = kWritePre;  // acc = w @ ew
  const float *x2, *x3, *x4;
  float *agg, *pre;
  const float* eb;  // in shared memory
  int R, N, K;
  const float *x2i, *x4i;  // the node tables of r's instance
  float x3r[8], sum[8];

  __device__ __forceinline__ void begin(long r, int t) {
    const long node0 = (r / R) * N;
    x2i = x2 + node0 * U;
    if constexpr (kWritePre) {
      x4i = x4 + node0 * U;
      load8(x3 + r * U, t, x3r);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) sum[c] = 0.0f;
  }
  __device__ __forceinline__ void fetch(long, int, int id, int t, float (&v)[2][8]) {
    load8(x2i + id * U, t, v[0]);
    if constexpr (kWritePre) load8(x4i + id * U, t, v[1]);
  }
  __device__ __forceinline__ void edge(long r, int j, int t, const float (&a)[8],
                                       const float (&acc)[8], const float (&v)[2][8]) {
#pragma unroll
    for (int c = 0; c < 8; ++c) sum[c] += fast_sigmoid(a[c]) * v[0][c];
    if constexpr (kWritePre) {
      float eb8[8], out[8];
      load8(eb, t, eb8);
#pragma unroll
      for (int c = 0; c < 8; ++c) out[c] = ((acc[c] + eb8[c]) + x3r[c]) + v[1][c];
      store8(pre + (r * K + j) * U, t, out);
    }
  }
  __device__ __forceinline__ void end(long r, int g, int t) {
    sum_over_rows(sum);
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < 8; ++c) sum[c] = sum[c] / (float)K;
      store8(agg + r * U, t, sum);
    }
  }
};

// The backward edge pass's tail: the loop's operand is d_pre, its product
// d_pre @ ew^T; w's row and x2[nbr] are fetched beside it. The sigmoid is
// the exact one: s * (1 - s) loses the digits of s near 1.
struct BwdEdgeTail {
  static constexpr bool kProduct = true;
  const float *x2, *w, *d_agg;
  float *d_w, *d_x3;
  int N, K;
  const float* x2i;  // x2 of r's instance
  float dg[8], dx3[8];

  __device__ __forceinline__ void begin(long r, int t) {
    x2i = x2 + (r / N) * N * U;
    load8(d_agg + r * U, t, dg);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      dg[c] = dg[c] / (float)K;
      dx3[c] = 0.0f;
    }
  }
  __device__ __forceinline__ void fetch(long r, int j, int id, int t, float (&v)[2][8]) {
    load8(w + (r * K + j) * U, t, v[0]);
    load8(x2i + id * U, t, v[1]);
  }
  __device__ __forceinline__ void edge(long r, int j, int t, const float (&a)[8],
                                       const float (&acc)[8], const float (&v)[2][8]) {
    float out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float s = sigmoidf_(v[0][c]);
      out[c] = dg[c] * v[1][c] * s * (1.0f - s) + acc[c];
      dx3[c] += a[c];
    }
    store8(d_w + (r * K + j) * U, t, out);
  }
  __device__ __forceinline__ void end(long r, int g, int t) {
    sum_over_rows(dx3);
    if (g == 0) store8(d_x3 + r * U, t, dx3);
  }
};

template <bool kWritePre>
__global__ void __launch_bounds__(kEdgeWarps * 32, kEdgeBlocks)
layer_fwd_kernel(const float* __restrict__ x2, const float* __restrict__ x3,
                 const float* __restrict__ x4, const int* __restrict__ nbr,
                 const float* __restrict__ w, const float* __restrict__ ew,
                 const float* __restrict__ eb, float* __restrict__ agg,
                 float* __restrict__ pre, long rows, int R, int N, int K) {
  __shared__ float4 frag[kFrags * 32];
  __shared__ __align__(16) float eb_s[U];
  if constexpr (kWritePre) {
    load_weight_frags(ew, frag);
    if (threadIdx.x < U) eb_s[threadIdx.x] = eb[threadIdx.x];
    __syncthreads();
  }
  FwdTail<kWritePre> tail{x2, x3, x4, agg, pre, eb_s, R, N, K};
  edge_loop(tail, w, nbr, frag, rows, K);
}

__global__ void __launch_bounds__(kEdgeWarps * 32, kEdgeBlocks)
layer_bwd_edge_kernel(const float* __restrict__ x2, const int* __restrict__ nbr,
                      const float* __restrict__ w, const float* __restrict__ ew,
                      const float* __restrict__ d_agg, const float* __restrict__ d_pre,
                      float* __restrict__ d_w, float* __restrict__ d_x3, long rows, int N,
                      int K) {
  __shared__ float4 frag[kFrags * 32];
  load_weight_frags<true>(ew, frag);  // ew^T
  __syncthreads();
  BwdEdgeTail tail{x2, w, d_agg, d_w, d_x3, N, K};
  edge_loop(tail, d_pre, nbr, frag, rows, K);
}

// i for the flat edge id f = i * K + k: a float product by 1/K, off by at
// most one, and one correction (exact while i < 2^22).
__device__ __forceinline__ int source_row(int f, int K, float inv_k) {
  int i = __float2int_rz(__int2float_rn(f) * inv_k);
  i -= (i * K > f);
  i += ((i + 1) * K <= f);
  return i;
}

// A warp a node. Lane (q, c) = (lane >> 3, lane & 7) takes float4 column c
// of the edges in slots q and q + 4 of each step of 8, so a step has 6
// independent 16-byte loads a lane in flight, and the next step's ids load
// while this one's rows do. The four slots' sums meet in a fixed butterfly.
__global__ void __launch_bounds__(kNodeWarps * 32)
layer_bwd_node_kernel(const int* __restrict__ offsets, const int* __restrict__ edges,
                      const float* __restrict__ w, const float* __restrict__ d_agg,
                      const float* __restrict__ d_pre, float* __restrict__ d_x2,
                      float* __restrict__ d_x4, long nodes, int N, int K) {
  constexpr int kStep = 2 * kNodeSlots, kRow4 = U / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long node = (long)blockIdx.x * kNodeWarps + warp;  // b * N + j
  if (node >= nodes) return;  // the whole warp: it shares one node
  const long b = node / N;
  const int j = (int)(node - b * N);
  const int q = lane >> 3, c = lane & 7;
  const int* off = offsets + b * (N + 1);
  const int* in = edges + b * (long)N * K;
  const float4* w4 = reinterpret_cast<const float4*>(w + b * (long)N * K * U) + c;
  const float4* dp4 = reinterpret_cast<const float4*>(d_pre + b * (long)N * K * U) + c;
  const float4* da4 = reinterpret_cast<const float4*>(d_agg + b * (long)N * U) + c;
  const float inv_k = 1.0f / (float)K;
  const int beg = off[j], end = off[j + 1];
  float s2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int f[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = beg + s * kNodeSlots + q;
    f[s] = e < end ? in[e] : -1;
  }
  for (int e0 = beg; e0 < end; e0 += kStep) {
    const int cur[2] = {f[0], f[1]};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int e = e0 + kStep + s * kNodeSlots + q;
      f[s] = e < end ? in[e] : -1;
    }
    float4 wv[2], dp[2], da[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (cur[s] >= 0) {
        wv[s] = w4[(long)cur[s] * kRow4];
        dp[s] = dp4[(long)cur[s] * kRow4];
        da[s] = da4[(long)source_row(cur[s], K, inv_k) * kRow4];
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (cur[s] >= 0) {
        const float wa[4] = {wv[s].x, wv[s].y, wv[s].z, wv[s].w};
        const float pa[4] = {dp[s].x, dp[s].y, dp[s].z, dp[s].w};
        const float ga[4] = {da[s].x, da[s].y, da[s].z, da[s].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s2[i] += sigmoidf_(wa[i]) * ga[i];
          s4[i] += pa[i];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
      s2[i] += __shfl_xor_sync(kFullMask, s2[i], o);
      s4[i] += __shfl_xor_sync(kFullMask, s4[i], o);
    }
  if (q == 0) {
    reinterpret_cast<float4*>(d_x2 + node * U)[c] =
        make_float4(s2[0] / (float)K, s2[1] / (float)K, s2[2] / (float)K, s2[3] / (float)K);
    reinterpret_cast<float4*>(d_x4 + node * U)[c] = make_float4(s4[0], s4[1], s4[2], s4[3]);
  }
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
  const long rows = (long)B * R;
  if (rows == 0) return cudaSuccess;
  const long units = (rows + kEdgeWarps - 1) / kEdgeWarps;
  if (write_pre) {
    static LaunchCache launch;
    const unsigned grid = persistent_grid(launch, layer_fwd_kernel<true>, kEdgeWarps * 32, 0,
                                          units);
    layer_fwd_kernel<true><<<grid, kEdgeWarps * 32, 0, s>>>(x2, x3, x4, nbr, w, ew, eb, agg,
                                                           pre, rows, R, N, K);
  } else {
    static LaunchCache launch;
    const unsigned grid = persistent_grid(launch, layer_fwd_kernel<false>, kEdgeWarps * 32, 0,
                                          units);
    layer_fwd_kernel<false><<<grid, kEdgeWarps * 32, 0, s>>>(x2, x3, x4, nbr, w, ew, eb, agg,
                                                            pre, rows, R, N, K);
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
  if (nodes == 0) return cudaSuccess;
  static LaunchCache edge_launch;
  const unsigned grid = persistent_grid(edge_launch, layer_bwd_edge_kernel, kEdgeWarps * 32, 0,
                                        (nodes + kEdgeWarps - 1) / kEdgeWarps);
  layer_bwd_edge_kernel<<<grid, kEdgeWarps * 32, 0, s>>>(x2, nbr, w, ew, d_agg, d_pre, d_w,
                                                         d_x3, nodes, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_bwd_node_kernel<<<(unsigned)((nodes + kNodeWarps - 1) / kNodeWarps), kNodeWarps * 32, 0,
                          s>>>(offsets, edges, w, d_agg, d_pre, d_x2, d_x4, nodes, N, K);
  return cudaGetLastError();
}
