// K1: distance matrix -> dense neural heuristic, in f32.
//
// Replaces deepaco_tpu/ops/fused_gnn.py:416 tsp_dense_heuristic (Pallas
// kernel _dense_kernel, 304-400, with _layer_stack 171-239). On the TPU one
// grid cell per instance kept the whole edge state in VMEM and gathered by
// one-hot MXU contractions. On the H100 the edge state ([B, N, K, 32] f32,
// 320 MB at B=100, N=500, K=50) does not fit on chip, so each layer streams
// it once through device memory and the neighbour gathers are direct loads
// from L2. What bounds it: the edge-state traffic of 12 layers (each reads
// and writes the 320 MB once), then the head's read of it and the dense
// write; the per-edge 32x32 products (e_lins0 each layer, two head layers)
// run on the tensor cores in 3xTF32, the f32 function, far below the bytes.
// The layer passes and the head share one tile routine (embnet_passes.cuh):
// a warp owns whole nodes, so there are no atomics and every write is owned
// by one warp.
//
// Phases, all on the caller's stream:
//   (a) knn_elin0: one warp per row takes the K smallest distances by
//       (value, index), the lowest index winning, and writes
//       nbr and w = silu(d * we_in + be_in);
//   (b) node_pass, each layer: x1234 = x @ wv_i + bv_i, [rows, 4U];
//   (c) edge_pass, each layer, persistent warps over whole nodes in tiles
//       of 16 edges: the edge update in place and the node update from the
//       layer's input state (both passes in embnet_passes.cuh, shared with
//       K9);
//   (d) head, persistent warps over whole rows: the 32->32->32->1 MLP and
//       sigmoid per edge on the same tiles, then the dense row written in
//       full: fill off the support, o + fill on it.
#include "embnet_passes.cuh"

namespace deepaco {
namespace {

constexpr int kKnnWarps = 4;      // rows per knn block
constexpr int kHeadWarps = 4;     // warps per head block

// The head's weights follow the layers' in the packed parameter buffer; the
// order matches ops/fused_gnn.py:_pack_params.
struct Params {
  LayerParams layers;
  const float *h0, *hb0, *h1, *hb1, *h2, *hb2;
};

Params unpack(const float* p, int L) {
  Params q;
  p = unpack_layers(p, L, 1, q.layers);
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

// Persistent warps, each taking whole rows r: the two 32x32 products of
// each tile of r's edges on the tensor cores (tile_product, the layers'
// 3xTF32 routine; the first product's output is the second one's input in
// place), the last layer's dot product summed over the 4 lanes of a row, and
// the dense row assembled in the warp's slice of shared memory, then written
// in full.
__global__ void __launch_bounds__(kHeadWarps * 32)
head_kernel(const float* __restrict__ w, const int* __restrict__ nbr,
            const float* __restrict__ h0, const float* __restrict__ hb0,
            const float* __restrict__ h1, const float* __restrict__ hb1,
            const float* __restrict__ h2, const float* __restrict__ hb2,
            float* __restrict__ heu, long rows, int n, int k, float fill) {
  extern __shared__ float4 smem4[];
  float4* f0 = smem4;
  float4* f1 = smem4 + kFrags * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* row = reinterpret_cast<float*>(smem4 + 2 * kFrags * 32) + (size_t)warp * n;
  load_weight_frags(h0, f0);
  load_weight_frags(h1, f1);
  __syncthreads();
  float b0[8], b1[8], w2[8];
  load8(hb0, t, b0);
  load8(hb1, t, b1);
  load8(h2, t, w2);
  const float b2 = hb2[0];
  const int tiles = (k + kTileRows - 1) / kTileRows;
  const long warps = (long)gridDim.x * kHeadWarps;
  for (long r = (long)blockIdx.x * kHeadWarps + warp; r < rows; r += warps) {
    for (int c = lane; c < n; c += 32) row[c] = fill;
    __syncwarp();
    for (int i = 0; i < tiles; ++i) {
      float a[2][8], h[2][8];
      int id[2];
      load_tile(w + r * k * U, nbr + r * k, i, k, g, t, a, id);
      tile_product(a, f0, lane, h);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) h[q][c] = fast_silu(h[q][c] + b0[c]);
      tile_product(h, f1, lane, a);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float o = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) o += fast_silu(a[q][c] + b1[c]) * w2[c];
        o += __shfl_xor_sync(kFullMask, o, 1);
        o += __shfl_xor_sync(kFullMask, o, 2);
        // k-NN columns of a row are distinct, so these writes never collide
        if (t == 0 && i * kTileRows + g + 8 * q < k) row[id[q]] = sigmoidf_(o + b2) + fill;
      }
    }
    __syncwarp();
    for (int c = lane; c < n; c += 32) heu[r * n + c] = row[c];
    __syncwarp();
  }
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
                     kKnnWarps * N * sizeof(float), s>>>(dist, nbr, w, p.layers.we_in,
                                                         p.layers.be_in, rows, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = run_layers(x, x1234, nbr, w, p.layers, rows, N, K, L, node_update, s);
  if (err != cudaSuccess) return err;
  const size_t head_smem = 2 * kFrags * 32 * sizeof(float4) + (size_t)kHeadWarps * N * sizeof(float);
  static LaunchCache head_launch;
  err = allow_smem(head_launch, head_kernel, head_smem);
  if (err != cudaSuccess) return err;
  const unsigned head_blocks = persistent_grid(head_launch, head_kernel, kHeadWarps * 32,
                                               head_smem, (rows + kHeadWarps - 1) / kHeadWarps);
  head_kernel<<<head_blocks, kHeadWarps * 32, head_smem, s>>>(
      w, nbr, p.h0, p.hb0, p.h1, p.hb1, p.h2, p.hb2, heu, rows, N, K, fill);
  return cudaGetLastError();
}
