// K9: the folded EmbNet layer stack over a given neighbour graph, in f32.
//
// Replaces deepaco_tpu/ops/fused_gnn.py:242 embnet_layers_pallas (Pallas
// kernel _layers_kernel, 111-168, with _layer_stack 171-239), the forward
// that net_forward_fast runs when the graph is given rather than built from
// a dense distance matrix (the large-N sparse TSP path: B=30, N=2000,
// K=200). On the TPU one grid cell per instance kept the edge state in
// VMEM, slot-grouped and transposed, and gathered by one-hot MXU
// contractions. None of that carries over: here the edge state [B, N, K, 32]
// f32 (1.54 GB at the path's shape) cannot stay on chip, so each layer
// streams it once through device memory, and the neighbour gathers of x2/x4
// are direct loads from x1234 [B, N, 128] (31 MB, held in the 50 MB L2).
// What bounds it: the edge state's bytes, read and written once a layer
// (12 x 2 x 1.54 GB, about 11 ms at 3.35 TB/s); its per-edge 32x32 products
// (about 3.4e11 operations) run on the tensor cores in 3xTF32, the f32
// function, in K1's layer passes (embnet_passes.cuh: a warp owns whole
// nodes, no atomics, and the K loop keeps no edge row on chip).
//
// Phases, all on the caller's stream:
//   (a) elin0: w = silu(edge @ we_in + be_in), one thread per (edge,
//       feature), the E <= 4 features summed in order;
//   (b) L layers of node_pass and edge_pass (embnet_passes.cuh).
#include "embnet_passes.cuh"

namespace deepaco {
namespace {

constexpr int kMaxEdgeFeats = 4;
constexpr int kElinThreads = 256;

__global__ void elin0_kernel(const float* __restrict__ edge, float* __restrict__ w,
                             const float* __restrict__ we_in, const float* __restrict__ be_in,
                             long edges, int E) {
  const long t = (long)blockIdx.x * kElinThreads + threadIdx.x;
  if (t >= edges * U) return;
  const long e = t / U;
  const int lane = (int)(t % U);
  float acc = 0.0f;
  for (int q = 0; q < E; ++q) acc = fmaf(edge[e * E + q], we_in[q * U + lane], acc);
  w[t] = siluf_(acc + be_in[lane]);
}

}  // namespace
}  // namespace deepaco

// edge [B,N,K,E] f32 and nbr [B,N,K] int32 (ids within each instance) ->
// w [B,N,K,U] f32, the final edge state. x [B,N,U] holds silu(v_lin0(x_in))
// on entry and the final node state on exit; x1234 [B,N,4U] is scratch
// owned by the caller. params: the layers' weights (ops/fused_gnn.py:
// _pack_layers), we_in with E rows.
extern "C" int deepaco_embnet_layers(const float* edge, float* x, float* x1234, const int* nbr,
                                     float* w, const float* params, int B, int N, int K, int E,
                                     int L, int node_update, void* stream) {
  using namespace deepaco;
  if (E < 1 || E > kMaxEdgeFeats || K < 1 || K > N) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LayerParams p;
  unpack_layers(params, L, E, p);
  const long rows = (long)B * N;
  const long edges = rows * K;
  elin0_kernel<<<(unsigned)((edges * U + kElinThreads - 1) / kElinThreads), kElinThreads, 0, s>>>(
      edge, w, p.we_in, p.be_in, edges, E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return run_layers(x, x1234, nbr, w, p, rows, N, K, L, node_update, s);
}
