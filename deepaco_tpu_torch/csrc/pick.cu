// K7: one sampling step of the construction, masked Gumbel-max action and
// the log-softmax at it, in f32.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:65 fused_pick_pallas (Pallas
// kernel _pick_kernel, 51-62), the step that engine.rollout(require_prob=True)
// takes for every ant (engine.py:114-125). The TPU made several passes over
// the [A, N] tile in VMEM (mask, argmax, max, exp-sum, a one-hot select);
// here one warp reads its row once: each lane keeps a running maximum and
// rescaled exp-sum of the masked logits (an online logsumexp) and the first
// maximum of logits + gumbel, and two butterflies combine the lanes.
//
// What bounds it: nothing on the card at the training shapes. A step of the
// TSP-NLS envelope reads 3 x 600 x 500 f32 (3.6 MB, about 1 us at 3.35 TB/s),
// so its time is launch latency. The argmax orders NaN above every number
// and takes the lowest index among equals, as torch.argmax does.
#include "common.cuh"

namespace deepaco {
namespace {

constexpr int kPickWarps = 4;
constexpr float kNegInf = -1e30f;

__global__ void pick_kernel(const float* __restrict__ score, const float* __restrict__ mask,
                            const float* __restrict__ gumbel, int64_t* __restrict__ action,
                            float* __restrict__ logp, long rows, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kPickWarps + warp;
  if (row >= rows) return;  // only warp-level synchronisation below
  const float* s = score + row * n;
  const float* m = mask + row * n;
  const float* g = gumbel + row * n;
  float mx = -INFINITY, sum = 0.0f;  // online logsumexp of the lane's logits
  float best = -INFINITY;
  int bidx = n;
  for (int c = lane; c < n; c += 32) {  // ascending c: the lane's first maximum
    const float l = m[c] > 0.0f ? s[c] : kNegInf;
    if (l > mx) {
      sum = sum * expf(mx - l) + 1.0f;
      mx = l;
    } else {
      sum += expf(l - mx);
    }
    const float v = l + g[c];
    if (argmax_before(v, c, best, bidx)) {  // also takes a first -inf, as torch.argmax does
      best = v;
      bidx = c;
    }
  }
  warp_pick<false>(best, bidx);
  float top = mx;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) top = fmaxf(top, __shfl_xor_sync(kFullMask, top, off));
  const float total = warp_sum(mx == -INFINITY ? 0.0f : sum * expf(mx - top));
  if (lane == 0) {
    const float la = m[bidx] > 0.0f ? s[bidx] : kNegInf;
    action[row] = bidx;
    logp[row] = (la - top) - logf(total);
  }
}

}  // namespace
}  // namespace deepaco

// score, mask, gumbel [rows, n] f32 -> action [rows] int64, logp [rows] f32.
extern "C" int deepaco_pick(const float* score, const float* mask, const float* gumbel,
                            int64_t* action, float* logp, int rows, int n, void* stream) {
  using namespace deepaco;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pick_kernel<<<(unsigned)((rows + kPickWarps - 1) / kPickWarps), kPickWarps * 32, 0, s>>>(
      score, mask, gumbel, action, logp, rows, n);
  return cudaGetLastError();
}
