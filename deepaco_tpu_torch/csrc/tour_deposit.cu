// K8: the all-ant pheromone deposit of one Ant System iteration,
//   D[b, u, v] = sum_a amounts[b, a] * #{l : (u, v) is edge l of ant a},
// over paths [B, L, A] int64 and amounts [B, A] f32, into D [B, n, n] f32.
// Cyclic paths have the L edges (path[i], path[i-1]); open paths the L-1
// edges (path[i], path[i+1]). A repeated edge deposits once per occurrence.
//
// Replaces deepaco_tpu/ops/pallas_kernels.py:340 tour_deposit_pallas (Pallas
// kernel _tour_deposit_kernel, 313-337), which built D by one one-hot MXU
// contraction per ant in VMEM. On the H100 the function is a scatter with
// heavy duplicates: a CVRP ant that has finished parks on the depot, so the
// self-loop (0, 0) repeats hundreds of times per ant. Global atomics would
// serialise there and sum the ants in an order that changes between runs.
//
// What bounds it: bytes. At B=100, L=1001, A=20, n=501 the paths are 16 MB
// and D 100 MB: 0.035 ms at 3.35 TB/s. D is almost all zeros, so the design
// reads the paths once and writes D once, each row with 16-byte stores; the
// zeros cost nothing beyond that write.
//
// Two launches:
// 1. bucket_kernel, one block per instance. It reads the instance's paths
//    (staged in shared memory as int32 when they fit), finds each open path's
//    parked tail (the longest suffix on one node) and turns every edge into a
//    record (v, count, ant) keyed by (u, ant): a count per key, an exclusive
//    scan, then a scatter to each key's range. A parked tail becomes one
//    record with its count. Records of one key sit in any order, but they all
//    carry the same addend amounts[a]; the keys of one row are in ant order.
//    The counts live in shared memory when the instance's n*A of them fit,
//    else in the scratch they are written to; the scanned counts go out.
// 2. row_kernel, one warp per row (b, u). The warp zeroes the row in shared
//    memory, reads the row's records 32 at a time and applies them: records
//    on one column in list order, records on distinct columns at once, a
//    record's count adds of one amount one after another. Then it writes the
//    row: a head up to the next 16-byte boundary, float4 stores, a tail (rows
//    of 501 floats are not aligned).
// Each entry therefore adds the ants in order, one add at a time: the result
// equals scatter_add_ on the CPU (ant-major, step-minor) bit for bit and does
// not change between launches.
//
// An id outside [0, n) stops the kernel with a device-side assert in the
// first launch, before it is used as an address and before D is written.
#include <cassert>

#include "common.cuh"

namespace deepaco {
namespace {

constexpr int kBucketThreads = 1024;
constexpr int kMaxWarpsPerRowBlock = 8;
constexpr long kSmemBytes = 224 * 1024;

// A record: (v, count << ant_bits | ant), ant_bits the bits of A - 1; a
// count is below L, and L*A < 2^30 keeps it below 2^(31 - ant_bits).
struct Packing {
  int ant_bits;
  __device__ int ant(int y) const { return y & ((1 << ant_bits) - 1); }
  __device__ int count(int y) const { return y >> ant_bits; }
  __device__ int pack(int count, int ant) const { return (count << ant_bits) | ant; }
};

// Exclusive prefix sum of x[0, len) in place, by the whole block.
__device__ void block_exclusive_scan(int* x, int len, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (len + blockDim.x - 1) / blockDim.x;
  const int lo = min(len, tid * per), hi = min(len, lo + per);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += x[k];
  int incl = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < nwarps ? warp_sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < nwarps) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - own;
  for (int k = lo; k < hi; ++k) {
    const int c = x[k];
    x[k] = run;
    run += c;
  }
  __syncthreads();
}

// Records of instance blockIdx.x: rec [A*L] int2 grouped by key u*A + a;
// incl [n*A + A] the end of each key's range, then A words of room for the
// tails. kSmemCounts: the counts and tails in shared memory, else in incl.
// staged: the paths as int32 in shared memory after them.
template <bool kSmemCounts>
__global__ void __launch_bounds__(kBucketThreads)
bucket_kernel(const int64_t* __restrict__ paths, int2* __restrict__ rec, int* __restrict__ incl,
              int L, int A, int n, int cyclic, Packing pk, int staged) {
  extern __shared__ int smem_bucket[];
  __shared__ int warp_sums[32];
  const int keys = n * A, total = L * A, tid = threadIdx.x, T = blockDim.x;
  const long b = blockIdx.x;
  int* cnt = kSmemCounts ? smem_bucket : incl + b * (keys + A);  // [n*A] counts, then offsets
  int* tails = cnt + keys;  // [A] first step of each ant's parked tail
  int* stage = kSmemCounts ? tails + A : smem_bucket;  // [L*A] the paths as int32
  const int64_t* p = paths + b * total;
  for (int k = tid; k < keys; k += T) cnt[k] = 0;
  for (int a = tid; a < A; a += T) tails[a] = cyclic ? L : 0;
  if (staged) {
    for (int t0 = tid; t0 < total; t0 += 4 * T) {
      int64_t c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // four loads in flight a thread
        const int t = t0 + q * T;
        c[q] = t < total ? p[t] : 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q * T;
        if (t < total) {
          assert(0 <= c[q] && c[q] < n);
          stage[t] = (int)c[q];
        }
      }
    }
  }
  __syncthreads();
  auto id = [&](int t) -> int {
    if (staged) return stage[t];
    const int64_t v = p[t];
    assert(0 <= v && v < n);
    return (int)v;
  };
  if (!cyclic) {
    // tails[a] = 1 + the last step whose node differs from the last node: a
    // warp an ant, reading back from the end 32 steps at a time
    const int warp = tid >> 5, lane = tid & 31;
    for (int a = warp; a < A; a += T >> 5) {
      const int last = id((L - 1) * A + a);
      int from = 0;
      for (int top = L - 1; top > 0; top -= 32) {
        const int i = top - 1 - lane;
        const unsigned hit = __ballot_sync(kFullMask, i >= 0 && id(i * A + a) != last);
        if (hit) {
          from = top - __ffs(hit) + 1;
          break;
        }
      }
      if (lane == 0) tails[a] = from;
    }
    __syncthreads();
  }
  const int edges = cyclic ? L : L - 1;
  auto visit = [&](auto&& emit) {
    int i = tid / A, a = tid - i * A;  // step and ant of t, advanced without a division
    for (int t = tid; t < edges * A; t += T) {
      if (i < tails[a]) {  // else on the parked tail
        const int u = id(t);
        const int v = cyclic ? id(i ? t - A : (L - 1) * A + a) : id(t + A);
        emit(u * A + a, make_int2(v, pk.pack(1, a)));
      }
      i += T / A;
      a += T % A;
      if (a >= A) {
        a -= A;
        ++i;
      }
    }
    if (!cyclic) {
      for (int a = tid; a < A; a += T) {
        const int count = L - 1 - tails[a];
        if (count > 0) {
          const int last = id((L - 1) * A + a);
          emit(last * A + a, make_int2(last, pk.pack(count, a)));
        }
      }
    }
  };
  visit([&](int key, int2) { atomicAdd(&cnt[key], 1); });
  __syncthreads();
  block_exclusive_scan(cnt, keys, warp_sums);
  int2* r = rec + b * total;
  visit([&](int key, int2 x) { r[atomicAdd(&cnt[key], 1)] = x; });
  __syncthreads();  // cnt[key] is now the end of the key's range
  if (kSmemCounts)
    for (int k = tid; k < keys; k += T) incl[b * (keys + A) + k] = cnt[k];
}

// A row's floats in shared memory: n, up to 3 of alignment, a multiple of 4.
__host__ __device__ long row_stride(int n) { return ((long)n + 3 + 3) & ~3L; }

// One warp per row (b, u) of D.
__global__ void row_kernel(const int2* __restrict__ rec, const int* __restrict__ incl,
                           const float* __restrict__ amounts, float* __restrict__ out, int L,
                           int A, int n, long rows, Packing pk) {
  extern __shared__ float smem_rows[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // no block barrier below
  const long b = row / n;
  const int u = (int)(row - b * n);
  // the row sits in shared memory at the alignment it has in out, so that
  // both sides of the float4 copy below are 16-byte aligned
  const long stride = row_stride(n);
  const int shift = (int)((row * n) & 3);
  float4* zero = reinterpret_cast<float4*>(smem_rows + warp * stride);
  for (long k = lane; k < stride / 4; k += 32) zero[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* d = smem_rows + warp * stride + shift;
  const int* ends = incl + b * ((long)n * A + A);
  const int s = u ? ends[u * A - 1] : 0, e = ends[u * A + A - 1];
  const int2* r = rec + b * (long)L * A;
  const float* w = amounts + b * A;
  __syncwarp();
  const unsigned below = (1u << lane) - 1;
  for (int base = s; base < e; base += 32) {
    // lane j takes record base + j; records on one column go in list order
    // (ant order), one lane at a time, records on other columns at once
    const bool has = base + lane < e;
    int2 mine = make_int2(-1 - lane, 0);  // a column of its own when empty
    float wm = 0.0f;
    if (has) {
      mine = r[base + lane];
      wm = w[pk.ant(mine.y)];
    }
    const int rank = __popc(__match_any_sync(kFullMask, mine.x) & below);
    const int rounds = (int)__reduce_max_sync(kFullMask, (unsigned)rank) + 1;
    for (int step = 0; step < rounds; ++step) {
      if (has && rank == step) {
        float x = d[mine.x];
        for (int c = pk.count(mine.y); c > 0; --c) x = __fadd_rn(x, wm);
        d[mine.x] = x;
      }
      __syncwarp();
    }
  }
  __syncwarp();
  float* o = out + row * n;  // out is 16-byte aligned
  const int head = min(n, (4 - shift) & 3);
  if (lane < head) o[lane] = d[lane];
  const int body = (n - head) >> 2;
  float4* o4 = reinterpret_cast<float4*>(o + head);
  for (int k = lane; k < body; k += 32) {
    o4[k] = reinterpret_cast<const float4*>(d + head)[k];
  }
  for (int c = head + 4 * body + lane; c < n; c += 32) o[c] = d[c];
}

}  // namespace
}  // namespace deepaco

// paths [B, L, A] int64 (ids in [0, n)), amounts [B, A] f32 -> out [B, n, n]
// f32, with the scratch rec [B, L*A] int2 and incl [B, n*A + A] int32.
// Returns cudaErrorInvalidValue when one row of D does not fit in shared
// memory (n above 57,000: D is then 13 GB an instance), L*A reaches 2^30
// or n*A + A 2^31.
extern "C" int deepaco_tour_deposit(const int64_t* paths, const float* amounts, float* out,
                                    void* rec, int* incl, int B, int L, int A, int n, int cyclic,
                                    void* stream) {
  using namespace deepaco;
  const long row_bytes = 4L * row_stride(n);
  if (row_bytes > kSmemBytes || (long)L * A >= (1L << 30) || (long)n * A + A >= (1L << 31))
    return cudaErrorInvalidValue;
  Packing pk;
  pk.ant_bits = A > 1 ? 32 - __builtin_clz((unsigned)(A - 1)) : 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const long counts_bytes = 4L * ((long)n * A + A), stage_bytes = 4L * L * A;
  const bool smem_counts = counts_bytes <= kSmemBytes;
  const long used = smem_counts ? counts_bytes : 0;
  const bool staged = used + stage_bytes <= kSmemBytes;
  const size_t smem = (size_t)(used + (staged ? stage_bytes : 0));
  // the shared-memory caps are set on every call: they belong to the device
  const void* bucket = smem_counts ? (const void*)bucket_kernel<true>
                                   : (const void*)bucket_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(bucket, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  if (smem_counts)
    bucket_kernel<true><<<(unsigned)B, kBucketThreads, smem, s>>>(
        paths, static_cast<int2*>(rec), incl, L, A, n, cyclic, pk, staged);
  else
    bucket_kernel<false><<<(unsigned)B, kBucketThreads, smem, s>>>(
        paths, static_cast<int2*>(rec), incl, L, A, n, cyclic, pk, staged);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long rows = (long)B * n;
  const int warps = (int)max(1L, min((long)kMaxWarpsPerRowBlock, kSmemBytes / row_bytes));
  const size_t row_smem = (size_t)(warps * row_bytes);
  err = cudaFuncSetAttribute(row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)row_smem);
  if (err != cudaSuccess) return err;
  row_kernel<<<(unsigned)((rows + warps - 1) / warps), 32 * warps, row_smem, s>>>(
      static_cast<const int2*>(rec), incl, amounts, out, L, A, n, rows, pk);
  return cudaGetLastError();
}
