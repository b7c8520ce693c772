// ordered_scatter: f32 scatter-add in update order (out[t] += vals[j] for
// every j with idx[j] == t, one round-to-nearest add at a time, j rising).
//
// Replaces no TPU kernel. The JAX package adds f32 per target with
// `jax.ops.segment_sum` (the batched matcher's host depletion,
// cook_tpu/ops/match.py:490-497; the quota usage sums, ops/cycle.py:
// 173-179) and `.at[idx].add(mode="drop")` (the resident credit scatter,
// scheduler/resident.py:157-159). On XLA-CPU both add each update to its
// target sequentially in update order (tests/test_torch_scatter.py pins
// it bit for bit). PyTorch's float `index_add_` on CUDA adds with atomics
// in whatever order they land, so a host lane could differ in its last
// bit from run to run and from the reference, and a later round then
// choose another host. This kernel adds in the reference's order, so its
// result is bit-equal to the plain PyTorch version
// (`segments.scatter_add_ordered_plain_`) and to XLA-CPU's.
//
// Input: the wrapper's stable sort of the indices as int32 (`torch.sort(
// idx, stable=True)`): `skey` the sorted indices and `perm` the update
// each came from, so each target's updates are one contiguous run in
// update order. Keys outside [0, T) are dropped.
//
// What bounds it on an H100: the function reads n indices and n x k
// floats and reads and writes the touched targets: a few microseconds
// of device memory at the port's calls (n <= 32,768). The order is a
// dependency chain per target, so a long run is bound by its chain of
// adds and by the latency of its gathers instead.
//
// Design (simple first): one thread per sorted position; the thread at
// the first position of a run walks the whole run, issuing kAhead
// (key, update) loads and then kAhead gathers of vals[perm[j]] before
// adding them in order, so a run of m updates costs ~m / kAhead pairs of
// memory latencies plus m dependent adds. Every other thread returns at
// once. No atomics, no shared memory, one launch. Runs are short at the
// main shapes (a host's bids in a round, a user's ~20-65 running tasks,
// a host's credits). The stable sort, not this kernel, takes most of a
// call's device time (int32 keys: half the radix passes of int64 ones).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 16;

template <int K>
__global__ void __launch_bounds__(kThreads)
ordered_scatter_kernel(const int32_t* __restrict__ skey,
                       const int64_t* __restrict__ perm,
                       const float* __restrict__ vals,
                       float* __restrict__ out, int n, int T) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  const int t = skey[j];
  if (t < 0 || t >= T) return;                // dropped
  if (j > 0 && skey[j - 1] == t) return;      // not the run's first update
  float acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = out[(size_t)t * K + c];
  for (int i = j;; i += kAhead) {
    // the run is a prefix of each batch (the keys are sorted): every
    // key and update index of the batch is loaded before any gather
    int key[kAhead];
    long long p[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int q = i + u;
      key[u] = q < n ? skey[q] : -1;
      p[u] = q < n ? perm[q] : 0;
    }
    float v[kAhead][K];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
#pragma unroll
      for (int c = 0; c < K; ++c)
        v[u][c] = key[u] == t ? vals[p[u] * K + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (key[u] == t) {
#pragma unroll
        for (int c = 0; c < K; ++c) acc[c] = __fadd_rn(acc[c], v[u][c]);
      }
    }
    if (key[kAhead - 1] != t) break;
  }
#pragma unroll
  for (int c = 0; c < K; ++c) out[(size_t)t * K + c] = acc[c];
}

template <int K>
void launch(const void* skey, const void* perm, const void* vals, void* out,
            int n, int T, cudaStream_t stream) {
  ordered_scatter_kernel<K><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              stream>>>(
      (const int32_t*)skey, (const int64_t*)perm, (const float*)vals,
      (float*)out, n, T);
}

}  // namespace

// Plain C entry point (bound with ctypes). vals (n, k) and out (T, k)
// contiguous f32, k in 1..4; skey (n,) int32 / perm (n,) int64 from the
// stable sort; T < 2^31. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched; cudaErrorInvalidValue for
// k out of range).
extern "C" int ordered_scatter_launch(const void* skey, const void* perm,
                                      const void* vals, void* out, int n,
                                      int T, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch<1>(skey, perm, vals, out, n, T, s); break;
    case 2: launch<2>(skey, perm, vals, out, n, T, s); break;
    case 3: launch<3>(skey, perm, vals, out, n, T, s); break;
    case 4: launch<4>(skey, perm, vals, out, n, T, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
