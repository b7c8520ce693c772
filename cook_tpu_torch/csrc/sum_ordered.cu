// sum_ordered: the f32 sum of a 1-D array in XLA-CPU's association.
//
// Replaces no TPU kernel. The JAX package sizes the batched matcher's
// fairness window with three `jnp.sum`s of f32 (cook_tpu/ops/match.py:
// 636-649: mean_mem, mean_cpus, absorb; W = K + int(absorb)). jax 0.9.0
// on XLA-CPU rewrites a reduction of more than 32 elements (the
// tree-reduction pass) into a reduce_window of size and stride 32, its
// padding split evenly with the odd one at the end, and reduces the
// window sums the same way until at most 32 remain; each window, and
// the last level, is summed left to right from +0.0. A single element
// is returned as it is. tests/test_torch_sum.py pins that order bit for
// bit. PyTorch's `sum` adds in another order on the CPU and in yet
// another on CUDA, so absorb can fall on the other side of an integer,
// W moves, and so do the placements.
//
// This kernel adds in exactly that order, one `__fadd_rn` at a time, so
// its result is bit-equal to the plain PyTorch version
// (`segments.sum_ordered_plain`) and to the reference.
//
// What bounds it on an H100: reading n floats (64 KB at n = 16,384, the
// port's largest call) and the launch. The order is a tree of depth
// log32(n) with chains of 32 dependent adds: ~100 adds deep at n =
// 16,384.
//
// Design: ONE launch of ONE CTA. Level 0: each warp loads 32 windows'
// 1,024 floats coalesced (lane l reads every 32nd float from its
// offset, 32 loads in flight) into its tile of shared memory, one pad
// word per 32 so that lane l then walks window l's 32 floats without a
// bank conflict, and writes the window's sum to shared memory; each
// higher level sums its windows from shared memory, a thread each;
// thread 0 sums the last <= 32 values. n <= 32 x 8,192 (the first
// level's window sums stay on chip).
//
// Beyond that, the "levels" route (segments.sum_ordered_plan): a grid
// launch per tree level from the bottom, while more than 32 x 8,192
// values remain, each warp of each CTA summing 32 windows of 32 in the
// same order as level 0 above (the same padding of -0.0, the same
// shared-memory tile), into a buffer in device memory; then the one-CTA
// kernel reduces what is left, whose tree is the rest of n's. At n = 1M
// the one level launch is 128 CTAs reading 4 MB: device memory bounds
// it, not one SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWin = 32;
constexpr int kMaxL1 = 8192;
constexpr int kTile = kWin * kWin + kWin;  // a warp's 32 windows, padded

__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

__global__ void __launch_bounds__(kThreads)
sum_ordered_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int n) {
  // per warp a tile of level 0, then level 1 (<= 8,192 window sums),
  // level 2 (<= 256), level 3 (<= 8) back in level 1's place
  extern __shared__ float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* tile = smem + warp * kTile;
  float* l1 = smem + nwarps * kTile;
  float* l2 = l1 + kMaxL1;
  if (n == 1) {  // XLA returns a single element as it is (-0.0 stays)
    if (tid == 0) out[0] = x[0];
    return;
  }
  int m = n;
  const float* src = nullptr;  // nullptr: level 0, read from x
  int p = 0;
  while (m > kWin) {
    const int nb = (m + kWin - 1) / kWin;
    const int lo = (nb * kWin - m) / 2;  // padding in front of window 0
    float* dst = p == 0 ? l1 : l2;
    if (src == nullptr) {
      // a warp's 32 windows: elements 1024 t - lo .. 1024 t - lo + 1023
      for (int b0 = warp * kWin; b0 < nb; b0 += nwarps * kWin) {
        const int e0 = b0 * kWin - lo;
        float v[kWin];
#pragma unroll
        for (int q = 0; q < kWin; ++q) {
          const int e = e0 + kWin * q + lane;
          // a padding slot holds -0.0, which leaves a sum as it is
          v[q] = (e >= 0 && e < m) ? x[e] : -0.0f;
        }
#pragma unroll
        for (int q = 0; q < kWin; ++q) tile[slot(kWin * q + lane)] = v[q];
        __syncwarp();
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < kWin; ++j)
          s = __fadd_rn(s, tile[slot(kWin * lane + j)]);
        if (b0 + lane < nb) dst[b0 + lane] = s;
        __syncwarp();
      }
    } else {
      for (int b = tid; b < nb; b += blockDim.x) {
        const int e0 = kWin * b - lo;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < kWin; ++j) {
          const int e = e0 + j;
          s = __fadd_rn(s, (e >= 0 && e < m) ? src[e] : -0.0f);
        }
        dst[b] = s;
      }
    }
    __syncthreads();
    src = dst;
    p ^= 1;
    m = nb;
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int e = 0; e < m; ++e)
      s = __fadd_rn(s, src == nullptr ? x[e] : src[e]);
    out[0] = s;
  }
}

// one tree level over many CTAs: y[b] = the sum of window b's 32 values
// x[32 b - lo .. 32 b - lo + 31] (-0.0 outside [0, m)), left to right
// from +0.0, for b < nb; a warp per 32 windows
constexpr int kLevelThreads = 256;

__global__ void __launch_bounds__(kLevelThreads)
sum_ordered_levels_kernel(const float* __restrict__ x, float* __restrict__ y,
                          long long m, long long nb, int lo) {
  __shared__ float tiles[kLevelThreads / 32 * kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* tile = tiles + warp * kTile;
  const long long b0 =
      ((long long)blockIdx.x * (kLevelThreads / 32) + warp) * kWin;
  if (b0 >= nb) return;  // the whole warp: no block barrier follows
  const long long e0 = b0 * kWin - lo;
  float v[kWin];
#pragma unroll
  for (int q = 0; q < kWin; ++q) {
    const long long e = e0 + kWin * q + lane;
    v[q] = (e >= 0 && e < m) ? x[e] : -0.0f;
  }
#pragma unroll
  for (int q = 0; q < kWin; ++q) tile[slot(kWin * q + lane)] = v[q];
  __syncwarp();
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kWin; ++j)
    s = __fadd_rn(s, tile[slot(kWin * lane + j)]);
  if (b0 + lane < nb) y[b0 + lane] = s;
}

bool g_attr_set = false;

}  // namespace

// Plain C entry point (bound with ctypes). x (n,) contiguous f32,
// 1 <= n <= 32 x 8192; out one f32. Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int sum_ordered_launch(const void* x, void* out, int n,
                                  void* stream) {
  if (n < 1 || n > kWin * kMaxL1) return (int)cudaErrorInvalidValue;
  if (!g_attr_set) {
    cudaFuncSetAttribute(
        sum_ordered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(float) * (kThreads / 32 * kTile + kMaxL1 + kMaxL1 / kWin));
    g_attr_set = true;
  }
  // a warp per 32 windows of level 0
  const int nb = (n + kWin - 1) / kWin;
  int warps = (nb + kWin - 1) / kWin;
  if (warps > kThreads / 32) warps = kThreads / 32;
  const size_t smem =
      sizeof(float) * (warps * kTile + kMaxL1 + kMaxL1 / kWin);
  sum_ordered_kernel<<<1, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

// Plain C entry point of the "levels" route (bound with ctypes): one tree
// level of m values, nb = ceil(m / 32) windows with lo padding values in
// front ((32 nb - m) / 2), into y (nb,). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int sum_ordered_levels_launch(const void* x, void* y, long long m,
                                         long long nb, int lo, void* stream) {
  if (m <= kWin || nb != (m + kWin - 1) / kWin || lo != (nb * kWin - m) / 2)
    return (int)cudaErrorInvalidValue;
  const long long per_cta = (long long)kLevelThreads / 32 * kWin;
  const long long ctas = (nb + per_cta - 1) / per_cta;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  sum_ordered_levels_kernel<<<(unsigned)ctas, kLevelThreads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, m, nb, lo);
  return (int)cudaGetLastError();
}
