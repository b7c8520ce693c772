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
// The level sums in shared memory have a pad word per 32 (slot(i)):
// thread b reads window b's 32 values, and unpadded every thread of a
// warp read the same bank (16 threads a 16-way conflict on each of 32
// loads at n = 16,384: ~700 of the kernel's ~3,800 cycles, by
// kernel_phases.py's stamps).
//
// Beyond that, up to 32 x 32 x 8,192 elements, the "cluster" route: ONE
// launch of one thread-block cluster (16 CTAs of 1,024 threads where the
// card co-schedules them, else 8). CTA r owns a contiguous range of
// level-1 windows (32 level-0 windows each, segments.sum_cluster_ranges);
// a warp sums one of them: its level-0 windows from device memory
// exactly as level 0 above, then their 32 sums in order (a shuffle
// each), into the CTA's shared memory; after the cluster has run (a
// relaxed arrive at the start, the wait here) every CTA writes its
// level-1 sums into CTA 0's shared memory over DSMEM; after a
// release/acquire cluster barrier CTA 0 finishes the tree as the one-CTA
// kernel does, and the others leave.
//
// Beyond that, the "levels" route (segments.sum_ordered_plan): a grid
// launch per tree level from the bottom, while more than 32 x 32 x 8,192
// values remain, each warp of each CTA summing 32 windows of 32 in the
// same order as level 0 above (the same padding of -0.0, the same
// shared-memory tile), into a buffer in device memory; then the cluster
// kernel reduces what is left, whose tree is the rest of n's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWin = 32;
constexpr int kMaxL1 = 8192;
// the level-1 and level-2 sums in shared memory, a pad word per 32
constexpr int kL1Words = kMaxL1 + kMaxL1 / 32;
constexpr int kL2Words = kMaxL1 / 32 + kMaxL1 / 32 / 32;
constexpr int kTile = kWin * kWin + kWin;  // a warp's 32 windows, padded
constexpr int kWarpsMax = kThreads / 32;

__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

// The window sums of a level live in shared memory at slot(i): thread b
// reads window b's 32 values, 32 b - lo .. 32 b - lo + 31, and without the
// pad word every thread of a warp would read the same bank (a 32-way
// conflict on each of its 32 loads).

// dst[slot(b)] = window b of a level of m values a (lo padding in front),
// left to right from +0.0. Every load is of an index clamped into [0, m)
// and issued before the adds; -0.0 where padded
__device__ __forceinline__ void s_window(const float* a, int m, int b, int lo,
                                         float* dst) {
  const int e0 = kWin * b - lo;
  float v[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) v[j] = a[slot(min(max(e0 + j, 0), m - 1))];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const int e = e0 + j;
    s = __fadd_rn(s, (e >= 0 && e < m) ? v[j] : -0.0f);
  }
  dst[slot(b)] = s;
}

// the last m <= 32 values, left to right from +0.0 (loads first, as
// above), from shared memory at slot(i) or as they are in device memory
template <bool kPadded>
__device__ __forceinline__ float s_last(const float* a, int m) {
  float v[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) v[j] = a[kPadded ? slot(min(j, m - 1))
                                                  : min(j, m - 1)];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kWin; ++j) s = __fadd_rn(s, j < m ? v[j] : -0.0f);
  return s;
}

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
  float* l2 = l1 + kL1Words;
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
        if (b0 + lane < nb) dst[slot(b0 + lane)] = s;
        __syncwarp();
      }
    } else {
      for (int b = tid; b < nb; b += blockDim.x) s_window(src, m, b, lo, dst);
    }
    __syncthreads();
    src = dst;
    p ^= 1;
    m = nb;
  }
  if (tid == 0)
    out[0] = src == nullptr ? s_last<false>(x, m) : s_last<true>(src, m);
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


// ---- "sum_ordered/cluster": one launch of one thread-block cluster -----
constexpr int kMaxCluster = 16;
constexpr int kL1Win = kWin * kWin;  // elements of a level-1 window

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// levels 2 up of a tree whose m level-1 sums are in shared memory at a
// (<= 8,192), as the one-CTA kernel sums them: a thread a window, b (<=
// 256) and a taking turns; thread 0 sums the last <= 32 into out
__device__ void finish_tree(float* a, float* b, int m,
                            float* __restrict__ out) {
  const int tid = threadIdx.x;
  float* src = a;
  float* dst = b;
  while (m > kWin) {
    const int nb = (m + kWin - 1) / kWin;
    const int lo = (nb * kWin - m) / 2;
    for (int w = tid; w < nb; w += blockDim.x) s_window(src, m, w, lo, dst);
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
    m = nb;
  }
  if (tid == 0) out[0] = s_last<true>(src, m);
}

// n > 32 x 8,192 elements: nb0 level-0 windows (lo0 padding in front),
// nb1 <= 8,192 level-1 windows of 32 level-0 windows (lo1 in front); CTA
// r of the cluster owns level-1 windows [r q, r q + q)
__global__ void __launch_bounds__(kThreads, 1)
sum_ordered_cluster_kernel(const float* __restrict__ x,
                           float* __restrict__ out, int n, int lo0, int nb0,
                           int nb1, int lo1, int q) {
  extern __shared__ float smem[];
  // every CTA must run before any DSMEM write: arrive now, wait later
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* tile = smem + warp * kTile;
  float* l1 = smem + kWarpsMax * kTile;  // CTA 0: every level-1 sum
  float* l2 = l1 + kL1Words;
  float* mine = l2 + kL2Words;           // this CTA's level-1 sums
  const int b1lo = min(nb1, r * q), b1hi = min(nb1, b1lo + q);
  // a warp a level-1 window: lane l sums level-0 window 32 b1 - lo1 + l
  // (elements from its first - lo0) from the warp's padded tile, exactly
  // as the one-CTA kernel's level 0, then every lane sums the 32 window
  // sums in order, taken from lane u by a shuffle
  for (int b1 = b1lo + warp; b1 < b1hi; b1 += kWarpsMax) {
    const long long e0 = (long long)(kWin * b1 - lo1) * kWin - lo0;
    float v[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      const long long e = e0 + kWin * j + lane;
      v[j] = (e >= 0 && e < n) ? x[e] : -0.0f;
    }
#pragma unroll
    for (int j = 0; j < kWin; ++j) tile[slot(kWin * j + lane)] = v[j];
    __syncwarp();
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kWin; ++j)
      s = __fadd_rn(s, tile[slot(kWin * lane + j)]);
    const int b0 = kWin * b1 - lo1 + lane;
    s = (b0 >= 0 && b0 < nb0) ? s : -0.0f;  // a padding window
    float s1 = 0.0f;
#pragma unroll
    for (int u = 0; u < kWin; ++u)
      s1 = __fadd_rn(s1, __shfl_sync(0xffffffffu, s, u));
    if (lane == 0) mine[b1 - b1lo] = s1;
    __syncwarp();
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // this CTA's level-1 sums into CTA 0's
  for (int i = tid; i < b1hi - b1lo; i += kThreads)
    *cluster.map_shared_rank(&l1[slot(b1lo + i)], 0) = mine[i];
  cluster_barrier();  // CTA 0 holds every level-1 sum; the others leave
  if (r != 0) return;
  finish_tree(l1, l2, nb1, out);
}

// the cluster route's shared memory a CTA: the warps' tiles, the level-1
// and level-2 sums, this CTA's level-1 sums (<= 8,192 / 8)
constexpr int kClusterSmem =
    (int)sizeof(float) *
    (kWarpsMax * kTile + kL1Words + kL2Words + kMaxL1 / 8);

// 16 CTAs where the card can co-schedule a cluster of 16, else the
// portable 8 (chosen once)
int cluster_size() {
  static int chosen = 0;
  if (chosen) return chosen;
  cudaFuncSetAttribute(sum_ordered_cluster_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kClusterSmem);
  cudaFuncSetAttribute(sum_ordered_cluster_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kClusterSmem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kMaxCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, (void*)sum_ordered_cluster_kernel, &cfg);
  if (e != cudaSuccess || n < 1) {
    cudaGetLastError();
    chosen = 8;
  } else {
    chosen = kMaxCluster;
  }
  return chosen;
}

// an empty kernel: the launch floor, one CTA or one cluster
__global__ void noop_kernel() {}

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
        (int)sizeof(float) * (kThreads / 32 * kTile + kL1Words + kL2Words));
    g_attr_set = true;
  }
  // a warp per 32 windows of level 0
  const int nb = (n + kWin - 1) / kWin;
  int warps = (nb + kWin - 1) / kWin;
  if (warps > kThreads / 32) warps = kThreads / 32;
  const size_t smem = sizeof(float) * (warps * kTile + kL1Words + kL2Words);
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

// The cluster size launches of the cluster route use (16, or 8 where 16
// cannot be scheduled).
extern "C" int sum_ordered_cluster_ctas(void) { return cluster_size(); }

// Plain C entry point of the cluster route (bound with ctypes). x (n,)
// contiguous f32, 32 x 8,192 < n <= 32 x 32 x 8,192; out one f32.
// Launches one cluster on `stream` and returns the launch's error (or
// cudaGetLastError()) as an int (0 = launched).
extern "C" int sum_ordered_cluster_launch(const void* x, void* out, int n,
                                          void* stream) {
  if (n <= kWin * kMaxL1 || n > kL1Win * kMaxL1)
    return (int)cudaErrorInvalidValue;
  const int C = cluster_size();
  const int nb0 = (n + kWin - 1) / kWin;
  const int lo0 = (nb0 * kWin - n) / 2;
  const int nb1 = (nb0 + kWin - 1) / kWin;
  const int lo1 = (nb1 * kWin - nb0) / 2;
  const int q = (nb1 + C - 1) / C;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kClusterSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, sum_ordered_cluster_kernel, (const float*)x,
                         (float*)out, n, lo0, nb0, nb1, lo1, q);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// An empty kernel's launch (the launch floor PERF.md compares the
// one-CTA route with): one CTA of 32 threads (cluster = 0), or one
// cluster of the cluster route's CTAs of 1,024 threads (1). Returns the
// launch's error as an int (0 = launched).
extern "C" int sum_ordered_noop_launch(int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster ? cluster_size() : 1);
  cfg.blockDim = dim3(cluster ? kThreads : 32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster ? cluster_size() : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster ? 1 : 0;
  if (cluster)
    cudaFuncSetAttribute(noop_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, noop_kernel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
