// blocked_cumsum: the port's f32 inclusive prefix sum along dim 0, with
// XLA-CPU's association.
//
// Replaces no TPU kernel. The JAX package takes `jnp.cumsum` of f32 in
// the rank (ops/dru.py), the segment scans (ops/segments.py) and the
// window rounds (ops/match.py); jax 0.9.0 lowers it on XLA-CPU to a
// reduce_window cumsum that XLA rewrites into a blocked scan with base
// 16: each run of 16 elements summed left to right from 0, the block
// totals scanned the same way recursively, and each block's exclusive
// prefix added to the block's running sums (the first block gets none).
// This kernel adds in exactly that order, one `__fadd_rn` at a time, so
// its result is bit-equal to the plain PyTorch version
// (`segments.blocked_cumsum_plain`) and to the reference, and the same
// from run to run (PyTorch's float cumsum on CUDA is neither). Only
// where each value is computed differs between the routes below; every
// value is the same add of the same operands.
//
// What bounds it on an H100: the n x k floats read once and written once
// (1.25 us at the port's largest call, 262,144 x 2). The association is
// a tree of depth ~log16(n) with chains of 16 dependent adds, which one
// CTA walks in microseconds once the column is on chip; what costs is
// getting the column on chip, and one SM alone loads it slowly (clock64
// stamps per phase: ~4,700 cycles for 16,384 floats; the cluster route's
// 8 CTAs a column each load 32,768 rows of a (262,144, 2) tensor, every
// other float of the lines they touch, in ~8,500).
//
// Three routes (segments.blocked_cumsum_plan picks one by n), each ONE
// launch with k columns side by side:
// - "one_cta" (n <= 16,384: the window rounds', the accept sums' and the
//   sequential rank's calls): one CTA a column loads the column into
//   shared memory and runs every level there: a thread per block of 16
//   for each level's totals, one thread for the top (<= 16 values), a
//   thread per block on the way down. Shared-memory slots carry one pad
//   word per 32, so the threads of a warp walking 32 blocks of 16 hit 32
//   banks.
// - "cluster" (n <= 8 x 40,960: the batched rank's (262,144, 2)): a
//   cluster of up to 8 CTAs a column; CTA r holds rows [rQ, rQ + Q) in
//   shared memory, Q a multiple of 4,096 = 16^3, so levels 0-2 are whole
//   inside it. Each CTA writes its level-3 totals into every CTA's copy
//   of the top array over DSMEM; after one cluster barrier each scans
//   the (<= 80) level-3 values itself, the same adds in each. On the way
//   down, the first block of a CTA's level 1 and level 0 needs the
//   previous CTA's last value of the level above: each CTA writes that
//   one value into its successor's shared memory, one cluster barrier a
//   level. The column is read once and written once; no running
//   aggregate crosses CTAs (a decoupled look-back would change the
//   association).
// - "global" (beyond): one CTA of 1,024 threads a column walks every
//   level through a scratch in device memory. The up-sweep writes each
//   level's block totals into the scratch the wrapper allocates (per
//   column: n/16 + n/256 + ... floats), one __syncthreads per level;
//   thread 0 scans the top level (<= 16 values); the down-sweep walks
//   back, rescanning each block left to right and adding the prefix from
//   the level above, level 0 writing the output. Each warp works on
//   tiles of 32 blocks (512 rows), loaded coalesced and transposed
//   through shared memory.
// The input may be strided (row stride rs, column stride cs); the output
// is contiguous (n, k).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBase = 16;
constexpr int kTile = 32 * kBase;          // a warp's 32 blocks
constexpr int kPad = kTile + kTile / 32;   // one pad float per 32
constexpr int kMaxLevels = 9;  // 16**8 = 2**32 > any int n
constexpr int kSmemBytes = kWarps * kPad * (int)sizeof(float);

// tile slot of element e: one pad per 32 keeps both the row-wise
// (32q + lane) and the block-wise (16 lane + j) walks free of bank
// conflicts
__device__ __forceinline__ int slot(int e) { return e + (e >> 5); }

// rows t0 .. t0 + 511 of a level into the warp's tile, coalesced (lane
// reads t0 + 32q + lane), all 16 loads in flight before the stores;
// rows past m read as 0 and are never added
__device__ __forceinline__ void load_tile(const float* src, long long st,
                                          int m, int t0, float* tile,
                                          int lane) {
  float v[kBase];
#pragma unroll
  for (int q = 0; q < kBase; ++q) {
    const int r = t0 + 32 * q + lane;
    v[q] = r < m ? src[(long long)r * st] : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < kBase; ++q) tile[slot(32 * q + lane)] = v[q];
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
blocked_cumsum_global_kernel(const float* __restrict__ x,
                             float* __restrict__ out,
                             float* __restrict__ scratch, int n, int k,
                             long long rs, long long cs, long long per_col) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* tile = smem + warp * kPad;
  float* sc = scratch + (long long)c * per_col;
  const float* xc = x + (long long)c * cs;

  // level sizes: len[0] = n, len[l + 1] = ceil(len[l] / 16), until <= 16
  int len[kMaxLevels];
  long long off[kMaxLevels];  // offset of level l >= 1 in this scratch
  int top = 0;
  len[0] = n;
  off[0] = 0;
  long long used = 0;
  while (len[top] > kBase) {
    len[top + 1] = (len[top] + kBase - 1) / kBase;
    off[top + 1] = used;
    used += len[top + 1];
    ++top;
  }
  // level l's values: the input column (row stride rs) or the scratch
  auto src = [&](int l) { return l == 0 ? xc : sc + off[l]; };
  auto stride = [&](int l) { return l == 0 ? rs : 1LL; };

  // up-sweep: block totals of each level, left to right from 0; lane
  // `lane` of a tile sums block t0 / 16 + lane
  for (int l = 0; l < top; ++l) {
    const int m = len[l];
    for (int t0 = warp * kTile; t0 < m; t0 += kWarps * kTile) {
      load_tile(src(l), stride(l), m, t0, tile, lane);
      const int b = t0 / kBase + lane;
      const int cnt = min(kBase, m - b * kBase);
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kBase; ++j)
        if (j < cnt) s = __fadd_rn(s, tile[slot(kBase * lane + j)]);
      if (cnt > 0) sc[off[l + 1] + b] = s;
      __syncwarp();
    }
    __syncthreads();
  }

  // the top level (<= 16 values): one running sum, in place
  if (threadIdx.x == 0) {
    const float* t = src(top);
    const long long st = stride(top);
    float r = 0.0f;
    for (int q = 0; q < len[top]; ++q) {
      const float v = t[(long long)q * st];
      // n == 1: XLA's window of one is the identity (-0.0 stays -0.0)
      r = n == 1 ? v : __fadd_rn(r, v);
      if (top == 0)
        out[(long long)q * k + c] = r;
      else
        sc[off[top] + q] = r;
    }
  }
  __syncthreads();

  // down-sweep: each block's running sums plus the inclusive scan of the
  // level above at the previous block (its exclusive prefix), written
  // back through the tile; level 0 writes the output, the others their
  // scratch in place
  for (int l = top - 1; l >= 0; --l) {
    const int m = len[l];
    const float* above = sc + off[l + 1];
    float* dst = l == 0 ? out + c : sc + off[l];
    const long long dst_st = l == 0 ? k : 1;
    for (int t0 = warp * kTile; t0 < m; t0 += kWarps * kTile) {
      load_tile(src(l), stride(l), m, t0, tile, lane);
      const int b = t0 / kBase + lane;
      const int cnt = min(kBase, m - b * kBase);
      const float p = cnt > 0 && b > 0 ? above[b - 1] : 0.0f;
      float r = 0.0f;
#pragma unroll
      for (int j = 0; j < kBase; ++j) {
        if (j < cnt) {
          float& e = tile[slot(kBase * lane + j)];
          r = __fadd_rn(r, e);
          e = b > 0 ? __fadd_rn(r, p) : r;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kBase; ++q) {
        const int row = t0 + 32 * q + lane;
        if (row < m) dst[(long long)row * dst_st] = tile[slot(32 * q + lane)];
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

bool g_attr_set = false;

// ---- the on-chip routes --------------------------------------------------

constexpr int kChunkAlign = kBase * kBase * kBase;  // 4,096 rows
constexpr int kMaxChunk = 40960;
constexpr int kMaxCtas = 8;

// floats of a level of m values in shared memory (one pad per 32)
__host__ __device__ constexpr int padded(int m) { return m + (m >> 5) + 1; }

// floats of the level totals smem_scan keeps for a level of m values
__host__ __device__ int scan_scratch(int m) {
  int total = 0;
  while (m > kBase) {
    m = (m + kBase - 1) / kBase;
    total += padded(m);
  }
  return total;
}

// block b of a level of m values: its 16 (or fewer) left to right from
// 0. All 16 loads go first, a slot past the level's end reading -0.0,
// which leaves every f32 as it is (no predicate per add)
__device__ __forceinline__ float block_total(const float* a, int m, int b) {
  const int cnt = min(kBase, m - kBase * b);
  float v[kBase];
#pragma unroll
  for (int j = 0; j < kBase; ++j)
    v[j] = j < cnt ? a[slot(kBase * b + j)] : -0.0f;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kBase; ++j) s = __fadd_rn(s, v[j]);
  return s;
}

// block b's running sums in place, each plus p where the block has a
// prefix (running sum first, as the plain version adds); all loads
// before the adds, all stores after them (a store between two loads of
// the same array would hold the second back)
__device__ __forceinline__ void down_block(float* a, int m, int b, bool has,
                                           float p) {
  const int cnt = min(kBase, m - kBase * b);
  float v[kBase];
#pragma unroll
  for (int j = 0; j < kBase; ++j)
    v[j] = j < cnt ? a[slot(kBase * b + j)] : -0.0f;
  float r = 0.0f;
#pragma unroll
  for (int j = 0; j < kBase; ++j) {
    r = __fadd_rn(r, v[j]);
    v[j] = has ? __fadd_rn(r, p) : r;
  }
#pragma unroll
  for (int j = 0; j < kBase; ++j)
    if (j < cnt) a[slot(kBase * b + j)] = v[j];
}

// the whole blocked scan of a[0, m) in shared memory, in place, by every
// thread of the CTA; the level totals go to scr (scan_scratch(m) floats)
__device__ void smem_scan(float* a, int m, float* scr) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* lv[kMaxLevels];
  int len[kMaxLevels];
  int top = 0;
  lv[0] = a;
  len[0] = m;
  while (len[top] > kBase) {
    len[top + 1] = (len[top] + kBase - 1) / kBase;
    lv[top + 1] = scr;
    scr += padded(len[top + 1]);
    ++top;
  }
  for (int l = 0; l < top; ++l) {
    for (int b = tid; b < len[l + 1]; b += nt)
      lv[l + 1][slot(b)] = block_total(lv[l], len[l], b);
    __syncthreads();
  }
  if (tid == 0) {  // the top (<= 16 values): one running sum
    float r = 0.0f;
    for (int q = 0; q < len[top]; ++q) {
      r = __fadd_rn(r, lv[top][slot(q)]);
      lv[top][slot(q)] = r;
    }
  }
  __syncthreads();
  for (int l = top - 1; l >= 0; --l) {
    for (int b = tid; b < len[l + 1]; b += nt)
      down_block(lv[l], len[l], b, b > 0, b > 0 ? lv[l + 1][slot(b - 1)]
                                                : 0.0f);
    __syncthreads();
  }
}

// rows r0 .. r0 + m - 1 of a column into shared memory, coalesced, 16
// loads in flight per thread before their stores (a loop that stored
// each load before issuing the next would wait out one memory latency
// per row a thread owns)
constexpr int kLoadAhead = 16;

__device__ __forceinline__ void load_column(const float* xc, long long rs,
                                            long long r0, int m, float* a) {
  const int nt = blockDim.x;
  for (int i0 = threadIdx.x; i0 < m; i0 += kLoadAhead * nt) {
    float v[kLoadAhead];
#pragma unroll
    for (int u = 0; u < kLoadAhead; ++u) {
      const int i = i0 + u * nt;
      v[u] = i < m ? xc[(r0 + i) * rs] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadAhead; ++u) {
      const int i = i0 + u * nt;
      if (i < m) a[slot(i)] = v[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
blocked_cumsum_one_cta_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int n, int k,
                              long long rs, long long cs) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  load_column(x + (long long)c * cs, rs, 0, n, smem);
  __syncthreads();
  // n == 1: XLA's window of one is the identity (-0.0 stays -0.0)
  if (n > 1) smem_scan(smem, n, smem + padded(n));
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[(long long)i * k + c] = smem[slot(i)];
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
blocked_cumsum_cluster_kernel(const float* __restrict__ x,
                              float* __restrict__ out, int n, int k,
                              long long rs, long long cs, int Q) {
  extern __shared__ float smem[];
  __shared__ float left[2];  // the previous CTA's last out_1, out_2
  // every CTA must run before any DSMEM write: arrive now, wait later
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int c = blockIdx.x / G;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int q1 = Q / kBase, q2 = q1 / kBase, q3 = q2 / kBase;
  const int tot3 = (n + kChunkAlign - 1) / kChunkAlign;
  float* a = smem;
  float* L1 = a + padded(Q);
  float* L2 = L1 + padded(q1);
  float* top = L2 + padded(q2);  // all level-3 values of the column
  float* tscr = top + padded(tot3);

  const long long r0 = (long long)r * Q;
  const int m0 = (int)min((long long)Q, n - r0);
  const int len1 = (m0 + kBase - 1) / kBase;
  const int len2 = (len1 + kBase - 1) / kBase;
  const int len3 = (len2 + kBase - 1) / kBase;
  load_column(x + (long long)c * cs, rs, r0, m0, a);
  __syncthreads();
  for (int b = tid; b < len1; b += nt) L1[slot(b)] = block_total(a, m0, b);
  __syncthreads();
  for (int b = tid; b < len2; b += nt) L2[slot(b)] = block_total(L1, len1, b);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  // this CTA's level-3 totals into every CTA's top array
  for (int i = tid; i < len3 * G; i += nt) {
    const int b = i / G;
    *cluster.map_shared_rank(&top[slot(r * q3 + b)], i % G) =
        block_total(L2, len2, b);
  }
  cluster_barrier();
  smem_scan(top, tot3, tscr);  // each CTA the same adds

  // level 2: the prefix of block b is out_3 of the block before it
  for (int b = tid; b < len3; b += nt) {
    const int B = r * q3 + b;
    down_block(L2, len2, b, B > 0, B > 0 ? top[slot(B - 1)] : 0.0f);
  }
  __syncthreads();
  if (tid == 0 && r + 1 < G)
    *cluster.map_shared_rank(&left[1], r + 1) = L2[slot(len2 - 1)];
  cluster_barrier();
  // level 1: the first block's prefix is the previous CTA's last out_2
  for (int b = tid; b < len2; b += nt)
    down_block(L1, len1, b, r > 0 || b > 0,
               b > 0 ? L2[slot(b - 1)] : (r > 0 ? left[1] : 0.0f));
  __syncthreads();
  if (tid == 0 && r + 1 < G)
    *cluster.map_shared_rank(&left[0], r + 1) = L1[slot(len1 - 1)];
  cluster_barrier();
  // level 0: the first block's prefix is the previous CTA's last out_1
  for (int b = tid; b < len1; b += nt)
    down_block(a, m0, b, r > 0 || b > 0,
               b > 0 ? L1[slot(b - 1)] : (r > 0 ? left[0] : 0.0f));
  __syncthreads();
  for (int i = tid; i < m0; i += nt) out[(r0 + i) * k + c] = a[slot(i)];
}

int cluster_smem_bytes(int Q, int tot3) {
  return (int)sizeof(float) *
         (padded(Q) + padded(Q / kBase) + padded(Q / (kBase * kBase)) +
          padded(tot3) + scan_scratch(tot3));
}

bool g_onchip_attr_set = false;

}  // namespace

// Plain C entry point of the on-chip routes (bound with ctypes): ctas == 1
// is "one_cta" (n <= 16,384), else "cluster" with `ctas` CTAs a column of
// `chunk` rows each (chunk a multiple of 4,096, <= 40,960; ctas <= 8;
// segments.blocked_cumsum_plan). Launches on `stream` and returns the
// launch's error (or cudaGetLastError()) as an int (0 = launched).
extern "C" int blocked_cumsum_launch(const void* x, void* out, int n, int k,
                                     long long rs, long long cs, int ctas,
                                     int chunk, void* stream) {
  if (!g_onchip_attr_set) {
    const int one = (int)sizeof(float) *
                    (padded(16384) + scan_scratch(16384));
    cudaFuncSetAttribute(blocked_cumsum_one_cta_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, one);
    cudaFuncSetAttribute(
        blocked_cumsum_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        cluster_smem_bytes(kMaxChunk, kMaxCtas * kMaxChunk / kChunkAlign));
    g_onchip_attr_set = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (ctas == 1) {
    if (n < 1 || n > 16384) return (int)cudaErrorInvalidValue;
    int threads = (n + kBase - 1) / kBase;
    threads = threads < 32 ? 32 : (threads + 31) / 32 * 32;
    if (threads > kThreads) threads = kThreads;
    blocked_cumsum_one_cta_kernel<<<
        k, threads, sizeof(float) * (padded(n) + scan_scratch(n)), s>>>(
        (const float*)x, (float*)out, n, k, rs, cs);
    return (int)cudaGetLastError();
  }
  if (ctas > kMaxCtas || chunk % kChunkAlign || chunk > kMaxChunk ||
      (long long)ctas * chunk < n || (long long)(ctas - 1) * chunk >= n)
    return (int)cudaErrorInvalidValue;
  const int tot3 = (n + kChunkAlign - 1) / kChunkAlign;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas * k);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = cluster_smem_bytes(chunk, tot3);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, blocked_cumsum_cluster_kernel, (const float*)x, (float*)out, n,
      k, rs, cs, chunk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Plain C entry point of the "global" route (bound with ctypes).
// `scratch` holds per_col floats per column (blocked_cumsum_scratch(n)).
// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched).
extern "C" int blocked_cumsum_global_launch(const void* x, void* out, int n,
                                            int k, long long rs,
                                            long long cs, void* scratch,
                                            long long per_col,
                                            void* stream) {
  if (!g_attr_set) {
    cudaFuncSetAttribute(blocked_cumsum_global_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    g_attr_set = true;
  }
  blocked_cumsum_global_kernel<<<k, kThreads, kSmemBytes,
                                 (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (float*)scratch, n, k, rs, cs, per_col);
  return (int)cudaGetLastError();
}
