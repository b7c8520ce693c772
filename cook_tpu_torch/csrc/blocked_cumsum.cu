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
// from run to run (PyTorch's float cumsum on CUDA is neither).
//
// Why a kernel at all: the plain version costs ~17 launches per level
// (~70 a call at 262,144 rows), and a batched match cycle takes ~17 float
// cumsums, so it would add ~1,200 launches to a cycle that is already
// bound by the host's ~4,480 launches.
//
// What bounds it on an H100: the n x k floats read once and written once
// (a microsecond at the port's largest call, 262,144 x 2); one block per
// column is bound instead by how many loads one SM keeps in flight.
// Design (simple first): ONE launch, one block of 1024 threads per
// column. The up-sweep writes each level's block totals into a scratch
// the wrapper allocates (per column: n/16 + n/256 + ... floats), one
// __syncthreads per level; thread 0 scans the top level (<= 16 values);
// the down-sweep walks back, rescanning each block left to right and
// adding the prefix from the level above, level 0 writing the output.
// Each warp works on tiles of 32 blocks (512 rows): it loads a tile
// coalesced (row 32q + lane, 16 loads in flight), transposes it through
// shared memory so that each lane walks its own block of 16 in order,
// and stores the down-sweep's sums back coalesced. The input may be
// strided (row stride rs, column stride cs); the output is contiguous
// (n, k).
#include <cuda_runtime.h>
#include <stdint.h>

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
blocked_cumsum_kernel(const float* __restrict__ x, float* __restrict__ out,
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

}  // namespace

// Plain C entry point (bound with ctypes). `scratch` holds per_col floats
// per column (blocked_cumsum_scratch(n)). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int blocked_cumsum_launch(const void* x, void* out, void* scratch,
                                     int n, int k, long long rs,
                                     long long cs, long long per_col,
                                     void* stream) {
  if (!g_attr_set) {
    cudaFuncSetAttribute(blocked_cumsum_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    g_attr_set = true;
  }
  blocked_cumsum_kernel<<<k, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (float*)scratch, n, k, rs, cs, per_col);
  return (int)cudaGetLastError();
}
