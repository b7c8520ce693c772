// best_host: one dense round of the batched matcher, every row at once.
//
// Replaces the TPU kernel cook_tpu/ops/pallas_match.py::best_host (bodies
// `_kernel`, `_kernel_bonus`, `_score_tile`, `_accumulate`). For each of N
// compact job rows and each of H hosts: the feasibility mask (host valid,
// slots > 0, forbidden byte 0, mem/cpus fit with eps 1e-6, the gpu-host
// rule, group-0 unique occupancy, row active), the division-form
// cpuMemBinPacker fitness, an optional (N, H) bonus and the u32 hash
// jitter x `spread`; then the row's first maximum over H. Emits only
// (best_fit, best_host) per row: -1.0 and -1 when nothing is feasible.
//
// What bounds it on an H100: the (N, H) byte mask (plus the (N, H) f32
// bonus in the bonus variant) streamed once from device memory, and
// about 35 integer/f32 operations per (row, host) pair (the jitter hash
// is half of them). At the main path's N = 1024, H = 16384 both bounds
// are a few microseconds.
//
// Design (simple first): ONE block of 256 threads per group of ROWS = 4
// rows; thread t walks hosts t, t + 256, ... so each host's nine fields
// are loaded once per block and used for four rows, and each row's mask
// and bonus loads coalesce across the warp (rows are contiguous in
// memory). Each thread keeps a running (fit, index) per row; the block
// then reduces each row with a warp-shuffle argmax and a shared-memory
// pass over warps, carrying the index and preferring the lower index on
// equal fitness — so the first maximum wins across threads, warps and
// strided iterations, as across the TPU kernel's H tiles. The running
// maximum starts at (-1.0, none) like the TPU kernel's output block.
// No state crosses blocks. Two variants sit behind one launch function:
// with a bonus, and without (which reads no bonus bytes).
//
// Numerics: every float op is an explicit round-to-nearest intrinsic
// (no FMA contraction; the build also passes --fmad=false) in the order
// 0.5 * (f_mem + f_cpu), then + bonus, then + noise; fitness divides by
// the capacity (__fdiv_rn), unlike exact_scan's reciprocal. The jitter
// is u32 arithmetic keyed on the GLOBAL row and host index, so the
// result equals the plain PyTorch version bit for bit.
//
// Later work: vectorised (16-byte) mask loads, more rows per block so
// the host fields are read from L2 fewer times, TMA streaming of the
// mask tiles.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int ROWS = 4;
constexpr int JOB_COLS = 8;
enum { H_MEM, H_CPUS, H_GPUS, H_CAP_MEM, H_CAP_CPUS, H_CAP_GPUS, H_SLOTS,
       H_VALID, H_OCC0 };
enum { J_MEM, J_CPUS, J_GPUS, J_ACTIVE, J_UNIQUE };
constexpr float EPS = 1e-6f;

__device__ __forceinline__ bool better(float f, int i, float bf, int bi) {
  return f > bf || (f == bf && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& bf, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float of = __shfl_down_sync(0xffffffffu, bf, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(of, oi, bf, bi)) {
      bf = of;
      bi = oi;
    }
  }
}

template <bool kBonus>
__global__ void __launch_bounds__(kThreads)
best_host_kernel(const float* __restrict__ jobs,
                 const float* __restrict__ hosts,
                 const uint8_t* __restrict__ forb,
                 const float* __restrict__ bonus,
                 float* __restrict__ best_fit,
                 int32_t* __restrict__ best_idx,
                 int N, int H, float spread) {
  __shared__ float s_fit[ROWS][kWarps];
  __shared__ int s_idx[ROWS][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const size_t HH = (size_t)H;
  const bool jitter = spread != 0.f;

  float jm[ROWS], jc[ROWS], jg[ROWS], bf[ROWS];
  bool live[ROWS], ju[ROWS];
  int bi[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    const bool in = row < N;
    const float* j = jobs + (size_t)(in ? row : 0) * JOB_COLS;
    jm[r] = j[J_MEM];
    jc[r] = j[J_CPUS];
    jg[r] = j[J_GPUS];
    live[r] = in && j[J_ACTIVE] > 0.f;
    ju[r] = j[J_UNIQUE] > 0.f;
    bf[r] = -1.0f;
    bi[r] = INT_MAX;
  }

  for (int h = tid; h < H; h += kThreads) {
    const float mem = hosts[H_MEM * HH + h];
    const float cpus = hosts[H_CPUS * HH + h];
    const float gpus = hosts[H_GPUS * HH + h];
    const float cap_mem = hosts[H_CAP_MEM * HH + h];
    const float cap_cpus = hosts[H_CAP_CPUS * HH + h];
    const bool is_gpu = hosts[H_CAP_GPUS * HH + h] > 0.f;
    const bool host_ok = hosts[H_VALID * HH + h] > 0.f &&
                         hosts[H_SLOTS * HH + h] > 0.f;
    const bool occ = hosts[H_OCC0 * HH + h] > 0.f;
    const float mem_eps = __fadd_rn(mem, EPS);
    const float cpus_eps = __fadd_rn(cpus, EPS);
    const float gpus_eps = __fadd_rn(gpus, EPS);
    const float used_mem = __fsub_rn(cap_mem, mem);
    const float used_cpus = __fsub_rn(cap_cpus, cpus);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = row0 + r;
      if (!live[r] || !host_ok) {
        if (better(-1.0f, h, bf[r], bi[r])) bi[r] = h;
        continue;
      }
      const size_t off = (size_t)row * HH + h;
      bool ok = forb[off] == 0 && mem_eps >= jm[r] && cpus_eps >= jc[r];
      ok = ok && (jg[r] > 0.f ? (is_gpu && gpus_eps >= jg[r]) : !is_gpu);
      ok = ok && !(ju[r] && occ);
      float fit = -1.0f;
      if (ok) {
        const float fm = cap_mem > 0.f
            ? __fdiv_rn(__fadd_rn(used_mem, jm[r]), cap_mem) : 0.f;
        const float fc = cap_cpus > 0.f
            ? __fdiv_rn(__fadd_rn(used_cpus, jc[r]), cap_cpus) : 0.f;
        fit = __fmul_rn(0.5f, __fadd_rn(fm, fc));
        if (kBonus) fit = __fadd_rn(fit, bonus[off]);
        if (jitter) {
          uint32_t z = (uint32_t)row * 2654435761u + (uint32_t)h * 40503u;
          z ^= z >> 15;
          z *= 2246822519u;
          z ^= z >> 13;
          const float noise =
              __fmul_rn(__fdiv_rn((float)(z & 0xFFFFu), 65536.0f), spread);
          fit = __fadd_rn(fit, noise);
        }
      }
      if (better(fit, h, bf[r], bi[r])) {
        bf[r] = fit;
        bi[r] = h;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    warp_argmax(bf[r], bi[r]);
    if (lane == 0) {
      s_fit[r][warp] = bf[r];
      s_idx[r][warp] = bi[r];
    }
  }
  __syncthreads();
  // warp r reduces row r over the block's warps
  if (warp < ROWS) {
    float f = lane < kWarps ? s_fit[warp][lane] : -1.0f;
    int i = lane < kWarps ? s_idx[warp][lane] : INT_MAX;
    warp_argmax(f, i);
    const int row = row0 + warp;
    if (lane == 0 && row < N) {
      best_fit[row] = f;
      best_idx[row] = f > -1.0f ? i : -1;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). `bonus` may be null (the
// variant that reads no bonus). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int best_host_launch(const void* jobs, const void* hosts,
                                const void* forb, const void* bonus,
                                void* best_fit, void* best_idx, int N, int H,
                                float spread, void* stream) {
  const int blocks = (N + ROWS - 1) / ROWS;
  if (bonus) {
    best_host_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)jobs, (const float*)hosts, (const uint8_t*)forb,
        (const float*)bonus, (float*)best_fit, (int32_t*)best_idx, N, H,
        spread);
  } else {
    best_host_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)jobs, (const float*)hosts, (const uint8_t*)forb,
        nullptr, (float*)best_fit, (int32_t*)best_idx, N, H, spread);
  }
  return (int)cudaGetLastError();
}
