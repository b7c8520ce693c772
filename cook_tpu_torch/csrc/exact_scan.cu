// exact_scan: the whole sequential-greedy Fenzo walk in one launch.
//
// Replaces the TPU kernel cook_tpu/ops/pallas_match.py::_exact_scan_kernel
// (wrapper `exact_scan`). For each of S queue-ordered jobs: build the
// feasibility mask over all H hosts (host valid, slots > 0, forbidden byte
// 0, mem/cpus fit with eps 1e-6, the gpu-host rule, group-0 unique
// occupancy, job active), score cpuMemBinPacker fitness with precomputed
// reciprocals, take the global argmax (lowest index among equal maxima),
// then deplete mem/cpus/gpus/slots of the chosen host and set its occ0.
//
// What bounds it on an H100: a chain of S DEPENDENT block-wide argmax
// reductions — step i+1 reads the host state step i wrote — so it is
// latency-bound, plus S x H bytes of forbidden mask streamed once.
//
// Design (simple first): ONE block of up to 1024 threads; thread t owns
// hosts t, t + blockDim, t + 2 blockDim, ... (any H works). Host state
// lives in a device-memory scratch owned per thread (only the owner ever
// reads or writes a host's mutable lanes, so no cross-thread sync is
// needed on it); each step's forbidden row streams from device memory,
// coalesced across the block. The per-step argmax is a warp-shuffle
// reduction then a shared-memory reduction over warps, carrying the
// index, lowest index winning ties. The owner of the winning host
// depletes it.
//
// Numerics: every float op is an explicit round-to-nearest intrinsic
// (no FMA contraction) and 1/cap is IEEE division, so job_host equals the
// plain PyTorch version exactly and the host lanes match bit for bit.
// Build without --use_fast_math.
//
// Later work: thread-block clusters with a DSMEM argmax reduction, host
// lanes in registers/shared memory across a cluster, and TMA streaming of
// the mask rows.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int JOB_COLS = 8;
enum { H_MEM, H_CPUS, H_GPUS, H_CAP_MEM, H_CAP_CPUS, H_CAP_GPUS, H_SLOTS,
       H_VALID, H_OCC0 };
constexpr int HOST_ROWS = 16;
enum { J_MEM, J_CPUS, J_GPUS, J_ACTIVE, J_UNIQUE };
constexpr float EPS = 1e-6f;

constexpr uint8_t F_VALID = 1;    // host valid
constexpr uint8_t F_GPU = 2;      // cap_gpus > 0
constexpr uint8_t F_OCC0 = 4;     // group-0 occupied (input or this scan)
constexpr uint8_t F_OCC_NEW = 8;  // occupied by this scan

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

__global__ void __launch_bounds__(kMaxThreads, 1)
exact_scan_kernel(const float* __restrict__ jobs,
                  const float* __restrict__ hosts_in,
                  const uint8_t* __restrict__ forb,
                  int32_t* __restrict__ job_host,
                  float* __restrict__ hosts_out,
                  float4* dyn, float4* stat, uint8_t* flags,
                  int S, int H) {
  __shared__ float s_fit[32];
  __shared__ int s_idx[32];
  __shared__ float s_best_fit;
  __shared__ int s_best_idx;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads >> 5;
  const size_t HH = (size_t)H;

  // per-host scratch, each entry touched only by its owner thread
  for (int h = tid; h < H; h += nthreads) {
    const float cm = hosts_in[H_CAP_MEM * HH + h];
    const float cc = hosts_in[H_CAP_CPUS * HH + h];
    const float inv_cm = cm > 0.f ? __fdiv_rn(1.0f, cm) : 0.f;
    const float inv_cc = cc > 0.f ? __fdiv_rn(1.0f, cc) : 0.f;
    stat[h] = make_float4(cm, cc, inv_cm, inv_cc);
    dyn[h] = make_float4(hosts_in[H_MEM * HH + h], hosts_in[H_CPUS * HH + h],
                         hosts_in[H_GPUS * HH + h],
                         hosts_in[H_SLOTS * HH + h]);
    flags[h] = (hosts_in[H_VALID * HH + h] > 0.f ? F_VALID : 0) |
               (hosts_in[H_CAP_GPUS * HH + h] > 0.f ? F_GPU : 0) |
               (hosts_in[H_OCC0 * HH + h] > 0.f ? F_OCC0 : 0);
  }

  for (int i = 0; i < S; ++i) {
    const float* row = jobs + (size_t)i * JOB_COLS;
    const float jm = row[J_MEM];
    const float jc = row[J_CPUS];
    const float jg = row[J_GPUS];
    const bool ja = row[J_ACTIVE] > 0.f;
    const bool ju = row[J_UNIQUE] > 0.f;
    const uint8_t* frow = forb + (size_t)i * HH;

    float bf = -INFINITY;
    int bi = INT_MAX;
    for (int h = tid; h < H; h += nthreads) {
      const uint8_t fl = flags[h];
      const float4 d = dyn[h];
      const float4 st = stat[h];
      bool ok = ja && (fl & F_VALID) && d.w > 0.f && frow[h] == 0;
      ok = ok && __fadd_rn(d.x, EPS) >= jm && __fadd_rn(d.y, EPS) >= jc;
      const bool is_gpu = (fl & F_GPU) != 0;
      ok = ok && (jg > 0.f ? (is_gpu && __fadd_rn(d.z, EPS) >= jg) : !is_gpu);
      ok = ok && !(ju && (fl & F_OCC0));
      float fit = -1.0f;
      if (ok) {
        const float fm = __fmul_rn(__fadd_rn(__fsub_rn(st.x, d.x), jm), st.z);
        const float fc = __fmul_rn(__fadd_rn(__fsub_rn(st.y, d.y), jc), st.w);
        fit = __fmul_rn(0.5f, __fadd_rn(fm, fc));
      }
      if (better(fit, h, bf, bi)) {
        bf = fit;
        bi = h;
      }
    }

    warp_argmax(bf, bi);
    if (lane == 0) {
      s_fit[warp] = bf;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bf = lane < nwarps ? s_fit[lane] : -INFINITY;
      bi = lane < nwarps ? s_idx[lane] : INT_MAX;
      warp_argmax(bf, bi);
      if (lane == 0) {
        s_best_fit = bf;
        s_best_idx = bi;
      }
    }
    __syncthreads();

    const float m = s_best_fit;
    const int best = s_best_idx;
    const bool assigned = m > -0.5f;
    if (tid == 0) job_host[i] = assigned ? best : -1;
    if (assigned && best % nthreads == tid) {
      float4 d = dyn[best];
      d.x = __fsub_rn(d.x, jm);
      d.y = __fsub_rn(d.y, jc);
      d.z = __fsub_rn(d.z, jg);
      d.w = __fsub_rn(d.w, 1.0f);
      dyn[best] = d;
      if (ju) flags[best] |= F_OCC0 | F_OCC_NEW;
    }
  }

  for (int h = tid; h < H; h += nthreads) {
#pragma unroll
    for (int r = 0; r < HOST_ROWS; ++r)
      hosts_out[r * HH + h] = hosts_in[r * HH + h];
    const float4 d = dyn[h];
    hosts_out[H_MEM * HH + h] = d.x;
    hosts_out[H_CPUS * HH + h] = d.y;
    hosts_out[H_GPUS * HH + h] = d.z;
    hosts_out[H_SLOTS * HH + h] = d.w;
    if (flags[h] & F_OCC_NEW)
      hosts_out[H_OCC0 * HH + h] = fmaxf(hosts_in[H_OCC0 * HH + h], 1.0f);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int exact_scan_launch(const void* jobs, const void* hosts_in,
                                 const void* forb, void* job_host,
                                 void* hosts_out, void* dyn, void* stat,
                                 void* flags, int S, int H, void* stream) {
  int threads = ((H + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  exact_scan_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)jobs, (const float*)hosts_in, (const uint8_t*)forb,
      (int32_t*)job_host, (float*)hosts_out, (float4*)dyn, (float4*)stat,
      (uint8_t*)flags, S, H);
  return (int)cudaGetLastError();
}
