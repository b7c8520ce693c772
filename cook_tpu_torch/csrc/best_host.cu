// best_host: one dense round of the batched matcher, every row at once.
//
// Replaces the TPU kernel cook_tpu/ops/pallas_match.py::best_host (bodies
// `_kernel`, `_kernel_bonus`, `_score_tile`, `_accumulate`). For each of N
// compact job rows and each of H hosts: the feasibility mask (host valid,
// slots > 0, forbidden byte 0, mem/cpus fit with eps 1e-6, the gpu-host
// rule, unique occupancy, row active), the division-form
// cpuMemBinPacker fitness, an optional (N, H) bonus and the u32 hash
// jitter x `spread`; then the row's first maximum over H. Emits only
// (best_fit, best_host) per row: -1.0 and -1 when nothing beats -1.0.
// Unique occupancy is the host stack's group-0 row (one group: the TPU
// kernel's fold), or, with G groups, a (G, H) u8 occupancy read at each
// unique row's group (clip(id, 0, G - 1), the XLA dense round's gather,
// cook_tpu/ops/match.py:676-678), 16 bytes beside each 16 mask bytes.
//
// What bounds it on an H100: the (N, H) byte mask (plus the (N, H) f32
// bonus in the bonus variant) streamed once from device memory, and the
// instructions of each (row, host) pair: the two divisions and the
// jitter hash are most of them. At the main path's N = 1024, H = 16384
// the bytes take ~5 us and the instructions, at the card's issue rate,
// ~20 us.
//
// Design, for Hopper. The first version (one block of 256 threads per 4
// rows, the host rows re-read by every block, byte mask loads, a warp
// and block argmax per row) ran at 26x its bound; a version with the
// host values in registers and two `redux.sync` per row and warp was
// still latency-bound on the per-row reductions. This one:
// - A 2-D grid: a CTA of kThreads = 128 threads takes 128 rows (one a
//   thread) x one tile of kTileH = 128 hosts, so the main call has 1,024
//   CTAs (~8 a SM) and N = 1 or H = 1 still run.
// - The tile's hosts derived once per CTA into shared memory (mem+eps,
//   cpus+eps, cap-mem, cap-cpus, the caps, their reciprocals, gpus+eps,
//   a class word, the host's part of the hash), 48 bytes a host, read by
//   every thread of a warp at the same address (a broadcast).
// - Each thread walks its row over the tile 16 hosts at a time: one
//   16-byte mask load (and four 16-byte bonus loads), the 16 bytes'
//   nonzero test in four SWAR steps, and a feasibility test of a few
//   predicate ops a pair: the host's class word (valid, slots, gpu host,
//   occupied) against the row's class (gpu row, unique row), the byte,
//   mem, cpus and, for gpu rows, gpus.
// - Fitness for every pair of the chunk (no divergent skip: at the main
//   call ~60% of pairs are feasible, so a warp would take the branch
//   anyway), then a running (fit, host) per thread, even and odd hosts
//   apart so the two select chains overlap.
// - The division by the capacity, RN(a / b), by div_rn.cuh: a
//   reciprocal taken once per host and one correction, no MUFU or FCHK
//   a pair (`best_host_div_check` below holds it against __fdiv_rn over
//   every pair of mantissas). The kernel takes this path
//   only when every host of the tile and the row are tame: used and
//   demand 0 or in [2^-60, 2^59], capacity in [2^-60, 2^60]; otherwise
//   __fdiv_rn. A host without capacity gets y = 0, so its term is +0.
// - The jitter's (z & 0xFFFF) / 65536 is built in the mantissa, 1 + z16 x
//   2^-16 minus 1: exact, as the reference's convert and divide are.
// - The cross-tile argmax in the same launch, deterministically: each
//   thread folds ((order-preserving u32 of the fit) << 32 | ~host) into
//   its row's 64-bit slot with one atomicMax, so the larger fit wins and
//   the lower index wins a tie, whatever order the CTAs run in. Only fits
//   above -1.0 are folded, so a zeroed slot means (-1.0, none) and a fit
//   at or below -1.0 (a negative bonus) loses to it, as in the TPU
//   kernel. The launch function zeroes the slots with cudaMemsetAsync
//   (no host sync); the last CTA to finish (a counter after a fence)
//   decodes every row's slot into (best_fit, best_host): the winner's
//   own bits and index.
//
// Numerics: every float op is an explicit round-to-nearest intrinsic
// (no FMA contraction; the build also passes --fmad=false) in the order
// 0.5 * (f_mem + f_cpu), then + bonus, then + noise; fitness divides by
// the capacity (correctly rounded, as above), as exact_scan does. The
// jitter is u32 arithmetic keyed on the GLOBAL row and
// host index. So the result equals the plain PyTorch version bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "div_rn.cuh"

namespace {

constexpr int kThreads = 128;   // rows a CTA, one a thread
constexpr int kTileH = 128;     // hosts a CTA
constexpr int kChunk = 16;      // hosts a mask load
constexpr int JOB_COLS = 8;
enum { H_MEM, H_CPUS, H_GPUS, H_CAP_MEM, H_CAP_CPUS, H_CAP_GPUS, H_SLOTS,
       H_VALID, H_OCC0, H_FIELDS };
enum { J_MEM, J_CPUS, J_GPUS, J_ACTIVE, J_UNIQUE, J_GROUP };
constexpr float EPS = 1e-6f;

// monotone map of a float's order onto u32 (finite values)
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(uint32_t m) {
  return __uint_as_float((m & 0x80000000u) ? (m & 0x7FFFFFFFu) : ~m);
}

// byte q of the result is 0x80 where byte q of w is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

struct Row {
  float jm, jc, jg;
  uint32_t cls;       // 1 << (gpu row | 2 x unique row)
  bool cpu_row;
  uint32_t rowz;      // the row's part of the jitter hash
};

// host classes: bit c set where the host may take a row of class c
constexpr uint32_t C_CPU = 1, C_GPU = 2, C_CPU_UNIQUE = 4, C_GPU_UNIQUE = 8;

// one chunk of kChunk hosts of one row: fold the feasible fits into the
// thread's two running bests (even and odd hosts)
template <bool kFast, bool kBonus, bool kJitter>
__device__ __forceinline__ void chunk(
    const Row& r, const uint32_t nz[4], const float* bz, int hbase,
    const float4* s_a, const float4* s_b, const uint4* s_c, float spread,
    float bf[2], int bi[2]) {
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const float4 a = s_a[q];    // mem+eps, cpus+eps, cap-mem, cap-cpus
    const float4 b = s_b[q];    // cap_mem, cap_cpus (-1: none), 1 / each
    const uint4 c = s_c[q];     // gpus+eps bits, class, hash part
    bool ok = (c.y & r.cls) != 0;
    ok &= (nz[q >> 2] & (0x80u << (8 * (q & 3)))) == 0;
    ok &= a.x >= r.jm;
    ok &= a.y >= r.jc;
    ok &= r.cpu_row | (__uint_as_float(c.x) >= r.jg);
    const float am = __fadd_rn(a.z, r.jm);
    const float ac = __fadd_rn(a.w, r.jc);
    float fm, fc;
    if (kFast) {
      fm = div_rn(am, b.x, b.z);
      fc = div_rn(ac, b.y, b.w);
    } else {
      fm = b.x > 0.f ? __fdiv_rn(am, b.x) : 0.f;
      fc = b.y > 0.f ? __fdiv_rn(ac, b.y) : 0.f;
    }
    float v = __fmul_rn(0.5f, __fadd_rn(fm, fc));
    if (kBonus) v = __fadd_rn(v, bz[q]);
    if (kJitter) {
      uint32_t z = r.rowz + c.z;
      z ^= z >> 15;
      z *= 2246822519u;
      z ^= z >> 13;
      // (z & 0xFFFF) / 65536: 1 + z16 x 2^-16 in the mantissa, minus 1
      const float u = __fsub_rn(
          __uint_as_float(0x3F800000u | ((z << 7) & 0x7FFF80u)), 1.0f);
      v = __fadd_rn(v, __fmul_rn(u, spread));
    }
    if (ok && v > bf[q & 1]) {   // hosts rise with q: the first max stays
      bf[q & 1] = v;
      bi[q & 1] = hbase + q;
    }
  }
}

template <bool kBonus, bool kVec, bool kJitter>
__global__ void __launch_bounds__(kThreads)
best_host_kernel(const float* __restrict__ jobs,
                 const float* __restrict__ hosts,
                 const uint8_t* __restrict__ forb,
                 const float* __restrict__ bonus,
                 const uint8_t* __restrict__ occ,
                 float* __restrict__ best_fit,
                 int32_t* __restrict__ best_idx,
                 unsigned long long* __restrict__ slots,
                 unsigned int* __restrict__ done,
                 int N, int H, int G, float spread) {
  __shared__ float4 s_a[kTileH];
  __shared__ float4 s_b[kTileH];
  __shared__ uint4 s_c[kTileH];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int ht = blockIdx.y * kTileH;
  const size_t HH = (size_t)H;

  // the tile's hosts, derived once
  bool tame_hosts = true;
  for (int i = tid; i < kTileH; i += kThreads) {
    const int h = ht + i;
    float f[H_FIELDS];
#pragma unroll
    for (int k = 0; k < H_FIELDS; ++k) f[k] = h < H ? hosts[k * HH + h] : 0.f;
    const float used_mem = __fsub_rn(f[H_CAP_MEM], f[H_MEM]);
    const float used_cpus = __fsub_rn(f[H_CAP_CPUS], f[H_CPUS]);
    const bool cm = f[H_CAP_MEM] > 0.f, cc = f[H_CAP_CPUS] > 0.f;
    const float cap_mem = cm ? f[H_CAP_MEM] : -1.0f;
    const float cap_cpus = cc ? f[H_CAP_CPUS] : -1.0f;
    s_a[i] = make_float4(__fadd_rn(f[H_MEM], EPS), __fadd_rn(f[H_CPUS], EPS),
                         used_mem, used_cpus);
    s_b[i] = make_float4(cap_mem, cap_cpus,
                         cm ? __frcp_rn(f[H_CAP_MEM]) : 0.f,
                         cc ? __frcp_rn(f[H_CAP_CPUS]) : 0.f);
    const bool ok = h < H && f[H_VALID] > 0.f && f[H_SLOTS] > 0.f;
    const bool gpu = f[H_CAP_GPUS] > 0.f;
    // with a (G, H) occupancy the rows' groups are checked per pair
    // instead, and the host stack's group-0 row is not read
    const bool vacant = occ != nullptr || !(f[H_OCC0] > 0.f);
    const uint32_t cls = (ok && !gpu ? C_CPU : 0u) | (ok && gpu ? C_GPU : 0u) |
                         (ok && !gpu && vacant ? C_CPU_UNIQUE : 0u) |
                         (ok && gpu && vacant ? C_GPU_UNIQUE : 0u);
    s_c[i] = make_uint4(__float_as_uint(__fadd_rn(f[H_GPUS], EPS)), cls,
                        (uint32_t)h * 40503u, 0u);
    tame_hosts = tame_hosts && tame(used_mem) && tame(used_cpus) &&
        (!cm || tame_divisor(cap_mem)) && (!cc || tame_divisor(cap_cpus));
  }
  tame_hosts = __syncthreads_and(tame_hosts);

  const int row = blockIdx.x * kThreads + tid;
  float bf[2] = {-1.0f, -1.0f};
  int bi[2] = {-1, -1};
  if (row < N && jobs[(size_t)row * JOB_COLS + J_ACTIVE] > 0.f) {
    const float* j = jobs + (size_t)row * JOB_COLS;
    Row r;
    r.jm = j[J_MEM];
    r.jc = j[J_CPUS];
    r.jg = j[J_GPUS];
    r.cpu_row = !(r.jg > 0.f);
    r.cls = 1u << ((r.cpu_row ? 0 : 1) | (j[J_UNIQUE] > 0.f ? 2 : 0));
    r.rowz = (uint32_t)row * 2654435761u;
    const bool fast = tame_hosts && tame(r.jm) && tame(r.jc);
    const uint8_t* mrow = forb + (size_t)row * HH + ht;
    const float* brow = kBonus ? bonus + (size_t)row * HH + ht : nullptr;
    // a unique row's group's occupancy (groups = clip(id, 0, G - 1)),
    // OR-ed into its mask bytes
    const uint8_t* orow = nullptr;
    if (occ != nullptr && j[J_UNIQUE] > 0.f) {
      const int g = (int)fminf(fmaxf(j[J_GROUP], 0.f), (float)(G - 1));
      orow = occ + (size_t)g * HH + ht;
    }
    for (int c0 = 0; c0 < kTileH && ht + c0 < H; c0 += kChunk) {
      uint32_t nz[4];
      float bz[kBonus ? kChunk : 1];
      if (kVec) {
        uint4 w = *reinterpret_cast<const uint4*>(mrow + c0);
        if (orow) {
          const uint4 o = *reinterpret_cast<const uint4*>(orow + c0);
          w.x |= o.x;
          w.y |= o.y;
          w.z |= o.z;
          w.w |= o.w;
        }
        nz[0] = nonzero_bytes(w.x);
        nz[1] = nonzero_bytes(w.y);
        nz[2] = nonzero_bytes(w.z);
        nz[3] = nonzero_bytes(w.w);
        if (kBonus) {
#pragma unroll
          for (int k = 0; k < kChunk; k += 4) {
            const float4 x = *reinterpret_cast<const float4*>(brow + c0 + k);
            bz[k] = x.x; bz[k + 1] = x.y; bz[k + 2] = x.z; bz[k + 3] = x.w;
          }
        }
      } else {
        // ragged or misaligned: byte loads, past-the-end hosts excluded
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t w = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int h = c0 + 4 * k + q;
            const uint32_t m =
                ht + h < H ? (uint32_t)mrow[h] | (orow ? orow[h] : 0u) : 1u;
            w |= m << (8 * q);
          }
          nz[k] = nonzero_bytes(w);
        }
        if (kBonus) {
#pragma unroll
          for (int q = 0; q < kChunk; ++q)
            bz[q] = ht + c0 + q < H ? brow[c0 + q] : 0.f;
        }
      }
      if (fast)
        chunk<true, kBonus, kJitter>(r, nz, bz, ht + c0, s_a + c0, s_b + c0,
                                     s_c + c0, spread, bf, bi);
      else
        chunk<false, kBonus, kJitter>(r, nz, bz, ht + c0, s_a + c0,
                                      s_b + c0, s_c + c0, spread, bf, bi);
    }
  }
  // even and odd bests: the larger fit, the lower host on a tie
  if (bf[1] > bf[0] || (bf[1] == bf[0] && bi[1] >= 0 &&
                        (bi[0] < 0 || bi[1] < bi[0]))) {
    bf[0] = bf[1];
    bi[0] = bi[1];
  }
  if (bf[0] > -1.0f)
    atomicMax(&slots[row], ((unsigned long long)order_key(bf[0]) << 32) |
                               (0xFFFFFFFFu - (uint32_t)bi[0]));

  // the last CTA to finish decodes every row's slot
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int r = tid; r < N; r += kThreads) {
    const unsigned long long k = __ldcg(&slots[r]);
    best_fit[r] = k ? from_order_key((uint32_t)(k >> 32)) : -1.0f;
    best_idx[r] = k ? (int32_t)(0xFFFFFFFFu - (uint32_t)k) : -1;
  }
}

template <bool kBonus, bool kVec, bool kJitter>
void launch(dim3 grid, cudaStream_t s, const void* jobs, const void* hosts,
            const void* forb, const void* bonus, const void* occ,
            void* best_fit, void* best_idx, void* scratch, int N, int H,
            int G, float spread) {
  best_host_kernel<kBonus, kVec, kJitter><<<grid, kThreads, 0, s>>>(
      (const float*)jobs, (const float*)hosts, (const uint8_t*)forb,
      (const float*)bonus, (const uint8_t*)occ, (float*)best_fit,
      (int32_t*)best_idx, (unsigned long long*)scratch,
      (unsigned int*)((unsigned long long*)scratch + N), N, H, G, spread);
}

template <bool kBonus, bool kVec>
void launch_jitter(dim3 grid, cudaStream_t s, const void* jobs,
                   const void* hosts, const void* forb, const void* bonus,
                   const void* occ, void* best_fit, void* best_idx,
                   void* scratch, int N, int H, int G, float spread) {
  if (spread != 0.f)
    launch<kBonus, kVec, true>(grid, s, jobs, hosts, forb, bonus, occ,
                               best_fit, best_idx, scratch, N, H, G, spread);
  else
    launch<kBonus, kVec, false>(grid, s, jobs, hosts, forb, bonus, occ,
                                best_fit, best_idx, scratch, N, H, G,
                                spread);
}

// div_rn against __fdiv_rn: blockIdx.x + b0 is b's mantissa (b in [1,
// 2)), the threads walk every a in [1, 2); both scale by powers of two
// without rounding inside the tame range, so these 2^46 pairs decide
// every tame pair. Mismatches are added to *bad.
__global__ void div_check_kernel(unsigned b0,
                                 unsigned long long* __restrict__ bad) {
  const float b = __uint_as_float(0x3F800000u | (b0 + blockIdx.x));
  const float y = __frcp_rn(b);
  unsigned long long n = 0;
  for (unsigned am = threadIdx.x; am < (1u << 23); am += blockDim.x) {
    const float a = __uint_as_float(0x3F800000u | am);
    n += __float_as_uint(div_rn(a, b, y)) !=
         __float_as_uint(__fdiv_rn(a, b));
  }
  if (n) atomicAdd(bad, n);
}

}  // namespace

// Plain C entry point (bound with ctypes). `bonus` may be null (the
// variant that reads no bonus); `occ` is null (the group-0 occupancy
// row of the host stack) or the (G, H) u8 occupancy of G groups.
// `scratch` holds N + 1 u64: the rows' argmax slots and the CTA counter,
// zeroed here on `stream`. Launches on `stream` and returns the CUDA
// error as an int (0 = launched; cudaErrorInvalidValue when H needs more
// than 65,535 host tiles).
extern "C" int best_host_launch(const void* jobs, const void* hosts,
                                const void* forb, const void* bonus,
                                const void* occ, void* best_fit,
                                void* best_idx, void* scratch, int N, int H,
                                int G, float spread, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + kThreads - 1) / kThreads, (H + kTileH - 1) / kTileH);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaMemsetAsync(scratch, 0, ((size_t)N + 1) * sizeof(uint64_t), s);
  if (e != cudaSuccess) return (int)e;
  // 16-byte mask, occupancy and bonus vectors
  const bool vec = H % kChunk == 0 && (uintptr_t)forb % 16 == 0 &&
                   (!bonus || (uintptr_t)bonus % 16 == 0) &&
                   (uintptr_t)occ % 16 == 0;
  if (bonus) {
    if (vec)
      launch_jitter<true, true>(grid, s, jobs, hosts, forb, bonus, occ,
                                best_fit, best_idx, scratch, N, H, G, spread);
    else
      launch_jitter<true, false>(grid, s, jobs, hosts, forb, bonus, occ,
                                 best_fit, best_idx, scratch, N, H, G,
                                 spread);
  } else {
    if (vec)
      launch_jitter<false, true>(grid, s, jobs, hosts, forb, nullptr, occ,
                                 best_fit, best_idx, scratch, N, H, G,
                                 spread);
    else
      launch_jitter<false, false>(grid, s, jobs, hosts, forb, nullptr, occ,
                                  best_fit, best_idx, scratch, N, H, G,
                                  spread);
  }
  return (int)cudaGetLastError();
}

// The division check over b mantissas [b0, b0 + nb) x every a mantissa,
// adding the mismatch count to the u64 at `bad` (zeroed by the caller).
extern "C" int best_host_div_check(unsigned b0, unsigned nb, void* bad,
                                   void* stream) {
  div_check_kernel<<<nb, 256, 0, (cudaStream_t)stream>>>(
      b0, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
