// exact_scan: the whole sequential-greedy Fenzo walk in one launch, on a
// thread-block cluster.
//
// Replaces the TPU kernel cook_tpu/ops/pallas_match.py:166-272
// (`_exact_scan_kernel`, wrapper `exact_scan`) and computes what the
// reference's default route computes, the XLA scan `_scan_assign`
// (cook_tpu/ops/match.py:135-172), for any number of groups G and an
// optional (S, H) fitness bonus. For each of S queue-ordered jobs: build
// the feasibility mask over all H hosts (host valid, slots > 0,
// forbidden byte 0, mem/cpus fit with eps 1e-6, the gpu-host rule, the
// job's group's unique occupancy, job active), score cpuMemBinPacker
// fitness (division form, the reference's `_fitness`) plus the bonus,
// take the global argmax (lowest index among equal maxima), then
// deplete mem/cpus/gpus/slots of the chosen host and set its occupancy
// bit for the job's group when the job is unique.
//
// What bounds it on an H100: not bytes (S x H mask bytes once, ~17 MB at
// S = 1024, H = 16384: 5 us at 3.35 TB/s; 4x that again for a bonus) but
// the chain of S DEPENDENT argmax steps: step i + 1 reads the host state
// step i wrote. The time is S x (one step's latency), and the design
// cuts that latency:
//
// - A cluster of 16 CTAs (non-portable size; 8 where the card cannot
//   co-schedule 16), launched with cudaLaunchKernelEx. CTA r owns one
//   contiguous slice of the hosts (a multiple of 16 long), so a step's
//   fitness work is spread over 16 SMs instead of one.
// - Host lanes on chip for the whole scan: each CTA keeps mem, cpus,
//   gpus, slots, cap_mem, cap_cpus, 1/cap_mem, 1/cap_cpus (two float4)
//   and the valid/gpu/occ0/occ-new flag bits of up to kCap = 4096
//   hosts in shared memory, 33 B a host: an on-chip capacity of 65,536
//   hosts with 16 CTAs (32,768 with 8). No lane is re-read from device
//   memory at any step. Beyond the capacity, a slice's remaining hosts
//   keep their lanes in a global scratch (slower, but any H works).
// - The mask is prefetched: each CTA keeps a ring of kRing mask rows of
//   its on-chip slice in shared memory, filled kRing steps ahead by
//   `cp.async.bulk` (a 1-D bulk copy completing on an mbarrier with an
//   expected byte count), so no device-memory latency sits on the chain.
//   A bonus row of the slice rides the same ring and the same mbarrier
//   (4 B a host). A slice that is not 16-byte aligned or sized
//   (H % 16 != 0) reads its mask and bonus with plain loads instead. The
//   job rows are staged in shared memory up front (kJobTile rows at a
//   time).
// - Shared memory: 2 x 4096 x 16 B of lanes, 4 x 4096 B of mask ring and
//   4 KB of flags, plus the job tile. Without a bonus the tile is 1,024
//   rows (32 KB; 180 KB in all); a bonus ring adds 4 x 4096 x 4 B =
//   64 KB, so the bonus route stages 256 job rows at a time (8 KB;
//   220 KB in all, under the 227 KB a CTA may have): kJobTile is the one
//   size the routes differ in, and a smaller tile costs one more staging
//   pass every 256 steps.
// - Groups (G > 1): the occupancy is a (G, H) u8 tensor, copied to the
//   output on the stream before the launch and updated there in place.
//   The thread that owns a host is the only one that ever reads or
//   writes that host's column (its depletion picks the same thread), so
//   a unique job's step reads its group's bytes of the thread's hosts
//   straight from device memory, with no fence and no cross-CTA
//   traffic, and the winner's owner writes the chosen host's byte. That
//   read is on the chain: ~one L2 round trip a step, for unique jobs
//   only. With G = 1 the occupancy is the host stack's group-0 row,
//   folded into the flag bits as before.
// - One cluster barrier a step: per-thread fitness; a warp-shuffle
//   argmax; the CTA argmax through shared memory (one __syncthreads);
//   warp 0 writes the CTA's (fit, idx) into slot r of every CTA's shared
//   memory over DSMEM; one barrier.cluster.arrive.release /
//   wait.acquire; every warp of every CTA reduces the same candidates
//   in the same order, so all agree on the winner, and the owning thread
//   depletes its lanes. The slots are double-buffered by step parity,
//   so a CTA that runs ahead cannot overwrite candidates still being
//   read. CTA 0 writes job_host[i]; at the end each CTA writes its slice
//   of hosts_out.
// - The routes (bonus or not, groups or not) are template arguments, so
//   the one-group route without a bonus compiles to what it was.
//
// Numerics: every float op is an explicit round-to-nearest intrinsic (no
// FMA contraction; the build also passes --fmad=false), in the
// reference's order: used = cap - left, (used + demand) / cap where cap >
// 0 (else 0), 0.5 * (f_mem + f_cpu), then + bonus. The division is
// correctly rounded, so an exact tie between hosts stays a tie, as in
// `_scan_assign`: div_rn.cuh's reciprocal taken once per host and one
// correction, exact for dividends of magnitude 0 or in [2^-60, 2^60]
// (it is odd in the dividend) and divisors in [2^-60, 2^60]. The launch
// checks once that every valid host's capacities and free amounts and
// every active job's demands are 0 or of magnitude in [2^-37, 2^58]:
// then every one is a multiple of 2^-60, every difference, sum and
// depletion of them stays one (rounding a multiple of 2^-60 gives one),
// so every dividend (used + demand) is 0 or of magnitude in [2^-60,
// 2^60], and every positive capacity a divisor div_rn takes (a capacity
// <= 0 has y = 0: a zero term, as the reference's where gives). Such a
// walk divides with div_rn alone; any other falls back, for the whole
// launch, to a branch a pair to `__fdiv_rn` where an operand is out of
// range. That branch on every pair, though never taken, made the walk
// 0.14 ms slower at S = 1024, H = 16384 on an H100 (time_kernels.py
// against the kernel before this division); the launch-wide check does
// not. The running
// max starts at -INF, the lowest index wins ties and m > -0.5 means
// assigned; argmax with that tie-break does not depend on the reduction
// order, so the cluster picks the same host as a single block. job_host
// equals the plain PyTorch version and the host lanes and the occupancy
// match bit for bit. Build without --use_fast_math.
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <limits.h>
#include <math.h>

#include "div_rn.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
// the CTA and cluster reductions hold one candidate per lane of a half
// warp (both halves the same), so each is a 4-level butterfly
static_assert(kMaxWarps <= 16 && kMaxCluster <= 16, "half-warp reductions");
constexpr int kCap = 4096;      // on-chip hosts per CTA
constexpr int kRing = 4;        // mask (and bonus) rows in flight per CTA
constexpr int JOB_COLS = 8;
enum { H_MEM, H_CPUS, H_GPUS, H_CAP_MEM, H_CAP_CPUS, H_CAP_GPUS, H_SLOTS,
       H_VALID, H_OCC0 };
constexpr int HOST_ROWS = 16;
enum { J_MEM, J_CPUS, J_GPUS, J_ACTIVE, J_UNIQUE, J_GROUP };
constexpr float EPS = 1e-6f;

constexpr uint8_t F_VALID = 1;    // host valid
constexpr uint8_t F_GPU = 2;      // cap_gpus > 0
constexpr uint8_t F_OCC0 = 4;     // group-0 occupied (input or this scan)
constexpr uint8_t F_OCC_NEW = 8;  // occupied by this scan

// job rows staged at a time: the bonus ring takes the room of 768 rows
template <bool kBonus>
__host__ __device__ constexpr int job_tile() { return kBonus ? 256 : 1024; }

// dynamic shared memory: dyn[kCap] float4, stat[kCap] float4, with a
// bonus bonus[kRing][kCap] f32, jobs[job_tile * 8] f32, ring[kRing][kCap]
// u8, flags[kCap] u8
template <bool kBonus>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * kCap * sizeof(float4) +
         (kBonus ? (size_t)kRing * kCap * sizeof(float) : 0) +
         job_tile<kBonus>() * JOB_COLS * sizeof(float) + kRing * kCap +
         kCap;
}
static_assert(smem_bytes<true>() + 1024 <= 232448, "227 KB a CTA");

__device__ __forceinline__ bool better(float f, int i, float bf, int bi) {
  return f > bf || (f == bf && i < bi);
}

// butterfly argmax over each run of kWidth lanes: every lane ends with
// its run's (max, lowest index)
template <int kWidth>
__device__ __forceinline__ void warp_argmax(float& bf, int& bi) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) {
    const float of = __shfl_xor_sync(0xffffffffu, bf, off, kWidth);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off, kWidth);
    if (better(of, oi, bf, bi)) {
      bf = of;
      bi = oi;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(1) : "memory");
}

// arm `bar` for `bytes` of bulk copies (one arrival)
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one row slice, global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

struct __align__(8) Cand {
  float f;
  int i;
};

struct Job {
  float jm, jc, jg;
  bool ja, ju;
  size_t occ_row;   // G > 1: the group's row offset in the occupancy
};

// the reference's where(cap > 0, (used + demand) / cap, 0), correctly
// rounded for any operands; y = RN(1 / cap)
__device__ __forceinline__ float frac(float a, float cap, float y) {
  if (!(cap > 0.f)) return 0.f;
  return tame_divisor(cap) && tame_dividend(a) ? div_rn(a, cap, y)
                                               : __fdiv_rn(a, cap);
}

// 0, or of magnitude in [2^-37, 2^58]: a multiple of 2^-60 (a float of
// magnitude >= 2^-37 has an ulp >= 2^-60) of magnitude <= 2^58
__device__ __forceinline__ bool grid60(float x) {
  const float m = fabsf(x);
  return x == 0.f || (m >= 0x1p-37f && m <= 0x1p58f);
}

// the walk's division route: div_rn alone (every operand on the 2^-60
// grid, see the header), or frac's branch to __fdiv_rn
template <bool B>
struct Exact {
  static constexpr bool value = B;
};

// fold one host into the thread's running (fit, idx); hosts arrive in
// ascending index order, so a strict > keeps the lowest index on ties
template <bool kBonus, bool kExact>
__device__ __forceinline__ void score(const Job& j, uint8_t fl, float4 d,
                                      float4 st, uint8_t fb, bool occupied,
                                      float bon, int h, float& bf, int& bi) {
  bool ok = j.ja && (fl & F_VALID) && d.w > 0.f && fb == 0;
  ok = ok && __fadd_rn(d.x, EPS) >= j.jm && __fadd_rn(d.y, EPS) >= j.jc;
  const bool is_gpu = (fl & F_GPU) != 0;
  ok = ok && (j.jg > 0.f ? (is_gpu && __fadd_rn(d.z, EPS) >= j.jg) : !is_gpu);
  ok = ok && !(j.ju && occupied);
  float fit = -1.0f;
  if (ok) {
    const float am = __fadd_rn(__fsub_rn(st.x, d.x), j.jm);
    const float ac = __fadd_rn(__fsub_rn(st.y, d.y), j.jc);
    float fm, fc;
    if (kExact) {
      fm = frac(am, st.x, st.z);
      fc = frac(ac, st.y, st.w);
    } else {
      fm = div_rn(am, st.x, st.z);
      fc = div_rn(ac, st.y, st.w);
    }
    fit = __fmul_rn(0.5f, __fadd_rn(fm, fc));
    if (kBonus) fit = __fadd_rn(fit, bon);
  }
  if (fit > bf) {
    bf = fit;
    bi = h;
  }
}

__device__ __forceinline__ void deplete(const Job& j, float4& d) {
  d.x = __fsub_rn(d.x, j.jm);
  d.y = __fsub_rn(d.y, j.jc);
  d.z = __fsub_rn(d.z, j.jg);
  d.w = __fsub_rn(d.w, 1.0f);
}

__device__ __forceinline__ void host_lanes(const float* __restrict__ hin,
                                           size_t HH, int h, float4& d,
                                           float4& st, uint8_t& fl) {
  const float cm = hin[H_CAP_MEM * HH + h];
  const float cc = hin[H_CAP_CPUS * HH + h];
  st = make_float4(cm, cc, cm > 0.f ? __frcp_rn(cm) : 0.f,
                   cc > 0.f ? __frcp_rn(cc) : 0.f);
  d = make_float4(hin[H_MEM * HH + h], hin[H_CPUS * HH + h],
                  hin[H_GPUS * HH + h], hin[H_SLOTS * HH + h]);
  fl = (hin[H_VALID * HH + h] > 0.f ? F_VALID : 0) |
       (hin[H_CAP_GPUS * HH + h] > 0.f ? F_GPU : 0) |
       (hin[H_OCC0 * HH + h] > 0.f ? F_OCC0 : 0);
}

__device__ __forceinline__ void write_host(const float* __restrict__ hin,
                                           float* __restrict__ hout,
                                           size_t HH, int h, float4 d,
                                           uint8_t fl) {
#pragma unroll
  for (int r = 0; r < HOST_ROWS; ++r) hout[r * HH + h] = hin[r * HH + h];
  hout[H_MEM * HH + h] = d.x;
  hout[H_CPUS * HH + h] = d.y;
  hout[H_GPUS * HH + h] = d.z;
  hout[H_SLOTS * HH + h] = d.w;
  if (fl & F_OCC_NEW)
    hout[H_OCC0 * HH + h] = fmaxf(hin[H_OCC0 * HH + h], 1.0f);
}

template <bool kBonus>
__device__ __forceinline__ void stage_jobs(const float* __restrict__ jobs,
                                           float* s_jobs, int first, int S) {
  const int n = min(job_tile<kBonus>(), S - first) * JOB_COLS;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    s_jobs[e] = jobs[(size_t)first * JOB_COLS + e];
}

// blockDim.x is a power of two (32..512); thread t of CTA r owns slice
// hosts l = t, t + blockDim.x, ... (global index h0 + l): it alone reads
// and writes their lanes and their occupancy bytes, so no sync is needed
// on them.
template <bool kBonus, bool kGroups>
__global__ void __launch_bounds__(kMaxThreads, 1)
exact_scan_kernel(const float* __restrict__ jobs,
                  const float* __restrict__ hosts_in,
                  const uint8_t* __restrict__ forb,
                  const float* __restrict__ bonus,
                  uint8_t* occ,
                  int32_t* __restrict__ job_host,
                  float* __restrict__ hosts_out,
                  float4* g_dyn, float4* g_stat, uint8_t* g_flags,
                  int S, int H, int G, int per_cta, int bulk) {
  constexpr int kJobTile = job_tile<kBonus>();
  extern __shared__ __align__(128) unsigned char smem[];
  float4* s_dyn = reinterpret_cast<float4*>(smem);
  float4* s_stat = s_dyn + kCap;
  float* s_bonus = reinterpret_cast<float*>(s_stat + kCap);
  float* s_jobs = s_bonus + (kBonus ? kRing * kCap : 0);
  uint8_t* s_ring = reinterpret_cast<uint8_t*>(s_jobs + kJobTile * JOB_COLS);
  uint8_t* s_flags = s_ring + kRing * kCap;
  __shared__ Cand s_cand[2][kMaxCluster];  // by step parity
  __shared__ Cand s_warp[kMaxWarps];
  __shared__ int s_grid[kMaxCluster];      // each CTA's grid verdict
  __shared__ __align__(8) uint64_t s_bar[kRing];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = blockDim.x;
  const int nwarps = T >> 5;
  const size_t HH = (size_t)H;
  const int h0 = (int)min((long long)H, (long long)rank * per_cta);
  const int h1 = (int)min((long long)H, (long long)h0 + per_cta);
  const int n_loc = h1 - h0;
  const int n_on = min(n_loc, kCap);
  const bool ring = bulk && n_on > 0;
  const uint32_t row_bytes = n_on * (kBonus ? 1 + sizeof(float) : 1);

  // fill ring slot `slot` with job i's mask (and bonus) row slice
  auto prefetch = [&](int slot, int i) {
    mbar_expect(&s_bar[slot], row_bytes);
    bulk_copy(s_ring + slot * kCap, forb + (size_t)i * HH + h0, n_on,
              &s_bar[slot]);
    if (kBonus)
      bulk_copy(s_bonus + slot * kCap, bonus + (size_t)i * HH + h0,
                n_on * sizeof(float), &s_bar[slot]);
  };

  // the division route: div_rn alone when every valid host's capacities
  // and free amounts and every active job's demands lie on the 2^-60
  // grid (the header); decided once for the launch, cluster-wide
  bool grid = true;
  for (int e = tid; e < S; e += T) {
    const float* r = jobs + (size_t)e * JOB_COLS;
    if (r[J_ACTIVE] > 0.f) grid = grid && grid60(r[J_MEM]) &&
                                  grid60(r[J_CPUS]);
  }
  for (int l = tid; l < n_loc; l += T) {
    float4 d, st;
    uint8_t fl;
    host_lanes(hosts_in, HH, h0 + l, d, st, fl);
    if (fl & F_VALID)
      grid = grid && grid60(st.x) && grid60(d.x) && grid60(st.y) &&
             grid60(d.y);
    if (l < kCap) {
      s_dyn[l] = d;
      s_stat[l] = st;
      s_flags[l] = fl;
    } else {
      g_dyn[h0 + l] = d;
      g_stat[h0 + l] = st;
      g_flags[h0 + l] = fl;
    }
  }
  if (ring && tid == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  stage_jobs<kBonus>(jobs, s_jobs, 0, S);
  grid = __syncthreads_and(grid);
  if (ring && tid == 0)
    for (int i = 0; i < min(S, kRing); ++i) prefetch(i, i);
  cluster_barrier();  // every CTA runs before any DSMEM write
  if (tid < C) *cluster.map_shared_rank(&s_grid[rank], tid) = grid;
  cluster_barrier();
  for (int r = 0; r < C; ++r) grid = grid && s_grid[r];

  auto walk = [&](auto route) {
    constexpr bool kExact = decltype(route)::value;
    for (int i = 0; i < S; ++i) {
      if (i > 0 && i % kJobTile == 0) {
        // every thread read row i - 1 before the last cluster barrier
        stage_jobs<kBonus>(jobs, s_jobs, i, S);
        __syncthreads();
      }
      const float* row = s_jobs + (i % kJobTile) * JOB_COLS;
      Job j = {row[J_MEM], row[J_CPUS], row[J_GPUS], row[J_ACTIVE] > 0.f,
               row[J_UNIQUE] > 0.f, 0};
      if (kGroups)   // clip(id, 0, G - 1), G - 1 exact in f32
        j.occ_row = (size_t)(int)fminf(fmaxf(row[J_GROUP], 0.f),
                                       (float)(G - 1)) * HH;
      const bool read_occ = kGroups && j.ju;
      const int slot = i % kRing;
      const uint8_t* mrow = s_ring + slot * kCap;
      const float* brow = s_bonus + slot * kCap;
      const uint8_t* frow = forb + (size_t)i * HH + h0;
      const float* grow = kBonus ? bonus + (size_t)i * HH + h0 : nullptr;
      if (ring) mbar_wait(&s_bar[slot], (uint32_t)(i / kRing) & 1u);

      float bf = -INFINITY;
      int bi = INT_MAX;
      for (int l = tid; l < n_on; l += T) {
        const uint8_t fl = s_flags[l];
        const bool occupied =
            kGroups ? read_occ && occ[j.occ_row + h0 + l] != 0
                    : (fl & F_OCC0) != 0;
        score<kBonus, kExact>(j, fl, s_dyn[l], s_stat[l],
                              ring ? mrow[l] : frow[l], occupied,
                              kBonus ? (ring ? brow[l] : grow[l]) : 0.f,
                              h0 + l, bf, bi);
      }
      for (int l = kCap + tid; l < n_loc; l += T) {
        const uint8_t fl = g_flags[h0 + l];
        const bool occupied =
            kGroups ? read_occ && occ[j.occ_row + h0 + l] != 0
                    : (fl & F_OCC0) != 0;
        score<kBonus, kExact>(j, fl, g_dyn[h0 + l], g_stat[h0 + l], frow[l],
                              occupied, kBonus ? grow[l] : 0.f, h0 + l, bf,
                              bi);
      }

      warp_argmax<32>(bf, bi);
      if (lane == 0) s_warp[warp] = Cand{bf, bi};
      __syncthreads();
      const int par = i & 1;
      if (warp == 0) {
        const int w = lane & 15;
        const Cand v = w < nwarps ? s_warp[w] : Cand{-INFINITY, INT_MAX};
        float f = v.f;
        int x = v.i;
        warp_argmax<16>(f, x);
        if (lane < C)
          *cluster.map_shared_rank(&s_cand[par][rank], lane) = Cand{f, x};
      }
      cluster_barrier();

      float m = -INFINITY;
      int best = INT_MAX;
      if ((lane & 15) < C) {
        const Cand v = s_cand[par][lane & 15];
        m = v.f;
        best = v.i;
      }
      warp_argmax<16>(m, best);
      const bool assigned = m > -0.5f;
      if (rank == 0 && tid == 0) job_host[i] = assigned ? best : -1;
      if (assigned && best >= h0 && best < h1 &&
          ((best - h0) & (T - 1)) == tid) {
        const int l = best - h0;
        uint8_t& fl = l < kCap ? s_flags[l] : g_flags[best];
        deplete(j, l < kCap ? s_dyn[l] : g_dyn[best]);
        if (j.ju) {
          if (kGroups)
            occ[j.occ_row + best] = 1;
          else
            fl |= F_OCC0 | F_OCC_NEW;
        }
      }
      // every thread of this CTA read slot `slot` before the barrier
      if (ring && tid == 0 && i + kRing < S) prefetch(slot, i + kRing);
    }
  };
  if (grid)
    walk(Exact<false>());
  else
    walk(Exact<true>());
  cluster_barrier();  // no CTA leaves while another could touch its smem

  for (int l = tid; l < n_loc; l += T) {
    if (l < kCap)
      write_host(hosts_in, hosts_out, HH, h0 + l, s_dyn[l], s_flags[l]);
    else
      write_host(hosts_in, hosts_out, HH, h0 + l, g_dyn[h0 + l],
                 g_flags[h0 + l]);
  }
}

// 16 CTAs where the card can co-schedule a cluster of 16 with this
// route's shared memory, else the portable 8 (chosen once a route)
template <bool kBonus, bool kGroups>
int cluster_size() {
  static int chosen = 0;
  if (chosen) return chosen;
  auto* kernel = exact_scan_kernel<kBonus, kGroups>;
  const int bytes = (int)smem_bytes<kBonus>();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaFuncSetAttribute(kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kMaxCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (e != cudaSuccess || n < 1) {
    cudaGetLastError();
    chosen = 8;
  } else {
    chosen = kMaxCluster;
  }
  return chosen;
}

template <bool kBonus, bool kGroups>
int launch(const void* jobs, const void* hosts_in, const void* forb,
           const void* bonus, void* occ, void* job_host, void* hosts_out,
           void* dyn, void* stat, void* flags, int S, int H, int G,
           cudaStream_t stream) {
  const int C = cluster_size<kBonus, kGroups>();
  const int per_cta = ((H + C - 1) / C + 15) / 16 * 16;
  int threads = 32;
  while (threads < per_cta && threads < kMaxThreads) threads <<= 1;
  const int bulk = H % 16 == 0 && (uintptr_t)forb % 16 == 0 &&
                   (uintptr_t)bonus % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes<kBonus>();
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, exact_scan_kernel<kBonus, kGroups>, (const float*)jobs,
      (const float*)hosts_in, (const uint8_t*)forb, (const float*)bonus,
      (uint8_t*)occ, (int32_t*)job_host, (float*)hosts_out, (float4*)dyn,
      (float4*)stat, (uint8_t*)flags, S, H, G, per_cta, bulk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The cluster size launches of the one-group route without a bonus use
// (16, or 8 where 16 cannot be scheduled).
extern "C" int exact_scan_cluster(void) {
  return cluster_size<false, false>();
}

// Plain C entry point (bound with ctypes). `bonus` is null or the (S, H)
// f32 bonus; `occ_in` is null (one group: the host stack's group-0 row)
// or the (G, H) u8 occupancy, copied into `occ_out` on `stream` and
// updated there. `dyn`/`stat`/`flags` are the global scratch of H hosts'
// lanes, used only beyond the on-chip capacity. Launches one cluster on
// `stream` and returns the launch's error (or cudaGetLastError()) as an
// int (0 = launched).
extern "C" int exact_scan_launch(const void* jobs, const void* hosts_in,
                                 const void* forb, const void* bonus,
                                 const void* occ_in, void* job_host,
                                 void* hosts_out, void* occ_out, void* dyn,
                                 void* stat, void* flags, int S, int H,
                                 int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (occ_in) {
    const cudaError_t e = cudaMemcpyAsync(occ_out, occ_in, (size_t)G * H,
                                          cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (bonus && occ_in)
    return launch<true, true>(jobs, hosts_in, forb, bonus, occ_out, job_host,
                              hosts_out, dyn, stat, flags, S, H, G, s);
  if (bonus)
    return launch<true, false>(jobs, hosts_in, forb, bonus, nullptr,
                               job_host, hosts_out, dyn, stat, flags, S, H,
                               G, s);
  if (occ_in)
    return launch<false, true>(jobs, hosts_in, forb, nullptr, occ_out,
                               job_host, hosts_out, dyn, stat, flags, S, H,
                               G, s);
  return launch<false, false>(jobs, hosts_in, forb, nullptr, nullptr,
                              job_host, hosts_out, dyn, stat, flags, S, H, G,
                              s);
}
