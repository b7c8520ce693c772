// ordered_scatter: f32 scatter-add in update order (out[t] += vals[j] for
// every j with idx[j] == t, one round-to-nearest add at a time, j rising;
// keys outside [0, T) are dropped).
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
// What bounds it on an H100: the function reads n indices and n x k
// floats and reads and writes the touched targets: well under a
// microsecond of device memory at the port's calls (n <= 300,064). The
// order is a dependency chain per target, so a long run is bound by its
// chain of adds. The one-launch route below runs on one SM: measured by
// clock64 stamps per phase, its sort is bound by that SM's instruction
// issue (~1,200 cycles per 32 words a warp, the 32 warps together), and
// where the values stay in device memory (the usage call) its walk is
// bound by that SM's rate of scattered loads (~3 cycles a value).
//
// Three routes (segments.scatter_plan picks one by the shape):
//
// "ordered_scatter" (n <= 32,768, T <= 65,535: every call of the main
// path), ONE launch of ONE CTA of 1,024 threads, no sort before it:
// - Each update becomes a word (key << jbits | j), key = idx[j], or T
//   for a dropped one. A stable LSD radix sort by key (one or two
//   passes of <= 9-bit digits over the bits of 0..T): per pass, warp w
//   owns a contiguous slice of the words in their current order and
//   counts its digits into its own column of a (digit, warp) histogram
//   in shared memory; an exclusive scan of that histogram, digit-major,
//   gives each (digit, warp) its first position; the warp then walks its
//   slice in order, 32 words at a time, ranking equal digits within the
//   32 by one ballot a digit bit and the popcount of the lower lanes.
//   Slices in order, words in order within a slice: stable by
//   construction. The last pass writes shared memory; the first of two
//   writes shared memory too where it fits (n <= ~16,000), else a
//   scratch in device memory (it stays in L2).
// - Every loop over device memory keeps 8 loads a lane in flight: one
//   memory latency per 8 words or values, not one each (one CTA has one
//   SM's worth of threads to hide latency with). A digit's row of
//   per-warp counts has a pad word, so that a warp's counts lie in 32
//   banks rather than one (a 32-way conflict on every count).
// - The values are copied into shared memory first where they fit
//   beside the words (the bids and the credits; not the usage's 32,768
//   x 3).
// - The walk: the thread at each run's first position adds the run's
//   updates into the target, 4 words and their values loaded before
//   the adds (most runs are short: a host's bids in a round), the
//   targets of 4 runs loaded together. A run still going after 64
//   updates is handed to a warp (its position and partial sums in
//   shared memory): the warp gathers
//   128 updates at a time, 4 a lane, the next batch's gathers issued
//   before this batch's adds, stages them in shared memory, and every
//   lane adds them in order from there, so the chain of adds waits on
//   no one thread's loads. Past a run's end both walks add -0.0, which
//   leaves every f32 as it is (-0.0 too), so no add waits on a
//   predicate (and ptxas has 7 predicate registers: a predicated add a
//   value, unrolled, failed to allocate).
//
// "ordered_scatter/cluster" (n > 32,768, T <= 1,023 and n within the
// shared memory of 8 CTAs: segments.scatter_plan; the rebalancer's usage
// at 50,064 and 300,064 tasks onto 501 users, the cycle's usage past
// 32,768 running tasks), ONE launch of G thread-block clusters of C CTAs
// of 1,024 threads (C = 16 where the card co-schedules such a cluster,
// else 8; G as many clusters as run at once, <= 16: 7 x 16 on an H100),
// no sort before it. Cluster g owns targets [g tq, g tq + tq), tq =
// ceil(T / G):
// - CTA r counts the keys of updates [r per, r per + per) that fall in
//   its cluster's range into per-warp row histograms (one row a target)
//   in its shared memory, and each row's warps' exclusive prefix.
// - After a cluster barrier, each CTA reads every CTA's row totals over
//   DSMEM and scans them: row d of CTA r starts after every update of
//   the rows before d, then row d's in the CTAs before r. The (row, CTA,
//   warp) order is the updates' order within a row: stable by
//   construction.
// - Each warp places its update indices, 32 at a time ranked by ballot,
//   at their sorted places, which spread evenly over the cluster's CTAs
//   (a DSMEM store where another CTA holds the place); a cluster barrier.
// - The walk: a warp per target's run, in the CTA holding its first
//   place: 128 places loaded (over DSMEM past the CTA's end) and their
//   values gathered (one float2 / float4 load an update where aligned),
//   the next batch before this batch's adds; 32 updates' values at a time
//   staged in shared memory, and every lane adds them in order from there.
//   A relaxed cluster barrier before any CTA exits.
//   Measured by clock64 stamps per CTA (kernel_phases.py) at 50,064 x 501
//   x 2: the count and the placement are bound by instruction issue (~160
//   instructions a row of 32 keys, every cluster's CTAs reading every
//   key: n / C keys an SM), each release/acquire cluster barrier takes
//   ~1,300 cycles, the walk ~4,300.
//
// "ordered_scatter/sorted" (beyond those sizes): the wrapper's stable
// torch.sort of the int32 keys (skey, perm), then one thread per sorted
// position: the thread at a run's first position walks the run, 16
// (key, update) loads and then 16 gathers ahead of the adds.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 16;

template <int K>
__global__ void __launch_bounds__(kThreads)
ordered_scatter_sorted_kernel(const int32_t* __restrict__ skey,
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
void launch_sorted(const void* skey, const void* perm, const void* vals,
                   void* out, int n, int T, cudaStream_t stream) {
  ordered_scatter_sorted_kernel<K>
      <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const int32_t*)skey, (const int64_t*)perm, (const float*)vals,
      (float*)out, n, T);
}

constexpr int kOneThreads = 1024;
constexpr int kWarps = kOneThreads / 32;
constexpr int kMaxN = 32768;
constexpr int kChunk = 8;       // words a lane loads per step of a pass
constexpr int kWalkAhead = 4;   // words a thread loads before its adds
constexpr int kRunGroup = 4;    // run starts whose targets load together
constexpr int kLong = 64;       // updates a thread adds before handing on
constexpr int kMaxLong = kMaxN / kLong;
constexpr int kWarpRows = 4;    // a warp's batch: 4 x 32 updates
constexpr int kLongWarps = 16;  // warps that finish long runs
// a digit's row of per-warp counts, one pad word: a warp's counts then
// lie in 32 banks, not all in one (digit d of warp w at d * 33 + w); the
// pads hold 0, so the digit-major scan over the rows is unchanged
constexpr int kHistRow = kWarps + 1;
// the histogram's region, at least the long-run warps' staging
constexpr int kMinHist = kLongWarps * kWarpRows * 32 * 4;
// shared memory a CTA may take (of 227 KB; the static arrays aside)
constexpr int kSmemMax = 226 * 1024;

struct Handoff {
  int t;
  int pos;
  float acc[4];
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// exclusive prefix sums of a[0, size) in place (integers: any order)
__device__ void block_exclusive_scan(unsigned* a, int size,
                                     unsigned* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (size + kOneThreads - 1) / kOneThreads;
  const int b0 = min(size, tid * per), b1 = min(size, b0 + per);
  unsigned s = 0;
  for (int i = b0; i < b1; ++i) s += a[i];
  unsigned v = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = warp_tot[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  unsigned base = v - s + (warp > 0 ? warp_tot[warp - 1] : 0u);
  for (int i = b0; i < b1; ++i) {
    const unsigned c = a[i];
    a[i] = base;
    base += c;
  }
  __syncthreads();
}

// the same digit as this lane among the active lanes, from one ballot a
// digit bit, up to kMaxBits bits (stable ranking within the warp;
// __match_any_sync, the other way, is several times slower)
template <int kMaxBits>
__device__ __forceinline__ unsigned peers_of(unsigned d, int bits,
                                             unsigned act) {
  unsigned m = act;
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b) {
    if (b < bits) {
      const unsigned bal = __ballot_sync(0xffffffffu, (d >> b) & 1u);
      m &= bal ^ (((d >> b) & 1u) - 1u);  // bal where set, ~bal where not
    }
  }
  return m;
}

// shared memory of the one-launch kernel, in 4-byte words: the
// histogram (later the long-run warps' staging), the sorted words, the
// first of two passes' words (else in device memory), the handoffs,
// and the values (else read from device memory), the last two where
// they fit
struct Layout {
  int hist, ping, vals, total;
};

__host__ __device__ inline Layout one_layout(int n, int k, int d0, int d1) {
  const int dmax = d0 > d1 ? d0 : d1;
  Layout l;
  l.hist = (kHistRow << dmax) > kMinHist ? (kHistRow << dmax) : kMinHist;
  int used = l.hist + n + (int)(sizeof(Handoff) / 4) * kMaxLong;
  const int cap = kSmemMax / 4;
  l.ping = d1 > 0 && used + n <= cap ? n : 0;
  used += l.ping;
  l.vals = used + n * k <= cap ? n * k : 0;
  l.total = used + l.vals;
  return l;
}

template <int K, typename I>
__global__ void __launch_bounds__(kOneThreads, 1)
ordered_scatter_one_kernel(const I* __restrict__ idx,
                           const float* __restrict__ vals,
                           float* __restrict__ out, unsigned* gping, int n,
                           int T, int jbits, int d0, int d1) {
  extern __shared__ unsigned smem[];
  __shared__ unsigned warp_tot[32];
  __shared__ int nlong;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int passes = d1 > 0 ? 2 : 1;
  const Layout lay = one_layout(n, K, d0, d1);
  unsigned* hist = smem;  // (digit, warp), digit-major
  unsigned* S = hist + lay.hist;
  unsigned* ping = lay.ping ? S + n : gping;
  Handoff* list = reinterpret_cast<Handoff*>(S + n + lay.ping);
  float* V = reinterpret_cast<float*>(list + kMaxLong);
  const float* src_vals = lay.vals ? V : vals;
  const unsigned jmask = (1u << jbits) - 1u;
  if (tid == 0) nlong = 0;
  if (lay.vals) {  // the values, coalesced, kChunk loads in flight
    for (int e0 = tid; e0 < n * K; e0 += kChunk * kOneThreads) {
      float v[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int e = e0 + u * kOneThreads;
        v[u] = e < n * K ? vals[e] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int e = e0 + u * kOneThreads;
        if (e < n * K) V[e] = v[u];
      }
    }
  }

  // warp w's slice of the words, in their current order
  const int per = ((n + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int w0 = min(n, warp * per), w1 = min(n, w0 + per);
  for (int p = 0; p < passes; ++p) {
    const int shift = jbits + (p == 0 ? 0 : d0);
    const int bins = 1 << (p == 0 ? d0 : d1);
    const unsigned dmask = (unsigned)bins - 1u;
    unsigned* dst = p == passes - 1 ? S : ping;
    // kChunk words of the slice from base, lane + 32 q: pass 0 makes
    // each from its index, pass 1 reads pass 0's; all loads in flight
    auto load_words = [&](int base, unsigned (&wv)[kChunk]) {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const int i = base + 32 * q + lane;
        if (i >= w1) {
          wv[q] = 0u;
        } else if (p > 0) {
          wv[q] = ping[i];
        } else {
          const I v = idx[i];
          const unsigned key =
              (v < 0 || v >= (I)T) ? (unsigned)T : (unsigned)v;
          wv[q] = key << jbits | (unsigned)i;
        }
      }
    };
    for (int i = tid; i < bins * kHistRow; i += kOneThreads) hist[i] = 0u;
    __syncthreads();
    for (int base = w0; base < w1; base += 32 * kChunk) {
      unsigned wv[kChunk];
      load_words(base, wv);
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (base + 32 * q >= w1) break;  // the slice's end (warp-uniform)
        if (base + 32 * q + lane < w1)
          atomicAdd(&hist[((wv[q] >> shift) & dmask) * kHistRow + warp], 1u);
      }
    }
    __syncthreads();
    block_exclusive_scan(hist, bins * kHistRow, warp_tot);
    // scatter: each word to its digit's next place, lower lanes first
    for (int base = w0; base < w1; base += 32 * kChunk) {
      unsigned wv[kChunk];
      load_words(base, wv);
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        if (base + 32 * q >= w1) break;  // the slice's end (warp-uniform)
        const bool valid = base + 32 * q + lane < w1;
        const unsigned d = (wv[q] >> shift) & dmask;
        const unsigned peers = peers_of<9>(
            d, p == 0 ? d0 : d1, __ballot_sync(0xffffffffu, valid));
        if (valid)
          dst[hist[d * kHistRow + warp] + __popc(peers & lanemask_lt())] =
              wv[q];
        __syncwarp();
        if (valid && lane == 31 - __clz(peers))
          hist[d * kHistRow + warp] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
  }

  // the walk: a thread per run's first position, kRunGroup positions
  // at a time (their targets' loads in flight together)
  for (int i0 = tid; i0 < n; i0 += kRunGroup * kOneThreads) {
    unsigned tg[kRunGroup];
    float base[kRunGroup][K];
#pragma unroll
    for (int g = 0; g < kRunGroup; ++g) {
      const int i = i0 + g * kOneThreads;
      const unsigned t = i < n ? S[i] >> jbits : (unsigned)T;
      // dropped, or not the run's first position: no run here
      tg[g] = t >= (unsigned)T || (i > 0 && (S[i - 1] >> jbits) == t)
                  ? 0xffffffffu : t;
#pragma unroll
      for (int c = 0; c < K; ++c)
        base[g][c] = tg[g] != 0xffffffffu ? out[(size_t)t * K + c] : 0.0f;
    }
#pragma unroll 1
    for (int g = 0; g < kRunGroup; ++g) {
      const unsigned t = tg[g];
      if (t == 0xffffffffu) continue;
      const int i = i0 + g * kOneThreads;
      float acc[K];
#pragma unroll
      for (int c = 0; c < K; ++c) acc[c] = base[g][c];
      int pos = i;
      bool handed = false;
      for (;;) {
        unsigned w[kWalkAhead];
        float v[kWalkAhead][K];
#pragma unroll
        for (int u = 0; u < kWalkAhead; ++u)
          w[u] = pos + u < n ? S[pos + u] : 0xffffffffu;
#pragma unroll
        for (int u = 0; u < kWalkAhead; ++u) {
#pragma unroll
          for (int c = 0; c < K; ++c)
            v[u][c] = (w[u] >> jbits) == t
                          ? src_vals[(size_t)(w[u] & jmask) * K + c]
                          : -0.0f;
        }
        // past the run's end each add is of -0.0, which leaves every
        // f32 as it is (-0.0 too): no predicate per add
#pragma unroll
        for (int u = 0; u < kWalkAhead; ++u) {
#pragma unroll
          for (int c = 0; c < K; ++c) acc[c] = __fadd_rn(acc[c], v[u][c]);
        }
        pos += kWalkAhead;
        if ((w[kWalkAhead - 1] >> jbits) != t) break;   // the run ended
        if (pos - i >= kLong) {                         // a warp goes on
          Handoff& h = list[atomicAdd(&nlong, 1)];
          h.t = (int)t;
          h.pos = pos;
#pragma unroll
          for (int c = 0; c < K; ++c) h.acc[c] = acc[c];
          handed = true;
          break;
        }
      }
      if (!handed) {
#pragma unroll
        for (int c = 0; c < K; ++c) out[(size_t)t * K + c] = acc[c];
      }
    }
  }
  __syncthreads();

  // the long runs' rest: a warp each. Its lanes gather 128 updates (the
  // next batch's gathers issued before this batch's adds), stage them in
  // the histogram's region (free now), and every lane adds them in order
  // from there (broadcast reads)
  const int nl = nlong;
  float* stage = reinterpret_cast<float*>(hist) + warp * kWarpRows * 32 * K;
  auto gather = [&](int pos, unsigned t, float (&v)[kWarpRows][K],
                    unsigned& last) {
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      const int q = pos + 32 * r + lane;
      const unsigned w = q < n ? S[q] : 0xffffffffu;
      const bool m = (w >> jbits) == t;
#pragma unroll
      for (int c = 0; c < K; ++c)
        v[r][c] = m ? src_vals[(size_t)(w & jmask) * K + c] : -0.0f;
      last = __ballot_sync(0xffffffffu, m);  // the last row's stays
    }
  };
  for (int e = warp; warp < kLongWarps && e < nl; e += kLongWarps) {
    const unsigned t = (unsigned)list[e].t;
    int pos = list[e].pos;
    float acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = list[e].acc[c];
    float cur[kWarpRows][K];
    unsigned last = 0u;
    gather(pos, t, cur, last);
    for (;;) {
      const bool more = last >> 31;  // the run may go on past the batch
      float nxt[kWarpRows][K];
      unsigned nlast = 0u;
      if (more) gather(pos + 32 * kWarpRows, t, nxt, nlast);
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
        for (int c = 0; c < K; ++c) stage[(32 * r + lane) * K + c] = cur[r][c];
      }
      __syncwarp();
#pragma unroll 8
      for (int u = 0; u < 32 * kWarpRows; ++u) {
#pragma unroll
        for (int c = 0; c < K; ++c)
          acc[c] = __fadd_rn(acc[c], stage[u * K + c]);
      }
      __syncwarp();
      if (!more) break;
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {
#pragma unroll
        for (int c = 0; c < K; ++c) cur[r][c] = nxt[r][c];
      }
      last = nlast;
      pos += 32 * kWarpRows;
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) out[(size_t)t * K + c] = acc[c];
    }
  }
}

template <int K, typename I>
int launch_one(const void* idx, const void* vals, void* out, void* ping,
               int n, int T, int jbits, int d0, int d1,
               cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(ordered_scatter_one_kernel<K, I>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemMax);
    attr_set = true;
  }
  const size_t smem = 4 * (size_t)one_layout(n, K, d0, d1).total;
  ordered_scatter_one_kernel<K, I><<<1, kOneThreads, smem, stream>>>(
      (const I*)idx, (const float*)vals, (float*)out, (unsigned*)ping, n, T,
      jbits, d0, d1);
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch_one(int k, const void* idx, const void* vals, void* out,
                 void* ping, int n, int T, int jbits, int d0, int d1,
                 cudaStream_t s) {
  switch (k) {
    case 1: return launch_one<1, I>(idx, vals, out, ping, n, T, jbits, d0,
                                    d1, s);
    case 2: return launch_one<2, I>(idx, vals, out, ping, n, T, jbits, d0,
                                    d1, s);
    case 3: return launch_one<3, I>(idx, vals, out, ping, n, T, jbits, d0,
                                    d1, s);
    case 4: return launch_one<4, I>(idx, vals, out, ping, n, T, jbits, d0,
                                    d1, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- "ordered_scatter/cluster": one launch of G thread-block clusters --
constexpr int kMaxCluster = 16;
constexpr int kMaxClusters = 16;
constexpr int kClusterMaxRows = 1024;  // a cluster's targets (T <= 1,023)
// shared words a row takes: its (row, warp) cursors, its total, its base
// and its run's start
constexpr int kRowWords = kHistRow + 3;
constexpr unsigned kSkip = 0xffffffffu;  // a key outside the cluster's
constexpr int kWalkWarps = 16;           // warps of a CTA that walk runs
// their staging: 32 updates' values (<= 4 floats) a warp
constexpr int kStageWords = kWalkWarps * 32 * 4;

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// before a CTA exits: the others' loads from its shared memory have
// returned before they arrive, so no memory order is waited for (a
// release waits for this CTA's stores to device memory)
__device__ __forceinline__ void cluster_exit() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
               "barrier.cluster.wait.aligned;" ::: "memory");
}

// an update's K values, one load where they are a float2 or a float4
// (one scattered request in place of K: the walk is bound by its SM's
// rate of them)
template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ vals,
                                         unsigned j, bool vec, float (&v)[K]) {
  const float* row = vals + (size_t)j * K;
  if (K == 2 && vec) {
    const float2 w = *reinterpret_cast<const float2*>(row);
    v[0] = w.x;
    v[K - 1] = w.y;
  } else if (K == 4 && vec) {
    const float4 w = *reinterpret_cast<const float4*>(row);
    v[0] = w.x;
    v[1 % K] = w.y;
    v[2 % K] = w.z;
    v[3 % K] = w.w;
  } else {
#pragma unroll
    for (int c = 0; c < K; ++c) v[c] = row[c];
  }
}

// sorted places a CTA holds: ceil(n / C), rounded up to whole warps
__host__ __device__ inline int cluster_slots(int n, int C) {
  return ((n + C - 1) / C + 31) / 32 * 32;
}

// Cluster g owns targets [g tq, g tq + tq): it sorts the updates whose
// key falls there and walks their runs. CTA r of the cluster counts and
// places updates [r per, r per + per) (the same slices in every
// cluster); the cluster's m sorted places spread evenly over its CTAs,
// ceil(m / C) (rounded up to 32, <= per) each
template <int K, typename I>
__global__ void __launch_bounds__(kOneThreads, 1)
ordered_scatter_cluster_kernel(const I* __restrict__ idx,
                               const float* __restrict__ vals,
                               float* __restrict__ out, int n, int T,
                               int tq, int per) {
  extern __shared__ unsigned smem[];
  __shared__ unsigned warp_tot[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const int t0 = (int)(blockIdx.x / C) * tq;
  const int R = min(T, t0 + tq) - t0;      // this cluster's rows
  const int bits = R > 1 ? 32 - __clz(R - 1) : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* hist = smem;                   // (row, warp), row-major
  unsigned* tot = hist + R * kHistRow;     // this CTA's count a row
  unsigned* base = tot + R;                // this CTA's first place a row
  unsigned* start = base + R;              // each run's first place, and
                                           // the end
  float* stage = reinterpret_cast<float*>(start + R + 1);
  unsigned* S = start + R + 1 + kStageWords;  // update indices
  const int c0 = min(n, r * per), c1 = min(n, c0 + per);
  const int pw = ((c1 - c0 + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int w0 = min(c1, c0 + warp * pw), w1 = min(c1, w0 + pw);
  // kChunk rows of the warp's slice from b, lane + 32 q (kSkip: another
  // cluster's target, a dropped key, or past the slice)
  auto load_rows = [&](int b, unsigned (&kv)[kChunk]) {
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int i = b + 32 * q + lane;
      const I v = i < w1 ? idx[i] : (I)-1;
      kv[q] = (v >= (I)t0 && v < (I)(t0 + R)) ? (unsigned)(v - (I)t0)
                                              : kSkip;
    }
  };

  for (int i = tid; i < R * kHistRow; i += kOneThreads) hist[i] = 0u;
  __syncthreads();
  for (int b = w0; b < w1; b += 32 * kChunk) {
    unsigned kv[kChunk];
    load_rows(b, kv);
#pragma unroll
    for (int q = 0; q < kChunk; ++q)
      if (kv[q] != kSkip) atomicAdd(&hist[kv[q] * kHistRow + warp], 1u);
  }
  __syncthreads();
  // a thread a row: its warps' exclusive prefix in place (row d's cells
  // lie in banks d .. d + 31: no conflict), the CTA's total
  for (int d = tid; d < R; d += kOneThreads) {
    unsigned run = 0u;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = hist[d * kHistRow + w];
      hist[d * kHistRow + w] = run;
      run += c;
    }
    tot[d] = run;
  }
  cluster_barrier();  // every CTA's row totals, readable over DSMEM

  // row d's cell of CTA r starts after every update of the rows before
  // d (all the cluster's CTAs), then row d's updates in the CTAs before
  // r: the (row, CTA, warp) order, stable by construction
  unsigned all = 0u, before = 0u;
  if (tid < R) {
    unsigned t[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      t[q] = q < C ? *cluster.map_shared_rank(tot + tid, q) : 0u;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      all += t[q];
      if (q < r) before += t[q];
    }
  }
  unsigned v = all;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned w = warp_tot[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += u;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  if (tid < R) {
    const unsigned first = v - all + (warp > 0 ? warp_tot[warp - 1] : 0u);
    start[tid] = first;
    base[tid] = first + before;
    if (tid == R - 1) start[R] = first + all;
  }
  __syncthreads();
  // the cluster's places, spread evenly: CTA q holds [q pq, q pq + pq)
  const int pq = max(32, cluster_slots((int)start[R], C));

  // placement: each update index to its sorted place, lower lanes first
  for (int b = w0; b < w1; b += 32 * kChunk) {
    unsigned kv[kChunk];
    load_rows(b, kv);
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (b + 32 * q >= w1) break;  // the slice's end (warp-uniform)
      const bool mine = kv[q] != kSkip;
      const unsigned act = __ballot_sync(0xffffffffu, mine);
      if (act == 0u) continue;
      const unsigned d = mine ? kv[q] : 0u;
      const unsigned peers = peers_of<10>(d, bits, act);
      if (mine) {
        const unsigned p = base[d] + hist[d * kHistRow + warp] +
                           __popc(peers & lanemask_lt());
        const int owner = (int)(p / (unsigned)pq);
        unsigned* at = S + (p - (unsigned)(owner * pq));
        *(owner == r ? at : cluster.map_shared_rank(at, owner)) =
            (unsigned)(b + 32 * q + lane);
      }
      __syncwarp();
      if (mine && lane == 31 - __clz(peers))
        hist[d * kHistRow + warp] += __popc(peers);
      __syncwarp();
    }
  }
  cluster_barrier();  // every update index at its place

  // the walk: a warp per target's run [start[t], start[t + 1]), in the
  // CTA that holds the run's first place (rows [d0, d1) here); its lanes
  // load 128 places (over DSMEM where the run goes on in the next CTA)
  // and gather their values from device memory, the next batch before
  // this batch's adds; they stage 32 updates' values at a time in shared
  // memory, and every lane adds them in order from there (broadcast
  // reads, issued ahead of the adds: a shuffle a value held each add
  // back by its latency). Past the run's end a lane holds -0.0, which
  // leaves every sum as it is
  const int d0 = __syncthreads_count(tid < R && (int)start[tid] < r * pq);
  const int d1 =
      __syncthreads_count(tid < R && (int)start[tid] < (r + 1) * pq);
  float* st = stage + warp * 32 * K;
  const bool vec = (K == 2 || K == 4) && ((uintptr_t)vals % (4 * K)) == 0;
  for (int d = d0 + warp; warp < kWalkWarps && d < d1; d += kWalkWarps) {
    const int p0 = (int)start[d], p1 = (int)start[d + 1];
    if (p0 == p1) continue;
    auto gather = [&](int pos, float (&v)[kWarpRows][K]) {
      unsigned j[kWarpRows];
#pragma unroll
      for (int u = 0; u < kWarpRows; ++u) {
        const int p = pos + 32 * u + lane;
        const int owner = p / pq;
        const unsigned* at = S + (p - owner * pq);
        j[u] = p >= p1        ? kSkip
               : owner == r ? *at
                            : *cluster.map_shared_rank(at, owner);
      }
#pragma unroll
      for (int u = 0; u < kWarpRows; ++u) {
        if (j[u] == kSkip) {
#pragma unroll
          for (int c = 0; c < K; ++c) v[u][c] = -0.0f;
        } else {
          load_row<K>(vals, j[u], vec, v[u]);
        }
      }
    };
    const size_t t = (size_t)(t0 + d);
    float acc[K];
#pragma unroll
    for (int c = 0; c < K; ++c) acc[c] = out[t * K + c];
    float cur[kWarpRows][K];
    gather(p0, cur);
    for (int pos = p0; pos < p1; pos += 32 * kWarpRows) {
      float nxt[kWarpRows][K];
      const bool more = pos + 32 * kWarpRows < p1;
      if (more) gather(pos + 32 * kWarpRows, nxt);
#pragma unroll
      for (int u = 0; u < kWarpRows; ++u) {
#pragma unroll
        for (int c = 0; c < K; ++c) st[c * 32 + lane] = cur[u][c];
        __syncwarp();
#pragma unroll 16
        for (int l = 0; l < 32; ++l) {
#pragma unroll
          for (int c = 0; c < K; ++c)
            acc[c] = __fadd_rn(acc[c], st[c * 32 + l]);
        }
        __syncwarp();
      }
      if (!more) break;
#pragma unroll
      for (int u = 0; u < kWarpRows; ++u) {
#pragma unroll
        for (int c = 0; c < K; ++c) cur[u][c] = nxt[u][c];
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < K; ++c) out[t * K + c] = acc[c];
    }
  }
  cluster_exit();  // no CTA leaves while another could read its places
}

// shared memory of a cluster CTA: tq rows, the staging and `per`
// places, in bytes
inline size_t cluster_smem_bytes(int tq, int per) {
  return 4 * ((size_t)kRowWords * tq + 1 + kStageWords + per);
}

template <int K, typename I>
void set_cluster_attrs() {
  static bool done = false;
  if (done) return;
  auto* kernel = ordered_scatter_cluster_kernel<K, I>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemMax);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                       1);
  done = true;
}

// clusters of `ctas` CTAs of 1,024 threads at the route's most shared
// memory the card can run at once (0 where none)
int active_clusters(int ctas) {
  set_cluster_attrs<4, int64_t>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kOneThreads);
  cfg.dynamicSmemBytes = kSmemMax;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, (void*)ordered_scatter_cluster_kernel<4, int64_t>, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// 16 CTAs a cluster where the card can run a cluster of 16, else the
// portable 8; and as many clusters (<= 16) as it can run at once (chosen
// once)
struct Grid {
  int ctas, clusters;
};

Grid cluster_grid() {
  static Grid g = {0, 0};
  if (g.ctas) return g;
  int ctas = kMaxCluster, m = active_clusters(ctas);
  if (m < 1) {
    ctas = 8;
    m = active_clusters(ctas);
  }
  g.ctas = ctas;
  g.clusters = m < 1 ? 1 : (m > kMaxClusters ? kMaxClusters : m);
  return g;
}

template <int K, typename I>
int launch_cluster(const void* idx, const void* vals, void* out, int n,
                   int T, cudaStream_t stream) {
  const Grid grid = cluster_grid();
  const int C = grid.ctas;
  // targets a cluster: as even as the clusters allow, none empty
  const int tq = (T + grid.clusters - 1) / grid.clusters;
  const int G = (T + tq - 1) / tq;
  const int per = cluster_slots(n, C);
  const size_t smem = cluster_smem_bytes(tq, per);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  set_cluster_attrs<K, I>();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * C);
  cfg.blockDim = dim3(kOneThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ordered_scatter_cluster_kernel<K, I>, (const I*)idx,
      (const float*)vals, (float*)out, n, T, tq, per);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch_cluster(int k, const void* idx, const void* vals, void* out,
                     int n, int T, cudaStream_t s) {
  switch (k) {
    case 1: return launch_cluster<1, I>(idx, vals, out, n, T, s);
    case 2: return launch_cluster<2, I>(idx, vals, out, n, T, s);
    case 3: return launch_cluster<3, I>(idx, vals, out, n, T, s);
    case 4: return launch_cluster<4, I>(idx, vals, out, n, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point of the one-launch route (bound with ctypes). idx
// (n,) contiguous int32 (idx64 = 0) or int64 (1); vals (n, k) and out
// (T, k) contiguous f32, k in 1..4; ping n int32 of scratch when d1 > 0;
// n <= 32,768, T <= 65,535, jbits = bits of n - 1, d0 + d1 = bits of T,
// each <= 9 (segments.scatter_plan). Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched; cudaErrorInvalidValue for
// arguments out of range).
extern "C" int ordered_scatter_launch(const void* idx, const void* vals,
                                      void* out, void* ping, int n, int T,
                                      int k, int idx64, int jbits, int d0,
                                      int d1, void* stream) {
  if (n < 1 || n > kMaxN || T < 1 || T > 65535 || d0 < 1 || d0 > 9 ||
      d1 < 0 || d1 > 9 || jbits + d0 + d1 > 31 || (1 << jbits) < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return idx64 ? dispatch_one<int64_t>(k, idx, vals, out, ping, n, T, jbits,
                                       d0, d1, s)
               : dispatch_one<int32_t>(k, idx, vals, out, ping, n, T, jbits,
                                       d0, d1, s);
}

// The cluster route's grid on this card: CTAs a cluster (16, or 8 where
// 16 cannot be scheduled) and clusters at most (as many as run at once,
// <= 16).
extern "C" int ordered_scatter_cluster_ctas(void) {
  return cluster_grid().ctas;
}
extern "C" int ordered_scatter_clusters(void) {
  return cluster_grid().clusters;
}

// Plain C entry point of the cluster route (bound with ctypes). idx (n,)
// contiguous int32 (idx64 = 0) or int64 (1); vals (n, k) and out (T, k)
// contiguous f32, k in 1..4; T <= 1,023; a CTA's rows and places within
// its shared memory (segments.scatter_plan). Launches one grid of
// clusters on `stream` and returns the launch's error (or
// cudaGetLastError()) as an int (0 = launched; cudaErrorInvalidValue for
// arguments out of range).
extern "C" int ordered_scatter_cluster_launch(const void* idx,
                                              const void* vals, void* out,
                                              int n, int T, int k, int idx64,
                                              void* stream) {
  if (n < 1 || T < 1 || T >= kClusterMaxRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return idx64 ? dispatch_cluster<int64_t>(k, idx, vals, out, n, T, s)
               : dispatch_cluster<int32_t>(k, idx, vals, out, n, T, s);
}

// Plain C entry point of the sorted route (bound with ctypes). vals
// (n, k) and out (T, k) contiguous f32, k in 1..4; skey (n,) int32 /
// perm (n,) int64 from the stable sort; T < 2^31. Launches on `stream`
// and returns cudaGetLastError() as an int (0 = launched;
// cudaErrorInvalidValue for k out of range).
extern "C" int ordered_scatter_sorted_launch(const void* skey,
                                             const void* perm,
                                             const void* vals, void* out,
                                             int n, int T, int k,
                                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch_sorted<1>(skey, perm, vals, out, n, T, s); break;
    case 2: launch_sorted<2>(skey, perm, vals, out, n, T, s); break;
    case 3: launch_sorted<3>(skey, perm, vals, out, n, T, s); break;
    case 4: launch_sorted<4>(skey, perm, vals, out, n, T, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
