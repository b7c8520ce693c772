// Correctly rounded f32 division by a per-host capacity, shared by the
// match kernels (best_host.cu, exact_scan.cu).
//
// RN(a / b) as q = RN(a y), r = a - b q, RN(q + r y) with y = RN(1 / b)
// taken once per host (__frcp_rn): one multiply and two FMAs, no MUFU or
// FCHK a pair. It equals __fdiv_rn when a is 0 or in [2^-60, 2^60] and b
// in [2^-60, 2^60] (Markstein's correction theorem; best_host.cu's
// `best_host_div_check` holds it against __fdiv_rn over every pair of
// mantissas). Outside that range a caller divides with __fdiv_rn.
#pragma once

// 0 or a normal number in [2^-60, 2^59]: the sum of two is a tame
// dividend
__device__ __forceinline__ bool tame(float x) {
  return x == 0.f || (x >= 0x1p-60f && x <= 0x1p59f);
}

// a in {0} U [2^-60, 2^60]: a dividend div_rn takes
__device__ __forceinline__ bool tame_dividend(float a) {
  return a == 0.f || (a >= 0x1p-60f && a <= 0x1p60f);
}

// b in [2^-60, 2^60]: a divisor div_rn takes
__device__ __forceinline__ bool tame_divisor(float b) {
  return b >= 0x1p-60f && b <= 0x1p60f;
}

// RN(a / b) from y = RN(1 / b): exact for a in {0} U [2^-60, 2^60] and b
// in [2^-60, 2^60]; with y = 0 (no capacity) and a >= 0 it gives +0
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}
