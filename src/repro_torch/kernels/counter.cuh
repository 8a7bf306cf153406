// The counter-hash draws of core.fixed_point (the port of
// src/repro/core/fixed_point.py::counter_u01 and ::counter_gauss), shared by
// the update kernels (stochastic rounding, write noise, stuck-cell masks) and
// the read kernel (read offsets). A draw is a pure function of the global
// (row, col) and two int32 key words, so it does not depend on the blocking.
// uint32 arithmetic wraps like the reference's int32 hash. The Gaussian is
// Box-Muller with every product rounded on its own (__fmul_rn), through
// libdevice's log1pf/sqrtf/cosf: accurate to an ulp or two, not the fast
// intrinsics (build without --use_fast_math).
#pragma once
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t panther_fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// U[0, 1): (fmix32(((r·GOLDEN) ^ (c·C2) ^ k0) ^ k1) >> 8) · 2^-24
__device__ __forceinline__ float counter_u01(int r, int c, int k0, int k1) {
  uint32_t h = ((uint32_t)r * 0x9e3779b9u) ^ ((uint32_t)c * 0xc2b2ae35u) ^ (uint32_t)k0;
  h = panther_fmix32(h ^ (uint32_t)k1);
  return (float)(h >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// N(0, 1): sqrt(-2·log1p(-u1)) · cos(f32(2π)·u2), the second draw under
// (k0 ^ GOLDEN, fmix32(k1 ^ C1)); u1 <= 1 - 2^-24, so the log is finite.
// Not inlined: K1's unrolled finalize calls it once per element of a
// thread's 8x8 sub-tile, and one copy of log1pf/cosf serves them all.
__device__ __noinline__ float counter_gauss(int r, int c, int k0, int k1) {
  const float u1 = counter_u01(r, c, k0, k1);
  const float u2 = counter_u01(r, c, (int)((uint32_t)k0 ^ 0x9e3779b9u),
                               (int)panther_fmix32((uint32_t)k1 ^ 0x85ebca6bu));
  const float rad = sqrtf(__fmul_rn(-2.f, log1pf(-u1)));
  return __fmul_rn(rad, cosf(__fmul_rn(6.28318548f, u2)));
}
