// The counter-hash draws of core.fixed_point (the port of
// src/repro/core/fixed_point.py::counter_u01 and ::counter_gauss), shared by
// the update kernels (stochastic rounding, write noise, stuck-cell masks) and
// the read kernel (read offsets); and the update's two other rounding
// draws, threefry_u01 (rng_mode "grid") and hw_u01 (rng_mode "hw"). A draw is a pure function of the global
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


// threefry2x32 (20 rounds) of the counter pair (x0, x1) under key (k0, k1):
// the hash of jax.random's default implementation (core.prng.threefry2x32)
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int rot[4] = {i % 2 ? 17 : 13, i % 2 ? 29 : 15, i % 2 ? 16 : 26, i % 2 ? 24 : 6};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rot[j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// rng_mode "grid": element idx of jax.random.uniform(key, shape, float32)'s
// stream (JAX's partitionable threefry, core.prng.uniform): the mantissa of
// (b0 ^ b1) >> 9 over [1, 2), minus 1, so multiples of 2^-23 (not 2^-24)
__device__ __forceinline__ float threefry_u01(int k0, int k1, unsigned long long idx) {
  const uint2 b = threefry2x32((uint32_t)k0, (uint32_t)k1, (uint32_t)(idx >> 32), (uint32_t)idx);
  return __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.f;
}

// Philox4x32-10 of counter (c0, c1, c2, c3) under key (k0, k1) (Salmon et
// al., SC'11; the constants of Random123), written out by hand
__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
  }
  return ctr;
}

// rng_mode "hw": the port's stream in place of the TPU's hardware PRNG
// (src/repro/kernels/sliced_opa/kernel.py::_block_noise). Tile tid of JAX's
// (bm, bn) tile grid seeds Philox4x32-10 with key (fmix32(k0 ^ fmix32(k1 ^
// tid)), 0), as the reference seeds the TPU's PRNG; counter (q, 0, 0, 0)
// gives the four in-tile cells 4q..4q+3 (row-major in the tile) four words,
// each (word >> 8) · 2^-24. A pure function of (key words, row, col, M, N).
__device__ __forceinline__ float4 hw_u01(int k0, int k1, int tid, uint32_t q) {
  const uint32_t seed = panther_fmix32((uint32_t)k0 ^ panther_fmix32((uint32_t)k1 ^ (uint32_t)tid));
  const uint4 w = philox4x32_10(make_uint4(q, 0u, 0u, 0u), seed, 0u);
  const float s = 5.9604644775390625e-08f;  // 2^-24
  return make_float4((float)(w.x >> 8) * s, (float)(w.y >> 8) * s, (float)(w.z >> 8) * s, (float)(w.w >> 8) * s);
}
