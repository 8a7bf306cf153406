// The balanced base-16 digit deposit shared by the update kernels
// (opa_deposit, opa_fused): the _deposit body of
// src/repro/kernels/sliced_opa/kernel.py. An int32 update on the weight grid
// is clipped to +-canonical_limit, cut into balanced digits LSB-first
// (d = ((rem + 8) & 15) - 8, then rem = (rem - d) >> 4, exact), and each
// digit is added to its plane with that plane's saturating clip.
//
// With a device model's stuck cells (deposit_stuck), the digit of slice s
// at (r, c) keeps its old value where counter_u01(r, c, w0_s, w1_s) < frac,
// with (w0_s, w1_s) = device_pattern_words(stuck_seed, s): the reference's
// _stuck_masks, applied after the deposit. stuck_bits packs that mask into
// a byte a cell, and deposit_keep applies a packed mask (K1's tensor-core
// body caches the bytes, since the mask is frozen).
#pragma once
#include <stdint.h>

#include "counter.cuh"

#define PANTHER_MAX_DEPOSIT_S 8  // canonical_limit fits int32 up to 8 slices

struct DepositParams {
  int S;
  int lim;                              // canonical_limit
  int plane_max[PANTHER_MAX_DEPOSIT_S];  // saturating bound per plane, LSB-first
};

struct StuckParams {
  float frac;                     // stuck share (f32); the mask is off when <= 0
  int w0[PANTHER_MAX_DEPOSIT_S];  // per-slice pattern key words
  int w1[PANTHER_MAX_DEPOSIT_S];
};

// new planes of one element: p[s] the S plane digits, read and written
__device__ __forceinline__ void deposit_one(int* p, int rem, const DepositParams& dp) {
  rem = min(max(rem, -dp.lim), dp.lim);
#pragma unroll
  for (int s = 0; s < PANTHER_MAX_DEPOSIT_S; ++s) {
    if (s < dp.S) {
      const int d = ((rem + 8) & 15) - 8;
      const int m = dp.plane_max[s];
      p[s] = min(max(p[s] + d, -m), m);
      rem = (rem - d) >> 4;
    }
  }
}

// the stuck-cell mask of the element at global (r, c) as bits, bit s set
// where slice s is stuck: the draws of deposit_stuck
__device__ __forceinline__ uint32_t stuck_bits(int r, int c, const DepositParams& dp, const StuckParams& st) {
  uint32_t bits = 0u;
#pragma unroll
  for (int s = 0; s < PANTHER_MAX_DEPOSIT_S; ++s)
    if (s < dp.S && counter_u01(r, c, st.w0[s], st.w1[s]) < st.frac) bits |= 1u << s;
  return bits;
}

// the deposit of one element whose slices with a set bit keep their old
// digit: deposit_stuck with the mask given as stuck_bits
__device__ __forceinline__ void deposit_keep(int* p, int rem, const DepositParams& dp, uint32_t bits) {
  int old[PANTHER_MAX_DEPOSIT_S];
#pragma unroll
  for (int s = 0; s < PANTHER_MAX_DEPOSIT_S; ++s) old[s] = p[s];
  deposit_one(p, rem, dp);
#pragma unroll
  for (int s = 0; s < PANTHER_MAX_DEPOSIT_S; ++s)
    if (s < dp.S && (bits >> s) & 1u) p[s] = old[s];
}

// the deposit of one element at global (r, c), whose stuck digits keep
// their old value
__device__ __forceinline__ void deposit_stuck(int* p, int rem, const DepositParams& dp, int r, int c,
                                              const StuckParams& st) {
  int old[PANTHER_MAX_DEPOSIT_S];
#pragma unroll
  for (int s = 0; s < PANTHER_MAX_DEPOSIT_S; ++s) old[s] = p[s];
  deposit_one(p, rem, dp);
#pragma unroll
  for (int s = 0; s < PANTHER_MAX_DEPOSIT_S; ++s)
    if (s < dp.S && counter_u01(r, c, st.w0[s], st.w1[s]) < st.frac) p[s] = old[s];
}
