// The balanced base-16 digit deposit shared by the update kernels
// (opa_deposit, opa_fused): the _deposit body of
// src/repro/kernels/sliced_opa/kernel.py. An int32 update on the weight grid
// is clipped to +-canonical_limit, cut into balanced digits LSB-first
// (d = ((rem + 8) & 15) - 8, then rem = (rem - d) >> 4, exact), and each
// digit is added to its plane with that plane's saturating clip.
#pragma once
#include <stdint.h>

#define PANTHER_MAX_DEPOSIT_S 8  // canonical_limit fits int32 up to 8 slices

struct DepositParams {
  int S;
  int lim;                              // canonical_limit
  int plane_max[PANTHER_MAX_DEPOSIT_S];  // saturating bound per plane, LSB-first
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
