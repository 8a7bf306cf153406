// The per-cell finalize shared by the update kernels (opa_fused, opa_deposit):
// from a cell's f32 increment before the grid scale to its int32 update on
// the 2^-F weight grid, as src/repro/kernels/sliced_opa/kernel.py's
// finalize and its jnp oracle compute it:
//   y  = acc · scale                                     (f32, one rounding)
//   DEV:  y = y >= 0 ? y · asym_up : y · asym_down       (asymmetry)
//         y = y + σ_w · gauss(r, c)                      (write noise)
//   q  = sat_i32(floor(y + u(r, c)))  with a draw,  sat_i32(rint(y)) without
// Every product and sum rounds on its own (__fmul_rn/__fadd_rn), so nvcc
// contracts nothing into an FMA; rintf rounds half to even like jnp.round;
// saturated() is XLA's convert of a clip at f32(2^31 - 1) = 2^31, which
// lands on INT32_MAX. The functions take their scalars, not a kernel's
// parameter block, so each kernel keeps its own layout.
#pragma once
#include <math.h>
#include <stdint.h>

#include "counter.cuh"
#include "deposit.cuh"

// the rounding source (kernel.py's _RNG_CODES)
enum Rng { RNG_NONE = 0, RNG_COUNTER = 1, RNG_GRID = 2, RNG_HW = 3 };

// a write-nonideal device model (DeviceModel's write fields)
struct DeviceParams {
  int asym;                  // != 0: gain asym_up on y >= 0, asym_down on y < 0
  float asym_up, asym_down;
  float write_noise;         // > 0: sigma in grid LSB, drawn under (nk0, nk1)
  int nk0, nk1;
  StuckParams stuck;         // frac > 0: stuck digits keep their value
};

// the grid or hw draws of the 4 cells (r, c..c + 3), c % 4 == 0 (cells past
// N are drawn and never deposited). Under RNG_GRID the 4 flat indices are
// offset + r·N + c + b, consecutive across a row's end. Under RNG_HW with
// bn % 4 == 0 the 4 cells are 4 aligned cells of one tile: one Philox
// block. Not inlined: one call a group of 4 cells, as the write noise's
// counter_gauss is one call a cell.
__device__ __noinline__ float4 far_u4(int r, int c, int rng, int k0, int k1, unsigned long long offset, int N,
                                      int bm, int bn, int tn, int hw4) {
  if (rng == RNG_GRID) {
    const unsigned long long i = offset + (unsigned long long)r * N + c;
    return make_float4(threefry_u01(k0, k1, i), threefry_u01(k0, k1, i + 1), threefry_u01(k0, k1, i + 2),
                       threefry_u01(k0, k1, i + 3));
  }
  const int tile_r = (r / bm) * tn, e_r = (r % bm) * bn;
  if (hw4) return hw_u01(k0, k1, tile_r + c / bn, (uint32_t)(e_r + c % bn) >> 2);
  float u[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int e = e_r + (c + b) % bn;
    const float4 w = hw_u01(k0, k1, tile_r + (c + b) / bn, (uint32_t)e >> 2);
    u[b] = (e & 3) == 0 ? w.x : (e & 3) == 1 ? w.y : (e & 3) == 2 ? w.z : w.w;
  }
  return make_float4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ float nth(const float4& v, int b) {
  return b == 0 ? v.x : b == 1 ? v.y : b == 2 ? v.z : v.w;
}

// the increment on the weight grid of one cell at global (r, c) from its
// f32 value acc, before the rounding: the scale, then the device's write
// physics
template <bool DEV>
__device__ __forceinline__ float increment_of(float acc, float scale, int r, int c, const DeviceParams& dv) {
  float y = __fmul_rn(acc, scale);
  if (DEV) {
    if (dv.asym) y = y >= 0.f ? __fmul_rn(y, dv.asym_up) : __fmul_rn(y, dv.asym_down);
    if (dv.write_noise > 0.f) y = __fadd_rn(y, __fmul_rn(dv.write_noise, counter_gauss(r, c, dv.nk0, dv.nk1)));
  }
  return y;
}

__device__ __forceinline__ int saturated(float y) {
  y = fminf(fmaxf(y, -2147483648.f), 2147483648.f);
  return __float2int_rz(y);
}

// the update on the weight grid of one cell at global (r, c) from its f32
// value under RNG_COUNTER (the draw inline, under (k0, k1)) or RNG_NONE
template <bool DEV>
__device__ __forceinline__ int update_of(float acc, float scale, int r, int c, int rng, int k0, int k1,
                                         const DeviceParams& dv) {
  const float y = increment_of<DEV>(acc, scale, r, c, dv);
  return saturated(rng == RNG_COUNTER ? floorf(__fadd_rn(y, counter_u01(r, c, k0, k1))) : rintf(y));
}

// the update under RNG_GRID or RNG_HW from the increment y and its draw u
// (far_u4): a body draws after the write noise of the 4 cells
__device__ __forceinline__ int update_far(float y, float u) { return saturated(floorf(__fadd_rn(y, u))); }

// -lr · 2^F in f32 (exact: a power of two times lr), F read on the device
// from its 1-element tensor, so that no launch syncs
__device__ __forceinline__ float grid_scale(float lr, const int* frac_bits) {
  return __fmul_rn(-lr, __int_as_float((frac_bits[0] + 127) << 23));
}
