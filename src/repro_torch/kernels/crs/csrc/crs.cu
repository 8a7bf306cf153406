// Carry Resolution Step on the int8 digit planes, in place, for NVIDIA
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/crs/kernel.py::crs (body
// _crs_kernel), which computes src/repro/core/slicing.py::crs. Per element:
// digit-serial carry propagation LSB -> MSB (v = plane + carry; d = balanced
// digit of v; carry = (v - d) >> 4, exact); a carry out of the MSB rails the
// whole digit vector to +-canonical_limit; a carry-free vector below
// -canonical_limit (MSB-first lexicographic compare with its digits) rails
// to it.
//
// Design and bound. Elementwise: a thread owns 4 consecutive elements
// (one 4-byte word per plane when M·N is a multiple of 4), keeps their S
// digits in registers and writes them back. It reads and writes each plane
// byte once, so it is bound by 2·S·M·N bytes over HBM (3.35 TB/s); the int32
// arithmetic per byte is far below the card's rate. A later design fuses it
// into the last OPA deposit of a CRS step, which already holds the digits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../deposit.cuh"

namespace {

constexpr int MAX_S = PANTHER_MAX_DEPOSIT_S;
constexpr int THREADS = 256;

struct Rails {
  int S;
  int pos[MAX_S];  // digits of +canonical_limit, LSB-first
  int neg[MAX_S];  // digits of -canonical_limit
};

__device__ __forceinline__ void crs_one(int* p, const Rails& r) {
  int carry = 0;
#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    if (s < r.S) {
      const int v = p[s] + carry;
      const int d = ((v + 8) & 15) - 8;
      p[s] = d;
      carry = (v - d) >> 4;
    }
  }
  bool lt = false, gt = false;
#pragma unroll
  for (int s = MAX_S - 1; s >= 0; --s) {
    if (s < r.S) {
      const bool lt_new = lt || (!gt && p[s] < r.neg[s]);
      gt = gt || (!lt && p[s] > r.neg[s]);
      lt = lt_new;
    }
  }
  lt = lt && carry == 0;
#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    if (s < r.S) {
      if (carry > 0) p[s] = r.pos[s];
      else if (carry < 0 || lt) p[s] = r.neg[s];
    }
  }
}

// 4 elements a thread through 4-byte words (M·N % 4 == 0, aligned)
__global__ void __launch_bounds__(THREADS) crs_vec_kernel(int8_t* __restrict__ planes, size_t mn, Rails r) {
  const size_t n4 = mn / 4;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n4; i += (size_t)gridDim.x * THREADS) {
    int p[4][MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < r.S) {
        const char4 w = reinterpret_cast<const char4*>(planes + s * mn)[i];
        p[0][s] = w.x; p[1][s] = w.y; p[2][s] = w.z; p[3][s] = w.w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) crs_one(p[e], r);
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < r.S) {
        reinterpret_cast<char4*>(planes + s * mn)[i] =
            make_char4((signed char)p[0][s], (signed char)p[1][s], (signed char)p[2][s], (signed char)p[3][s]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) crs_scalar_kernel(int8_t* __restrict__ planes, size_t mn, Rails r) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < mn; i += (size_t)gridDim.x * THREADS) {
    int p[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < r.S) p[s] = planes[s * mn + i];
    crs_one(p, r);
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < r.S) planes[s * mn + i] = (int8_t)p[s];
  }
}

}  // namespace

// planes int8 [S, M·N] contiguous on the current device, rewritten in place.
// pos, neg: host int[S], the balanced digits of +-canonical_limit, LSB-first.
// vec != 0 takes the 4-element path (M·N % 4 == 0, planes 4-byte aligned).
// Returns a cudaError_t (0 on success).
extern "C" int panther_crs(void* planes, long long mn, int S, const int* pos, const int* neg,
                           int vec, void* stream) {
  if (S < 1 || S > MAX_S || mn < 1) return (int)cudaErrorInvalidValue;
  Rails r;
  r.S = S;
  for (int s = 0; s < MAX_S; ++s) {
    r.pos[s] = s < S ? pos[s] : 0;
    r.neg[s] = s < S ? neg[s] : 0;
  }
  const size_t work = vec ? (size_t)mn / 4 : (size_t)mn;
  const size_t want = (work + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* p = static_cast<int8_t*>(planes);
  if (vec) crs_vec_kernel<<<blocks, THREADS, 0, st>>>(p, (size_t)mn, r);
  else crs_scalar_kernel<<<blocks, THREADS, 0, st>>>(p, (size_t)mn, r);
  return (int)cudaGetLastError();
}
