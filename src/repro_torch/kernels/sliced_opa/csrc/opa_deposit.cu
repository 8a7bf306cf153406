// Saturating digit deposit of an int32 update into the int8 digit planes,
// in place, for NVIDIA Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_opa/kernel.py::
// opa_deposit (body _opa_deposit_kernel -> _deposit): per element, the
// update p_q on the 2^-F weight grid is clipped to +-canonical_limit, cut
// into balanced base-16 digits LSB-first, and digit s is added to plane s
// with that plane's saturating clip (deposit.cuh).
//
// Design and bound. Elementwise: a thread owns 4 consecutive elements (one
// int4 of p_q and one 4-byte word per plane when M·N is a multiple of 4) and
// runs the S digits in a register loop. It reads p_q once (4 bytes an
// element) and reads and writes each plane byte once, so it is bound by
// (4 + 2·S)·M·N bytes over HBM (3.35 TB/s). A later design takes the float
// gradient and the rounding draw in the same pass (the dense path's quantize
// writes and re-reads p_q today).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../deposit.cuh"

namespace {

constexpr int MAX_S = PANTHER_MAX_DEPOSIT_S;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
opa_deposit_vec_kernel(int8_t* __restrict__ planes, const int* __restrict__ pq, size_t mn, DepositParams dp) {
  const size_t n4 = mn / 4;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n4; i += (size_t)gridDim.x * THREADS) {
    const int4 q = reinterpret_cast<const int4*>(pq)[i];
    int p[4][MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < dp.S) {
        const char4 w = reinterpret_cast<const char4*>(planes + s * mn)[i];
        p[0][s] = w.x; p[1][s] = w.y; p[2][s] = w.z; p[3][s] = w.w;
      }
    }
    deposit_one(p[0], q.x, dp);
    deposit_one(p[1], q.y, dp);
    deposit_one(p[2], q.z, dp);
    deposit_one(p[3], q.w, dp);
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < dp.S) {
        reinterpret_cast<char4*>(planes + s * mn)[i] =
            make_char4((signed char)p[0][s], (signed char)p[1][s], (signed char)p[2][s], (signed char)p[3][s]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
opa_deposit_scalar_kernel(int8_t* __restrict__ planes, const int* __restrict__ pq, size_t mn, DepositParams dp) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < mn; i += (size_t)gridDim.x * THREADS) {
    int p[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < dp.S) p[s] = planes[s * mn + i];
    deposit_one(p, pq[i], dp);
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < dp.S) planes[s * mn + i] = (int8_t)p[s];
  }
}

}  // namespace

// planes int8 [S, M·N] and p_q int32 [M·N], contiguous on the current
// device; planes rewritten in place. plane_max: host int[S], LSB-first;
// lim: canonical_limit. vec != 0 takes the 4-element path (M·N % 4 == 0,
// planes 4-byte and p_q 16-byte aligned). Returns a cudaError_t.
extern "C" int panther_opa_deposit(void* planes, const void* p_q, long long mn, int S,
                                   const int* plane_max, int lim, int vec, void* stream) {
  if (S < 1 || S > MAX_S || mn < 1) return (int)cudaErrorInvalidValue;
  DepositParams dp;
  dp.S = S;
  dp.lim = lim;
  for (int s = 0; s < MAX_S; ++s) dp.plane_max[s] = s < S ? plane_max[s] : 0;
  const size_t work = vec ? (size_t)mn / 4 : (size_t)mn;
  const size_t want = (work + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* p = static_cast<int8_t*>(planes);
  const int* q = static_cast<const int*>(p_q);
  if (vec) opa_deposit_vec_kernel<<<blocks, THREADS, 0, st>>>(p, q, (size_t)mn, dp);
  else opa_deposit_scalar_kernel<<<blocks, THREADS, 0, st>>>(p, q, (size_t)mn, dp);
  return (int)cudaGetLastError();
}
