// Saturating digit deposit of an int32 update into the int8 digit planes,
// in place, for NVIDIA Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_opa/kernel.py::
// opa_deposit (body _opa_deposit_kernel -> _deposit): per element, the
// update p_q on the 2^-F weight grid is clipped to +-canonical_limit, cut
// into balanced base-16 digits LSB-first, and digit s is added to plane s
// with that plane's saturating clip (deposit.cuh).
//
// The STUCK instance adds a device model's stuck-cell mask after the
// deposit: the reference applies it in jnp after this kernel
// (src/repro/kernels/sliced_opa/ops.py::opa_device_update); fused here, the
// planes stay in place and no copy of the old digits is made. Each element
// knows its global (row, col) in the [M, N] block from its flat index.
//
// Design and bound. Elementwise: a thread owns 4 consecutive elements (one
// int4 of p_q and one 4-byte word per plane when M·N is a multiple of 4) and
// runs the S digits in a register loop. It reads p_q once (4 bytes an
// element) and reads and writes each plane byte once, so it is bound by
// (4 + 2·S)·M·N bytes over HBM (3.35 TB/s). The stuck mask adds S counter
// hashes an element (~20 32-bit operations each) on the CUDA cores, which
// at S = 8 stays under the byte bound. A later design takes the float
// gradient and the rounding draw in the same pass (the dense path's
// quantize writes and re-reads p_q today).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../deposit.cuh"

namespace {

constexpr int MAX_S = PANTHER_MAX_DEPOSIT_S;
constexpr int THREADS = 256;

template <bool STUCK>
__device__ __forceinline__ void deposit_at(int* p, int q, const DepositParams& dp, int r, int c,
                                           const StuckParams& st) {
  if (STUCK) deposit_stuck(p, q, dp, r, c, st);
  else deposit_one(p, q, dp);
}

template <bool STUCK>
__global__ void __launch_bounds__(THREADS)
opa_deposit_vec_kernel(int8_t* __restrict__ planes, const int* __restrict__ pq, size_t mn, int N,
                       DepositParams dp, StuckParams st) {
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
    const int qs[4] = {q.x, q.y, q.z, q.w};
    int r = 0, c = 0;
    if (STUCK) {
      r = (int)((4 * i) / (size_t)N);
      c = (int)(4 * i - (size_t)r * N);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      deposit_at<STUCK>(p[j], qs[j], dp, r, c, st);
      if (STUCK && ++c == N) {
        c = 0;
        ++r;
      }
    }
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < dp.S) {
        reinterpret_cast<char4*>(planes + s * mn)[i] =
            make_char4((signed char)p[0][s], (signed char)p[1][s], (signed char)p[2][s], (signed char)p[3][s]);
      }
    }
  }
}

template <bool STUCK>
__global__ void __launch_bounds__(THREADS)
opa_deposit_scalar_kernel(int8_t* __restrict__ planes, const int* __restrict__ pq, size_t mn, int N,
                          DepositParams dp, StuckParams st) {
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < mn; i += (size_t)gridDim.x * THREADS) {
    int p[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < dp.S) p[s] = planes[s * mn + i];
    const int r = STUCK ? (int)(i / (size_t)N) : 0;
    deposit_at<STUCK>(p, pq[i], dp, r, STUCK ? (int)(i - (size_t)r * N) : 0, st);
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < dp.S) planes[s * mn + i] = (int8_t)p[s];
  }
}

template <bool STUCK>
void launch(int8_t* p, const int* q, size_t mn, int N, int vec, unsigned blocks, const DepositParams& dp,
            const StuckParams& st, cudaStream_t stream) {
  if (vec) opa_deposit_vec_kernel<STUCK><<<blocks, THREADS, 0, stream>>>(p, q, mn, N, dp, st);
  else opa_deposit_scalar_kernel<STUCK><<<blocks, THREADS, 0, stream>>>(p, q, mn, N, dp, st);
}

}  // namespace

// planes int8 [S, M, N] and p_q int32 [M, N], contiguous on the current
// device; planes rewritten in place. mn = M·N; N the row length.
// plane_max: host int[S], LSB-first; lim: canonical_limit. vec != 0 takes
// the 4-element path (M·N % 4 == 0, planes 4-byte and p_q 16-byte
// aligned). stuck_words: NULL, or host int[2·S] (w0_s, w1_s per slice) with
// stuck_frac > 0 for the stuck-cell instance. Returns a cudaError_t.
extern "C" int panther_opa_deposit(void* planes, const void* p_q, long long mn, int N, int S,
                                   const int* plane_max, int lim, int vec, float stuck_frac,
                                   const int* stuck_words, void* stream) {
  if (S < 1 || S > MAX_S || mn < 1 || N < 1 || mn % N != 0) return (int)cudaErrorInvalidValue;
  DepositParams dp;
  dp.S = S;
  dp.lim = lim;
  for (int s = 0; s < MAX_S; ++s) dp.plane_max[s] = s < S ? plane_max[s] : 0;
  StuckParams st;
  st.frac = stuck_frac;
  for (int s = 0; s < MAX_S; ++s) {
    st.w0[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s] : 0;
    st.w1[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s + 1] : 0;
  }
  const size_t work = vec ? (size_t)mn / 4 : (size_t)mn;
  const size_t want = (work + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  int8_t* p = static_cast<int8_t*>(planes);
  const int* q = static_cast<const int*>(p_q);
  if (stuck_words != nullptr) launch<true>(p, q, (size_t)mn, N, vec, blocks, dp, st, stream_);
  else launch<false>(p, q, (size_t)mn, N, vec, blocks, dp, st, stream_);
  return (int)cudaGetLastError();
}
