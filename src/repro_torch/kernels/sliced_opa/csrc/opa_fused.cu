// Fused outer-product update of the int8 digit planes, in place, for NVIDIA
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_opa/kernel.py::
// opa_fused (body _opa_fused_kernel, with _deposit, the counter draw of
// _block_noise, and the device physics of _global_coords/_stuck_masks):
//   acc[m,n] = sum_t x[t,m] · dh[t,n]                        (f32)
//   y        = acc · scale,  scale = -lr · 2^F               (f32, exact)
//   DEV:  y  = y >= 0 ? y · asym_up : y · asym_down          (asymmetry)
//         y  = y + σ_w · gauss(m, n)                         (write noise)
//   y        = floor(y + u(m, n))  with key words,  rint(y) without
//   p_q      = sat_i32(clip(y, +-f32(2^31 - 1)))
//   planes  <- deposit(planes, p_q)                          (deposit.cuh)
//   DEV:  stuck digits keep their old value                  (deposit_stuck)
// u and gauss are the counter draws of core.fixed_point at the GLOBAL (row,
// col) (counter.cuh), under the rounding key words and the write-noise key
// words, so no draw depends on the blocking. The kernel builds scale itself
// from the host lr and the device frac_bits: nothing syncs. Every product
// and sum of the finalize rounds on its own (__fmul_rn/__fadd_rn), as the
// reference's source and its jnp oracle do; rintf rounds half to even like
// jnp.round; __float2int_rz saturates 2^31 to INT32_MAX as XLA's convert
// does. The ideal instance (DEV false) has none of the physics in its code.
//
// Design. The gradient [M, N] never reaches device memory: a block owns a
// 128x128 output tile, walks the token axis 8 tokens at a time through
// shared memory (both operands are read along their contiguous feature
// axis, so the loads coalesce), and a thread accumulates an 8x8 sub-tile
// with f32 FMAs on the CUDA cores (no TF32: every product and sum is f32).
// The finalize deposits the tile straight into the S planes, 8 bytes a
// plane row when N % 8 == 0. The operands may be f32 or bf16 (bf16 widens
// to f32 exactly).
//
// Bound. 2·T·M·N operations and (S·M·N read + S·M·N written + T·(M+N)
// operand) bytes. At the training step's 256 tokens the operations bound it.
// The device physics add ~150 CUDA-core operations a cell (two hashes and a
// Box-Muller for the noise, S hashes for the stuck mask), a few percent of
// the contraction's 2·T at T = 256. The CUDA-core f32 FMAs run far below
// the card's tensor rate: bf16 x bf16 products are exact in f32, so a later
// design runs the contraction on bf16 wgmma with f32 accumulation
// (bit-identical to this one where the f32 sums are exact) and overlaps the
// plane traffic of one tile with the next tile's mainloop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../counter.cuh"
#include "../../deposit.cuh"

namespace {

constexpr int MAX_S = PANTHER_MAX_DEPOSIT_S;
constexpr int BM = 128, BN = 128, BK = 8;  // output tile and token step
constexpr int TM = 8, TN = 8;              // per-thread sub-tile
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// a write-nonideal device model (DeviceModel's write fields)
struct DeviceParams {
  int asym;                  // != 0: gain asym_up on y >= 0, asym_down on y < 0
  float asym_up, asym_down;
  float write_noise;         // > 0: sigma in grid LSB, drawn under (nk0, nk1)
  int nk0, nk1;
  StuckParams stuck;         // frac > 0: stuck digits keep their value
};

template <typename T, bool DEV>
__global__ void __launch_bounds__(THREADS)
opa_fused_kernel(int8_t* __restrict__ planes, const T* __restrict__ x, const T* __restrict__ dh,
                 const int* __restrict__ frac_bits, float lr, int Tn, int M, int N,
                 int has_key, int k0, int k1, int vec, DepositParams dp, DeviceParams dv) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += BK) {
    // operand strips [BK, BM] and [BK, BN]; ragged edges read as 0
#pragma unroll
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int k = e / BM, m = e % BM;
      const int gt = t0 + k, gm = m0 + m;
      As[k][m] = (gt < Tn && gm < M) ? widen(x[(size_t)gt * M + gm]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int gt = t0 + k, gn = n0 + n;
      Bs[k][n] = (gt < Tn && gn < N) ? widen(dh[(size_t)gt * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // finalize: scale, round, saturate, deposit into the S planes
  const float scale = __fmul_rn(-lr, __int_as_float((frac_bits[0] + 127) << 23));
  const int c0 = n0 + tx * TN;
  const size_t plane = (size_t)M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= M || c0 >= N) break;
    int q[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float y = __fmul_rn(acc[i][j], scale);
      if (DEV) {
        if (dv.asym) y = y >= 0.f ? __fmul_rn(y, dv.asym_up) : __fmul_rn(y, dv.asym_down);
        if (dv.write_noise > 0.f)
          y = __fadd_rn(y, __fmul_rn(dv.write_noise, counter_gauss(r, c0 + j, dv.nk0, dv.nk1)));
      }
      y = has_key ? floorf(__fadd_rn(y, counter_u01(r, c0 + j, k0, k1))) : rintf(y);
      y = fminf(fmaxf(y, -2147483648.f), 2147483648.f);
      q[j] = __float2int_rz(y);
    }
    int8_t* row = planes + (size_t)r * N + c0;
    if (vec && c0 + TN <= N) {
      int p[TN][MAX_S];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        if (s < dp.S) {
          const uint2 w = *reinterpret_cast<const uint2*>(row + s * plane);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j][s] = (int)(signed char)(w.x >> (8 * j));
            p[j + 4][s] = (int)(signed char)(w.y >> (8 * j));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (DEV && dv.stuck.frac > 0.f) deposit_stuck(p[j], q[j], dp, r, c0 + j, dv.stuck);
        else deposit_one(p[j], q[j], dp);
      }
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        if (s < dp.S) {
          uint2 w = make_uint2(0u, 0u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w.x |= (uint32_t)(uint8_t)p[j][s] << (8 * j);
            w.y |= (uint32_t)(uint8_t)p[j + 4][s] << (8 * j);
          }
          *reinterpret_cast<uint2*>(row + s * plane) = w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (c0 + j < N) {
          int p[MAX_S];
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < dp.S) p[s] = row[s * plane + j];
          if (DEV && dv.stuck.frac > 0.f) deposit_stuck(p, q[j], dp, r, c0 + j, dv.stuck);
          else deposit_one(p, q[j], dp);
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < dp.S) row[s * plane + j] = (int8_t)p[s];
        }
      }
    }
  }
}

template <typename T, bool DEV>
cudaError_t launch(int8_t* planes, const void* x, const void* dh, const int* frac_bits, float lr,
                   int Tn, int M, int N, int has_key, int k0, int k1, int vec,
                   const DepositParams& dp, const DeviceParams& dv, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  opa_fused_kernel<T, DEV><<<grid, THREADS, 0, stream>>>(
      planes, static_cast<const T*>(x), static_cast<const T*>(dh), frac_bits, lr, Tn, M, N,
      has_key, k0, k1, vec, dp, dv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dev(bool dev, int8_t* planes, const void* x, const void* dh, const int* frac_bits,
                       float lr, int Tn, int M, int N, int has_key, int k0, int k1, int vec,
                       const DepositParams& dp, const DeviceParams& dv, cudaStream_t stream) {
  if (dev) return launch<T, true>(planes, x, dh, frac_bits, lr, Tn, M, N, has_key, k0, k1, vec, dp, dv, stream);
  return launch<T, false>(planes, x, dh, frac_bits, lr, Tn, M, N, has_key, k0, k1, vec, dp, dv, stream);
}

}  // namespace

// planes int8 [S,M,N] (rewritten in place), x [T,M] and dh [T,N] of one
// dtype (bf16 != 0: bfloat16, else float32), frac_bits int32 [1], all
// contiguous on the current device. lr: the host learning rate (the kernel
// folds -lr·2^F). has_key != 0 rounds stochastically under the int32 key
// words (k0, k1); otherwise half to even. plane_max: host int[S]; lim:
// canonical_limit. vec != 0: N % 8 == 0 and planes 8-byte aligned.
// physics: NULL for the ideal device, else host float[4] = (asym_up,
// asym_down, write_noise, stuck_frac), with (nk0, nk1) the write-noise key
// words and stuck_words host int[2·S] (w0_s, w1_s per slice).
// Returns a cudaError_t (0 on success).
extern "C" int panther_opa_fused(void* planes, const void* x, const void* dh, const void* frac_bits,
                                 float lr, int Tn, int M, int N, int S, const int* plane_max,
                                 int lim, int bf16, int has_key, int k0, int k1, int vec,
                                 const float* physics, int nk0, int nk1, const int* stuck_words,
                                 void* stream) {
  if (S < 1 || S > MAX_S || Tn < 0 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  DepositParams dp;
  dp.S = S;
  dp.lim = lim;
  for (int s = 0; s < MAX_S; ++s) dp.plane_max[s] = s < S ? plane_max[s] : 0;
  DeviceParams dv;
  const bool dev = physics != nullptr;
  dv.asym_up = dev ? physics[0] : 1.f;
  dv.asym_down = dev ? physics[1] : 1.f;
  dv.asym = dv.asym_up != 1.f || dv.asym_down != 1.f;
  dv.write_noise = dev ? physics[2] : 0.f;
  dv.nk0 = nk0;
  dv.nk1 = nk1;
  dv.stuck.frac = dev ? physics[3] : 0.f;
  for (int s = 0; s < MAX_S; ++s) {
    dv.stuck.w0[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s] : 0;
    dv.stuck.w1[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s + 1] : 0;
  }
  int8_t* p = static_cast<int8_t*>(planes);
  const int* f = static_cast<const int*>(frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_dev<__nv_bfloat16>(dev, p, x, dh, f, lr, Tn, M, N, has_key, k0, k1, vec, dp, dv, st);
  return (int)launch_dev<float>(dev, p, x, dh, f, lr, Tn, M, N, has_key, k0, k1, vec, dp, dv, st);
}
