// The im2col deposit of a depthwise conv's taps, for NVIDIA Hopper (sm_90a),
// with a plain C interface for ctypes: K1's function (the update from
// gradient operands, never formed as a dense gradient in device memory) on
// the im2col layout, one launch a layer block.
//
// Replaces, for the conv taps, the Pallas TPU kernel
// src/repro/kernels/sliced_opa/kernel.py::opa_fused as the reference runs it
// on an im2col operand (src/repro/optim/panther.py::_opa_operand_update):
// the planes [S, *lead, K, C] viewed channel-as-stack [S, *lead, C, K, 1],
// one [K, 1] tile a (layer, channel) under a device-side lax.scan. Per cell
// (k, c) of the layer block l:
//   acc = Σ_t x[c, t, k] · dh[c, t, 0]                (f32)
//   q   = sat_i32(floor(acc · (-lr·2^F) + u))  with the counter draw,
//         sat_i32(rint(acc · (-lr·2^F)))      without  (finalize.cuh)
//   planes[:, k, c] <- deposit(planes[:, k, c], q)    (deposit.cuh)
// u = counter_u01(k, 0, w0, w1) with (w0, w1) = fold_in(key, l·C + c): the
// reference's per-tile key of its flattened (*lead, C) stack index, at the
// tile's cell (k, 0). The key is derived here from the leaf key's words with
// counter.cuh's threefry2x32 (fold_in(key, d) = threefry2x32(key, (0, d))),
// so a launch needs no key array. The stored [S, K, C] block is written in
// place: there is no transposed copy.
//
// A launch may update a block of the leaf's [K, C] layer (one rank's block
// on a mesh): its first tap row r0 and channel c0, and the leaf's channel
// count C_leaf. Channel c of the block is then the leaf's channel c0 + c,
// keyed fold_in(key, l·C_leaf + c0 + c), its cell k drawn at the tile's row
// r0 + k: the block's update equals the same block of the whole leaf's.
//
// Design and bound. One warp owns a channel c and its K cells (K <= 8): its
// lanes stride the tokens (lane i takes t = i, i + 32, ...), each reading
// its token's K contiguous patch values and dh once, accumulating K sums
// with f32 FMAs; a butterfly of shuffles (__shfl_xor_sync, commutative, so
// every lane ends with the same bits) sums the lanes; lane k then finalizes
// and deposits cell (k, c). A warp's x rows are one contiguous run of T·K
// values. The launch reads x (C·T·K values) and dh (C·T) once and each
// plane byte of the block once each way: 2·S·K·C bytes, a few MB at the
// path's shapes, so it is bound by bytes (chip_smoke.py phase 18 prints the
// bound beside its time). The sums run in another order than the plain
// version's matmul (ref.opa_im2col_ref); they are equal where the f32 sums
// are exact, and that is where the two are held bit for bit.
//
// The instances: the operand dtype (bf16, f32) x the rounding (RNG_NONE,
// RNG_COUNTER). The grid/hw draws and the write-nonideal device model take
// the per-tile K1 launches (ops.opa_im2col_update) instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../counter.cuh"
#include "../../deposit.cuh"
#include "../../finalize.cuh"

namespace {

constexpr int MAX_S = PANTHER_MAX_DEPOSIT_S;
constexpr int MAX_K = 8;
constexpr int WARPS = 8;  // channels a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Im2colParams {
  int8_t* planes;  // [S, K, C]
  const void* x;   // [C, T, K]
  const void* dh;  // [C, T, 1]
  const int* frac_bits;
  float lr;
  int Tn, K, C;
  uint32_t k0, k1;  // the leaf key's words
  uint32_t layer;   // the block's flat index in the leaf's stack
  int r0, c0;       // the block's first tap row and channel in the leaf's [K, C] layer
  uint32_t c_leaf;  // the leaf's channels
  DepositParams dp;
};

template <typename T, int RNG>
__global__ void __launch_bounds__(WARPS * 32) opa_im2col_kernel(const Im2colParams a) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= a.C) return;
  const int K = a.K;
  const T* xc = static_cast<const T*>(a.x) + (size_t)c * a.Tn * K;
  const T* dc = static_cast<const T*>(a.dh) + (size_t)c * a.Tn;
  float acc[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) acc[k] = 0.f;
  for (int t = lane; t < a.Tn; t += 32) {
    const float d = to_f32(dc[t]);
    const T* xr = xc + (size_t)t * K;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (k < K) acc[k] = __fmaf_rn(to_f32(xr[k]), d, acc[k]);
  }
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    if (k < K) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
    }
  }
  if (lane >= K) return;
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k)
    if (k == lane) mine = acc[k];
  int w0 = 0, w1 = 0;
  if (RNG == RNG_COUNTER) {
    const uint2 w = threefry2x32(a.k0, a.k1, 0u, a.layer * a.c_leaf + (uint32_t)(a.c0 + c));
    w0 = (int)w.x;
    w1 = (int)w.y;
  }
  const DeviceParams ideal = {};
  const int q = update_of<false>(mine, grid_scale(a.lr, a.frac_bits), a.r0 + lane, 0, RNG, w0, w1, ideal);
  const size_t plane = (size_t)K * a.C, cell = (size_t)lane * a.C + c;
  int p[MAX_S];
#pragma unroll
  for (int s = 0; s < MAX_S; ++s)
    if (s < a.dp.S) p[s] = a.planes[s * plane + cell];
  deposit_one(p, q, a.dp);
#pragma unroll
  for (int s = 0; s < MAX_S; ++s)
    if (s < a.dp.S) a.planes[s * plane + cell] = (int8_t)p[s];
}

template <typename T, int RNG>
cudaError_t launch(const Im2colParams& a, cudaStream_t stream) {
  opa_im2col_kernel<T, RNG><<<(a.C + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// planes int8 [S, K, C] (one layer block, rewritten in place), x [C, T, K]
// and dh [C, T, 1] of one dtype (bf16 != 0: bfloat16, else float32),
// frac_bits int32 [1], all contiguous on the current device. lr: the host
// learning rate (the kernel folds -lr·2^F). rng: RNG_COUNTER rounds by the
// counter draw under each tile's fold_in((k0, k1), layer·c_leaf + c0 + c),
// (k0, k1) the leaf key's words, cell k at the tile's row r0 + k; RNG_NONE
// half to even. (r0, c0): the block's origin in the leaf's [K, C] layer,
// c_leaf the leaf's channels ((0, 0) and C for a whole layer). plane_max:
// host int[S]; lim: canonical_limit. Returns a cudaError_t (0 on success).
extern "C" int panther_opa_im2col(void* planes, const void* x, const void* dh, const void* frac_bits, float lr,
                                  int Tn, int K, int C, int S, const int* plane_max, int lim, int bf16, int rng,
                                  unsigned k0, unsigned k1, unsigned layer, int r0, int c0, unsigned c_leaf,
                                  void* stream) {
  if (S < 1 || S > MAX_S || K < 1 || K > MAX_K || C < 1 || Tn < 0) return (int)cudaErrorInvalidValue;
  if (r0 < 0 || c0 < 0 || (long long)c0 + C > (long long)c_leaf) return (int)cudaErrorInvalidValue;
  if (rng != RNG_NONE && rng != RNG_COUNTER) return (int)cudaErrorInvalidValue;
  Im2colParams a;
  a.planes = static_cast<int8_t*>(planes);
  a.x = x;
  a.dh = dh;
  a.frac_bits = static_cast<const int*>(frac_bits);
  a.lr = lr;
  a.Tn = Tn;
  a.K = K;
  a.C = C;
  a.k0 = k0;
  a.k1 = k1;
  a.layer = layer;
  a.r0 = r0;
  a.c0 = c0;
  a.c_leaf = c_leaf;
  a.dp.S = S;
  a.dp.lim = lim;
  for (int s = 0; s < MAX_S; ++s) a.dp.plane_max[s] = s < S ? plane_max[s] : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return (int)(rng ? launch<__nv_bfloat16, RNG_COUNTER>(a, st) : launch<__nv_bfloat16, RNG_NONE>(a, st));
  return (int)(rng ? launch<float, RNG_COUNTER>(a, st) : launch<float, RNG_NONE>(a, st));
}
