// The dense-leaf write of the digit planes, in place, for NVIDIA Hopper
// (sm_90a), with a plain C interface for ctypes: one pass from a dense
// gradient (or an int32 update) to the deposited planes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_opa/kernel.py::
// opa_deposit (body _opa_deposit_kernel -> _deposit) together with what the
// reference computes around it in jnp: the dense path's
// quantize(-lr·g, F) (src/repro/optim/panther.py, update) before it, and
// opa_device_update's write physics and stuck mask
// (src/repro/kernels/sliced_opa/ops.py) around it. Per cell of an [M, N]
// layer block:
//   ideal:  y = (-lr · g) · 2^F                 (two roundings, as quantize)
//   DEV:    y = g · (2^F · -lr)                 (one, as opa_device_update)
//           then asymmetry and write noise      (finalize.cuh, increment_of)
//   q = sat_i32(floor(y + u))  under a draw,  sat_i32(rint(y)) without
//   planes <- deposit(planes, q)                (deposit.cuh)
//   DEV:    stuck digits keep their old value
// u is the counter hash at the cell's (row, col) under the layer's key words
// (RNG_COUNTER), or jax.random.uniform's threefry stream at the flat index
// offset + row·N + col of the leaf (RNG_GRID). The two orders of the scale
// differ only where -lr·g is subnormal; each instance keeps its reference's.
// A launch may hold a block of a larger leaf (one rank's block on a mesh):
// (row0, col0) is its origin and ldn the leaf's column count, so the draws
// and the stuck hashes take the cell's global (row, col), and the grid
// index is offset + row·ldn + col.
// The finalize is K1's (finalize.cuh), held bit for bit on the card already.
//
// The template runs over three choices: the input (IN_PQ, an int32 update
// on the grid: the reference's opa_deposit API; IN_F32 or IN_BF16, a dense
// gradient read as it is), the rounding (RNG_NONE, RNG_COUNTER, RNG_GRID;
// IN_PQ takes none) and DEV (the write physics; on IN_PQ the stuck mask
// alone). The stuck mask is frozen (a pure function of stuck_seed, slice and
// (row, col)), so a DEV launch reads it as K1's tensor-core body does: a byte
// of slice bits a cell (stuck_bits), drawn and written by the first launch
// at a block shape (mask_mode 1), read by the later ones (mask_mode 2).
//
// Design and bound. Elementwise: a thread owns 16 consecutive cells of the
// row-major block. Each plane moves as one 16-byte word, the gradient as 16-
// byte vectors through the read-only path (64 bytes of f32, 32 of bf16),
// the mask as one 16-byte word; the digits run in registers. Blocks whose
// M·N is not a multiple of 16, or whose planes, input or mask do not start
// on 16 bytes, run the scalar body, a cell a thread. It reads the input once
// and reads and writes each plane byte once: (4 or 2, + 2·S, + 1 with the
// mask) bytes a cell over HBM. The CUDA cores add ~8 operations a plane
// cell for the deposit (~110 a cell at S = 8, most of them int32, which
// issue on 64 lanes an SM: about the byte time on the embedding), ~14 a
// cell for the counter hash, ~100 for the grid draw's threefry and ~110
// for the write noise's Box-Muller (one out-of-line counter_gauss a cell).
// So the instance without a draw runs near the byte bound, and each draw
// and the device physics add issue time on top (PERF.md has the times).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../counter.cuh"
#include "../../deposit.cuh"
#include "../../finalize.cuh"

namespace {

constexpr int MAX_S = PANTHER_MAX_DEPOSIT_S;
constexpr int THREADS = 256;
constexpr int SEG = 16;  // cells a thread owns in the vector body: one 16-byte word of each plane

// the input of a launch
enum Input { IN_PQ = 0, IN_F32 = 1, IN_BF16 = 2 };

struct DenseParams {
  int8_t* planes;             // [S, M, N], rewritten in place
  const void* src;            // [M, N]: int32 p_q, or the f32 / bf16 gradient
  const int* frac_bits;       // [1] (gradient inputs)
  float lr;
  unsigned long long mn;      // M·N
  int N;
  int k0, k1;                 // the rounding draw's key words
  unsigned long long offset;  // RNG_GRID: flat index of the block's cell (0, 0) in its leaf
  int vec;                    // the 16-cell vector body
  DepositParams dp;
  DeviceParams dv;            // DEV: the write physics (IN_PQ: the stuck mask only)
  uint8_t* stuck_mask;        // [M, N] stuck_bits bytes: mask_mode 1 writes them, 2 reads them
  int mask_mode;
  int row0, col0, ldn;        // the block's origin in its leaf's [M, N] layer, and that N
};

__device__ __forceinline__ uint32_t& word_of(uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the input value of flat cell i, widened exactly to f32 (gradients)
template <int IN>
__device__ __forceinline__ float value_at(const void* src, unsigned long long i) {
  if (IN == IN_F32) return __ldg(static_cast<const float*>(src) + i);
  return __uint_as_float((uint32_t)__ldg(static_cast<const unsigned short*>(src) + i) << 16);
}

__device__ __forceinline__ void next_cell(int& r, int& c, int N) {
  if (++c == N) {
    c = 0;
    ++r;
  }
}

template <int IN, int RNG, bool DEV>
__global__ void __launch_bounds__(THREADS)
opa_dense_kernel(const DenseParams p) {
  constexpr bool COORDS = IN != IN_PQ || DEV;  // the draws and the stuck hashes take (row, col)
  const unsigned long long mn = p.mn;
  const int N = p.N, S = p.dp.S;
  const int R0 = p.row0, C0 = p.col0;  // the cells' global (row, col) are (r + R0, c + C0)
  const bool stuck = DEV && p.dv.stuck.frac > 0.f;
  // the value multiplied before the rounding: (-lr · g) · 2^F, or g · (2^F · -lr) on DEV
  float pre = 1.f, scale = 1.f;
  if (IN != IN_PQ) {
    if (DEV) {
      scale = grid_scale(p.lr, p.frac_bits);
    } else {
      pre = -p.lr;
      scale = __int_as_float((p.frac_bits[0] + 127) << 23);
    }
  }
  const unsigned long long stride = (unsigned long long)gridDim.x * THREADS;
  if (p.vec) {
    for (unsigned long long gi = (unsigned long long)blockIdx.x * THREADS + threadIdx.x; gi < mn / SEG;
         gi += stride) {
      const unsigned long long i0 = gi * SEG;
      int q[SEG];
      int r0 = 0, c0 = 0;
      if (COORDS) {
        r0 = (int)(i0 / (unsigned)N);
        c0 = (int)(i0 - (unsigned long long)r0 * N);
      }
      if (IN == IN_PQ) {
#pragma unroll
        for (int k = 0; k < SEG / 4; ++k) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(p.src) + i0) + k);
          q[4 * k] = v.x; q[4 * k + 1] = v.y; q[4 * k + 2] = v.z; q[4 * k + 3] = v.w;
        }
      } else {
        float g[SEG];
        if (IN == IN_F32) {
#pragma unroll
          for (int k = 0; k < SEG / 4; ++k) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p.src) + i0) + k);
            g[4 * k] = v.x; g[4 * k + 1] = v.y; g[4 * k + 2] = v.z; g[4 * k + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < SEG / 8; ++k) {
            uint4 v = __ldg(reinterpret_cast<const uint4*>(static_cast<const unsigned short*>(p.src) + i0) + k);
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              g[8 * k + 2 * h] = bf16_lo(word_of(v, h));
              g[8 * k + 2 * h + 1] = bf16_hi(word_of(v, h));
            }
          }
        }
        int r = r0, c = c0;
#pragma unroll
        for (int j4 = 0; j4 < SEG / 4; ++j4) {
          if (RNG == RNG_GRID) {
            const int rb = r, cb = c;
            float y[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float a = DEV ? g[4 * j4 + b] : __fmul_rn(pre, g[4 * j4 + b]);
              y[b] = increment_of<DEV>(a, scale, r + R0, c + C0, p.dv);
              next_cell(r, c, N);
            }
            // 4 consecutive flat indices from the group's first cell (the
            // host runs the scalar body where a group would cross a row of
            // a block narrower than its leaf)
            const float4 u = far_u4(rb + R0, cb + C0, RNG_GRID, p.k0, p.k1, p.offset, p.ldn, 1, 1, 1, 0);
#pragma unroll
            for (int b = 0; b < 4; ++b) q[4 * j4 + b] = update_far(y[b], nth(u, b));
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float a = DEV ? g[4 * j4 + b] : __fmul_rn(pre, g[4 * j4 + b]);
              q[4 * j4 + b] = update_of<DEV>(a, scale, r + R0, c + C0, RNG, p.k0, p.k1, p.dv);
              next_cell(r, c, N);
            }
          }
        }
      }
      uint4 w[MAX_S];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s < S) w[s] = *reinterpret_cast<const uint4*>(p.planes + s * mn + i0);
      uint8_t* mrow = stuck ? p.stuck_mask + i0 : nullptr;
      uint4 keep = make_uint4(0u, 0u, 0u, 0u);  // the cells' stuck bits, a byte a cell
      if (stuck && p.mask_mode == 2) keep = *reinterpret_cast<const uint4*>(mrow);
      int r = r0, c = c0;
#pragma unroll
      for (int j4 = 0; j4 < SEG / 4; ++j4) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          int d[MAX_S];
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) d[s] = (int)(signed char)(word_of(w[s], j4) >> (8 * b));
          if (stuck) {
            uint32_t bits;
            if (p.mask_mode == 2) {
              bits = (word_of(keep, j4) >> (8 * b)) & 0xffu;
            } else {
              bits = stuck_bits(r + R0, c + C0, p.dp, p.dv.stuck);
              word_of(keep, j4) |= bits << (8 * b);
            }
            deposit_keep(d, q[4 * j4 + b], p.dp, bits);
          } else {
            deposit_one(d, q[4 * j4 + b], p.dp);
          }
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) {
              uint32_t& wd = word_of(w[s], j4);
              wd = (wd & ~(0xffu << (8 * b))) | ((uint32_t)(uint8_t)d[s] << (8 * b));
            }
          if (COORDS) next_cell(r, c, N);
        }
      }
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s < S) *reinterpret_cast<uint4*>(p.planes + s * mn + i0) = w[s];
      if (stuck && p.mask_mode == 1) *reinterpret_cast<uint4*>(mrow) = keep;
    }
    return;
  }
  // the scalar body: a cell a thread
  for (unsigned long long i = (unsigned long long)blockIdx.x * THREADS + threadIdx.x; i < mn; i += stride) {
    int r = 0, c = 0;
    if (COORDS) {
      r = (int)(i / (unsigned)N);
      c = (int)(i - (unsigned long long)r * N);
    }
    int q;
    if (IN == IN_PQ) {
      q = __ldg(static_cast<const int*>(p.src) + i);
    } else {
      const float g = value_at<IN>(p.src, i);
      const float a = DEV ? g : __fmul_rn(pre, g);
      if (RNG == RNG_GRID)
        q = update_far(increment_of<DEV>(a, scale, r + R0, c + C0, p.dv),
                       threefry_u01(p.k0, p.k1, p.offset + (unsigned long long)(r + R0) * p.ldn + (c + C0)));
      else
        q = update_of<DEV>(a, scale, r + R0, c + C0, RNG, p.k0, p.k1, p.dv);
    }
    int d[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < S) d[s] = p.planes[s * mn + i];
    if (stuck) {
      const uint32_t bits = p.mask_mode == 2 ? p.stuck_mask[i] : stuck_bits(r + R0, c + C0, p.dp, p.dv.stuck);
      if (p.mask_mode == 1) p.stuck_mask[i] = (uint8_t)bits;
      deposit_keep(d, q, p.dp, bits);
    } else {
      deposit_one(d, q, p.dp);
    }
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (s < S) p.planes[s * mn + i] = (int8_t)d[s];
  }
}

template <int IN, int RNG>
cudaError_t launch(bool dev, const DenseParams& p, unsigned blocks, cudaStream_t stream) {
  if (dev) opa_dense_kernel<IN, RNG, true><<<blocks, THREADS, 0, stream>>>(p);
  else opa_dense_kernel<IN, RNG, false><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int IN>
cudaError_t launch_rng(int rng, bool dev, const DenseParams& p, unsigned blocks, cudaStream_t stream) {
  if (rng == RNG_COUNTER) return launch<IN, RNG_COUNTER>(dev, p, blocks, stream);
  if (rng == RNG_GRID) return launch<IN, RNG_GRID>(dev, p, blocks, stream);
  return launch<IN, RNG_NONE>(dev, p, blocks, stream);
}

}  // namespace

// planes int8 [S, M, N] (rewritten in place) and src [M, N] (input 0: int32
// p_q; 1: f32 gradient; 2: bf16 gradient), contiguous on the current device;
// mn = M·N, N the row length. Gradient inputs: frac_bits int32 [1] on the
// device, lr the host learning rate, rng (enum Rng: 0 half to even, 1
// counter, 2 grid) under the int32 key words (k0, k1), offset RNG_GRID's
// flat index of the leaf's cell (0, 0) of this layer. plane_max: host
// int[S]; lim: canonical_limit. vec != 0: the 16-cell body (mn % 16 == 0;
// planes, src and stuck_mask 16-byte aligned; N % 16 == 0 or N == ldn).
// (row0, col0): the block's origin in its layer, ldn the layer's column
// count (0, 0, N for a whole layer). physics: NULL for the ideal instance, else host
// float[4] = (asym_up, asym_down, write_noise, stuck_frac) (input 0: 1, 1,
// 0, stuck_frac), (nk0, nk1) the write-noise key words and stuck_words host
// int[2·S] (w0_s, w1_s per slice); stuck_mask uint8 [M, N] on the device
// with mask_mode 1 (draw and write it) or 2 (read it) where stuck_frac > 0,
// else NULL and 0. Returns a cudaError_t (0 on success).
extern "C" int panther_opa_deposit(void* planes, const void* src, int input, const void* frac_bits, float lr,
                                   long long mn, int N, int S, const int* plane_max, int lim, int rng, int k0,
                                   int k1, unsigned long long offset, int vec, const float* physics, int nk0,
                                   int nk1, const int* stuck_words, void* stuck_mask, int mask_mode,
                                   int row0, int col0, int ldn, void* stream) {
  if (S < 1 || S > MAX_S || mn < 1 || N < 1 || mn % N != 0) return (int)cudaErrorInvalidValue;
  if (row0 < 0 || col0 < 0 || ldn < col0 + N || (vec && N % SEG != 0 && N != ldn))
    return (int)cudaErrorInvalidValue;
  if (input < IN_PQ || input > IN_BF16 || rng < RNG_NONE || rng > RNG_GRID) return (int)cudaErrorInvalidValue;
  if ((input == IN_PQ && rng != RNG_NONE) || (input != IN_PQ && frac_bits == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool dev = physics != nullptr;
  const bool stuck = dev && physics[3] > 0.f;
  if (mask_mode < 0 || mask_mode > 2 || stuck != (mask_mode != 0) || (stuck && stuck_mask == nullptr))
    return (int)cudaErrorInvalidValue;
  if (input == IN_PQ && dev && (physics[0] != 1.f || physics[1] != 1.f || physics[2] != 0.f))
    return (int)cudaErrorInvalidValue;
  DenseParams p;
  p.planes = static_cast<int8_t*>(planes);
  p.src = src;
  p.frac_bits = static_cast<const int*>(frac_bits);
  p.lr = lr;
  p.mn = (unsigned long long)mn;
  p.N = N;
  p.k0 = k0;
  p.k1 = k1;
  p.offset = rng == RNG_GRID ? offset : 0ull;
  p.vec = vec;
  p.dp.S = S;
  p.dp.lim = lim;
  for (int s = 0; s < MAX_S; ++s) p.dp.plane_max[s] = s < S ? plane_max[s] : 0;
  p.dv.asym_up = dev ? physics[0] : 1.f;
  p.dv.asym_down = dev ? physics[1] : 1.f;
  p.dv.asym = p.dv.asym_up != 1.f || p.dv.asym_down != 1.f;
  p.dv.write_noise = dev ? physics[2] : 0.f;
  p.dv.nk0 = nk0;
  p.dv.nk1 = nk1;
  p.dv.stuck.frac = dev ? physics[3] : 0.f;
  for (int s = 0; s < MAX_S; ++s) {
    p.dv.stuck.w0[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s] : 0;
    p.dv.stuck.w1[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s + 1] : 0;
  }
  p.stuck_mask = static_cast<uint8_t*>(stuck_mask);
  p.mask_mode = mask_mode;
  p.row0 = row0;
  p.col0 = col0;
  p.ldn = ldn;
  const unsigned long long work = vec ? (unsigned long long)mn / SEG : (unsigned long long)mn;
  const unsigned long long want = (work + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (input == IN_PQ) err = launch<IN_PQ, RNG_NONE>(dev, p, blocks, st);
  else if (input == IN_F32) err = launch_rng<IN_F32>(rng, dev, p, blocks, st);
  else err = launch_rng<IN_BF16>(rng, dev, p, blocks, st);
  return (int)err;
}
