// Fused outer-product update of the int8 digit planes, in place, for NVIDIA
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sliced_opa/kernel.py::
// opa_fused (body _opa_fused_kernel, with _deposit, the three rounding
// sources of its finalize, and the device physics of
// _global_coords/_stuck_masks):
//   acc[m,n] = sum_t x[t,m] · dh[t,n]                        (f32)
//   y        = acc · scale,  scale = -lr · 2^F               (f32, exact)
//   DEV:  y  = y >= 0 ? y · asym_up : y · asym_down          (asymmetry)
//         y  = y + σ_w · gauss(m, n)                         (write noise)
//   y        = floor(y + u(m, n))  with key words,  rint(y) without
//   p_q      = sat_i32(clip(y, +-f32(2^31 - 1)))
//   planes  <- deposit(planes, p_q)                          (deposit.cuh)
//   DEV:  stuck digits keep their old value                  (deposit_stuck)
// gauss is the counter draw of core.fixed_point at the GLOBAL (row, col)
// (counter.cuh) under the write-noise key words; u is the rounding draw of
// the launch's Rng under the rounding key words: the counter hash at (row,
// col); "grid", jax.random.uniform's threefry stream at the flat index
// offset + row·N + col of the leaf (the reference reads it as an [M, N] f32
// input; here it is generated in place, and no draw crosses device memory);
// or "hw", the port's Philox stream over the reference's tile grid in place
// of the TPU's hardware PRNG. No draw depends on the CUDA blocking. A
// launch may hold a block of a larger leaf (one rank's block on a mesh):
// (row0, col0) is its origin and ldn the leaf's column count, so every draw
// is taken at the cell's global (row, col) and "grid"'s flat index is
// offset + row·ldn + col; at the zero origin of a whole leaf ldn = N. The
// source is a runtime field of the launch. The grid and hw draws are ~100
// and ~40 integer operations a cell (threefry's 20 rounds; Philox's 10
// shared by 4 cells), the counter hash ~10; they run out of line, one call
// (far_u4) a group of 4 cells after the group's write noise. The
// tensor-core body has an instance of its own for them (FAR), so that the
// counter instance's finalize is the code it was, draw inline; the
// CUDA-core body branches per group of 4 cells. The kernel builds scale itself from the
// host lr and the device frac_bits: nothing syncs. Every product and sum of
// the finalize rounds on its own (__fmul_rn/__fadd_rn), as the reference's
// source and its jnp oracle do; rintf rounds half to even like jnp.round;
// __float2int_rz saturates 2^31 to INT32_MAX as XLA's convert does. The
// ideal instances (DEV false) have none of the physics in their code. Both
// bodies below share that finalize (increment_of, the draw, update_of or
// update_far, then the deposit: kernels/finalize.cuh, shared with
// opa_deposit.cu's dense write).
//
// Two bodies compute the contraction; the gradient [M, N] never reaches
// device memory in either.
//
// opa_mma_kernel (bf16 operands, the training path). A block of 8 warps owns
// a 128x128 output tile and walks the token axis 32 tokens a stage through a
// 3-stage cp.async ring of [32, 128] x and dh strips (16-byte chunks,
// XOR-swizzled by token row so that ldmatrix.trans reads 8 token rows on 8
// distinct bank groups). Each warp computes a 64x32 sub-tile with
// mma.sync.m16n8k16 bf16 -> f32: bf16 x bf16 products are exact in f32, so
// the tensor cores form the same products as the CUDA-core body, and where
// the f32 sums are exact (every partial sum representable) any order gives
// the same bits. Ragged T, M and N read as zeros, which add exactly. The
// accumulator tile is then staged through shared memory (over the ring), so
// that each thread finalizes 16 contiguous columns of a row and moves the S
// planes in 16-byte words; __launch_bounds__(256, 2) keeps two blocks an SM,
// so one block's finalize overlaps the other's mainloop.
//
// The stuck-cell mask is frozen per (stuck_seed, slice) and the same on every
// layer, so the tensor-core body draws its S hashes a cell on the first
// launch at a block shape, writes them as a byte of bits a cell
// (stuck_bits), and later launches read that byte (+1 byte a cell of
// traffic, S hashes fewer).
//
// opa_fused_kernel (f32 operands; also the same-work yardstick on bf16): the
// CUDA-core body. A block owns a 128x128 tile, walks the token axis 8 tokens
// at a time through shared memory, and a thread accumulates an 8x8 sub-tile
// with f32 FMAs (no TF32: every product and sum is f32), then deposits it
// 8 bytes a plane row.
//
// Bound. 2·T·M·N operations and (S·M·N read + S·M·N written + T·(M+N)
// operand) bytes. At the training step's 256 tokens and S = 8, the bytes
// bound it on the tensor cores (2·T = 512 bf16 operations a cell against 16
// plane bytes: 32 operations a byte, far below the card's ~295). What sets
// the tensor-core body's pace is its finalize on the CUDA cores: ~100
// integer operations a cell (one hash, S digit steps, unpack and pack),
// ~60 more for the write noise (two hashes and a Box-Muller) and, on the
// first launch at a shape only, S hashes for the stuck mask. Timed in parts
// by kernels/sliced_opa/split.py, it takes about 85% of the ideal
// instance's time, and the plane traffic alone about half. The CUDA-core
// body is bound by its f32 FMAs and one block an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../counter.cuh"
#include "../../deposit.cuh"
#include "../../finalize.cuh"

// OPA_PART 0 builds the whole kernel. kernels/sliced_opa/split.py builds
// the parts apart to time them: 1 the mainloop alone (a checksum store in
// place of the finalize), 2 the finalize alone (acc = 1, no mainloop), 3 the
// plane load and store alone.
#ifndef OPA_PART
#define OPA_PART 0
#endif

namespace {

constexpr int MAX_S = PANTHER_MAX_DEPOSIT_S;

struct OpaParams {
  int8_t* planes;            // [S, M, N], rewritten in place
  const void* x;             // [T, M]
  const void* dh;            // [T, N]
  const int* frac_bits;      // [1]
  float lr;
  int Tn, M, N;
  int rng, k0, k1;           // rounding: Rng's draw under (k0, k1); RNG_NONE half to even
  int vec;                   // plane rows move in whole words (the body's width)
  int ld16;                  // x and dh rows load in 16-byte chunks (mma body)
  DepositParams dp;
  DeviceParams dv;
  // the mma body's cached stuck mask, [M, N] stuck_bits bytes: mask_mode 1
  // draws the bits and writes them, 2 reads them; 0 (the CUDA-core body, or
  // no stuck cells) draws them and keeps nothing
  uint8_t* stuck_mask;
  int mask_mode;
  // the grid and hw draws' fields come last: placed before dp and dv, they
  // slowed the tensor-core body's device instance of the counter draw
  unsigned long long offset; // RNG_GRID: flat index of the block's cell (0, 0) in its leaf
  int hw_bm, hw_bn, hw_tn;   // RNG_HW: the tile (bm, bn) and N / bn
  int hw4;                   // RNG_HW: bn % 4 == 0, so 4 aligned cells share one Philox block
  int row0, col0, ldn;       // the block's origin in its leaf's [M, N] layer, and that N
};

// the draws and the finalize of the block's cell (r, c), at its global
// (r + row0, c + col0)
__device__ __forceinline__ float4 far_u4(int r, int c, const OpaParams& a) {
  return ::far_u4(r + a.row0, c + a.col0, a.rng, a.k0, a.k1, a.offset, a.ldn, a.hw_bm, a.hw_bn, a.hw_tn, a.hw4);
}

template <bool DEV>
__device__ __forceinline__ float increment_at(float acc, float scale, int r, int c, const OpaParams& a) {
  return increment_of<DEV>(acc, scale, r + a.row0, c + a.col0, a.dv);
}

template <bool DEV>
__device__ __forceinline__ int update_at(float acc, float scale, int r, int c, const OpaParams& a) {
  return update_of<DEV>(acc, scale, r + a.row0, c + a.col0, a.rng, a.k0, a.k1, a.dv);
}

__device__ __forceinline__ uint32_t stuck_bits_at(int r, int c, const OpaParams& a) {
  return stuck_bits(r + a.row0, c + a.col0, a.dp, a.dv.stuck);
}

// the deposit of update q into the S digits p of the block's cell (r, c)
template <bool DEV>
__device__ __forceinline__ void deposit_cell(int* p, int q, int r, int c, const OpaParams& a) {
  if (DEV && a.dv.stuck.frac > 0.f) deposit_stuck(p, q, a.dp, r + a.row0, c + a.col0, a.dv.stuck);
  else deposit_one(p, q, a.dp);
}

// ---------------------------------------------------------------------------
// the CUDA-core body
namespace cc {
constexpr int BM = 128, BN = 128, BK = 8;  // output tile and token step
constexpr int TM = 8, TN = 8;              // per-thread sub-tile
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
}  // namespace cc

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool DEV>
__global__ void __launch_bounds__(cc::THREADS)
opa_fused_kernel(const OpaParams a) {
  using namespace cc;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ dh = static_cast<const T*>(a.dh);
  const int Tn = a.Tn, M = a.M, N = a.N;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = OPA_PART == 2 ? 1.f : 0.f;

  for (int t0 = 0; OPA_PART < 2 && t0 < Tn; t0 += BK) {
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
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (OPA_PART == 1) {  // a checksum store in place of the finalize
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sum += acc[i][j];
    reinterpret_cast<float*>(a.planes)[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * THREADS + tid] = sum;
    return;
  }

  // finalize: scale, round, saturate, deposit into the S planes
  const float scale = grid_scale(a.lr, a.frac_bits);
  const int c0 = n0 + tx * TN;
  const size_t plane = (size_t)M * N;
  const int S = a.dp.S;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= M || c0 >= N) break;
    int8_t* row = a.planes + (size_t)r * N + c0;
    if (OPA_PART == 3) {  // the plane words loaded and stored back
      if (a.vec && c0 + TN <= N)
        for (int s = 0; s < S; ++s) {
          uint2 w = *reinterpret_cast<const uint2*>(row + s * plane);
          w.x ^= (uint32_t)Tn >> 31;  // 0 at run time, unknown to the compiler
          *reinterpret_cast<uint2*>(row + s * plane) = w;
        }
      continue;
    }
    int q[TN];
#pragma unroll
    for (int j4 = 0; j4 < TN; j4 += 4) {
      if (a.rng >= RNG_GRID) {
        float y[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) y[b] = increment_at<DEV>(acc[i][j4 + b], scale, r, c0 + j4 + b, a);
        const float4 u = far_u4(r, c0 + j4, a);  // past N: drawn, never deposited
#pragma unroll
        for (int b = 0; b < 4; ++b) q[j4 + b] = update_far(y[b], nth(u, b));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          q[j4 + b] = update_at<DEV>(acc[i][j4 + b], scale, r, c0 + j4 + b, a);
      }
    }
    if (a.vec && c0 + TN <= N) {
      int p[TN][MAX_S];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        if (s < S) {
          const uint2 w = *reinterpret_cast<const uint2*>(row + s * plane);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j][s] = (int)(signed char)(w.x >> (8 * j));
            p[j + 4][s] = (int)(signed char)(w.y >> (8 * j));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) deposit_cell<DEV>(p[j], q[j], r, c0 + j, a);
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        if (s < S) {
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
            if (s < S) p[s] = row[s * plane + j];
          deposit_cell<DEV>(p, q[j], r, c0 + j, a);
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) row[s * plane + j] = (int8_t)p[s];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 tensor-core body
namespace tc {
constexpr int BM = 128, BN = 128;       // output tile (BM == BN: one strip shape)
constexpr int BT = 32;                  // tokens a stage: two k16 steps
constexpr int STAGES = 3;               // cp.async ring depth
constexpr int WM = 2, WN = 4;           // warps along the rows and the columns
constexpr int THREADS = 32 * WM * WN;   // 256
constexpr int FM = BM / WM / 16;        // m16 fragments a warp: 4 (64 rows)
constexpr int FN = BN / WN / 8;         // n8 fragments a warp: 4 (32 columns)
constexpr int CHUNKS = BM * 2 / 16;     // 16-byte chunks a strip row: 16
constexpr int STRIP = BT * BM * 2;      // bytes of one [BT, 128] bf16 strip
constexpr int STAGE = 2 * STRIP;        // x strip, then dh strip
constexpr int CS = BN + 8;              // staged accumulator row stride (floats)
constexpr int SEG = 16;                 // columns a thread finalizes: one 16-byte plane word
constexpr int SMEM = STAGES * STAGE > BM * CS * 4 ? STAGES * STAGE : BM * CS * 4;
}  // namespace tc

// byte offset of chunk q of token row t in a strip: XOR-swizzled, so that 8
// consecutive token rows put one chunk on 8 distinct 16-byte bank groups
__device__ __forceinline__ int strip_off(int t, int q) { return t * tc::CHUNKS * 16 + ((q ^ (t & 7)) << 4); }

// float index of cell (m, n) of the staged tile: float4 slot L of a row sits
// at L ^ ((L >> 3) & 3), so the 8 threads that finalize one row (16 columns
// each) read their float4s on 8 distinct bank groups; with the row stride
// of 136 floats the fragment stores are conflict-free too
__device__ __forceinline__ int cs_at(int m, int n) {
  const int L = n >> 2;
  return m * tc::CS + ((L ^ ((L >> 3) & 3)) << 2) + (n & 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += A(16x16, row) · B(16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
               "{%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one [BT, 128] strip of a [T, K] operand at tokens t0.., features f0..,
// into the strip at shared address dst: 16-byte cp.async chunks (zero-filled
// past T and K) when ld16, else element by element (ragged K or alignment)
__device__ __forceinline__ void load_strip(uint32_t dst, unsigned char* dst_ptr, const __nv_bfloat16* src,
                                           int t0, int f0, int Tn, int K, bool ld16, int idx) {
  const int t = idx / tc::CHUNKS, q = idx % tc::CHUNKS;
  const int gt = t0 + t, gf = f0 + 8 * q;
  if (ld16) {
    const bool valid = gt < Tn && gf < K;
    cp_async16(dst + strip_off(t, q), valid ? src + (size_t)gt * K + gf : src, valid);
  } else {
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = gt < Tn && gf + e < K ? src[(size_t)gt * K + gf + e] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst_ptr + strip_off(t, q)) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ uint32_t& word_of(uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// FAR: the instance of the grid and hw draws (far_u4), apart from the
// counter one, whose finalize keeps the counter draw inline. A runtime
// branch on the source in one instance spills at the 128-register cap of
// the device instance and slows the counter instances (PERF.md, K1's
// rounding sources).
template <bool DEV, bool FAR>
__global__ void __launch_bounds__(tc::THREADS, 2)
opa_mma_kernel(const OpaParams a) {
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem[];
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* __restrict__ dh = static_cast<const __nv_bfloat16*>(a.dh);
  const int Tn = a.Tn, M = a.M, N = a.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const bool ld16 = a.ld16;

  float acc[FM][FN][4];
#pragma unroll
  for (int f = 0; f < FM; ++f)
#pragma unroll
    for (int h = 0; h < FN; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][h][e] = OPA_PART == 2 ? 1.f : 0.f;

  // mainloop: the token axis through the ring, STAGES - 1 strips ahead
  const int KT = OPA_PART < 2 ? (Tn + BT - 1) / BT : 0;
  auto load_stage = [&](int kt) {
    const int st = kt % STAGES;
#pragma unroll
    for (int i = 0; i < 2 * BT * CHUNKS / THREADS; ++i) {
      const int idx = tid + i * THREADS;  // the first BT·CHUNKS chunks are x's, the rest dh's
      const bool is_x = idx < BT * CHUNKS;
      const int off = st * STAGE + (is_x ? 0 : STRIP);
      load_strip(sbase + off, smem + off, is_x ? x : dh, kt * BT, is_x ? m0 : n0, Tn, is_x ? M : N, ld16,
                 is_x ? idx : idx - BT * CHUNKS);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s);
    cp_async_commit();
  }
  // per lane: the ldmatrix.trans row of each 8x8 matrix it addresses
  const int lrow = lane & 7, lmat = lane >> 3;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1);
    cp_async_commit();
    const uint32_t xs = sbase + (kt % STAGES) * STAGE, ds = xs + STRIP;
#pragma unroll
    for (int kk = 0; kk < BT; kk += 16) {
      // A (16 rows m x 16 tokens) from the [token, m] strip: matrix j holds
      // tokens kk + 8·(j >> 1).., rows 8·(j & 1)..: a0..a3 of m16n8k16
      uint32_t af[FM][4];
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        const int t = kk + 8 * (lmat >> 1) + lrow;
        const int m = wm * (BM / WM) + 16 * f + 8 * (lmat & 1);
        ldsm_x4_trans(af[f], xs + strip_off(t, m >> 3));
      }
      // B (16 tokens x 8 columns n) from the [token, n] strip: matrix j holds
      // tokens kk + 8·(j & 1).., columns 8·(j >> 1)..: b0, b1 of two n8 tiles
      uint32_t bf[FN][2];
#pragma unroll
      for (int h = 0; h < FN; h += 2) {
        const int t = kk + 8 * (lmat & 1) + lrow;
        const int n = wn * (BN / WN) + 8 * h + 8 * (lmat >> 1);
        uint32_t r[4];
        ldsm_x4_trans(r, ds + strip_off(t, n >> 3));
        bf[h][0] = r[0];
        bf[h][1] = r[1];
        bf[h + 1][0] = r[2];
        bf[h + 1][1] = r[3];
      }
#pragma unroll
      for (int f = 0; f < FM; ++f)
#pragma unroll
        for (int h = 0; h < FN; ++h) mma_bf16(acc[f][h], af[f], bf[h][0], bf[h][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the staged tile may overwrite it
  if (OPA_PART == 1) {  // a checksum store in place of the finalize
    float sum = 0.f;
#pragma unroll
    for (int f = 0; f < FM; ++f)
#pragma unroll
      for (int h = 0; h < FN; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += acc[f][h][e];
    reinterpret_cast<float*>(a.planes)[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * THREADS + tid] = sum;
    return;
  }

  // stage the f32 tile: c0, c1 at (row g, columns 2·tig, +1), c2, c3 at row g + 8
  float* cs = reinterpret_cast<float*>(smem);
  if (OPA_PART != 3) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int f = 0; f < FM; ++f)
#pragma unroll
      for (int h = 0; h < FN; ++h) {
        const int m = wm * (BM / WM) + 16 * f + g, n = wn * (BN / WN) + 8 * h + 2 * tig;
        *reinterpret_cast<float2*>(cs + cs_at(m, n)) = make_float2(acc[f][h][0], acc[f][h][1]);
        *reinterpret_cast<float2*>(cs + cs_at(m + 8, n)) = make_float2(acc[f][h][2], acc[f][h][3]);
      }
    __syncthreads();
  }

  // finalize: a thread owns 16 contiguous columns of a row, 8 threads a row
  // (a warp moves 4 whole 128-byte plane rows an instruction), 4 row passes
  // over the tile
  const float scale = grid_scale(a.lr, a.frac_bits);
  const size_t plane = (size_t)M * N;
  const int S = a.dp.S;
  const bool stuck = DEV && a.dv.stuck.frac > 0.f;
  const int seg = tid & (BN / SEG - 1), c = n0 + SEG * seg;
#pragma unroll 1
  for (int pass = 0; pass < BM * BN / (THREADS * SEG); ++pass) {
    const int lr = pass * (THREADS * SEG / BN) + tid / (BN / SEG);
    const int r = m0 + lr;
    if (r >= M || c >= N) continue;
    int8_t* row = a.planes + (size_t)r * N + c;
    if (a.vec && c + SEG <= N) {
      uint4 w[MAX_S];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s < S) w[s] = *reinterpret_cast<const uint4*>(row + s * plane);
      if (OPA_PART == 3) {  // the plane words loaded and stored back
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s < S) {
            w[s].x ^= (uint32_t)Tn >> 31;  // 0 at run time, unknown to the compiler
            *reinterpret_cast<uint4*>(row + s * plane) = w[s];
          }
        continue;
      }
      uint8_t* mrow = a.stuck_mask + (size_t)r * N + c;
      uint4 keep = make_uint4(0u, 0u, 0u, 0u);  // the segment's stuck bits, a byte a cell
      if (stuck && a.mask_mode == 2) keep = *reinterpret_cast<const uint4*>(mrow);
#pragma unroll
      for (int j4 = 0; j4 < SEG / 4; ++j4) {
        const float4 v = reinterpret_cast<const float4*>(cs + cs_at(lr, SEG * seg + 4 * j4))[0];
        const float vs[4] = {v.x, v.y, v.z, v.w};
        float y[4];
        float4 u;
        if (FAR) {
#pragma unroll
          for (int b = 0; b < 4; ++b) y[b] = increment_at<DEV>(vs[b], scale, r, c + 4 * j4 + b, a);
          u = far_u4(r, c + 4 * j4, a);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = 4 * j4 + b;
          const int q = FAR ? update_far(y[b], nth(u, b))
                            : update_at<DEV>(vs[b], scale, r, c + j, a);
          int p[MAX_S];
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) p[s] = (int)(signed char)(word_of(w[s], j4) >> (8 * b));
          if (stuck) {
            uint32_t bits;
            if (a.mask_mode == 2) {
              bits = (word_of(keep, j4) >> (8 * b)) & 0xffu;
            } else {
              bits = stuck_bits_at(r, c + j, a);
              word_of(keep, j4) |= bits << (8 * b);
            }
            deposit_keep(p, q, a.dp, bits);
          } else {
            deposit_one(p, q, a.dp);
          }
#pragma unroll
          for (int s = 0; s < MAX_S; ++s)
            if (s < S) {
              uint32_t& wd = word_of(w[s], j4);
              wd = (wd & ~(0xffu << (8 * b))) | ((uint32_t)(uint8_t)p[s] << (8 * b));
            }
        }
      }
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s < S) *reinterpret_cast<uint4*>(row + s * plane) = w[s];
      if (stuck && a.mask_mode == 1) *reinterpret_cast<uint4*>(mrow) = keep;
    } else if (OPA_PART != 3) {
      for (int j = 0; j < SEG && c + j < N; ++j) {
        const float acc = cs[cs_at(lr, SEG * seg + j)];
        const int q = FAR ? update_far(increment_at<DEV>(acc, scale, r, c + j, a),
                                       nth(far_u4(r, (c + j) & ~3, a), (c + j) & 3))
                          : update_at<DEV>(acc, scale, r, c + j, a);
        int p[MAX_S];
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s < S) p[s] = row[s * plane + j];
        if (stuck) {
          uint8_t* m = a.stuck_mask + (size_t)r * N + c + j;
          const uint32_t bits = a.mask_mode == 2 ? *m : stuck_bits_at(r, c + j, a);
          if (a.mask_mode == 1) *m = (uint8_t)bits;
          deposit_keep(p, q, a.dp, bits);
        } else {
          deposit_one(p, q, a.dp);
        }
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s < S) row[s * plane + j] = (int8_t)p[s];
      }
    }
  }
}

template <typename T, bool DEV>
cudaError_t launch_fma(const OpaParams& a, cudaStream_t stream) {
  const dim3 grid((a.N + cc::BN - 1) / cc::BN, (a.M + cc::BM - 1) / cc::BM);
  opa_fused_kernel<T, DEV><<<grid, cc::THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool DEV, bool FAR>
cudaError_t launch_mma(const OpaParams& a, cudaStream_t stream) {
  const dim3 grid((a.N + tc::BN - 1) / tc::BN, (a.M + tc::BM - 1) / tc::BM);
  cudaError_t err = cudaFuncSetAttribute(opa_mma_kernel<DEV, FAR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tc::SMEM);
  if (err != cudaSuccess) return err;
  opa_mma_kernel<DEV, FAR><<<grid, tc::THREADS, tc::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <bool DEV>
cudaError_t launch_body(bool bf16, bool mma, const OpaParams& a, cudaStream_t stream) {
  if (mma) return a.rng >= RNG_GRID ? launch_mma<DEV, true>(a, stream) : launch_mma<DEV, false>(a, stream);
  return bf16 ? launch_fma<__nv_bfloat16, DEV>(a, stream) : launch_fma<float, DEV>(a, stream);
}

}  // namespace

// planes int8 [S,M,N] (rewritten in place), x [T,M] and dh [T,N] of one
// dtype (bf16 != 0: bfloat16, else float32), frac_bits int32 [1], all
// contiguous on the current device. mma != 0 runs the bf16 tensor-core body
// (bf16 operands only), else the CUDA-core body. lr: the host learning rate
// (the kernel folds -lr·2^F). rng (enum Rng) != 0 rounds stochastically by
// that draw under the int32 key words (k0, k1); 0 half to even. offset:
// RNG_GRID's flat index of the layer's cell (0, 0); hw_bm, hw_bn: RNG_HW's
// tile of the layer, which divides (ldm, ldn) and the block's origin.
// (row0, col0): the block's origin in its layer, ldn the layer's column
// count (0, 0, N for a whole layer). plane_max: host int[S]; lim: canonical_limit. vec != 0:
// planes 16-byte aligned with N % 16 == 0 (mma), 8-byte aligned with N % 8
// == 0 (CUDA-core body). physics: NULL for the ideal device, else host
// float[4] = (asym_up, asym_down, write_noise, stuck_frac), with (nk0, nk1)
// the write-noise key words and stuck_words host int[2·S] (w0_s, w1_s per
// slice). stuck_mask: uint8 [M, N] on the
// device for the mma body's stuck cells, mask_mode 1 (write it) or 2 (read
// it), else NULL and 0. Returns a cudaError_t (0 on success).
extern "C" int panther_opa_fused(void* planes, const void* x, const void* dh, const void* frac_bits,
                                 float lr, int Tn, int M, int N, int S, const int* plane_max,
                                 int lim, int bf16, int mma, int rng, int k0, int k1,
                                 unsigned long long offset, int hw_bm, int hw_bn, int vec,
                                 const float* physics, int nk0, int nk1, const int* stuck_words,
                                 void* stuck_mask, int mask_mode, int row0, int col0, int ldn,
                                 void* stream) {
  if (S < 1 || S > MAX_S || Tn < 0 || M < 1 || N < 1 || (mma && !bf16)) return (int)cudaErrorInvalidValue;
  if (mask_mode < 0 || mask_mode > 2 || (mask_mode && (!mma || !stuck_mask))) return (int)cudaErrorInvalidValue;
  if ((M + 127) / 128 > 65535) return (int)cudaErrorInvalidValue;
  if (rng < RNG_NONE || rng > RNG_HW) return (int)cudaErrorInvalidValue;
  if (row0 < 0 || col0 < 0 || ldn < col0 + N) return (int)cudaErrorInvalidValue;
  if (rng == RNG_HW && (hw_bm < 1 || hw_bn < 1 || row0 % hw_bm || col0 % hw_bn || ldn % hw_bn))
    return (int)cudaErrorInvalidValue;
  OpaParams a;
  a.planes = static_cast<int8_t*>(planes);
  a.x = x;
  a.dh = dh;
  a.frac_bits = static_cast<const int*>(frac_bits);
  a.lr = lr;
  a.Tn = Tn;
  a.M = M;
  a.N = N;
  a.rng = rng;
  a.k0 = k0;
  a.k1 = k1;
  a.offset = offset;
  a.hw_bm = rng == RNG_HW ? hw_bm : 1;
  a.hw_bn = rng == RNG_HW ? hw_bn : 1;
  a.hw_tn = ldn / a.hw_bn;
  a.hw4 = a.hw_bn % 4 == 0;
  a.vec = vec;
  a.ld16 = M % 8 == 0 && N % 8 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dh)) % 16 == 0;
  a.dp.S = S;
  a.dp.lim = lim;
  for (int s = 0; s < MAX_S; ++s) a.dp.plane_max[s] = s < S ? plane_max[s] : 0;
  const bool dev = physics != nullptr;
  a.dv.asym_up = dev ? physics[0] : 1.f;
  a.dv.asym_down = dev ? physics[1] : 1.f;
  a.dv.asym = a.dv.asym_up != 1.f || a.dv.asym_down != 1.f;
  a.dv.write_noise = dev ? physics[2] : 0.f;
  a.dv.nk0 = nk0;
  a.dv.nk1 = nk1;
  a.dv.stuck.frac = dev ? physics[3] : 0.f;
  for (int s = 0; s < MAX_S; ++s) {
    a.dv.stuck.w0[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s] : 0;
    a.dv.stuck.w1[s] = stuck_words != nullptr && s < S ? stuck_words[2 * s + 1] : 0;
  }
  a.stuck_mask = static_cast<uint8_t*>(stuck_mask);
  a.mask_mode = mask_mode;
  a.row0 = row0;
  a.col0 = col0;
  a.ldn = ldn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dev ? launch_body<true>(bf16, mma, a, st) : launch_body<false>(bf16, mma, a, st));
}
