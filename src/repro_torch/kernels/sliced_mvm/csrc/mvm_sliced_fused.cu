// Bit-sliced crossbar read (PANTHER's finite-ADC MVM) for NVIDIA Hopper
// (sm_90a), with a plain C interface for ctypes: the quantize-fused read
// (K4) and the read of a pre-quantized int input (K5).
//
// Replaces the Pallas TPU kernels src/repro/kernels/sliced_mvm/kernel.py::
// mvm_sliced_fused (K4: bodies _mvm_fused_db_kernel / _mvm_fused_kernel,
// _tile_compute, _dac_block, read_offsets), the forward read and the
// transpose (MᵀVM) read, with and without device read noise, and
// mvm_sliced (K5: body _mvm_kernel, the same _tile_compute on an int32
// x_q, no DAC prologue).
//
// What it computes, per 128-row crossbar tile k, token b, output column n
// (the transpose read swaps the roles of the plane's rows and columns: it
// contracts over 128-column tiles of N into outputs over M, with the same
// ADC full scale 128·plane_max):
//   x_q[b,r]  = clamp(rint(x[b,r] * 2^F), +-(2^(io-1)-1))         (DAC, K4)
//   c[t,s]    = sum_r sgn(x_q)·bit_t(|x_q|)[b,r] · plane[s,r,n]  (int32)
//   code[t,s] = clamp(rint((c + off[k,s,n]) / step_s), +-2^(adc-1))
//               step_s = 2·128·pm_s/2^adc
//   z[s]      = sum_t code[t,s] · 2^t                            (int32, exact)
//   out[b,n] += sum_s z[s] · step_s · 16^s                       (f32)
// With adc_bits <= 0 (ideal ADC) code = c, and the offset enters once, as
// (z + off·(2^(io-1)-1))·16^s: every bit cycle reads the same offset. off is
// 0 without read noise (the ideal instances add nothing); with it, it is a
// frozen Gaussian per (global tile, slice, global column),
// counter_gauss((tile0 + k)·S + s, col0 + n) under the pattern's key words
// (the forward and the MᵀVM read use different salts), times
// f32(read_noise·128·pm_s). step_s is a power of two, so the ADC is exact;
// the DAC scale is built from the exponent field like exp2i; rintf rounds
// half to even like jnp.round; each add of an offset rounds on its own.
//
// Design. A block owns BN=32 output columns and up to MAX_BB=16 tokens and
// loops over the 128-row tiles (the TPU's sequential k axis and its 2-slot
// DMA become this loop). Per tile, the x strip is quantized and split into
// its io_bits-1 signed bit planes, each packed 4 rows to a 32-bit word, and
// the plane tile [S,128,BN] is transposed into the same 4-rows-per-word
// packing, both in shared memory; with read noise the block draws the
// tile's S·BN offsets into shared memory once (not per token or bit cycle).
// A thread owns one slice, 4 columns and every 4th token of the block; it
// holds the (io_bits-1)x4 column currents of one token in registers and
// computes them with __dp4a (4 int8 MACs a lane), exact in int32 (|c| <=
// 128·pm). Each tile's slice fold then runs through shared memory in
// ascending s, and the tile is added to the accumulator: the order of the
// plain version (and of the reference), so at finite ADC the kernel agrees
// with it bit for bit. io_bits 8, 12 and 16 are template instances (7, 11,
// 15 bit cycles).
//
// The transpose read takes the planes in place, row-major [S, M, N]: four
// consecutive contraction indices of one output row are four consecutive
// bytes of a plane row, so its packed word is a plain 4-byte load and no
// transposed copy of the planes is made. Its shared-memory rows are padded
// by 4 words (WS) so the stores of one warp spread over the banks.
//
// Bound on the H100. Decode at small batch moves S·M·N plane bytes once and
// is bound by those bytes (3.35 TB/s); prefill does 2·B·M·N·S·(io_bits-1)
// int8 operations and is bound by the int8 tensor-core rate (1979 TOP/s).
// This simple design runs on the CUDA cores (dp4a), so it is far from
// either bound. Left for later: the [(io_bits-1)·bb, 128] x [128, S·bn]
// packed product on int8 wgmma (exact in s32), fed by a TMA/cp.async ring of
// plane tiles, and a split over tiles for the narrow-N decode shapes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../counter.cuh"

namespace {

constexpr int XBAR_ROWS = 128;
constexpr int R4 = XBAR_ROWS / 4;       // packed 4-row words per column per tile
constexpr int BN = 32;                  // output columns per block
constexpr int TN = 4;                   // columns per thread
constexpr int NG = BN / TN;             // column groups
constexpr int BG = 4;                   // token groups
constexpr int SG = 8;                   // slice groups
constexpr int THREADS = NG * BG * SG;   // 256
constexpr int MAX_BB = 16;              // tokens per block
constexpr int TPT = MAX_BB / BG;        // tokens per thread
constexpr int MAX_S = 16;

struct ReadParams {
  const int8_t* planes;   // [S, M, N] row-major
  const void* x;          // f32 (K4) or int32 (K5) [B, K]
  const int* frac_bits;   // [1] DAC exponent on the device (K4)
  float* out;             // [B, NO]
  int B, K, NO, S, BB, io_bits, adc_half, vec;
  int rw0, rw1;           // read-noise pattern key words
  int tile0, col0;        // global crossbar-tile and output-column offsets
  float inv_step[MAX_S];  // 2^-e_s: column current -> ADC code units
  float weight[MAX_S];    // step_s · 16^s (finite ADC) or 16^s (ideal)
  float off_scale[MAX_S]; // f32(read_noise · 128 · pm_s)
};

__device__ __forceinline__ uint32_t pack_row_bytes(const int8_t* p, int valid, bool vec) {
  // 4 consecutive plane bytes of one row; columns at or past N read as 0
  if (vec && valid >= 4) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) w |= (uint32_t)(uint8_t)p[j] << (8 * j);
  return w;
}

// K: contraction length (M forward, N transpose); NO: outputs (N forward,
// M transpose); the planes are [S, M, N] row-major either way. XT: float
// (K4, the DAC in the prologue) or int (K5, x_q read as it is).
template <int D, bool FINITE, bool TRANS, bool NOISY, typename XT>
__global__ void __launch_bounds__(THREADS)
mvm_sliced_kernel(const ReadParams a) {
  extern __shared__ __align__(16) int smem[];
  constexpr int XS = D * R4 + 1;       // +1 word: tokens land on distinct banks
  constexpr int WS = TRANS ? BN + 4 : BN;  // packed plane words per r4 row
  const int S = a.S, BB = a.BB, B = a.B, K = a.K, NO = a.NO;
  int* wpk = smem;                     // [S][R4][WS] packed plane words
  int* xd = wpk + S * R4 * WS;         // [BB][XS] packed x digit words
  float* red = reinterpret_cast<float*>(xd + BB * XS);  // [S][BB][BN] slice terms
  float* offs = red + S * BB * BN;     // [S][BN] read offsets of the tile (NOISY)
  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int8_t* __restrict__ planes = a.planes;

  const int tid = threadIdx.x;
  const int ng = tid % NG;
  const int bg = (tid / NG) % BG;
  const int sg = tid / (NG * BG);
  const int n0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * BB;

  float scale = 0.f;
  if constexpr (std::is_same<XT, float>::value)
    scale = __int_as_float((a.frac_bits[0] + 127) << 23);  // exp2i(F)
  const float lim = (float)((1 << (a.io_bits - 1)) - 1);
  const float half = (float)a.adc_half;

  // per-thread output accumulators: tasks tid, tid + THREADS of [BB x BN]
  constexpr int OUT_TASKS = MAX_BB * BN / THREADS;
  float acc[OUT_TASKS];
#pragma unroll
  for (int i = 0; i < OUT_TASKS; ++i) acc[i] = 0.f;

  const int ntiles = (K + XBAR_ROWS - 1) / XBAR_ROWS;
  for (int k = 0; k < ntiles; ++k) {
    const int row0 = k * XBAR_ROWS;

    // DAC + bit planes of the x strip: word (b, t, r4) packs sgn·bit_t of
    // rows 4r4..4r4+3 as int8 lanes (-1, 0, +1)
    for (int task = tid; task < BB * R4; task += THREADS) {
      const int b = task / R4, r4 = task % R4;
      const int gb = b0 + b;
      uint32_t mag[4], neg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + 4 * r4 + i;
        const bool in = gb < B && r < K;
        int q;
        if constexpr (std::is_same<XT, float>::value) {
          const float v = in ? x[(size_t)gb * K + r] : 0.f;
          q = (int)fminf(fmaxf(rintf(v * scale), -lim), lim);
        } else {
          q = in ? x[(size_t)gb * K + r] : 0;
        }
        mag[i] = q < 0 ? 0u - (uint32_t)q : (uint32_t)q;
        neg[i] = q < 0;
      }
      int* dst = xd + b * XS + r4;
#pragma unroll
      for (int t = 0; t < D; ++t) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t bit = (mag[i] >> t) & 1u;
          word |= (bit ? (neg[i] ? 0xFFu : 0x01u) : 0u) << (8 * i);
        }
        dst[t * R4] = (int)word;
      }
    }

    if (TRANS) {
      // plane tile [S,BN,128] (rows n0.., columns row0..) -> wpk[s][r4][n]:
      // columns 4r4..4r4+3 of plane row n are one 4-byte word; a warp
      // reads one 128-byte row segment
      for (int task = tid; task < S * BN * R4; task += THREADS) {
        const int r4 = task % R4;
        const int n = (task / R4) % BN;
        const int s = task / (R4 * BN);
        const int gn = n0 + n;
        const int col = row0 + 4 * r4;
        const int valid = K - col;
        wpk[(s * R4 + r4) * WS + n] =
            (gn < NO && valid > 0)
                ? (int)pack_row_bytes(planes + ((size_t)s * NO + gn) * K + col, valid, a.vec)
                : 0;
      }
    } else {
      // plane tile [S,128,BN] -> wpk[s][r4][n]: rows 4r4..4r4+3 of column n
      // in one word (a 4x4 byte transpose per 4 rows x 4 columns)
      for (int task = tid; task < S * R4 * NG; task += THREADS) {
        const int c4 = task % NG;
        const int r4 = (task / NG) % R4;
        const int s = task / (NG * R4);
        const int col = n0 + 4 * c4;
        const int valid = NO - col;
        uint32_t rw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + 4 * r4 + i;
          rw[i] = (r < K && valid > 0)
                      ? pack_row_bytes(planes + ((size_t)s * K + r) * NO + col, valid, a.vec)
                      : 0u;
        }
        const uint32_t lo01 = __byte_perm(rw[0], rw[1], 0x5140);
        const uint32_t hi01 = __byte_perm(rw[0], rw[1], 0x7362);
        const uint32_t lo23 = __byte_perm(rw[2], rw[3], 0x5140);
        const uint32_t hi23 = __byte_perm(rw[2], rw[3], 0x7362);
        int4 o;
        o.x = (int)__byte_perm(lo01, lo23, 0x5410);
        o.y = (int)__byte_perm(lo01, lo23, 0x7632);
        o.z = (int)__byte_perm(hi01, hi23, 0x5410);
        o.w = (int)__byte_perm(hi01, hi23, 0x7632);
        reinterpret_cast<int4*>(wpk)[((s * R4 + r4) * WS + 4 * c4) / 4] = o;
      }
    }

    if (NOISY) {
      // the tile's frozen read offsets, once per block and tile; at the
      // ideal ADC already summed over the io_bits-1 bit cycles
      const float cycles = (float)((1 << (a.io_bits - 1)) - 1);
      for (int task = tid; task < S * BN; task += THREADS) {
        const int s = task / BN, n = task - s * BN;
        float o = __fmul_rn(counter_gauss((a.tile0 + k) * S + s, a.col0 + n0 + n, a.rw0, a.rw1),
                            a.off_scale[s]);
        if (!FINITE) o = __fmul_rn(o, cycles);
        offs[task] = o;
      }
    }
    __syncthreads();

    // column currents, ADC and bit fold; each (slice, token, column) term
    // z·step_s·16^s goes to red[s][b][n]
    for (int s = sg; s < S; s += SG) {
      const int* wrow = wpk + s * R4 * WS;
      const float inv_step = a.inv_step[s];
      const float weight = a.weight[s];
      float off[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) off[j] = NOISY ? offs[s * BN + ng * TN + j] : 0.f;
#pragma unroll
      for (int i = 0; i < TPT; ++i) {
        const int b = bg + i * BG;
        if (b >= BB) break;
        const int* xrow = xd + b * XS;
        int c[D][TN];
#pragma unroll
        for (int t = 0; t < D; ++t)
#pragma unroll
          for (int j = 0; j < TN; ++j) c[t][j] = 0;
#pragma unroll 2
        for (int r4 = 0; r4 < R4; ++r4) {
          const int4 w = reinterpret_cast<const int4*>(wrow + r4 * WS)[ng];
#pragma unroll
          for (int t = 0; t < D; ++t) {
            const int xv = xrow[t * R4 + r4];
            c[t][0] = __dp4a(xv, w.x, c[t][0]);
            c[t][1] = __dp4a(xv, w.y, c[t][1]);
            c[t][2] = __dp4a(xv, w.z, c[t][2]);
            c[t][3] = __dp4a(xv, w.w, c[t][3]);
          }
        }
        int z[TN] = {0, 0, 0, 0};
#pragma unroll
        for (int t = 0; t < D; ++t)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            int code = c[t][j];
            if (FINITE) {
              // c·2^-e is exact in f32; rint is round half to even
              const float cur = NOISY ? __fadd_rn((float)code, off[j]) : (float)code;
              code = (int)fminf(fmaxf(rintf(cur * inv_step), -half), half);
            }
            z[j] += code * (1 << t);
          }
        float* dst = red + (s * BB + b) * BN + ng * TN;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          dst[j] = (NOISY && !FINITE) ? __fmul_rn(__fadd_rn((float)z[j], off[j]), weight)
                                      : (float)z[j] * weight;
      }
    }
    __syncthreads();

    // slice fold in ascending s, then add the tile to the accumulator
#pragma unroll
    for (int i = 0; i < OUT_TASKS; ++i) {
      const int task = tid + i * THREADS;
      if (task < BB * BN) {
        float v = red[task];
        for (int s = 1; s < S; ++s) v += red[s * BB * BN + task];
        acc[i] += v;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < OUT_TASKS; ++i) {
    const int task = tid + i * THREADS;
    const int b = task / BN, n = task % BN;
    const int gb = b0 + b, gn = n0 + n;
    if (task < BB * BN && gb < B && gn < NO) a.out[(size_t)gb * NO + gn] = acc[i];
  }
}

template <int D, bool FINITE, bool TRANS, bool NOISY, typename XT>
cudaError_t launch_one(const ReadParams& a, cudaStream_t stream) {
  constexpr int WS = TRANS ? BN + 4 : BN;
  const size_t smem = ((size_t)a.S * R4 * WS + (size_t)a.BB * (D * R4 + 1) + (size_t)a.S * a.BB * BN +
                       (NOISY ? (size_t)a.S * BN : 0)) * sizeof(int);
  const dim3 grid((a.NO + BN - 1) / BN, (a.B + a.BB - 1) / a.BB);
  cudaError_t err = cudaFuncSetAttribute(mvm_sliced_kernel<D, FINITE, TRANS, NOISY, XT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mvm_sliced_kernel<D, FINITE, TRANS, NOISY, XT><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool NOISY, typename XT>
cudaError_t launch_d(bool finite, bool transpose, const ReadParams& a, cudaStream_t stream) {
  if (finite)
    return transpose ? launch_one<D, true, true, NOISY, XT>(a, stream)
                     : launch_one<D, true, false, NOISY, XT>(a, stream);
  return transpose ? launch_one<D, false, true, NOISY, XT>(a, stream)
                   : launch_one<D, false, false, NOISY, XT>(a, stream);
}

// the io_bits the source instantiates: 8, 12 and 16 (7, 11, 15 bit cycles)
template <bool NOISY, typename XT>
cudaError_t launch(bool finite, bool transpose, const ReadParams& a, cudaStream_t stream) {
  switch (a.io_bits) {
    case 8: return launch_d<7, NOISY, XT>(finite, transpose, a, stream);
    case 12: return launch_d<11, NOISY, XT>(finite, transpose, a, stream);
    case 16: return launch_d<15, NOISY, XT>(finite, transpose, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the shapes, the ADC and the slice weights of a read; false on bad sizes
bool read_params(ReadParams& a, const void* planes, const void* x, void* out, int B, int M, int N, int S,
                 int io_bits, int adc_bits, const int* slice_bits, int vec, int transpose) {
  if (S < 1 || S > MAX_S || B < 1 || M < 1 || N < 1 || adc_bits > 16) return false;
  a.planes = static_cast<const int8_t*>(planes);
  a.x = x;
  a.frac_bits = nullptr;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.K = transpose ? N : M;
  a.NO = transpose ? M : N;
  a.S = S;
  a.BB = B < MAX_BB ? B : MAX_BB;
  a.io_bits = io_bits;
  const bool finite = adc_bits > 0;
  a.adc_half = finite ? (1 << (adc_bits - 1)) : 0;
  a.vec = vec;
  a.rw0 = a.rw1 = a.tile0 = a.col0 = 0;
  for (int s = 0; s < MAX_S; ++s) {
    a.inv_step[s] = 0.f;
    a.weight[s] = 0.f;
    a.off_scale[s] = 0.f;
  }
  for (int s = 0; s < S; ++s) {
    // full scale 128·2^(b-1) = 2^(6+b); step = 2·fs/2^adc = 2^(7+b-adc)
    const int e = 7 + slice_bits[s] - adc_bits;
    a.inv_step[s] = finite ? ldexpf(1.f, -e) : 1.f;
    a.weight[s] = finite ? ldexpf(1.f, e + 4 * s) : ldexpf(1.f, 4 * s);
  }
  return true;
}

}  // namespace

// K4. planes int8 [S,M,N], x f32 [B,M] ([B,N] when transpose), frac_bits
// int32 [1] (device), out f32 [B,N] ([B,M] when transpose), all contiguous
// on the current device. slice_bits: host int[S], physical bits per slice
// LSB-first. adc_bits <= 0 selects the ideal ADC. io_bits: 8, 12 or 16.
// vec != 0: the planes' row length (N) is a multiple of 4 and the planes
// 4-byte aligned. off_scale: NULL (no read noise), or host float[S] =
// f32(read_noise·128·pm_s), with (rw0, rw1) the pattern's key words and
// (tile0, col0) the global tile and column offsets. Returns a cudaError_t.
extern "C" int panther_mvm_sliced_fused(const void* planes, const void* x, const void* frac_bits,
                                        void* out, int B, int M, int N, int S, int io_bits,
                                        int adc_bits, const int* slice_bits, int vec,
                                        int transpose, const float* off_scale, int rw0, int rw1,
                                        int tile0, int col0, void* stream) {
  ReadParams a;
  if (!read_params(a, planes, x, out, B, M, N, S, io_bits, adc_bits, slice_bits, vec, transpose))
    return (int)cudaErrorInvalidValue;
  a.frac_bits = static_cast<const int*>(frac_bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (off_scale == nullptr) return (int)launch<false, float>(adc_bits > 0, transpose != 0, a, st);
  for (int s = 0; s < S; ++s) a.off_scale[s] = off_scale[s];
  a.rw0 = rw0;
  a.rw1 = rw1;
  a.tile0 = tile0;
  a.col0 = col0;
  return (int)launch<true, float>(adc_bits > 0, transpose != 0, a, st);
}

// K5. As K4 without the DAC and the read noise: x_q int32 [B,M] ([B,N]
// when transpose) on the io_bits grid; the bits of |x_q| at and above
// io_bits-1 are not streamed. Returns a cudaError_t.
extern "C" int panther_mvm_sliced(const void* planes, const void* x_q, void* out, int B, int M, int N,
                                  int S, int io_bits, int adc_bits, const int* slice_bits, int vec,
                                  int transpose, void* stream) {
  ReadParams a;
  if (!read_params(a, planes, x_q, out, B, M, N, S, io_bits, adc_bits, slice_bits, vec, transpose))
    return (int)cudaErrorInvalidValue;
  return (int)launch<false, int>(adc_bits > 0, transpose != 0, a, static_cast<cudaStream_t>(stream));
}
