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
// the DAC scale is built from the exponent field like exp2i; rint rounds
// half to even like jnp.round; each add of an offset rounds on its own; the
// slice fold runs in ascending s and each tile is added to the accumulator
// in tile order, the order of the plain version (and of the reference), so
// at finite ADC the three bodies below agree with it bit for bit. io_bits 8,
// 12 and 16 are template instances (7, 11, 15 bit cycles).
//
// Three bodies compute these numbers, chosen by shape only (the wrapper's
// body_for; nothing falls back on an error): the decode body for forward K4
// reads of at most 4 tokens (DECODE_MAX_B), the dp4a body for MᵀVM K4 reads
// and for K5 reads of as few tokens, the tensor-core body for every read of
// more. K5's dp4a instances are also called by name: the same-work yardstick
// of the old design.
//
// The tensor-core body (mvm_mma_kernel). The column currents of one tile are one
// int8 product, exact in s32, on mma.sync.m16n8k32: A = the bit planes
// [T·bb, 128] (values -1/0/+1, rows t-major: one m16 fragment is 16 tokens
// at one bit cycle t), B = the plane tile [S·BN, 128], contraction-
// contiguous per output column as the .col operand wants. A block owns
// BN=64 output columns and BB tokens (32, or 64 for reads of more than 128
// tokens: 8 or 16 warps) and loops over the 128-row tiles (the TPU's
// sequential k axis). Per tile it quantizes the x strip and writes its
// (io-1) bit planes as packed words (4 rows of one token and cycle a word,
// byte i for row 4r4+i; xa[b][t][r4]), and the plane tile as packed words
// per column (wb[s][n][r4], 128 bytes a column): the MᵀVM read copies the
// 16-byte chunks of the row-major plane rows as they are; the forward read
// loads 4 rows x 16 columns a thread and transposes 4x4 bytes with
// __byte_perm. A and B fragments come from shared memory with ldmatrix: an
// A register is 4 consecutive k of one token, a B register 4 consecutive k
// of one column, exactly the packed words. The 16-byte chunks of a column
// are XOR-swizzled and the token rows padded by 4 words, so the stores and
// the ldmatrix loads hit distinct banks. Each warp owns 16 tokens x 16
// columns (two n8 fragments). It takes the slices two at a time in
// ascending order: it holds their B fragments of the whole tile in
// registers and walks the bit cycles t, loading the A fragments of t once
// for 4 mma (2 slices x 2 n8). Every C fragment is 16 tokens x 8 columns of
// one (t, s), so the same register of the same thread holds the same
// (token, column) for every t and every s: the ADC, the bit fold and the
// slice fold run in registers, with no shuffle and no reduction buffer.
//
// Its epilogue has no int<->float conversion in the bit-cycle loop (I2F and
// F2I yield 16 results a clock per SM on sm_90, FFMA 128). The first mma of
// each (t, s) starts from the bits of 1.5·2^23, so the four leave c +
// 0x4B400000, whose float is 1.5·2^23 + c, exact for |c| < 2^22 (|c| <=
// 128·128 here). One fmaf with the power-of-two 1/step and the exact addend
// 1.5·2^23·(1 - 1/step) gives 1.5·2^23 + c/step rounded half to even at the
// integer grid, like rintf. A float clamp to 1.5·2^23 +- 2^(adc-1) is right
// for any current, since the rounding is monotone. The float's bits are then
// 0x4B400000 + code: the bit fold adds them shifted by t and takes
// (2^T-1)·0x4B400000 off once (wrapping uint32, exact). With read noise the
// current is first recovered exactly (float less 1.5·2^23), the offset added
// with one rounding as in the dp4a body, and fmaf(cur, 1/step, 1.5·2^23)
// rounds it. The slice terms and the tile sum use __fmul_rn/__fadd_rn, so
// nothing is contracted into an FMA that the plain version does not do.
// Blocks run the token blocks of one column block together, so each plane
// tile is read from device memory once and from L2 B/BB times. K5's
// instances read x_q with int4 loads and no DAC; x_q is not clamped, so each
// magnitude is cut to its D streamed bits before it is packed into a 16-bit
// lane (the bits the dp4a body streams: K5's dp4a and tensor-core instances
// agree bit for bit on any int32, INT_MIN included).
//
// The dp4a body (mvm_sliced_kernel: the MᵀVM K4 reads and the K5 reads of
// at most 4 tokens). A block owns 32 columns and up to 16 tokens and walks every
// crossbar tile; a thread holds the (io-1)x4 currents of one token, slice
// and 4 columns in registers and computes them with __dp4a (4 int8 MACs a
// lane, exact in int32) from the same packed words; the slice fold runs
// through shared memory in ascending s.
//
// The decode body (mvm_decode_kernel: forward K4 reads of at most 4
// tokens, the serving path's decode). Such a read moves S·M·N plane bytes
// once for few operations each, so it needs many blocks in flight and its
// plane loads overlapped with the compute. It is split over crossbar tiles:
// a block owns 32 output columns and a group of G consecutive 128-row
// tiles, G chosen per shape by the wrapper's decode_plan so that every
// gemma-2b read launches several waves of blocks (64 columns a block, a
// deeper ring and taller stages ran no faster on the card). The split
// stays bit for bit: every block computes each of its tiles' f32 term (ADC,
// bit fold, slice fold in ascending s) exactly as the other bodies do, into
// a workspace [tiles, B, NO]; the last block of a column block to finish
// (an atomic ticket taken after __threadfence) sums the workspace in
// ascending tile order from 0.f with __fadd_rn, the plain version's order,
// so which block finishes first does not matter. Its ticket is reset by
// that block, so a read needs no memset; the wrapper keeps one ticket array
// per (device, stream), so reads on two streams never share one. A ring of
// 3 stages of 64 plane rows fed by 16-byte cp.async copies (zero-filled
// past the M and N edges) keeps the next stages' loads in flight while one
// is computed; the next stage's x rows are loaded into registers meanwhile
// and turned into bit-plane words after the compute, so a stage costs one
// barrier. A thread holds the (io-1)x4 currents of one
// slice, token and 4 columns, transposes 4x4 plane bytes from the stage
// with __byte_perm and computes them with __dp4a, each accumulator started
// from the bits of 1.5·2^23 as the tensor-core body starts its C fragment:
// the ADC is the same fmaf and float clamp, with no int<->float conversion
// a code.
//
// Bound on the H100. Decode at small batch moves S·M·N plane bytes once and
// is bound by those bytes (3.35 TB/s); prefill does 2·B·M·N·S·(io_bits-1)
// int8 operations and is bound by the int8 tensor-core rate (1979 TOP/s).
// On the CUDA cores the decode read is not free either: B·(io_bits-1)/4
// __dp4a a plane byte (15 at 4 tokens and io 16, ~13 G a gemma-2b layer),
// at 64 a clock per SM about 0.8 ms a layer, three times the 0.26 ms byte
// bound; an int8 mma.sync decode body with rows packed as (bit cycle,
// token) would do the same work in 4 m16 fragments.
// The tensor-core body makes one ADC output per 128 MACs. Its epilogue (4
// instructions an output at finite ADC, 6 with read noise) runs on the CUDA
// cores beside the mma, and the prologue's global loads are not overlapped
// with the mma (one buffer, two barriers a tile), so it stays about 4x over
// the int8 bound at 256 tokens: wgmma with TMA would buy little until the
// epilogue shrinks. The 64-token blocks of 16 warps run at 128 registers a
// thread and spill a few words, and still run faster than 8 warps of 32
// tokens at 255 registers: hiding latency is worth more. Left for later: a
// cp.async ring for its plane tiles, and the MᵀVM reads of at most 4 tokens
// on the decode body's split.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../counter.cuh"

namespace {

constexpr int XBAR_ROWS = 128;
constexpr int R4 = XBAR_ROWS / 4;       // packed 4-row words per column per tile
constexpr int MAX_S = 16;

struct ReadParams {
  const int8_t* planes;   // [S, M, N] row-major
  const void* x;          // f32 (K4) or int32 (K5) [B, K]
  const int* frac_bits;   // [1] DAC exponent on the device (K4)
  float* out;             // [B, NO]
  int B, K, NO, S, BB, io_bits, adc_half, vec;
  int vec16;              // planes 16-byte aligned, N % 16 == 0 (tensor-core body)
  int xvec;               // x 16-byte aligned, K % 4 == 0 (tensor-core body)
  int rw0, rw1;           // read-noise pattern key words
  int tile0, col0;        // global crossbar-tile and output-column offsets
  float inv_step[MAX_S];  // 2^-e_s: column current -> ADC code units
  float bias[MAX_S];      // 1.5·2^23·(1 - 2^-e_s), exact: see the tensor-core epilogue
  float weight[MAX_S];    // step_s · 16^s (finite ADC) or 16^s (ideal)
  float off_scale[MAX_S]; // f32(read_noise · 128 · pm_s)
  float* ws;              // [tiles, B, NO] tile terms (decode body)
  unsigned* tickets;      // [n_tickets] zero between reads, one a column block (decode body)
  int group;              // crossbar tiles a block owns (decode body)
  int n_tickets;          // the tickets' length: the widest grid a launch may take (decode body)
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

// 4 rows x 4 bytes -> 4 words, word j = byte j of every row (row i in byte i)
__device__ __forceinline__ int4 transpose4x4(const uint32_t (&rw)[4]) {
  const uint32_t lo01 = __byte_perm(rw[0], rw[1], 0x5140);
  const uint32_t hi01 = __byte_perm(rw[0], rw[1], 0x7362);
  const uint32_t lo23 = __byte_perm(rw[2], rw[3], 0x5140);
  const uint32_t hi23 = __byte_perm(rw[2], rw[3], 0x7362);
  int4 o;
  o.x = (int)__byte_perm(lo01, lo23, 0x5410);
  o.y = (int)__byte_perm(lo01, lo23, 0x7632);
  o.z = (int)__byte_perm(hi01, hi23, 0x5410);
  o.w = (int)__byte_perm(hi01, hi23, 0x7632);
  return o;
}

// ---------------------------------------------------------------------------
// The dp4a body
// ---------------------------------------------------------------------------

constexpr int BN = 32;                  // output columns per block
constexpr int TN = 4;                   // columns per thread
constexpr int NG = BN / TN;             // column groups
constexpr int BG = 4;                   // token groups
constexpr int SG = 8;                   // slice groups
constexpr int THREADS = NG * BG * SG;   // 256
constexpr int MAX_BB = 16;              // tokens per block
constexpr int TPT = MAX_BB / BG;        // tokens per thread

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
        reinterpret_cast<int4*>(wpk)[((s * R4 + r4) * WS + 4 * c4) / 4] = transpose4x4(rw);
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
cudaError_t launch_dp4a(const ReadParams& a, cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// The tensor-core body
// ---------------------------------------------------------------------------

namespace tc {
constexpr int NJ = 2;                   // n8 fragments per warp
constexpr int SP = 2;                   // slices a warp computes per pass over the bit cycles
constexpr int WN = 4;                   // warps along the columns
constexpr int BN = 8 * NJ * WN;         // 64 output columns per block
constexpr int WIDE_B = 128;             // reads of more tokens take 64-token blocks, others 32
constexpr int NC16 = BN / 16;           // 16-column groups of the forward plane loads
constexpr int MAGIC_I = 0x4B400000;     // the bits of 1.5·2^23
constexpr float MAGIC_F = 12582912.f;   // 1.5·2^23
}  // namespace tc

// the 16-byte chunk of column n's 128-byte row that holds chunk q: 8
// consecutive columns put one chunk on 8 distinct bank groups (ldmatrix),
// and the forward prologue's 4 column groups a warp stores land apart
__device__ __forceinline__ int chunk_swz(int n, int q) {
  return q ^ (n & 7) ^ ((((n >> 4) & (tc::NC16 - 1)) * (8 / tc::NC16)) & 7);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d = A(16x32, row) · B(32x8, col) + c, int8 in, exact s32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                       const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// MI: m16 fragments (warps) along the tokens; BB = 16·MI tokens a block.
// XT: float (K4, the DAC in the prologue) or int (K5, x_q read as it is).
template <int MI, int D, bool FINITE, bool TRANS, bool NOISY, typename XT>
__global__ void __launch_bounds__(32 * MI * tc::WN, 1)
mvm_mma_kernel(const ReadParams a) {
  constexpr int BB = 16 * MI, BN = tc::BN, NJ = tc::NJ, SP = tc::SP, NC16 = tc::NC16, THREADS = 32 * MI * tc::WN;
  constexpr int MAGIC_I = tc::MAGIC_I;
  constexpr float MAGIC_F = tc::MAGIC_F;
  extern __shared__ __align__(16) int smem[];
  constexpr int XS = D * R4 + 4;       // words per token: t-major bit planes, +4 (ldmatrix rows on distinct banks)
  const int S = a.S, B = a.B, K = a.K, NO = a.NO;
  int* wb = smem;                      // [S][BN][R4] packed plane words, chunks swizzled
  int* xa = wb + S * BN * R4;          // [BB][XS] packed bit-plane words
  float* offs = reinterpret_cast<float*>(xa + BB * XS);  // [S][BN] read offsets of the tile (NOISY)
  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int8_t* __restrict__ planes = a.planes;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int mi = warp % MI, nq = warp / MI;  // the warp's 16 tokens and 16 columns
  const int b0 = blockIdx.x * BB, n0 = blockIdx.y * BN;
  const int bb = min(BB, B - b0);
  const bool active = 16 * mi < bb;    // warp-uniform: a warp past the last token only loads

  float scale = 0.f;
  if constexpr (std::is_same<XT, float>::value)
    scale = __int_as_float((a.frac_bits[0] + 127) << 23);  // exp2i(F)
  const float lim = (float)((1 << (a.io_bits - 1)) - 1);
  const float lo = MAGIC_F - (float)a.adc_half, hi = MAGIC_F + (float)a.adc_half;

  // per lane: the ldmatrix row addresses of the A fragments (matrix lane>>3:
  // tokens +8 for odd matrices, bytes +16 for matrices 2 and 3) and of the B
  // fragments (matrix lane>>3 is 16-byte chunk 4p + (lane>>3) of a kk pair p)
  const int* a_lane = xa + (16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1)) * XS + 4 * (lane >> 4);
  const int bcol = 16 * nq + (lane & 7);  // + 8j

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int ntiles = (K + XBAR_ROWS - 1) / XBAR_ROWS;
  for (int k = 0; k < ntiles; ++k) {
    const int row0 = k * XBAR_ROWS;

    // DAC + bit planes of the x strip: word (b, t, r4) packs sgn·bit_t of
    // rows 4r4..4r4+3 as int8 lanes (-1, 0, +1), byte i for row 4r4+i
    for (int task = tid; task < bb * R4; task += THREADS) {
      const int b = task / R4, r4 = task % R4;
      const int r = row0 + 4 * r4;
      const XT* xr = x + (size_t)(b0 + b) * K + r;
      uint32_t mag[4], nb = 0;
      if constexpr (std::is_same<XT, float>::value) {
        float v[4];
        if (a.xvec && r + 3 < K) {
          const float4 f = *reinterpret_cast<const float4*>(xr);
          v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = r + i < K ? xr[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = (int)fminf(fmaxf(rintf(v[i] * scale), -lim), lim);
          mag[i] = (uint32_t)abs(q);
          nb |= (uint32_t)(q < 0) << (8 * i);
        }
      } else {
        // x_q as it is, unclamped: only the D streamed bits of |x_q| are
        // kept (as the dp4a body streams them; |INT_MIN| wraps to 2^31, whose
        // low bits are 0), so no magnitude spills into the next 16-bit lane
        int q[4];
        if (a.xvec && r + 3 < K) {
          const int4 f = *reinterpret_cast<const int4*>(xr);
          q[0] = f.x, q[1] = f.y, q[2] = f.z, q[3] = f.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) q[i] = r + i < K ? xr[i] : 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mag[i] = (q[i] < 0 ? 0u - (uint32_t)q[i] : (uint32_t)q[i]) & ((1u << D) - 1u);
          nb |= (uint32_t)(q[i] < 0) << (8 * i);
        }
      }
      // magnitudes < 2^15 in 16-bit lanes: bit t of rows 0, 2 and of 1, 3
      const uint32_t m02 = mag[0] | (mag[2] << 16), m13 = mag[1] | (mag[3] << 16);
      int* dst = xa + b * XS + r4;
#pragma unroll
      for (int t = 0; t < D; ++t) {
        uint32_t w = ((m02 >> t) & 0x00010001u) | (((m13 >> t) & 0x00010001u) << 8);
        w += (w & nb) * 0xFEu;  // byte 1 -> 0xFF (-1) where the row is negative
        dst[t * R4] = (int)w;
      }
    }

    if (TRANS) {
      // plane rows n0.. (the outputs), columns row0..row0+127 (the
      // contraction): each row's 16-byte chunks are packed words as they are
      for (int task = tid; task < S * BN * 8; task += THREADS) {
        const int q = task & 7, n = (task >> 3) % BN, s = task / (8 * BN);
        const int gn = n0 + n, col = row0 + 16 * q;
        const int valid = gn < NO ? K - col : 0;
        const int8_t* src = planes + ((size_t)s * NO + gn) * K + col;
        int4 w;
        if (a.vec16 && valid >= 16) {
          w = *reinterpret_cast<const int4*>(src);
        } else {
          w.x = valid > 0 ? (int)pack_row_bytes(src, valid, false) : 0;
          w.y = valid > 4 ? (int)pack_row_bytes(src + 4, valid - 4, false) : 0;
          w.z = valid > 8 ? (int)pack_row_bytes(src + 8, valid - 8, false) : 0;
          w.w = valid > 12 ? (int)pack_row_bytes(src + 12, valid - 12, false) : 0;
        }
        reinterpret_cast<int4*>(wb)[(s * BN + n) * 8 + chunk_swz(n, q)] = w;
      }
    } else {
      // plane rows row0.. (the contraction), columns n0.. (the outputs): a
      // task reads 4 rows x 16 columns and writes the 16 columns' words of
      // r4 (a 4x4 byte transpose per 4 columns)
      for (int task = tid; task < S * R4 * NC16; task += THREADS) {
        const int c16 = task % NC16, r4 = (task / NC16) % R4, s = task / (NC16 * R4);
        const int col = n0 + 16 * c16;
        const int valid = NO - col;
        uint32_t rows[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + 4 * r4 + i;
          const int8_t* src = planes + ((size_t)s * K + r) * NO + col;
          if (r < K && a.vec16 && valid >= 16) {
            const int4 w = *reinterpret_cast<const int4*>(src);
            rows[i][0] = w.x, rows[i][1] = w.y, rows[i][2] = w.z, rows[i][3] = w.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              rows[i][c] = (r < K && valid > 4 * c) ? pack_row_bytes(src + 4 * c, valid - 4 * c, false) : 0u;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t rw[4] = {rows[0][c], rows[1][c], rows[2][c], rows[3][c]};
          const int4 o = transpose4x4(rw);
          const int ow[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 16 * c16 + 4 * c + j;
            wb[(s * BN + n) * R4 + 4 * chunk_swz(n, r4 >> 2) + (r4 & 3)] = ow[j];
          }
        }
      }
    }

    if (NOISY) {
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

    if (active) {
      float v[NJ][4];
      // slices in passes of SP: each A fragment loaded serves SP·NJ mma
      for (int s0 = 0; s0 < S; s0 += SP) {
        // the tile's B fragments of slices s0..: [p][j][kk] = {bytes 0-15,
        // 16-31}; zero past the last slice (its terms are not folded)
        uint32_t bf[SP][NJ][4][2];
        float off[SP][NJ][2], inv_step[SP], bias[SP];
#pragma unroll
        for (int p = 0; p < SP; ++p) {
          const int s = s0 + p;
          const bool in = s < S;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int n = bcol + 8 * j;
            const int* row = wb + (s * BN + n) * R4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t r[4] = {0u, 0u, 0u, 0u};
              if (in) ldsm_x4(r, row + 4 * chunk_swz(n, 4 * h + (lane >> 3)));
              bf[p][j][2 * h][0] = r[0], bf[p][j][2 * h][1] = r[1];
              bf[p][j][2 * h + 1][0] = r[2], bf[p][j][2 * h + 1][1] = r[3];
            }
            off[p][j][0] = off[p][j][1] = 0.f;
            if (NOISY && in) {
              const float2 o = *reinterpret_cast<const float2*>(offs + s * BN + 16 * nq + 8 * j + 2 * tig);
              off[p][j][0] = o.x, off[p][j][1] = o.y;
            }
          }
          inv_step[p] = a.inv_step[in ? s : 0];
          bias[p] = a.bias[in ? s : 0];
        }

        // z: the bit fold of the codes' float bits (finite) or of the
        // currents (ideal), wrapping uint32
        uint32_t z[SP][NJ][4];
#pragma unroll
        for (int p = 0; p < SP; ++p)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) z[p][j][i] = 0u;
#pragma unroll
        for (int t = 0; t < D; ++t) {
          constexpr int C0[4] = {FINITE ? MAGIC_I : 0, FINITE ? MAGIC_I : 0, FINITE ? MAGIC_I : 0,
                                 FINITE ? MAGIC_I : 0};
          int c[SP][NJ][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t af[4];
            ldsm_x4(af, a_lane + t * R4 + 8 * kk);
#pragma unroll
            for (int p = 0; p < SP; ++p)
#pragma unroll
              for (int j = 0; j < NJ; ++j) {
                if (kk == 0)
                  mma_s8(c[p][j], af, bf[p][j][kk][0], bf[p][j][kk][1], C0);
                else
                  mma_s8(c[p][j], af, bf[p][j][kk][0], bf[p][j][kk][1], c[p][j]);
              }
          }
#pragma unroll
          for (int p = 0; p < SP; ++p)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (FINITE) {
                  float r;
                  if (NOISY) {
                    const float cur = __fadd_rn(__fsub_rn(__int_as_float(c[p][j][i]), MAGIC_F), off[p][j][i & 1]);
                    r = fmaf(cur, inv_step[p], MAGIC_F);
                  } else {
                    r = fmaf(__int_as_float(c[p][j][i]), inv_step[p], bias[p]);
                  }
                  r = fminf(fmaxf(r, lo), hi);
                  z[p][j][i] += (uint32_t)__float_as_int(r) << t;
                } else {
                  z[p][j][i] += (uint32_t)c[p][j][i] << t;
                }
              }
        }
        // the slices' terms, folded in ascending s
        constexpr uint32_t FOLD = FINITE ? (uint32_t)MAGIC_I * ((1u << D) - 1u) : 0u;
#pragma unroll
        for (int p = 0; p < SP; ++p) {
          const int s = s0 + p;
          if (s >= S) break;
          const float weight = a.weight[s];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float zf = (float)(int)(z[p][j][i] - FOLD);
              const float term = (NOISY && !FINITE) ? __fmul_rn(__fadd_rn(zf, off[p][j][i & 1]), weight)
                                                    : __fmul_rn(zf, weight);
              v[j][i] = s == 0 ? term : __fadd_rn(v[j][i], term);
            }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = __fadd_rn(acc[j][i], v[j][i]);
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gb = b0 + 16 * mi + g + 8 * (i >> 1);
        const int gn = n0 + 16 * nq + 8 * j + 2 * tig + (i & 1);
        if (gb < B && gn < NO) a.out[(size_t)gb * NO + gn] = acc[j][i];
      }
  }
}

template <int MI, int D, bool FINITE, bool TRANS, bool NOISY, typename XT>
cudaError_t launch_mma_mi(const ReadParams& a, cudaStream_t stream) {
  constexpr int BB = 16 * MI;
  const size_t smem = ((size_t)a.S * tc::BN * R4 + (size_t)BB * (D * R4 + 4) +
                       (NOISY ? (size_t)a.S * tc::BN : 0)) * sizeof(int);
  // token blocks fastest: the blocks of one column block run together
  const dim3 grid((a.B + BB - 1) / BB, (a.NO + tc::BN - 1) / tc::BN);
  cudaError_t err = cudaFuncSetAttribute(mvm_mma_kernel<MI, D, FINITE, TRANS, NOISY, XT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mvm_mma_kernel<MI, D, FINITE, TRANS, NOISY, XT><<<grid, 32 * MI * tc::WN, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool FINITE, bool TRANS, bool NOISY, typename XT>
cudaError_t launch_mma(const ReadParams& a, cudaStream_t stream) {
  return a.B > tc::WIDE_B ? launch_mma_mi<4, D, FINITE, TRANS, NOISY, XT>(a, stream)
                          : launch_mma_mi<2, D, FINITE, TRANS, NOISY, XT>(a, stream);
}

// ---------------------------------------------------------------------------
// The decode body
// ---------------------------------------------------------------------------

namespace dec {
constexpr int BN = 32;                  // output columns a block owns
constexpr int NQ = BN / 4;              // 4-column groups: one thread each per (slice, token)
constexpr int CH = 64;                  // plane rows a ring stage holds: half a crossbar tile
constexpr int CR4 = CH / 4;             // packed 4-row words a column per stage
constexpr int CHUNKS = XBAR_ROWS / CH;  // stages a tile
constexpr int NST = 3;                  // ring depth
constexpr int C16 = BN / 16;            // 16-byte copies a stage row
constexpr int MAX_THREADS = 512;        // one thread per (slice, token, 4 columns): S·B <= 64
constexpr int MAX_DEVICES = 64;

// words of one token's bit-plane words [CR4][DP] (DP: the bit cycles
// padded to 16 bytes), +4 words so the tokens' 16-byte loads hit distinct banks
__host__ __device__ constexpr int xs_words(int D) { return CR4 * ((D + 3) & ~3) + 4; }
// the ring [NST][S][CH][BN] int8, the bit-plane words [2][B][xs_words],
// the slice terms [S][B][BN] f32, the read offsets [S][BN] f32 (noisy)
inline size_t smem_bytes(int D, bool noisy, int S, int B) {
  return (size_t)NST * S * CH * BN + 4 * (2 * (size_t)B * xs_words(D) + (size_t)S * B * BN + (noisy ? (size_t)S * BN : 0));
}
}  // namespace dec

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Forward read only (K = M rows contracted, NO = N outputs). Grid: (column
// blocks of BN, groups of a.group tiles); a.S·a.B·NQ threads (rounded up to
// a warp), thread (s, b, q) owning slice s, token b, columns 4q..4q+3.
template <int D, bool FINITE, bool NOISY>
__global__ void __launch_bounds__(dec::MAX_THREADS)
mvm_decode_kernel(const ReadParams a) {
  constexpr int BN = dec::BN, NQ = dec::NQ, CH = dec::CH, CR4 = dec::CR4, CHUNKS = dec::CHUNKS, NST = dec::NST,
                C16 = dec::C16;
  constexpr int DP = (D + 3) & ~3;
  constexpr int XSW = dec::xs_words(D);
  constexpr int MAGIC_I = tc::MAGIC_I;
  constexpr float MAGIC_F = tc::MAGIC_F;
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ int last_block;
  const int S = a.S, B = a.B, K = a.K, NO = a.NO;
  const int stage = S * CH * BN;
  int* xs = reinterpret_cast<int*>(dsm + NST * stage);  // [2][B][XSW] bit-plane words, by chunk parity
  float* red = reinterpret_cast<float*>(xs + 2 * B * XSW);  // [S][B][BN] slice terms of the tile
  float* offs = red + S * B * BN;                            // [S][BN] read offsets of the tile (NOISY)
  const int8_t* __restrict__ planes = a.planes;
  const float* __restrict__ x = static_cast<const float*>(a.x);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int q = tid % NQ, b = (tid / NQ) % B, s = tid / (NQ * B);
  const bool worker = s < S;  // the threads past S·B·NQ only load
  const int n0 = blockIdx.x * BN;
  const int ntiles = (K + XBAR_ROWS - 1) / XBAR_ROWS;
  const int k0 = blockIdx.y * a.group;
  const int nchunks = min(a.group, ntiles - k0) * CHUNKS;
  const auto chunk_row0 = [&](int i) { return (k0 + i / CHUNKS) * XBAR_ROWS + (i % CHUNKS) * CH; };

  const float scale = __int_as_float((a.frac_bits[0] + 127) << 23);  // exp2i(F)
  const float lim = (float)((1 << (a.io_bits - 1)) - 1);
  const float lo = MAGIC_F - (float)a.adc_half, hi = MAGIC_F + (float)a.adc_half;
  const int sw = worker ? s : 0;
  const float inv_step = a.inv_step[sw], bias = a.bias[sw], weight = a.weight[sw];

  // the planes of chunk i (64 rows of tile k0 + i/2) into stage i % NST: one
  // commit group a call, empty past the last chunk
  const auto load = [&](int i) {
    if (i < nchunks) {
      const int row0 = chunk_row0(i);
      unsigned char* st = dsm + (i % NST) * stage;
      if (a.vec16) {
        for (int task = tid; task < S * CH * C16; task += nthr) {
          const int c16 = task % C16, r = (task / C16) % CH, sl = task / (C16 * CH);
          const int gr = row0 + r, gc = n0 + 16 * c16;
          const bool in = gr < K && gc < NO;
          cp_async16(smem_addr(st + (sl * CH + r) * BN + 16 * c16),
                     in ? planes + ((size_t)sl * K + gr) * NO + gc : planes, in);
        }
      } else {
        for (int task = tid; task < S * CH * NQ; task += nthr) {
          const int c4 = task % NQ, r = (task / NQ) % CH, sl = task / (NQ * CH);
          const int gr = row0 + r, gc = n0 + 4 * c4;
          const int valid = gr < K ? NO - gc : 0;
          reinterpret_cast<uint32_t*>(st)[(sl * CH + r) * NQ + c4] =
              valid > 0 ? pack_row_bytes(planes + ((size_t)sl * K + gr) * NO + gc, valid, a.vec) : 0u;
        }
      }
    }
    cp_async_commit();
  };

  // the DAC of chunk i's x rows, in two steps so the loads fly during a
  // chunk's compute: x_rows reads the 4 rows of task (token, r4) = tid,
  // x_words writes their bit-plane words: word (b, r4, t) packs sgn·bit_t of
  // rows 4r4..4r4+3 as int8 lanes (-1, 0, +1), byte i for row 4r4+i
  const bool dac_task = tid < B * CR4;
  const int dac_b = tid / CR4, dac_r4 = tid % CR4;
  const auto x_rows = [&](int i) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (dac_task && i < nchunks) {
      const int r = chunk_row0(i) + 4 * dac_r4;
      const float* src = x + (size_t)dac_b * K + r;
      if (a.xvec && r + 3 < K) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        v.x = r < K ? src[0] : 0.f;
        v.y = r + 1 < K ? src[1] : 0.f;
        v.z = r + 2 < K ? src[2] : 0.f;
        v.w = r + 3 < K ? src[3] : 0.f;
      }
    }
    return v;
  };
  const auto x_words = [&](int i, float4 f) {
    if (!dac_task || i >= nchunks) return;
    const float v[4] = {f.x, f.y, f.z, f.w};
    uint32_t mag[4], nb = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qv = (int)fminf(fmaxf(rintf(v[j] * scale), -lim), lim);
      mag[j] = (uint32_t)abs(qv);
      nb |= (uint32_t)(qv < 0) << (8 * j);
    }
    const uint32_t m02 = mag[0] | (mag[2] << 16), m13 = mag[1] | (mag[3] << 16);
    int* dst = xs + ((i & 1) * B + dac_b) * XSW + dac_r4 * DP;
#pragma unroll
    for (int t = 0; t < D; ++t) {
      uint32_t w = ((m02 >> t) & 0x00010001u) | (((m13 >> t) & 0x00010001u) << 8);
      w += (w & nb) * 0xFEu;  // byte 1 -> 0xFF (-1) where the row is negative
      dst[t] = (int)w;
    }
  };

  int c[D][4];
#pragma unroll
  for (int t = 0; t < D; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[t][j] = FINITE ? MAGIC_I : 0;

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) load(i);
  x_words(0, x_rows(0));
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<NST - 2>();
    // chunk i's planes and bit-plane words are in; every thread is done
    // with chunk i-1's stage, words and slice terms
    __syncthreads();
    load(i + NST - 1);
    const float4 x_next = x_rows(i + 1);
    const unsigned char* st = dsm + (i % NST) * stage;
    const int tile = k0 + i / CHUNKS;
    if (NOISY && i % CHUNKS == 0) {
      // the tile's frozen read offsets (read at its end, after the next
      // barrier); at the ideal ADC summed over the bit cycles
      const float cycles = (float)((1 << (a.io_bits - 1)) - 1);
      for (int task = tid; task < S * BN; task += nthr) {
        const int sl = task / BN, n = task % BN;
        float o = __fmul_rn(counter_gauss((a.tile0 + tile) * S + sl, a.col0 + n0 + n, a.rw0, a.rw1),
                            a.off_scale[sl]);
        if (!FINITE) o = __fmul_rn(o, cycles);
        offs[task] = o;
      }
    }

    if (worker) {
      // column currents: rows 4r4..4r4+3 of columns 4q..4q+3 (one word a
      // row in the stage) transposed to a word a column, times every bit
      // cycle's word of token b
      const uint32_t* prow = reinterpret_cast<const uint32_t*>(st + s * CH * BN) + q;
      const int4* xrow = reinterpret_cast<const int4*>(xs + ((i & 1) * B + b) * XSW);
#pragma unroll 2
      for (int r4 = 0; r4 < CR4; ++r4) {
        uint32_t rw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) rw[j] = prow[(4 * r4 + j) * NQ];
        const int4 w = transpose4x4(rw);
        int xv[DP];
#pragma unroll
        for (int t4 = 0; t4 < DP / 4; ++t4) {
          const int4 v = xrow[r4 * (DP / 4) + t4];
          xv[4 * t4] = v.x, xv[4 * t4 + 1] = v.y, xv[4 * t4 + 2] = v.z, xv[4 * t4 + 3] = v.w;
        }
#pragma unroll
        for (int t = 0; t < D; ++t) {
          c[t][0] = __dp4a(xv[t], w.x, c[t][0]);
          c[t][1] = __dp4a(xv[t], w.y, c[t][1]);
          c[t][2] = __dp4a(xv[t], w.z, c[t][2]);
          c[t][3] = __dp4a(xv[t], w.w, c[t][3]);
        }
      }
    }
    x_words(i + 1, x_next);  // the other parity's words: free since the barrier

    if (i % CHUNKS == CHUNKS - 1) {
      // the tile is read: ADC and bit fold on the codes' float bits, as the
      // tensor-core body does; the slice term goes to red[s][b][4q..]
      if (worker) {
        float off[4] = {0.f, 0.f, 0.f, 0.f};
        if (NOISY) {
          const float4 o = reinterpret_cast<const float4*>(offs + s * BN)[q];
          off[0] = o.x, off[1] = o.y, off[2] = o.z, off[3] = o.w;
        }
        uint32_t z[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int t = 0; t < D; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (FINITE) {
              float r;
              if (NOISY) {
                const float cur = __fadd_rn(__fsub_rn(__int_as_float(c[t][j]), MAGIC_F), off[j]);
                r = fmaf(cur, inv_step, MAGIC_F);
              } else {
                r = fmaf(__int_as_float(c[t][j]), inv_step, bias);
              }
              r = fminf(fmaxf(r, lo), hi);
              z[j] += (uint32_t)__float_as_int(r) << t;
              c[t][j] = MAGIC_I;
            } else {
              z[j] += (uint32_t)c[t][j] << t;
              c[t][j] = 0;
            }
          }
        constexpr uint32_t FOLD = FINITE ? (uint32_t)MAGIC_I * ((1u << D) - 1u) : 0u;
        float term[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float zf = (float)(int)(z[j] - FOLD);
          term[j] = (NOISY && !FINITE) ? __fmul_rn(__fadd_rn(zf, off[j]), weight) : __fmul_rn(zf, weight);
        }
        reinterpret_cast<float4*>(red + (s * B + b) * BN)[q] = make_float4(term[0], term[1], term[2], term[3]);
      }
      __syncthreads();
      // the slice fold in ascending s: the tile's term, into the workspace
      for (int o = tid; o < B * BN; o += nthr) {
        const int bb = o / BN, gn = n0 + o % BN;
        float v = red[o];
        for (int sl = 1; sl < S; ++sl) v = __fadd_rn(v, red[sl * B * BN + o]);
        if (gn < NO) a.ws[((size_t)tile * B + bb) * NO + gn] = v;
      }
    }
  }

  // the last block of this column block to finish folds every tile's term
  // in ascending tile order, from 0 as the plain version does, and resets
  // the ticket for the next read on this stream
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(a.tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const size_t tile_stride = (size_t)B * NO;
  for (int o = tid; o < B * BN; o += nthr) {
    const int bb = o / BN, gn = n0 + o % BN;
    if (gn >= NO) continue;
    const float* src = a.ws + (size_t)bb * NO + gn;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < ntiles; ++k) acc = __fadd_rn(acc, __ldcg(src + k * tile_stride));
    a.out[(size_t)bb * NO + gn] = acc;
  }
  if (tid == 0) atomicExch(a.tickets + blockIdx.x, 0u);
}

template <int D, bool FINITE, bool NOISY>
cudaError_t launch_decode(const ReadParams& a, cudaStream_t stream) {
  const int threads = (a.S * a.B * dec::NQ + 31) / 32 * 32;
  const int ntiles = (a.K + XBAR_ROWS - 1) / XBAR_ROWS;
  const dim3 grid((a.NO + dec::BN - 1) / dec::BN, (ntiles + a.group - 1) / a.group);
  if (a.ws == nullptr || a.tickets == nullptr || a.group < 1 || threads > dec::MAX_THREADS ||
      (int)grid.x > a.n_tickets)
    return cudaErrorInvalidValue;
  const size_t smem = dec::smem_bytes(D, NOISY, a.S, a.B);
  // the dynamic shared-memory limit, raised once per instance and device (a
  // launch that needs more than the last one raises it again)
  static size_t allowed[dec::MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= dec::MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(mvm_decode_kernel<D, FINITE, NOISY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  mvm_decode_kernel<D, FINITE, NOISY><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

enum Body { BODY_DP4A = 0, BODY_MMA = 1, BODY_DECODE = 2 };

// K4 (float x): the tensor-core body, the decode body (forward only) or the
// dp4a body (MᵀVM only); K5 (int x_q): the tensor-core or the dp4a body
template <int D, bool FINITE, bool TRANS, bool NOISY, typename XT>
cudaError_t launch_one(int body, const ReadParams& a, cudaStream_t stream) {
  if (body == BODY_MMA) return launch_mma<D, FINITE, TRANS, NOISY, XT>(a, stream);
  if constexpr (std::is_same<XT, float>::value) {
    if constexpr (TRANS)
      return body == BODY_DP4A ? launch_dp4a<D, FINITE, true, NOISY, float>(a, stream) : cudaErrorInvalidValue;
    else
      return body == BODY_DECODE ? launch_decode<D, FINITE, NOISY>(a, stream) : cudaErrorInvalidValue;
  } else {
    return body == BODY_DP4A ? launch_dp4a<D, FINITE, TRANS, NOISY, XT>(a, stream) : cudaErrorInvalidValue;
  }
}

template <int D, bool NOISY, typename XT>
cudaError_t launch_d(int body, bool finite, bool transpose, const ReadParams& a, cudaStream_t stream) {
  if (finite)
    return transpose ? launch_one<D, true, true, NOISY, XT>(body, a, stream)
                     : launch_one<D, true, false, NOISY, XT>(body, a, stream);
  return transpose ? launch_one<D, false, true, NOISY, XT>(body, a, stream)
                   : launch_one<D, false, false, NOISY, XT>(body, a, stream);
}

// the io_bits the source instantiates: 8, 12 and 16 (7, 11, 15 bit cycles)
template <bool NOISY, typename XT>
cudaError_t launch(int body, bool finite, bool transpose, const ReadParams& a, cudaStream_t stream) {
  switch (a.io_bits) {
    case 8: return launch_d<7, NOISY, XT>(body, finite, transpose, a, stream);
    case 12: return launch_d<11, NOISY, XT>(body, finite, transpose, a, stream);
    case 16: return launch_d<15, NOISY, XT>(body, finite, transpose, a, stream);
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
  a.vec16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  a.xvec = a.K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.rw0 = a.rw1 = a.tile0 = a.col0 = 0;
  a.ws = nullptr;
  a.tickets = nullptr;
  a.group = 0;
  a.n_tickets = 0;
  for (int s = 0; s < MAX_S; ++s) {
    a.inv_step[s] = 0.f;
    a.bias[s] = 0.f;
    a.weight[s] = 0.f;
    a.off_scale[s] = 0.f;
  }
  for (int s = 0; s < S; ++s) {
    // full scale 128·2^(b-1) = 2^(6+b); step = 2·fs/2^adc = 2^(7+b-adc)
    const int e = 7 + slice_bits[s] - adc_bits;
    a.inv_step[s] = finite ? ldexpf(1.f, -e) : 1.f;
    // 1.5·2^23 - 1.5·2^23·2^-e: a multiple of 2^(22-e) below 2^24, exact in
    // f32 for the e of any slice width and ADC the wrapper takes
    a.bias[s] = finite ? (float)(12582912.0 - ldexp(12582912.0, -e)) : 0.f;
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
// (tile0, col0) the global tile and column offsets. body: 1 the tensor-core
// body; 2 the decode body (forward only), with ws f32 [ceil(M/128), B, N]
// workspace, tickets uint32 [n_tickets] zero (and left zero), n_tickets at
// least ceil(N / bn) (bn from panther_decode_geometry), group the tiles a
// block owns; 0 the dp4a body (MᵀVM only).
// Returns a cudaError_t.
extern "C" int panther_mvm_sliced_fused(const void* planes, const void* x, const void* frac_bits,
                                        void* out, int B, int M, int N, int S, int io_bits,
                                        int adc_bits, const int* slice_bits, int vec,
                                        int transpose, const float* off_scale, int rw0, int rw1,
                                        int tile0, int col0, int body, void* ws, void* tickets, int n_tickets,
                                        int group, void* stream) {
  ReadParams a;
  if (!read_params(a, planes, x, out, B, M, N, S, io_bits, adc_bits, slice_bits, vec, transpose))
    return (int)cudaErrorInvalidValue;
  a.frac_bits = static_cast<const int*>(frac_bits);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<unsigned*>(tickets);
  a.n_tickets = n_tickets;
  a.group = group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (off_scale == nullptr) return (int)launch<false, float>(body, adc_bits > 0, transpose != 0, a, st);
  for (int s = 0; s < S; ++s) a.off_scale[s] = off_scale[s];
  a.rw0 = rw0;
  a.rw1 = rw1;
  a.tile0 = tile0;
  a.col0 = col0;
  return (int)launch<true, float>(body, adc_bits > 0, transpose != 0, a, st);
}

// The decode body's geometry, which the wrapper's planner repeats: the
// output columns a block owns, and the most slices × tokens a read may have
// (one thread per slice, token and 4 columns).
extern "C" void panther_decode_geometry(int* bn, int* max_sb) {
  *bn = dec::BN;
  *max_sb = dec::MAX_THREADS / dec::NQ;
}

// K5. As K4 without the DAC and the read noise: x_q int32 [B,M] ([B,N]
// when transpose) on the io_bits grid; the bits of |x_q| at and above
// io_bits-1 are not streamed. body: 1 the tensor-core body, 0 the dp4a
// body. Returns a cudaError_t.
extern "C" int panther_mvm_sliced(const void* planes, const void* x_q, void* out, int B, int M, int N,
                                  int S, int io_bits, int adc_bits, const int* slice_bits, int vec,
                                  int transpose, int body, void* stream) {
  ReadParams a;
  if (!read_params(a, planes, x_q, out, B, M, N, S, io_bits, adc_bits, slice_bits, vec, transpose))
    return (int)cudaErrorInvalidValue;
  return (int)launch<false, int>(body, adc_bits > 0, transpose != 0, a, static_cast<cudaStream_t>(stream));
}
