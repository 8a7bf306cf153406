// Carry Resolution Step on the int8 digit planes, in place, for NVIDIA
// Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/crs/kernel.py::crs (body
// _crs_kernel), which computes src/repro/core/slicing.py::crs. Per element:
// digit-serial carry propagation LSB -> MSB (v = plane + carry; d = balanced
// digit of v; carry = (v - d) >> 4, exact); a carry out of the MSB rails the
// whole digit vector to +-canonical_limit; a carry-free vector below
// -canonical_limit (MSB-first lexicographic compare with its digits) rails
// to it. canonical_limit = 7·(16^S - 1)/15, so its digits are all 7 and
// those of -canonical_limit all -7, for every S.
//
// Bound. The pass reads and writes each plane byte once: 2·S·M·N bytes over
// HBM (3.35 TB/s on the H100). The digit arithmetic is integer work on the
// CUDA cores, whose integer pipe issues 64 lanes a clock per SM, half the
// f32 rate: at the ~15 operations an element and slice of a scalar carry
// chain it would cost, by that count, about as much as the bytes, so the
// design cuts it first.
//
// Design.
// * Byte lanes. A thread holds 4 elements of a plane in one 32-bit word and
//   runs the carry chain on all 4 at once with adds, shifts and logic ops
//   whose byte lanes never carry into each other (the arithmetic and its
//   ranges are in crs_words; ref.crs_words is its plain mirror, checked
//   against the reference on every int8 input): 13 operations a word and
//   slice, about 3 an element and slice. "Below -canonical_limit" is the
//   sign of sum (d_s + 7)·16^s, a second carry chain in the same loop.
// * S is a template argument, 1 to 8: every digit stays in registers.
// * Data movement: a persistent grid, each block walking chunks of 4096
//   elements of the flat M·N; one thread moves a chunk's S plane segments by
//   TMA 1-D bulk copies (cp.async.bulk, completion on an mbarrier) into a
//   ring of 3 shared-memory stages, every thread resolves 16 consecutive
//   elements with 16-byte shared accesses and writes the digits back into
//   the stage, and the one thread bulk-stores the segments; a stage is
//   refilled once its store has read it (cp.async.bulk.wait_group.read).
//   On the H100 it runs at about 0.95 of a device-to-device copy of the same
//   bytes; a variant with 16-byte loads and stores straight from and to
//   device memory measured the same within the run-to-run spread, the ring
//   ahead by less than 1% (PERF.md has both times).
// * Bulk copies need 16-byte-aligned addresses and sizes. The planes'
//   segments share one alignment only when M·N is a multiple of 16: then the elements before the first 16-byte boundary (the head) and
//   after the last (the tail) take the per-element routine in the same
//   launch; for other shapes every element does. Layer views of odd shapes
//   start anywhere.
// A later design fuses the pass into the last OPA deposit of a CRS step,
// which already holds the digits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_S = 8;  // canonical_limit fits int32
constexpr int THREADS = 256;
constexpr int GROUP = 16;               // elements a thread resolves at once: 16 bytes a plane
constexpr int CHUNK = GROUP * THREADS;  // elements of a bulk chunk (4096 bytes a plane)
constexpr int STAGES = 3;               // ring depth
constexpr int MAX_DEVICES = 64;

// -------------------------------------------------------------------------
// The arithmetic
// -------------------------------------------------------------------------

// One element through the reference's steps; planes [S, mn], p its address
// in plane 0.
template <int S>
__device__ __forceinline__ void crs_element(int8_t* p, size_t mn) {
  int d[S];
  int carry = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int v = p[s * mn] + carry;
    d[s] = ((v + 8) & 15) - 8;
    carry = (v - d[s]) >> 4;
  }
  bool lt = false, gt = false;
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const bool lt_new = lt || (!gt && d[s] < -7);
    gt = gt || (!lt && d[s] > -7);
    lt = lt_new;
  }
  lt = lt && carry == 0;
#pragma unroll
  for (int s = 0; s < S; ++s) p[s * mn] = (int8_t)(carry > 0 ? 7 : (carry < 0 || lt) ? -7 : d[s]);
}

// 4 elements a word: byte i of w[s] is the plane-s digit (int8) of element
// i; rewritten with the canonical digits. Per lane, with p the int8 digit
// and q = p + 128 = 16h + l its offset binary: the carry c in [-9, 9] is
// kept as cb = c + 9 in [0, 18], and wb = l + cb + 15 in [15, 48] equals
// (p + c + 8) - 16(h - 9), so the digit's x = d + 8 is wb & 15 and the next
// cb is h + (wb >> 4). Digits are kept as z = x + 0x78 (z ^ 0x80 is the
// int8 digit). Below -canonical_limit: lb in {0, 1} is one plus the borrow
// of sum (x_s - 1)·16^s, x_s - 1 + borrow + 16 = z + lb - 0x6A in [14, 30];
// lb = 0 at the end is below. No lane ever leaves [0, 255], so no lane
// carries into or borrows from its neighbour.
template <int S>
__device__ __forceinline__ void crs_words(uint32_t (&w)[S]) {
  constexpr uint32_t ONES = 0x01010101u, LO = 0x0F0F0F0Fu, SIGN = 0x80808080u;
  uint32_t cb = 9 * ONES, lb = ONES;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const uint32_t h = ((w[s] >> 4) ^ (8 * ONES)) & LO;
    const uint32_t wb = (w[s] & LO) + cb + 15 * ONES;
    const uint32_t z = (wb & LO) + 0x78787878u;
    cb = h + ((wb >> 4) & LO);
    lb = ((z + lb - 0x6A6A6A6Au) >> 4) & ONES;
    w[s] = z;
  }
  const uint32_t pos = (cb + 0x76767676u) & SIGN;    // carry > 0
  const uint32_t nonneg = (cb + 0x77777777u) & SIGN; // carry >= 0
  const uint32_t neg = (~nonneg & SIGN) | (((lb ^ ONES) << 7) & ~pos);
  const uint32_t posf = (pos >> 7) * 0xFFu, negf = (neg >> 7) * 0xFFu;
  const uint32_t rail = posf | negf;
  // per byte: 0x80 (z ^ 0x80 is the digit), +7 or -7 where railed
  const uint32_t q = (SIGN & ~rail) | (0x07070707u & posf) | (0xF9F9F9F9u & negf);
#pragma unroll
  for (int s = 0; s < S; ++s) w[s] = (w[s] & ~rail) ^ q;
}

// 16 consecutive elements: 16 bytes of each plane
template <int S>
__device__ __forceinline__ void crs_group(uint4 (&v)[S]) {
  uint32_t a[S], b[S], c[S], d[S];
#pragma unroll
  for (int s = 0; s < S; ++s) a[s] = v[s].x, b[s] = v[s].y, c[s] = v[s].z, d[s] = v[s].w;
  crs_words<S>(a);
  crs_words<S>(b);
  crs_words<S>(c);
  crs_words<S>(d);
#pragma unroll
  for (int s = 0; s < S; ++s) v[s] = make_uint4(a[s], b[s], c[s], d[s]);
}

// The per-element elements of a block: the head [0, head) and the tail
// [head + nbulk, mn), over the whole grid.
template <int S>
__device__ __forceinline__ void crs_edges(int8_t* planes, size_t mn, size_t head, size_t nbulk) {
  const size_t edge = head + (mn - head - nbulk);
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < edge; i += (size_t)gridDim.x * THREADS)
    crs_element<S>(planes + (i < head ? i : nbulk + i), mn);
}

// -------------------------------------------------------------------------
// TMA 1-D bulk copies through a ring of shared-memory stages
// -------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// planes [S, mn]; bulk elements [head, head + nbulk), 16-byte aligned in
// every plane. Block b walks chunks b, b + gridDim.x, ...
template <int S>
__global__ void __launch_bounds__(THREADS) crs_kernel(int8_t* __restrict__ planes, size_t mn, size_t head,
                                                           size_t nbulk) {
  extern __shared__ __align__(128) unsigned char ring[];  // [STAGES][S][CHUNK]
  __shared__ __align__(8) uint64_t full[STAGES];
  const int tid = threadIdx.x;
  crs_edges<S>(planes, mn, head, nbulk);

  const size_t nchunks = (nbulk + CHUNK - 1) / CHUNK;
  const size_t first = blockIdx.x, step = gridDim.x;
  const auto bytes_of = [&](size_t c) { return (uint32_t)(nbulk - c * CHUNK < CHUNK ? nbulk - c * CHUNK : CHUNK); };
  // thread 0: chunk i of this block into stage i % STAGES
  const auto load = [&](int i) {
    const size_t c = first + i * step;
    if (c >= nchunks) return;
    const uint32_t bytes = bytes_of(c);
    unsigned char* st = ring + (i % STAGES) * S * CHUNK;
    mbar_expect_tx(&full[i % STAGES], S * bytes);
#pragma unroll
    for (int s = 0; s < S; ++s) bulk_load(st + s * CHUNK, planes + s * mn + head + c * CHUNK, bytes, &full[i % STAGES]);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < STAGES; ++i) load(i);
  }
  __syncthreads();

  for (int i = 0; first + i * step < nchunks; ++i) {
    const size_t c = first + i * step;
    const uint32_t bytes = bytes_of(c);
    unsigned char* st = ring + (i % STAGES) * S * CHUNK;
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    if (GROUP * tid < bytes) {
      uint4 v[S];
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = reinterpret_cast<const uint4*>(st + s * CHUNK)[tid];
      crs_group<S>(v);
#pragma unroll
      for (int s = 0; s < S; ++s) reinterpret_cast<uint4*>(st + s * CHUNK)[tid] = v[s];
    }
    // the digits written by the threads, visible to the bulk store
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) bulk_store(planes + s * mn + head + c * CHUNK, st + s * CHUNK, bytes);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i > 0) {
        // the previous chunk's store has read its stage: refill it
        bulk_wait_read<1>();
        load(i - 1 + STAGES);
      }
    }
  }
  // the stores read the ring until they complete
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// -------------------------------------------------------------------------
// Launch
// -------------------------------------------------------------------------

template <int S>
cudaError_t launch(int8_t* planes, size_t mn, cudaStream_t stream) {
  size_t head = mn, nbulk = 0;
  if (mn % GROUP == 0) {
    head = (GROUP - reinterpret_cast<uintptr_t>(planes) % GROUP) % GROUP;
    nbulk = (mn - head) / GROUP * GROUP;
  }
  const size_t smem = (size_t)STAGES * S * CHUNK;
  // blocks resident on one SM at `smem` dynamic bytes, times the SMs, once
  // per device; the dynamic shared-memory limit is set even at 48 KB, since
  // the static mbarriers come on top of it
  static int most[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (most[dev] == 0) {
    err = cudaFuncSetAttribute(crs_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crs_kernel<S>, THREADS, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    most[dev] = per_sm * sms;
  }
  const size_t edge_blocks = (head + (mn - head - nbulk) + THREADS - 1) / THREADS;
  const size_t chunks = (nbulk + CHUNK - 1) / CHUNK;
  const size_t want = chunks > edge_blocks ? chunks : edge_blocks;
  const unsigned grid = (unsigned)(want < (size_t)most[dev] ? want : most[dev]);
  crs_kernel<S><<<grid, THREADS, smem, stream>>>(planes, mn, head, nbulk);
  return cudaGetLastError();
}

}  // namespace

// planes int8 [S, M·N] contiguous on the current device, rewritten in place.
// Returns a cudaError_t (0 on success).
extern "C" int panther_crs(void* planes, long long mn, int S, void* stream) {
  if (S < 1 || S > MAX_S || mn < 1) return (int)cudaErrorInvalidValue;
  int8_t* p = static_cast<int8_t*>(planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return (int)launch<1>(p, (size_t)mn, st);
    case 2: return (int)launch<2>(p, (size_t)mn, st);
    case 3: return (int)launch<3>(p, (size_t)mn, st);
    case 4: return (int)launch<4>(p, (size_t)mn, st);
    case 5: return (int)launch<5>(p, (size_t)mn, st);
    case 6: return (int)launch<6>(p, (size_t)mn, st);
    case 7: return (int)launch<7>(p, (size_t)mn, st);
    default: return (int)launch<8>(p, (size_t)mn, st);
  }
}
