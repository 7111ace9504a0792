// Row-group scatter updates with stochastic rounding, in place, for bf16 and
// int8 tables:
//
//   bf16: row = SR_bf16(f32(row) + vals)               for each real slot
//   int8: q   = int8(clip(floor(f32(q) + vals_grid + u), -127, 127)),
//         u   = (bits >> 8) * 2^-24
//
// Replaces dssm_tpu/kernels/pallas_gather.py::scatter_sr_row_groups (kernel
// _scatter_sr_kernel) and ::scatter_sr_int8_row_groups (kernel
// _scatter_sr_int8_kernel), which DMA each row group into VMEM, draw bits
// from the TPU's PRNG seeded per 32-group grid step, round and DMA back.
//
// Semantics: slot s with 0 <= gids[s] < num_groups replaces table group
// gids[s] by the rounded sum of its rows and vals[s*group : (s+1)*group]
// (SET semantics: the real ids of one call are distinct, as the dedupe
// makes them, so no two threads touch one address and the result is
// deterministic). Any other id, at any position (the dedupe's skip sentinel
// 1 << 25, a negative id, one past the table), touches nothing. A zero
// update leaves a row bit-identical: a bf16 value has zero low bits and
// cannot carry, and floor(q + u) = q for u < 1 (the int8 kernel adds u to
// the fraction alone, so f32 rounding cannot carry either).
//
// Random bits: Philox4x32-10 in registers, key (seed, 0), counter
// (e / 4, 0, 0) as a 64-bit value in the first two words, output word e % 4,
// for the element with flat index e = slot * group * H + offset in the
// compact block. kernels/stochastic.py::philox_bits is the same stream in
// plain PyTorch, so the plain versions of these updates are bit-equal to
// the kernels whatever thread computes an element. The seed is read from
// device memory (an int32 the train step computes from its step counter on
// the card), not passed by value, so a captured CUDA graph of the step
// draws a new stream at every replay instead of the stream of the step it
// was captured at.
//
// Bound on the H100: bytes, with the instructions close behind. Each real
// group is read and written once and its f32 vals read once: at the `full`
// preset's first batch (256 slots, 54 real at bf16 / 16-row groups, 27 at
// int8 / 32-row groups) 2.7 and 2.0 MB, 0.79 and 0.59 us at 3.35 TB/s;
// with every slot real 12.6 and 18.9 MB, 3.8 and 5.6 us. A Philox call is
// ten rounds of two 32 x 32 -> 64-bit multiplies and two three-way xors for
// four elements; with the rounding, a thread issues ~23 instructions an
// element at bf16 and ~30 at int8 (cuobjdump -sass; tools/sass.py counts
// them), 1.7 and 3.3 us of issue on 132 SMs with every slot real. On the
// few SMs that a block a slot gives the smoke's 27 or 54 real slots, that
// issue, and not the memory traffic, decided the time.
//
// Design: a flat grid. A block takes kThreads consecutive 16-byte vectors
// of one slot's group, a thread one vector (bf16: 8 elements, two Philox
// calls; int8: 16 elements, four), so a real slot's work spreads over
// several blocks and SMs, and a skip slot costs blocks that read one id. A
// thread tests its slot's id before it forms any address, then issues its
// table vector's load and its f32 vals loads together, draws the Philox
// words while they are in flight (they depend only on the element's index
// and the seed), rounds and stores: one memory round trip. The rounding is
// the plain version's arithmetic with fewer conversions: an int8 byte
// becomes a float, and a rounded value a byte, through the 1.5 * 2^23
// magic number, and u's multiply folds into one fma (its product is
// exact). Offsets are 64-bit: sentinel * group * H overflows 32 bits.
// Also measured on the card (tools/eval_kernels.py --cases scatter,
// PERF.md): a persistent grid whose blocks compact the real slots (a
// ballot a warp, a scan, three barriers) and share out their units, at
// full occupancy and at two blocks an SM (slower at every shape: the
// compaction stands before any unit's load); one unit a thread, or 2-4
// units a thread a block apart; 512 and 1024 threads a block; blocks
// interleaved across slots; vals loads without L1 or with plain L1
// allocation.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // load_evict_first

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint64_t counter,
                                               uint32_t key0) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = key0, k1 = 0u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// f32 accumulator -> bf16 bits in the high half: add 16 random bits below
// the kept half (the high half is then the truncated result).
__device__ __forceinline__ uint32_t sr_bf16_high(float acc, uint32_t rnd) {
  return __float_as_uint(acc) + (rnd & 0xFFFFu);
}

// Four bf16 values (two words, lower address in the low half) and their
// four vals and random words.
struct Bf16 {
  using Vec = uint2;
  static constexpr int kUnits = 2;  // a 16-byte vector's
  static __device__ __forceinline__ uint2 round(uint2 t, float4 v, uint4 r) {
    const uint32_t a = sr_bf16_high(__uint_as_float(t.x << 16) + v.x, r.x);
    const uint32_t b = sr_bf16_high(__uint_as_float(t.x & 0xFFFF0000u) + v.y,
                                    r.y);
    const uint32_t c = sr_bf16_high(__uint_as_float(t.y << 16) + v.z, r.z);
    const uint32_t d = sr_bf16_high(__uint_as_float(t.y & 0xFFFF0000u) + v.w,
                                    r.w);
    return make_uint2(__byte_perm(a, b, 0x7632), __byte_perm(c, d, 0x7632));
  }
};

// 1.5 * 2^23 + 128: a byte b placed in the low bits of 1.5 * 2^23's float
// is that float plus b exactly, so an int8 s (b = s ^ 0x80 = s + 128) is
// its float minus kInt8Magic, and an integral float q in [-128, 127] plus
// kInt8Magic holds q + 128 in its low byte.
constexpr float kInt8Magic = 12583040.0f;

__device__ __forceinline__ float sr_int8(uint32_t flipped, int i, float val,
                                         uint32_t rnd) {
  const float old =
      __uint_as_float(__byte_perm(flipped, 0x4B400000u, 0x7650 + i)) -
      kInt8Magic;
  const float acc = old + val;
  // floor(acc + u) as floor(acc) + (frac + u >= 1): one f32 add of acc and
  // u would round an integer acc up when u is within half an ulp of 1. The
  // product (bits >> 8) * 2^-24 is exact, so its fma is the plain version's
  // frac + u.
  const float low = floorf(acc);
  const float s = __fmaf_rn((float)(rnd >> 8), 5.9604644775390625e-08f,
                            acc - low);
  const float q = low + (s >= 1.0f ? 1.0f : 0.0f);
  return fminf(fmaxf(q, -127.0f), 127.0f) + kInt8Magic;
}

// Four int8 values in one word, lowest address in the low byte.
struct Int8 {
  using Vec = uint32_t;
  static constexpr int kUnits = 4;  // a 16-byte vector's
  static __device__ __forceinline__ uint32_t round(uint32_t t, float4 v,
                                                   uint4 r) {
    const uint32_t f = t ^ 0x80808080u;
    const uint32_t a = __float_as_uint(sr_int8(f, 0, v.x, r.x));
    const uint32_t b = __float_as_uint(sr_int8(f, 1, v.y, r.y));
    const uint32_t c = __float_as_uint(sr_int8(f, 2, v.z, r.z));
    const uint32_t d = __float_as_uint(sr_int8(f, 3, v.w, r.w));
    return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                       0x5410) ^
           0x80808080u;
  }
};

// A block takes kThreads consecutive 16-byte vectors of one slot's group, a
// thread one of them: its Op::kUnits units of four elements. table: the
// table as 16-byte vectors; vals: one float4 a unit; units: a group's units;
// blocks: a slot's blocks.
template <typename Op>
__global__ void __launch_bounds__(kThreads)
    scatter_sr_kernel(uint4* __restrict__ table,
                      const int32_t* __restrict__ gids,
                      const float4* __restrict__ vals, int64_t num_groups,
                      uint32_t units, uint32_t blocks,
                      const int32_t* __restrict__ seed_ptr) {
  constexpr int K = Op::kUnits;
  const uint32_t slot = blockIdx.x / blocks;
  const uint32_t vec = (blockIdx.x - slot * blocks) * kThreads + threadIdx.x;
  const uint32_t vecs = units / K;
  const int64_t gid = __ldg(gids + slot);
  if (gid < 0 || gid >= num_groups || vec >= vecs) return;
  const uint32_t seed = (uint32_t)__ldg(seed_ptr);
  uint4* dst = table + gid * vecs + vec;
  const uint64_t unit0 = (uint64_t)slot * units + (uint64_t)vec * K;
  uint4 t = *dst;
  // A thread's vals are 32 (bf16) or 64 (int8) contiguous bytes, read 16
  // at a time: evict_first keeps each 32-byte sector in L1 for its second
  // load without the stream pushing out more than it needs (no_allocate
  // read each sector from L2 twice, plain loads thrashed L1 at the cnn
  // width: PERF.md).
  float4 v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = dssm::load_evict_first(vals + unit0 + i);
  }
  typename Op::Vec* words = reinterpret_cast<typename Op::Vec*>(&t);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    words[i] = Op::round(words[i], v[i], philox4x32_10(unit0 + i, seed));
  }
  *dst = t;
}

template <typename Op>
int launch(void* table, const void* gids, const void* vals,
           long long num_slots, long long num_groups, long long group_elems,
           const void* seed, void* stream) {
  const long long units = group_elems / 4;
  const long long blocks = (units / Op::kUnits + kThreads - 1) / kThreads;
  if (units >= (1LL << 32) || num_slots * blocks >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  scatter_sr_kernel<Op><<<(unsigned int)(num_slots * blocks), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (uint4*)table, (const int32_t*)gids, (const float4*)vals,
      (int64_t)num_groups, (uint32_t)units, (uint32_t)blocks,
      (const int32_t*)seed);
  return (int)cudaGetLastError();
}

}  // namespace

// table: [num_groups * group, H] bf16, updated in place; gids: [num_slots]
// int32; vals: [num_slots * group, H] f32; seed: one int32 in device
// memory, the Philox key. group_elems = group * H, a multiple of 8; table
// and vals 16-byte aligned. Returns cudaGetLastError().
extern "C" int dssm_scatter_sr_bf16_row_groups(void* table, const void* gids,
                                               const void* vals,
                                               long long num_slots,
                                               long long num_groups,
                                               long long group_elems,
                                               const void* seed,
                                               void* stream) {
  if (num_slots <= 0 || group_elems <= 0 || group_elems % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<Bf16>(table, gids, vals, num_slots, num_groups, group_elems,
                      seed, stream);
}

// table: [num_groups * group, H] int8, updated in place; vals_grid:
// [num_slots * group, H] f32 in grid units (already divided by the row's
// scale). group_elems = group * H, a multiple of 16.
extern "C" int dssm_scatter_sr_int8_row_groups(void* table, const void* gids,
                                               const void* vals_grid,
                                               long long num_slots,
                                               long long num_groups,
                                               long long group_elems,
                                               const void* seed,
                                               void* stream) {
  if (num_slots <= 0 || group_elems <= 0 || group_elems % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<Int8>(table, gids, vals_grid, num_slots, num_groups,
                      group_elems, seed, stream);
}
